"""Models of the inference task: the 3-D U-Net (``unet``), weights carried
from the JAX package's flax checkpoints (``flax_import``) and from a
user's torch checkpoint (``torch_import``)."""

from .unet import UNet3D, get_model

__all__ = ["UNet3D", "get_model"]
