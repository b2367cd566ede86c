"""Bring your own torch U-Net: load a torch checkpoint into the port's
:class:`~.unet.UNet3D`.

Port of ``cluster_tools_tpu/models/torch_import.py``.  A user arrives with
a torch ``state_dict`` of the same U-Net family (the same layers in the
same order); its tensors map one for one, by position, onto the port's
parameters in registration order.  Torch layouts need no conversion here
(the JAX package flips and transposes them into flax's).  A tensor whose
shape does not fit, or a different tensor count, raises naming the first
tensor that fails.

:func:`infer_unet_config` is a copy of the reference's census (numpy only):
it deduces ``base_features`` / ``depth`` / ``out_channels`` / ``norm`` /
``in_channels`` from the tensors alone.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .unet import UNet3D


def _to_array(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)


def infer_unet_config(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Deduce the UNet3D hyperparameters from a torch ``state_dict`` alone.

    - 5-D conv tensors: per level a 2-conv block + 1 downsample, a 2-conv
      bottom, per level 1 transpose + a 2-conv block, and 1 output head
      = ``6 * depth + 3``  ->  depth.
    - first conv weight ``(O, I, k, k, k)``: O = base_features,
      I = in_channels; last conv weight: O = out_channels.
    - 1-D tensors: one bias per conv without norm (``6 depth + 3``), plus a
      GroupNorm scale+bias pair per block conv (``+ 4 (2 depth + 1)``)
      with norm.

    Returns kwargs for :class:`~.unet.UNet3D`.  Raises ``ValueError``
    naming the offending tensor when the census does not fit the family.
    """
    items = [(k, a) for k, v in state_dict.items() if "num_batches_tracked" not in k for a in (_to_array(v),)]
    conv5 = [(k, a) for k, a in items if a.ndim == 5]
    one_d = [(k, a) for k, a in items if a.ndim == 1]
    other = [(k, a) for k, a in items if a.ndim not in (1, 5) and a.ndim >= 1]
    if other:
        k, a = other[0]
        raise ValueError(
            f"state_dict tensor {k!r} has shape {tuple(a.shape)} — not part of the 3-D U-Net family "
            "(expected 5-D conv kernels and 1-D bias/norm vectors)"
        )
    if not conv5:
        raise ValueError("state_dict holds no 5-D tensors — not a 3-D conv net")
    n5 = len(conv5)
    if n5 < 3 or (n5 - 3) % 6:
        raise ValueError(
            f"{n5} conv tensors does not fit the U-Net census 6*depth + 3 (first conv tensor: {conv5[0][0]!r})"
        )
    depth = (n5 - 3) // 6
    base_features = int(conv5[0][1].shape[0])
    in_channels = int(conv5[0][1].shape[1])
    out_channels = int(conv5[-1][1].shape[0])
    n1 = len(one_d)
    if n1 == n5:
        norm = None
    elif n1 == n5 + 4 * (2 * depth + 1):
        norm = "group"
    else:
        raise ValueError(
            f"{n1} 1-D tensors fits neither norm=None ({n5}) nor norm='group' ({n5 + 4 * (2 * depth + 1)}) "
            f"for depth={depth} (first 1-D tensor: {one_d[0][0] if one_d else None!r})"
        )
    return {"out_channels": out_channels, "base_features": base_features, "depth": depth, "norm": norm,
            "in_channels": in_channels}


def _unwrap_state_dict(obj, origin):
    for key in ("state_dict", "model_state_dict", "model"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    if not isinstance(obj, dict):
        raise ValueError(f"{origin!r} does not contain a state_dict (got {type(obj).__name__})")
    return obj


def _read_state_dict(path_or_state_dict) -> Mapping[str, Any]:
    if isinstance(path_or_state_dict, (str, bytes, os.PathLike)):
        obj = torch.load(path_or_state_dict, map_location="cpu", weights_only=True)
        return _unwrap_state_dict(obj, path_or_state_dict)
    return _unwrap_state_dict(path_or_state_dict, "state_dict")


def torch_state_dict_to_port(state_dict: Mapping[str, Any], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A torch ``state_dict`` of the same architecture as ``model``, mapped
    by position onto ``model``'s ``state_dict`` keys."""
    want = list(model.state_dict().items())
    items = [(k, torch.from_numpy(np.ascontiguousarray(a))) for k, v in state_dict.items()
             if "num_batches_tracked" not in k for a in (_to_array(v),) if a.ndim >= 1]
    first = None
    for (pkey, pt), (tkey, t) in zip(want, items):
        if tuple(t.shape) != tuple(pt.shape):
            first = f"port {pkey!r} wants {tuple(pt.shape)}, torch {tkey!r} has {tuple(t.shape)}"
            break
    if len(items) != len(want) or first is not None:
        raise ValueError(
            f"parameter mismatch: the port's {type(model).__name__} has {len(want)} tensors, the torch "
            f"state_dict {len(items)}.\nfirst unmappable tensor: {first or 'lists agree up to the shorter length'}"
            f"\nport: {[k for k, _ in want]}\ntorch: {[k for k, _ in items]}"
        )
    return {pkey: t.to(torch.float32) for (pkey, _), (_, t) in zip(want, items)}


def load_torch_checkpoint(path_or_state_dict, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Load a ``.pt``/``.pth`` torch checkpoint, or a ``state_dict`` (raw,
    or wrapped as ``state_dict`` / ``model_state_dict`` / ``model``), into
    ``model``; returns the mapped ``state_dict``."""
    sd = torch_state_dict_to_port(_read_state_dict(path_or_state_dict), model)
    model.load_state_dict(sd)
    return sd


def import_torch_unet(path_or_state_dict, **overrides) -> Tuple[UNet3D, Dict[str, torch.Tensor]]:
    """Torch U-Net checkpoint -> ``(model, state_dict)``, config-free.

    Infers the architecture with :func:`infer_unet_config`, builds the
    port's :class:`~.unet.UNet3D` (``overrides`` go to its constructor,
    e.g. ``dtype=torch.float32``) and loads the weights.  GroupNorm group
    counts are not in the shapes: the model uses ``min(8, channels)``.
    """
    sd = _read_state_dict(path_or_state_dict)
    cfg = infer_unet_config(sd)
    cfg.update(overrides)
    model = UNet3D(**cfg)
    return model, load_torch_checkpoint(sd, model)
