"""3-D U-Net as a torch ``nn.Module``, the twin of the flax ``UNet3D``.

Port of ``cluster_tools_tpu/models/unet.py``: the same layers applied in
the same order, with the flax module's numerics carried over where a torch
default differs.  Layout is torch's NCDHW: ``(batch, c_in, z, y, x) ->
(batch, out_channels, z, y, x)`` float32 logits (callers apply
sigmoid/softmax).

- Parameters are float32.  The input is cast to ``dtype`` first; each
  convolution casts its input, weight and bias to ``dtype`` and outputs
  ``dtype``, adding the bias after the convolution (as flax does, so the
  convolution's output is rounded to ``dtype`` before the bias).
- GroupNorm (``norm="group"``) runs in float32 with ``min(8, features)``
  groups, epsilon 1e-6 (flax's default; torch's is 1e-5) and the variance
  as E[x^2] - E[x]^2 clamped at 0 (flax's ``use_fast_variance``).
- GELU is the tanh approximation (flax ``nn.gelu``), on float32 after
  GroupNorm and on ``dtype`` without it.
- Downsampling is a 2^3 stride-2 convolution without padding (flax's
  "SAME" pads nothing for even inputs), upsampling a 2^3 stride-2
  transposed convolution; the skip is cast to the upsampled dtype and
  concatenated after it.  The 1^3 head runs in float32.

Submodules carry flax's auto-names (``ConvBlock_{i}``, ``Conv_{k}``,
``ConvTranspose_{t}``; inside a block ``Conv_{j}`` and ``GroupNorm_{j}``)
and are registered in application order, so a ``state_dict`` lists its
tensors in the order flax creates its parameters, and
:mod:`.flax_import` maps the two by name.

Initialisation: convolution weights are normal with std
``1/sqrt(fan_in)`` (the scale of flax's ``lecun_normal``), biases 0,
GroupNorm scale 1 and bias 0, drawn from an explicit CPU
``torch.Generator`` (:meth:`UNet3D.reset_parameters`; the constructor uses
seed 0).  These are not the values of flax's ``PRNGKey(0)`` init: random
weights serve pipeline smoke runs only, and a checkpoint is what carries a
network between the packages.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _as_dtype(dtype) -> torch.dtype:
    """``dtype`` as a torch dtype (accepts the names ``"bfloat16"`` etc.)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


class Conv(nn.Module):
    """flax ``nn.Conv`` / ``nn.ConvTranspose`` with cubic kernels.

    ``weight`` is ``(out, in, k, k, k)`` (``(in, out, k, k, k)`` when
    ``transpose``).  "SAME" padding for odd ``kernel`` at stride 1; none for
    the stride-2 down/up convolutions."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 dtype=torch.bfloat16, transpose: bool = False):
        super().__init__()
        self.stride = int(stride)
        self.padding = kernel // 2 if stride == 1 else 0
        self.dtype = _as_dtype(dtype)
        self.transpose = bool(transpose)
        shape = (in_channels, out_channels) if transpose else (out_channels, in_channels)
        self.weight = nn.Parameter(torch.empty(shape + (kernel,) * 3))
        self.bias = nn.Parameter(torch.empty(out_channels))
        # flax's fan-in: the kernel volume times the input channels
        self.fan_in = in_channels * kernel ** 3

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=generator) / math.sqrt(self.fan_in))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        if self.transpose:
            y = F.conv_transpose3d(x, w, stride=self.stride)
        else:
            y = F.conv3d(x, w, stride=self.stride, padding=self.padding)
        return y + self.bias.to(self.dtype).view(1, -1, 1, 1, 1)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, dtype=float32)``: float32 statistics
    with the fast variance, epsilon 1e-6, float32 output."""

    def __init__(self, num_groups: int, channels: int, epsilon: float = 1e-6):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{channels} channels do not split into {num_groups} groups")
        self.num_groups = int(num_groups)
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        xf = x.to(torch.float32)
        g = xf.reshape(n, self.num_groups, -1)
        mu = g.mean(dim=2)
        mu2 = (g * g).mean(dim=2)
        var = torch.clamp_min(mu2 - mu * mu, 0.0)
        rep = c // self.num_groups
        mean = mu.repeat_interleave(rep, dim=1).view(n, c, 1, 1, 1)
        mul = torch.rsqrt(var + self.epsilon).repeat_interleave(rep, dim=1) * self.weight.view(1, c)
        y = xf - mean
        y = y * mul.view(n, c, 1, 1, 1)
        return y + self.bias.view(1, c, 1, 1, 1)


class ConvBlock(nn.Module):
    """Two 3^3 convolutions, each followed by GroupNorm (``norm="group"``)
    and the tanh GELU."""

    def __init__(self, in_channels: int, features: int, dtype=torch.bfloat16, norm: Optional[str] = "group"):
        super().__init__()
        if norm not in ("group", None):
            raise ValueError(f"norm must be 'group' or None, got {norm!r}")
        self.norm = norm
        for j in range(2):
            self.add_module(f"Conv_{j}", Conv(in_channels if j == 0 else features, features, 3, dtype=dtype))
            if norm == "group":
                self.add_module(f"GroupNorm_{j}", GroupNorm(min(8, features), features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(2):
            x = getattr(self, f"Conv_{j}")(x)
            if self.norm == "group":
                x = getattr(self, f"GroupNorm_{j}")(x)
            x = F.gelu(x, approximate="tanh")
        return x


class UNet3D(nn.Module):
    """Symmetric 3-D U-Net.

    ``depth`` pooling levels halve each spatial dim; every spatial extent
    of the input must be divisible by ``2**depth`` (the inference task pads
    blocks to meet this).  ``norm=None`` makes the network purely
    convolutional."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, base_features: int = 16, depth: int = 2,
                 dtype=torch.bfloat16, norm: Optional[str] = "group"):
        super().__init__()
        self.in_channels = int(in_channels)
        self.out_channels = int(out_channels)
        self.base_features = int(base_features)
        self.depth = int(depth)
        self.dtype = _as_dtype(dtype)
        self.norm = norm
        feats, cin = self.base_features, self.in_channels
        # registration order == application order == flax's creation order
        for i in range(self.depth):
            self.add_module(f"ConvBlock_{i}", ConvBlock(cin, feats, self.dtype, norm))
            self.add_module(f"Conv_{i}", Conv(feats, feats * 2, 2, stride=2, dtype=self.dtype))
            cin, feats = feats * 2, feats * 2
        self.add_module(f"ConvBlock_{self.depth}", ConvBlock(cin, feats, self.dtype, norm))
        for t in range(self.depth):
            feats //= 2
            self.add_module(f"ConvTranspose_{t}", Conv(feats * 2, feats, 2, stride=2, dtype=self.dtype,
                                                       transpose=True))
            self.add_module(f"ConvBlock_{self.depth + 1 + t}", ConvBlock(feats * 2, feats, self.dtype, norm))
        self.add_module(f"Conv_{self.depth}", Conv(feats, self.out_channels, 1, dtype=torch.float32))
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter anew from ``generator`` (a CPU generator,
        so the weights do not depend on the device), in registration
        order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mult = 2 ** self.depth
        if x.dim() != 5 or x.shape[1] != self.in_channels or any(s % mult for s in x.shape[2:]):
            raise ValueError(f"UNet3D(depth={self.depth}, in_channels={self.in_channels}) takes "
                             f"(batch, {self.in_channels}, z, y, x) with z, y, x divisible by {mult}; "
                             f"got {tuple(x.shape)}")
        x = x.to(self.dtype)
        skips = []
        for i in range(self.depth):
            x = getattr(self, f"ConvBlock_{i}")(x)
            skips.append(x)
            x = getattr(self, f"Conv_{i}")(x)
        x = getattr(self, f"ConvBlock_{self.depth}")(x)
        for t, skip in enumerate(reversed(skips)):
            x = getattr(self, f"ConvTranspose_{t}")(x)
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
            x = getattr(self, f"ConvBlock_{self.depth + 1 + t}")(x)
        return getattr(self, f"Conv_{self.depth}")(x)


_MODELS = {"unet3d": UNet3D}


def get_model(name: str, **kwargs) -> nn.Module:
    try:
        cls = _MODELS[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: {sorted(_MODELS)}") from None
    return cls(**kwargs)
