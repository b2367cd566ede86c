"""Separable gaussian smoothing as weighted shift-sums.

Port of ``cluster_tools_tpu/ops/filters.py::gaussian_smooth`` (the
``sigma_seeds`` smoothing of the DT-watershed seeds): the same sequence of
shifted multiply-adds per axis, in the same order, each multiply and add
rounded to float32 on its own.  The reference's XLA build for the CPU
contracts some of those multiply-adds into fused ones (one rounding), so
on the CPU the two differ by a few float32 ulps (tests/test_torch_workflow_ws.py
states the bound; ROADMAP Queue C).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from .ccl import _shift


def _gaussian_kernel(sigma: float, truncate: float = 3.0) -> np.ndarray:
    radius = max(1, int(truncate * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_smooth_tensor(x: torch.Tensor, sigma: float,
                           sampling: Optional[Tuple[float, ...]] = None) -> torch.Tensor:
    """:func:`gaussian_smooth` on a tensor, on its own device."""
    xf = x.to(torch.float32)
    if sigma <= 0:
        return xf
    if sampling is None:
        sampling = (1.0,) * x.dim()

    def blur(v):
        for axis in range(v.dim()):
            s_ax = float(sigma) / float(sampling[axis])
            if s_ax <= 1e-3:
                continue
            k = _gaussian_kernel(s_ax)
            radius = len(k) // 2
            acc = torch.zeros_like(v)
            for j, w in enumerate(k):
                acc = acc + float(w) * _shift(v, j - radius, axis, 0.0)
            v = acc
        return v

    return blur(xf) / torch.clamp_min(blur(torch.ones_like(xf)), 1e-6)


def gaussian_smooth(x, sigma: float, sampling: Optional[Tuple[float, ...]] = None,
                    device=None) -> torch.Tensor:
    """Separable gaussian blur with border renormalization
    (``blur(x) / blur(1)``, so edge voxels average only over real data).
    ``sampling`` gives per-axis voxel sizes: the per-axis sigma is ``sigma /
    sampling[axis]``."""
    return gaussian_smooth_tensor(as_tensor(x, resolve_device(device), torch.float32), sigma, sampling)
