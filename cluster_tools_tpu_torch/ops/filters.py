"""Separable image filters as weighted shift-sums.

Port of ``cluster_tools_tpu/ops/filters.py``: gaussian smoothing (the
``sigma_seeds`` smoothing of the DT-watershed seeds and the ilastik feature
bank), central-difference gradients, gaussian gradient magnitude, and the
eigenvalues of the gaussian Hessian and structure tensor (closed-form
Cardano per voxel).  ``gaussian_smooth`` runs the same sequence of shifted
multiply-adds per axis, in the same order, each multiply and add rounded
to float32 on its own.  The reference's XLA build for the CPU contracts
some of those multiply-adds into fused ones (one rounding), so on the CPU
the two differ by a few float32 ulps (tests/test_torch_workflow_ws.py
states the bound; ROADMAP Queue C); the filters built on it inherit that.

Each filter is a function on tensors (``*_tensor``, on the tensor's own
device) and a wrapper that takes a numpy array or a tensor and a
``device`` (default: the card).
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
                           sampling: Optional[Tuple[float, ...]] = None, lead: int = 0) -> torch.Tensor:
    """:func:`gaussian_smooth` on a tensor, on its own device; ``lead``
    leading axes are lanes, each smoothed on its own."""
    xf = x.to(torch.float32)
    if sigma <= 0:
        return xf
    if sampling is None:
        sampling = (1.0,) * (x.dim() - lead)

    def blur(v):
        for axis in range(v.dim() - lead):
            s_ax = float(sigma) / float(sampling[axis])
            if s_ax <= 1e-3:
                continue
            k = _gaussian_kernel(s_ax)
            radius = len(k) // 2
            acc = torch.zeros_like(v)
            for j, w in enumerate(k):
                acc = acc + float(w) * _shift(v, j - radius, lead + axis, 0.0)
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


def gradient_1d_tensor(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Central-difference gradient along ``axis``, 0 at both borders."""
    xf = x.to(torch.float32)
    fwd = _shift(xf, -1, axis, 0.0)
    bwd = _shift(xf, 1, axis, 0.0)
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device)
    shape = [1] * x.dim()
    shape[axis] = n
    interior = ((idx > 0) & (idx < n - 1)).reshape(shape)
    return torch.where(interior, 0.5 * (fwd - bwd), 0.0)


def _gradient_magnitude_of(s: torch.Tensor, sampling: Tuple[float, ...]) -> torch.Tensor:
    """Gradient magnitude of an already smoothed float32 volume."""
    g2 = torch.zeros(s.shape, dtype=torch.float32, device=s.device)
    for axis in range(s.dim()):
        g = gradient_1d_tensor(s, axis) / float(sampling[axis])
        g2 = g2 + g * g
    return torch.sqrt(g2)


def gradient_magnitude_tensor(x: torch.Tensor, sigma: float = 0.0,
                              sampling: Optional[Tuple[float, ...]] = None) -> torch.Tensor:
    """Gaussian gradient magnitude (vigra ``gaussianGradientMagnitude``)."""
    s = gaussian_smooth_tensor(x, sigma, sampling) if sigma > 0 else x.to(torch.float32)
    return _gradient_magnitude_of(s, sampling if sampling is not None else (1.0,) * x.dim())


def symmetric3_eigenvalues(a00, a01, a02, a11, a12, a22) -> torch.Tensor:
    """Closed-form eigenvalues of a field of symmetric 3x3 matrices
    (Noble/Smith trigonometric form of Cardano's method), ``(*shape, 3)``
    sorted descending.  The scale ``p`` is floored at 1e-10, so near-zero
    matrices give ``q`` (not 0/0), and ``r`` is clipped into [-1, 1]."""
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    p = torch.clamp_min(torch.sqrt(torch.clamp_min(p2 / 6.0, 0.0)), 1e-10)
    det = (b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02) + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(det / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    two_pi_3 = float(np.float32(2.0 * np.pi / 3.0))
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + two_pi_3)
    e2 = 3.0 * q - e1 - e3
    return torch.stack([e1, e2, e3], dim=-1)


def _first_derivatives(x: torch.Tensor, sigma: float, sampling) -> Tuple[list, Tuple[float, ...]]:
    if x.dim() != 3:
        raise ValueError("the eigenvalue filters expect a 3-D volume")
    if sampling is None:
        sampling = (1.0,) * x.dim()
    s = gaussian_smooth_tensor(x, sigma, sampling)
    inv = [1.0 / float(sp) for sp in sampling]
    return [gradient_1d_tensor(s, a) * inv[a] for a in range(3)], tuple(sampling)


def hessian_eigenvalues_tensor(x: torch.Tensor, sigma: float,
                               sampling: Optional[Tuple[float, ...]] = None) -> torch.Tensor:
    """Eigenvalues of the gaussian Hessian, descending ``(*shape, 3)``
    (vigra ``hessianOfGaussianEigenvalues``): second derivatives are
    central differences of the first ones of the smoothed volume."""
    g, sampling = _first_derivatives(x, sigma, sampling)
    inv = [1.0 / float(sp) for sp in sampling]
    h = {(a, b): gradient_1d_tensor(g[a], b) * inv[b] for a in range(3) for b in range(a, 3)}
    return symmetric3_eigenvalues(h[(0, 0)], h[(0, 1)], h[(0, 2)], h[(1, 1)], h[(1, 2)], h[(2, 2)])


def structure_tensor_eigenvalues_tensor(x: torch.Tensor, sigma: float, rho: Optional[float] = None,
                                        sampling: Optional[Tuple[float, ...]] = None) -> torch.Tensor:
    """Eigenvalues of the gaussian structure tensor, descending
    ``(*shape, 3)`` (vigra ``structureTensorEigenvalues``): gradients at
    inner scale ``sigma``, their outer product smoothed at outer scale
    ``rho`` (default ``sigma / 2``)."""
    g, sampling = _first_derivatives(x, sigma, sampling)
    if rho is None:
        rho = float(sigma) / 2.0
    t = {(a, b): gaussian_smooth_tensor(g[a] * g[b], rho, sampling) for a in range(3) for b in range(a, 3)}
    return symmetric3_eigenvalues(t[(0, 0)], t[(0, 1)], t[(0, 2)], t[(1, 1)], t[(1, 2)], t[(2, 2)])


def gradient_1d(x, axis: int, device=None) -> torch.Tensor:
    """:func:`gradient_1d_tensor` of a numpy array or tensor on ``device``."""
    return gradient_1d_tensor(as_tensor(x, resolve_device(device), torch.float32), axis)


def gradient_magnitude(x, sigma: float = 0.0, sampling: Optional[Tuple[float, ...]] = None,
                       device=None) -> torch.Tensor:
    """:func:`gradient_magnitude_tensor` of a numpy array or tensor on ``device``."""
    return gradient_magnitude_tensor(as_tensor(x, resolve_device(device), torch.float32), sigma, sampling)


def hessian_eigenvalues(x, sigma: float, sampling: Optional[Tuple[float, ...]] = None,
                        device=None) -> torch.Tensor:
    """:func:`hessian_eigenvalues_tensor` of a numpy array or tensor on ``device``."""
    return hessian_eigenvalues_tensor(as_tensor(x, resolve_device(device), torch.float32), sigma, sampling)


def structure_tensor_eigenvalues(x, sigma: float, rho: Optional[float] = None,
                                 sampling: Optional[Tuple[float, ...]] = None, device=None) -> torch.Tensor:
    """:func:`structure_tensor_eigenvalues_tensor` of a numpy array or tensor on ``device``."""
    return structure_tensor_eigenvalues_tensor(as_tensor(x, resolve_device(device), torch.float32), sigma, rho,
                                               sampling)
