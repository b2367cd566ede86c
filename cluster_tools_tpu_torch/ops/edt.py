"""Euclidean distance transform as separable parabolic erosion cascades.

Port of ``cluster_tools_tpu/ops/edt.py``.  The per-axis min-plus transform
``g[i] = min_j f[j] + w (i - j)^2`` equals ``r`` iterated 3-tap erosions
with costs ``w (2i + 1)``; ``r = n - 1`` is exact, a smaller ``r`` caps the
transform at that radius.  On the card each axis pass is kernel B3
(:func:`.kernels.edt_cascade`); the torch route runs the reference's
``_edt_1d_axis`` (the cascade, or the one-shot broadcast min-plus above
``_CASCADE_MAX_RADIUS``).  Float32 results match the reference bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import as_tensor, resolve_device, resolve_impl
from .kernels import edt_cascade, edt_cascade_torch

_BIG = np.float32(1e12)
_CASCADE_MAX_RADIUS = 160


def _edt_1d_axis_bcast(f: torch.Tensor, axis: int, w: float) -> torch.Tensor:
    """One-shot min-plus: g[..., i] = min_j f[..., j] + w*(i-j)^2 along axis."""
    n = f.shape[axis]
    f = torch.movedim(f, axis, -1)
    i = torch.arange(n, dtype=torch.float32, device=f.device)
    dist = (i[:, None] - i[None, :]) ** 2 * torch.tensor(np.float32(w), device=f.device)  # [j, i]
    g = torch.amin(f[..., :, None] + dist, dim=-2)
    return torch.movedim(g, -1, axis)


def _edt_1d_axis(f: torch.Tensor, axis: int, w: float, radius: int) -> torch.Tensor:
    """Parabolic erosion along ``axis``: min_j f[j] + w*(i-j)^2, |i-j| <= radius."""
    n = f.shape[axis]
    radius = min(radius, n - 1)
    if radius <= 0:
        return f
    if radius > _CASCADE_MAX_RADIUS:
        return _edt_1d_axis_bcast(f, axis, w)
    return edt_cascade_torch(f, axis, radius, w, float(_BIG))


def _norm_sampling(ndim: int, sampling) -> Tuple[float, ...]:
    if sampling is None:
        return (1.0,) * ndim
    sampling = tuple(float(s) for s in np.atleast_1d(sampling))
    if len(sampling) == 1:
        sampling = sampling * ndim
    if len(sampling) != ndim:
        raise ValueError(f"sampling {sampling} has wrong rank for ndim {ndim}")
    return sampling


def _radii(shape, sampling, max_distance) -> Tuple[int, ...]:
    if max_distance is None:
        return tuple(n - 1 for n in shape)
    return tuple(int(np.ceil(float(max_distance) / s)) for s in sampling)


def _lane_view(f: torch.Tensor, axis: int):
    """A 3-D view of a ``[B, z, y, x]`` stack in which the lines along
    spatial ``axis`` stay inside their lane, and that axis in the view:
    ``[B, z, y*x]`` for z, ``[B*z, y, x]`` for y and x."""
    b, z, y, x = f.shape
    if axis == 0:
        return f.reshape(b, z, y * x), 1
    return f.reshape(b * z, y, x), axis


def dt_squared(mask: torch.Tensor, sampling: Tuple[float, ...], radii: Tuple[int, ...],
               impl: str = "auto", lead: int = 0) -> torch.Tensor:
    """Squared EDT of ``mask`` with per-axis radii (the reference's
    ``_dt_squared_impl``), on the mask's own device.  ``lead=1``: ``mask``
    is a ``[B, z, y, x]`` stack of 3-D lanes, each transformed on its own
    (on the card, one B3 launch per axis over lane-safe views)."""
    impl = resolve_impl(impl, mask)
    big = torch.tensor(_BIG, device=mask.device)
    f = torch.where(mask, big, torch.tensor(np.float32(0.0), device=mask.device)).contiguous()
    vol = f.shape[lead:]
    if impl == "cuda" and len(vol) == 3 and lead in (0, 1):
        for axis in range(3):
            r = min(radii[axis], vol[axis] - 1)
            if r > 0:
                view, ax = (f, axis) if lead == 0 else _lane_view(f, axis)
                f = edt_cascade(view, ax, r, float(sampling[axis]) ** 2, float(_BIG),
                                impl="cuda").reshape(f.shape)
        return torch.minimum(f, big)
    for axis in range(len(vol)):
        f = _edt_1d_axis(f, lead + axis, float(sampling[axis]) ** 2, radii[axis])
    return torch.minimum(f, big)


def edt_axis_pass(f, axis: int, w: float, radius: int, impl: str = "auto", device=None) -> torch.Tensor:
    """One separable min-plus (parabolic erosion) pass along ``axis``;
    ``w`` is the squared voxel size, ``radius`` caps the pass."""
    f = as_tensor(f, resolve_device(device), torch.float32)
    radius = min(int(radius), f.shape[axis] - 1)
    if radius <= 0:
        return f
    if resolve_impl(impl, f) == "cuda" and f.dim() == 3:
        # B3 runs the cascade at any radius, where the twin switches to the
        # broadcast min-plus above _CASCADE_MAX_RADIUS (the exact EDT's
        # full-extent passes).  For unit sampling the two are bit-equal: every
        # finite value is an integer below 2**24, so each sum is exact.  Other
        # sampling is not covered by that argument.
        return edt_cascade(f, axis, radius, float(w), float(_BIG), impl="cuda")
    return _edt_1d_axis(f, axis, float(w), radius)


def distance_transform_squared_tensor(mask: torch.Tensor, sampling=None,
                                      max_distance: Optional[float] = None,
                                      impl: str = "auto", lead: int = 0) -> torch.Tensor:
    """:func:`distance_transform_squared` on a tensor, on its own device
    (``lead`` leading axes are lanes, see :func:`dt_squared`)."""
    vol = mask.shape[lead:]
    sampling = _norm_sampling(len(vol), sampling)
    return dt_squared(mask.to(torch.bool), sampling, _radii(vol, sampling, max_distance), impl, lead)


def distance_transform_squared(mask, sampling: Optional[Sequence[float]] = None,
                               max_distance: Optional[float] = None, impl: str = "auto",
                               device=None) -> torch.Tensor:
    """Squared EDT of a boolean mask: distance to the nearest background
    voxel (0 on background; ``1e12`` where a line sees no background).
    ``max_distance`` caps the transform (values up to the cap exact)."""
    dev = resolve_device(device)
    return distance_transform_squared_tensor(
        as_tensor(mask, dev, torch.bool), sampling=sampling, max_distance=max_distance, impl=impl
    )


def distance_transform(mask, sampling: Optional[Sequence[float]] = None,
                       max_distance: Optional[float] = None, impl: str = "auto",
                       device=None) -> torch.Tensor:
    """Euclidean distance transform (sqrt of the squared EDT)."""
    return torch.sqrt(
        distance_transform_squared(mask, sampling=sampling, max_distance=max_distance,
                                   impl=impl, device=device)
    )
