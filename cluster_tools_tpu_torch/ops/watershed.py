"""Seeded watershed as dense steepest descent + pointer jumping (legacy).

Port of ``cluster_tools_tpu/ops/watershed.py``, the per-block watershed
that 2-D mode, connectivity above 1, ``impl="legacy"`` and the size
filter run:

1. **descent pointers**: every voxel points at the lexicographic minimum
   of ``(height, flat_index)`` over its closed neighbourhood; seeds and
   masked-out voxels point at themselves;
2. **resolve**: pointer jumping ``ptr = ptr[ptr]`` to the fixpoint;
3. **fill**: unlabeled voxels adopt the label of their lowest labeled
   neighbour until nothing changes (an unordered relaxation; the tiled
   watershed in ``tile_ws.py`` fills across the lowest saddles instead).

The distance transforms go through ``edt.py``, so kernel B3 on the card
(a 2-D slice is lifted to a 3-D volume of one plane).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import as_tensor, resolve_device, resolve_impl
from .ccl import _compress, _neighbor_offsets, _shift_nd, finalize_labels, label_components_batched

_BIG = float(np.float32(3e38))
_NEG_BIG = -3e38


def local_maxima_tensor(x: torch.Tensor, connectivity: int = 1) -> torch.Tensor:
    """:func:`local_maxima` on a tensor, on its own device."""
    xf = x.to(torch.float32)
    m = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    for off in _neighbor_offsets(x.dim(), connectivity):
        for o in (off, tuple(-v for v in off)):
            m &= xf >= _shift_nd(xf, o, _NEG_BIG)
    return m


def local_maxima(x, connectivity: int = 1, device=None) -> torch.Tensor:
    """Boolean mask of (plateau) local maxima: ``x >= all neighbours``."""
    return local_maxima_tensor(as_tensor(x, resolve_device(device)), connectivity)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(v), device=like.device)


def _descent_pointers(height: torch.Tensor, is_seed: torch.Tensor, valid: torch.Tensor,
                      connectivity: int) -> torch.Tensor:
    """Flat index of the lex-min ``(height, index)`` closed-neighbourhood element."""
    shape = height.shape
    n = height.numel()
    idx = torch.arange(n, dtype=torch.int32, device=height.device).reshape(shape)
    h = torch.where(valid, height, _f32(_BIG, height))
    best_h, best_i = h, idx
    for off in _neighbor_offsets(len(shape), connectivity):
        for o in (off, tuple(-x for x in off)):
            nh = _shift_nd(h, o, _BIG)
            ni = _shift_nd(idx, o, n)
            better = (nh < best_h) | ((nh == best_h) & (ni < best_i))
            best_h = torch.where(better, nh, best_h)
            best_i = torch.where(better, ni, best_i)
    return torch.where(is_seed | ~valid, idx, best_i).reshape(-1)


def seeded_watershed_tensor(height: torch.Tensor, seeds: torch.Tensor, mask: Optional[torch.Tensor] = None,
                            connectivity: int = 1) -> torch.Tensor:
    """:func:`seeded_watershed` on tensors, on their own device."""
    shape = height.shape
    n = height.numel()
    dev = height.device
    valid = torch.ones(shape, dtype=torch.bool, device=dev) if mask is None else mask.to(torch.bool)
    seeds = seeds.to(torch.int32)
    hf = height.to(torch.float32)
    is_seed = (seeds > 0) & valid
    ptr = _compress(_descent_pointers(hf, is_seed, valid, connectivity).reshape(1, n), n)[0]
    lab = seeds.reshape(-1)[ptr.clamp(0, n - 1).long()]
    lab = torch.where(valid.reshape(-1), lab, 0).to(torch.int32)

    # fill unseeded basins: unlabeled voxels adopt the label of their lowest
    # labeled neighbour, iterated to the fixpoint
    h = torch.where(valid, hf, _f32(_BIG, hf))
    offsets = []
    for off in _neighbor_offsets(len(shape), connectivity):
        offsets += [off, tuple(-x for x in off)]
    while True:
        lab3 = lab.reshape(shape)
        best_h = torch.full(shape, _BIG, dtype=torch.float32, device=dev)
        best_l = torch.zeros(shape, dtype=torch.int32, device=dev)
        for off in offsets:
            nh = _shift_nd(h, off, _BIG)
            nl = _shift_nd(lab3, off, 0)
            better = (nl > 0) & (nh < best_h)
            best_h = torch.where(better, nh, best_h)
            best_l = torch.where(better, nl, best_l)
        take = (lab3 == 0) & valid & (best_l > 0)
        new = torch.where(take, best_l, lab3).reshape(-1)
        if not bool((new != lab).any()):
            return new.reshape(shape)
        lab = new


def seeded_watershed(height, seeds, mask=None, connectivity: int = 1, device=None) -> torch.Tensor:
    """Grow ``seeds`` (int32, 0 = unlabeled) over ``height`` basins.  Labels
    are 0 only outside ``mask`` or where no seed is reachable."""
    dev = resolve_device(device)
    return seeded_watershed_tensor(
        as_tensor(height, dev, torch.float32), as_tensor(seeds, dev, torch.int32),
        None if mask is None else as_tensor(mask, dev, torch.bool), connectivity,
    )


def dt_seeds_tensor(dist: torch.Tensor, mask: torch.Tensor, min_distance: float = 0.0,
                    connectivity: int = 1) -> torch.Tensor:
    """:func:`dt_seeds` on tensors, on their own device."""
    maxima = local_maxima_tensor(dist, connectivity) & mask.to(torch.bool) & (dist >= _f32(min_distance, dist))
    raw = label_components_batched(maxima.unsqueeze(0), connectivity)[0]
    return finalize_labels(raw)


def dt_seeds(dist, mask, min_distance: float = 0.0, connectivity: int = 1, device=None) -> torch.Tensor:
    """Watershed seeds: connected components of DT local-maxima plateaus."""
    dev = resolve_device(device)
    return dt_seeds_tensor(as_tensor(dist, dev, torch.float32), as_tensor(mask, dev, torch.bool),
                           min_distance, connectivity)


def _dt_squared(fg: torch.Tensor, sampling, max_distance, impl: str) -> torch.Tensor:
    """Squared EDT of ``fg``; on the card a 2-D slice runs as one plane of a
    3-D volume, so its two axis passes are kernel B3 launches."""
    from .edt import _norm_sampling, _radii, distance_transform_squared_tensor, dt_squared

    if fg.dim() == 2 and resolve_impl(impl, fg) == "cuda":
        s = _norm_sampling(2, sampling)
        return dt_squared(fg[None], (1.0,) + s, (0,) + _radii(fg.shape, s, max_distance), "cuda")[0]
    return distance_transform_squared_tensor(fg, sampling=sampling, max_distance=max_distance, impl=impl)


def _seeds_of(boundaries, valid, threshold, sigma_seeds, min_seed_distance, sampling, connectivity,
              dt_max_distance, impl):
    """Threshold -> capped squared EDT -> optional smoothing -> DT seeds."""
    from .filters import gaussian_smooth_tensor

    fg = (boundaries < _f32(threshold, boundaries)) & valid
    dist = _dt_squared(fg, sampling, dt_max_distance, impl)
    if sigma_seeds > 0:
        dist = gaussian_smooth_tensor(dist, sigma_seeds, sampling=sampling)
    # dist is the squared EDT, so the seed floor compares squared
    return dt_seeds_tensor(dist, fg, min_seed_distance * min_seed_distance, connectivity)


def distance_transform_watershed(boundaries, threshold: float = 0.25, sigma_seeds: float = 0.0,
                                 min_seed_distance: float = 0.0, sampling: Optional[Tuple[float, ...]] = None,
                                 mask=None, connectivity: int = 1, two_d: bool = False,
                                 dt_max_distance: Optional[float] = None, impl: str = "auto",
                                 device=None) -> torch.Tensor:
    """Per-block distance-transform watershed: ``fg = boundaries <
    threshold``; seeds = CCL of the maxima plateaus of its (capped, squared)
    EDT; steepest-descent watershed of ``boundaries`` from the seeds.

    ``two_d=True`` runs each z-slice on its own, with per-slice label
    offsets (``z * slice_voxels``) keeping labels unique in the block.
    Labels are block-local flat-index based (int32, 0 = none)."""
    dev = resolve_device(device)
    b = as_tensor(boundaries, dev, torch.float32)
    valid = torch.ones(b.shape, dtype=torch.bool, device=dev) if mask is None else as_tensor(mask, dev, torch.bool)
    if two_d:
        samp2 = None if sampling is None else tuple(sampling[1:])
        lab = torch.stack([
            distance_transform_watershed(b[z], threshold, sigma_seeds, min_seed_distance, sampling=samp2,
                                         mask=valid[z], connectivity=connectivity,
                                         dt_max_distance=dt_max_distance, impl=impl, device=dev)
            for z in range(b.shape[0])
        ])
        per_slice = int(np.prod(b.shape[1:]))
        offs = (torch.arange(b.shape[0], dtype=torch.int32, device=dev) * per_slice).reshape(
            (-1,) + (1,) * (b.dim() - 1))
        return torch.where(lab > 0, lab + offs, 0)
    seeds = _seeds_of(b, valid, threshold, sigma_seeds, min_seed_distance, sampling, connectivity,
                      dt_max_distance, impl)
    return seeded_watershed_tensor(b, seeds, valid, connectivity)


def filter_small_segments(labels, height, min_size: int, connectivity: int = 1,
                          max_label: Optional[int] = None, device=None) -> torch.Tensor:
    """Remove segments below ``min_size`` voxels and grow the survivors into
    the freed space.  ``labels`` are flat-index based, in ``[0, max_label]``
    (default: the block's voxel count; ``2 * N`` for the two-pass encoding)."""
    dev = resolve_device(device)
    lab = as_tensor(labels, dev, torch.int32)
    n = lab.numel() if max_label is None else int(max_label)
    flat = lab.reshape(-1)
    idx = flat.clamp(0, n).long()
    sizes = torch.bincount(idx, minlength=n + 1)
    small = (sizes[idx] < int(min_size)) & (flat > 0)
    kept = torch.where(small, 0, flat).reshape(lab.shape)
    return seeded_watershed_tensor(as_tensor(height, dev, torch.float32), kept, lab > 0, connectivity)


def dt_watershed_seeded(boundaries, ext_seeds, threshold: float = 0.25, sigma_seeds: float = 0.0,
                        min_seed_distance: float = 0.0, sampling: Optional[Tuple[float, ...]] = None,
                        mask=None, connectivity: int = 1, dt_max_distance: Optional[float] = None,
                        impl: str = "auto", device=None) -> torch.Tensor:
    """DT watershed honouring external seeds (two-pass mode): ``ext_seeds``
    (int32, dense ``1..K``, 0 = none) dominate; internal DT seeds are planted
    elsewhere.  Values above ``N`` (the voxel count) are external ids
    (``+N``), ``1..N`` new internal fragments."""
    dev = resolve_device(device)
    b = as_tensor(boundaries, dev, torch.float32)
    n = b.numel()
    valid = torch.ones(b.shape, dtype=torch.bool, device=dev) if mask is None else as_tensor(mask, dev, torch.bool)
    internal = _seeds_of(b, valid, threshold, sigma_seeds, min_seed_distance, sampling, connectivity,
                         dt_max_distance, impl)
    ext = as_tensor(ext_seeds, dev, torch.int32)
    seeds = torch.where(ext > 0, ext + n, internal)
    return seeded_watershed_tensor(b, seeds, valid, connectivity)
