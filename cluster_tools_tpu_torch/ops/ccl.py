"""Connected-components labeling by label equivalence (legacy labeller).

Port of ``cluster_tools_tpu/ops/ccl.py``: shift helpers and the
hook + compress fixpoint (Playne & Hawick style) that
``tile_local_labels`` runs inside every tile — the plain twin of the
tiled CCL kernel — and that the blockwise connected-components task runs
per block; its keyed variant (components of equal-valued regions); and
:func:`finalize_labels`.  Labels are int32 flat-index representatives (the
component's minimum flat index); background holds ``N`` (the item's voxel
count).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import as_tensor, resolve_device


def _shift(x: torch.Tensor, offset: int, axis: int, fill) -> torch.Tensor:
    """y[i] = x[i - offset] along ``axis``, with ``fill`` shifted in."""
    n = x.shape[axis]
    pad_shape = list(x.shape)
    pad_shape[axis] = abs(offset)
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if offset > 0:
        return torch.cat([pad, x.narrow(axis, 0, n - offset)], dim=axis)
    return torch.cat([x.narrow(axis, -offset, n + offset), pad], dim=axis)


def _neighbor_offsets(ndim: int, connectivity: int) -> Sequence[Tuple[int, ...]]:
    """Half of the symmetric neighborhood (each unordered pair once)."""
    offsets = []
    for off in np.ndindex(*([3] * ndim)):
        off = tuple(o - 1 for o in off)
        if all(o == 0 for o in off):
            continue
        if sum(abs(o) for o in off) > connectivity:
            continue
        if off > tuple([0] * ndim):
            offsets.append(off)
    return offsets


def _shift_nd(x: torch.Tensor, offset: Tuple[int, ...], fill, axis0: int = 0) -> torch.Tensor:
    """Shift over consecutive axes starting at ``axis0``."""
    for i, o in enumerate(offset):
        if o != 0:
            x = _shift(x, o, axis0 + i, fill)
    return x


def _compress(flat: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Pointer-jump ``flat = flat[flat]`` to fixpoint, per row of a
    ``(batch, n)`` table whose entries index their own row."""
    n = flat.shape[1]
    while True:
        g = torch.gather(flat, 1, flat.clamp(0, n - 1).long())
        f2 = torch.where(flat == sentinel, flat, g)
        if not bool((f2 != flat).any()):
            return flat
        flat = f2


def label_components_batched(mask: torch.Tensor, connectivity: int = 1) -> torch.Tensor:
    """The legacy labeller over a leading batch axis (each item on its own).

    ``mask``: bool ``(B, *spatial)``.  Returns int32 of the same shape; an
    item's labels are flat indices into that item, background ``N``.
    """
    shape = mask.shape[1:]
    b = mask.shape[0]
    n = int(np.prod(shape))
    sentinel = n
    dev = mask.device
    mask = mask.to(torch.bool)
    idx = torch.arange(n, dtype=torch.int32, device=dev).reshape(shape)
    lab = torch.where(mask, idx, torch.tensor(sentinel, dtype=torch.int32, device=dev))
    offsets = _neighbor_offsets(len(shape), connectivity)
    row_base = (torch.arange(b, device=dev, dtype=torch.int64) * n).reshape(b, 1)

    def neighbor_min(lab3):
        m = lab3
        for off in offsets:
            m = torch.minimum(m, _shift_nd(lab3, off, sentinel, axis0=1))
            m = torch.minimum(m, _shift_nd(lab3, tuple(-o for o in off), sentinel, axis0=1))
        return torch.where(mask, m, sentinel)

    flat = lab.reshape(b, n)
    while True:
        nmin = neighbor_min(flat.reshape(mask.shape)).reshape(b, n)
        improved = nmin < flat
        # hook: push the improved label onto the current root (flat is fully
        # compressed, so flat[i] is i's root)
        root = flat.clamp(0, n - 1).long() + row_base
        upd = torch.where(improved, nmin, sentinel)
        hooked = flat.reshape(-1).scatter_reduce(
            0, root.reshape(-1), upd.reshape(-1), "amin", include_self=True
        ).reshape(b, n)
        hooked = torch.where(flat == sentinel, sentinel, hooked)
        new = _compress(torch.minimum(hooked, torch.minimum(flat, nmin)), sentinel)
        if not bool((new != flat).any()):
            return new.reshape(mask.shape)
        flat = new


def label_components(mask, connectivity: int = 1, device=None) -> torch.Tensor:
    """Label connected components of a boolean mask (any rank >= 1).

    Foreground voxels get the flat index of their component's minimum
    voxel; background gets ``N`` (the voxel count).
    """
    dev = resolve_device(device)
    m = as_tensor(mask, dev, torch.bool)
    return label_components_batched(m.unsqueeze(0), connectivity)[0]


def label_components_keyed_tensor(keys: torch.Tensor, connectivity: int = 1) -> torch.Tensor:
    """:func:`label_components_keyed` on a tensor, on its own device."""
    shape = keys.shape
    n = int(np.prod(shape))
    sentinel = n
    dev = keys.device
    mask = keys != 0
    idx = torch.arange(n, dtype=torch.int32, device=dev).reshape(shape)
    offsets = _neighbor_offsets(len(shape), connectivity)

    def neighbor_min(lab3):
        m = lab3
        for off in offsets:
            for o in (off, tuple(-x for x in off)):
                cand = _shift_nd(lab3, o, sentinel)
                same = _shift_nd(keys, o, 0) == keys
                m = torch.minimum(m, torch.where(same, cand, sentinel))
        return torch.where(mask, m, sentinel)

    flat = torch.where(mask, idx, sentinel).reshape(1, n)
    while True:
        nmin = neighbor_min(flat.reshape(shape)).reshape(1, n)
        improved = nmin < flat
        root = flat.clamp(0, n - 1).long()
        upd = torch.where(improved, nmin, sentinel)
        hooked = flat.scatter_reduce(1, root, upd, "amin", include_self=True)
        hooked = torch.where(flat == sentinel, sentinel, hooked)
        new = _compress(torch.minimum(hooked, torch.minimum(flat, nmin)), sentinel)
        if not bool((new != flat).any()):
            return new.reshape(shape)
        flat = new


def label_components_keyed(keys, connectivity: int = 1, device=None) -> torch.Tensor:
    """Label connected components of equal-valued regions: voxels connect
    only where their integer ``keys`` are equal and non-zero (0 is
    background).  Same encoding as :func:`label_components`."""
    return label_components_keyed_tensor(as_tensor(keys, resolve_device(device)), connectivity)


def finalize_labels(raw: torch.Tensor) -> torch.Tensor:
    """Sentinel/flat-index labels -> ``flat_index + 1``, background 0."""
    n = raw.numel()
    return torch.where(raw == n, 0, raw + 1).to(torch.int32)
