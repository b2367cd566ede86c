"""Halo (ghost-zone) exchange over a sharded spatial axis.

Port of ``cluster_tools_tpu/parallel/halo.py``.  The neighbour's rows
arrive by :func:`~.spmd.ppermute` inside a :func:`~.spmd.shard_map` body;
at the ends of the mesh the halo is ``fill``.  An axis of one shard needs
no collective (both halos are ``fill``), so that case also runs outside
``shard_map``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import spmd


def _fill_where(x: torch.Tensor, edge: bool, fill) -> torch.Tensor:
    """``ppermute`` zero-fills ranks that receive nothing; rewrite with
    ``fill`` when a non-zero border fill is requested."""
    if edge and not (isinstance(fill, (int, float)) and fill == 0):
        return torch.full_like(x, fill)
    return x


def exchange_halo(x: torch.Tensor, halo: int, axis: int, axis_name: Optional[str] = None, axis_size: int = 1,
                  fill=0) -> torch.Tensor:
    """Pad the local shard with ``halo`` slabs from its mesh neighbours
    along ``axis`` (the extent grows by ``2 * halo``); ``fill`` at the
    mesh ends."""
    if halo <= 0:
        return x
    if x.shape[axis] < halo:
        raise ValueError(f"shard extent {x.shape[axis]} along axis {axis} smaller than halo {halo}")
    n = int(axis_size)
    if n == 1:
        slab_shape = list(x.shape)
        slab_shape[axis] = halo
        slab = torch.full(slab_shape, fill, dtype=x.dtype, device=x.device)
        return torch.cat([slab, x, slab], dim=axis)
    idx = spmd.axis_index(axis_name)
    lo_slab = x.narrow(axis, 0, halo)
    hi_slab = x.narrow(axis, x.shape[axis] - halo, halo)
    # my low rows -> previous rank's high halo; my high rows -> next rank's low
    halo_hi = spmd.ppermute(lo_slab, axis_name, [(i, i - 1) for i in range(1, n)])
    halo_lo = spmd.ppermute(hi_slab, axis_name, [(i, i + 1) for i in range(n - 1)])
    halo_hi = _fill_where(halo_hi, idx == n - 1, fill)
    halo_lo = _fill_where(halo_lo, idx == 0, fill)
    return torch.cat([halo_lo, x, halo_hi], dim=axis)


def crop_halo(x: torch.Tensor, halo: int, axis: int) -> torch.Tensor:
    """Inverse of :func:`exchange_halo`: drop ``halo`` slabs from both ends."""
    if halo <= 0:
        return x
    return x.narrow(axis, halo, x.shape[axis] - 2 * halo)


def neighbor_face(x: torch.Tensor, axis: int, axis_name: str, axis_size: int, direction: int = -1,
                  fill=0) -> torch.Tensor:
    """The 1-voxel face of the neighbouring shard adjacent to this shard:
    ``direction=-1`` the previous rank's last slab, ``+1`` the next rank's
    first slab; ``fill`` past the mesh ends."""
    n = int(axis_size)
    idx = spmd.axis_index(axis_name)
    if direction == -1:
        slab = x.narrow(axis, x.shape[axis] - 1, 1)
        out = spmd.ppermute(slab, axis_name, [(i, i + 1) for i in range(n - 1)])
        edge = idx == 0
    elif direction == 1:
        slab = x.narrow(axis, 0, 1)
        out = spmd.ppermute(slab, axis_name, [(i, i - 1) for i in range(1, n)])
        edge = idx == n - 1
    else:
        raise ValueError(f"direction must be +/-1, got {direction}")
    return _fill_where(out, edge, fill)
