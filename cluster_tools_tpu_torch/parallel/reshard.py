"""Shard-axis transposition: the all-to-all reshard primitive.

Port of ``cluster_tools_tpu/parallel/reshard.py``: changing which spatial
axis of a volume is sharded is one tiled :func:`~.spmd.all_to_all`, so an
op that needs one axis resident in full (the exact EDT's pass along a
sharded axis) can run locally at full extent.
"""

from __future__ import annotations

import torch

from . import spmd


def reshard_axis(x: torch.Tensor, axis_name: str, from_axis: int, to_axis: int) -> torch.Tensor:
    """Inside ``shard_map``: the local shard of a volume sharded along
    ``from_axis`` becomes the local shard of it sharded along ``to_axis``
    (``from_axis`` fully resident).  ``to_axis``'s local extent must divide
    by the mesh axis size."""
    if from_axis == to_axis:
        return x
    return spmd.all_to_all(x, axis_name, split_axis=to_axis, concat_axis=from_axis, tiled=True)


def transpose_sharding(vol, mesh, axis_name: str = "sp", from_axis: int = 0, to_axis: int = 2) -> spmd.Sharded:
    """Whole-volume wrapper: ``vol`` sharded along ``from_axis`` (a global
    tensor or a :class:`~.spmd.Sharded`), returned as a
    :class:`~.spmd.Sharded` along ``to_axis``."""
    ndim = vol.pieces[min(vol.pieces)].dim() if isinstance(vol, spmd.Sharded) else torch.as_tensor(vol).dim()
    spec_in = [None] * ndim
    spec_in[from_axis] = axis_name
    spec_out = [None] * ndim
    spec_out[to_axis] = axis_name
    fn = spmd.shard_map(
        lambda v: reshard_axis(v, axis_name, from_axis, to_axis),
        mesh, spmd.P(*spec_in), spmd.P(*spec_out), name="reshard", keep_sharded=True,
    )
    return fn(vol)
