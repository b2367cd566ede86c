"""Globally consistent connected components over a mesh-sharded volume.

Port of ``cluster_tools_tpu/parallel/distributed_ccl.py``.  The volume is
sharded in slabs along one axis or over several axes, and the merge is
three collective steps:

1. per-shard CCL (the tiled labeller, or the legacy one), labels
   globalized by linearized shard rank;
2. cross-shard equivalences: each shard receives its lower neighbours'
   boundary slabs by :func:`~.halo.neighbor_face` (composed for diagonal
   shards at connectivity > 1) and pairs touching labels;
3. the pairs, deduplicated per shard, are gathered over every sharded axis
   and resolved by a replicated union-find over the boundary labels; each
   shard relabels through the result.

``max_labels_per_shard=C`` compacts each shard's labels to ``1..K`` before
globalizing as ``rank * (C + 1) + k``; a shard with more than ``C``
components raises the mesh-wide overflow flag.
"""

from __future__ import annotations

from itertools import product
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.ccl import _neighbor_offsets, _shift, label_components_batched, relabel_consecutive
from ..ops.tile_ccl import _compact, _shift1, label_components_tiled_tensor
from ..ops.unionfind import union_find_tensor
from . import spmd
from .halo import neighbor_face

_INT32_MAX = int(np.iinfo(np.int32).max)
#: pair lists of at most this many rows a shard are merged without a dedup
PAIR_CAP_FLOOR = 16384

# (array_axis, mesh_axis_name, mesh_axis_size)
ShardAxis = Tuple[int, str, int]


def linearized_shard_rank(axes: Sequence[ShardAxis]) -> int:
    """This shard's rank over the sharded axes, first listed axis slowest.

    The one label-globalization convention: every site that builds or
    merges ``rank * span + local`` labels uses this function.  Inside
    ``shard_map`` only.
    """
    rank = 0
    for _, name, size in axes:
        rank = rank * int(size) + spmd.axis_index(name)
    return rank


def sp_axes_for_mesh(mesh, sp_axis) -> Tuple[ShardAxis, ...]:
    """A mesh-axis name or sequence of names as ``ShardAxis`` triples over
    the leading array axes."""
    names = (sp_axis,) if isinstance(sp_axis, str) else tuple(sp_axis)
    return tuple((i, name, mesh.axis_size(name)) for i, name in enumerate(names))


def _boundary_pairs(glob: torch.Tensor, axes: Sequence[ShardAxis], connectivity: int) -> torch.Tensor:
    """Label-equivalence pairs across every shard boundary of this shard.

    For each neighbour-shard direction whose first nonzero is -1 (every
    shard pair once; faces at connectivity 1, edge- and corner-adjacent
    shards above), the neighbour's boundary slab arrives by one
    ``neighbor_face`` per crossed axis (the second crossing slices the
    already-received slab; shards past the grid edge give zeros), and
    in-slab diagonal adjacency is enumerated as shifted views with at most
    ``connectivity`` differing coordinates.  Invalid rows are (-1, -1).
    """
    shard_ax = [a for a, _, _ in axes]
    meta = {a: (name, size) for a, name, size in axes}
    out = []
    neg1 = torch.tensor(-1, dtype=torch.int32, device=glob.device)
    for d_combo in (tuple(-v for v in d) for d in _neighbor_offsets(len(shard_ax), connectivity)):
        theirs = glob
        mine = glob
        for a, dv in zip(shard_ax, d_combo):
            if dv == 0:
                continue
            name, size = meta[a]
            theirs = neighbor_face(theirs, a, name, size, direction=dv)
            if dv == -1:
                mine = mine.narrow(a, 0, 1)
            else:
                mine = mine.narrow(a, mine.shape[a] - 1, 1)
        crossing = set(a for a, dv in zip(shard_ax, d_combo) if dv)
        budget = connectivity - len(crossing)
        free = [a for a in range(glob.dim()) if a not in crossing]
        for s_combo in product((-1, 0, 1), repeat=len(free)):
            if sum(1 for v in s_combo if v) > budget:
                continue
            th = theirs
            for a, sv in zip(free, s_combo):
                if sv:
                    # th[p] = theirs[p + sv] along a; 0 (background) shifted in
                    th = _shift(th, -sv, a, 0)
            m = mine.reshape(-1)
            t = th.reshape(-1)
            valid = (m > 0) & (t > 0)
            out.append(torch.stack([torch.where(valid, t, neg1), torch.where(valid, m, neg1)], dim=1))
    return torch.cat(out, dim=0)


def _norm_shard_axes(axis_name: Optional[str], axis_size: Optional[int], shard_axis: int,
                     shard_axes: Optional[Sequence[ShardAxis]]) -> Tuple[ShardAxis, ...]:
    if shard_axes is not None:
        if axis_name is not None:
            raise ValueError("pass either axis_name/axis_size or shard_axes, not both")
        return tuple((int(a), str(n), int(s)) for a, n, s in shard_axes)
    if axis_name is None or axis_size is None:
        raise ValueError("axis_name and axis_size required without shard_axes")
    return ((int(shard_axis), axis_name, int(axis_size)),)


def _pmax_all(v: torch.Tensor, axes: Sequence[ShardAxis]) -> torch.Tensor:
    for _, name, _ in axes:
        v = spmd.pmax(v, name)
    return v


def sharded_label_components(mask: torch.Tensor, *, axis_name: Optional[str] = None,
                             axis_size: Optional[int] = None, connectivity: int = 1, shard_axis: int = 0,
                             shard_axes: Optional[Sequence[ShardAxis]] = None,
                             max_labels_per_shard: Optional[int] = None, return_overflow: bool = False,
                             impl: str = "legacy", tier: str = "cond"):
    """Connected components of a volume sharded over one or more mesh axes,
    inside ``shard_map``; ``mask`` is the local boolean shard.

    Returns int32 labels consistent across all shards (background 0); with
    ``return_overflow`` also a replicated bool (a 0-d tensor), True when a
    shard exceeded ``max_labels_per_shard`` or a tiled-kernel capacity.

    ``impl``: ``legacy`` (the hook/compress labeller, any connectivity) or
    the tiled labeller's ``auto``/``cuda``/``torch`` (3-D shards at
    connectivity 1; elsewhere the legacy labeller runs).  ``tier`` goes to
    the tiled labeller (its remap site counts as ``cc``).
    """
    if not 1 <= connectivity <= mask.dim():
        raise ValueError(f"connectivity must be in [1, {mask.dim()}]")
    axes = _norm_shard_axes(axis_name, axis_size, shard_axis, shard_axes)
    n_slab = int(mask.numel())
    n_shards = int(np.prod([s for _, _, s in axes]))
    rank = linearized_shard_rank(axes)

    # 1. per-shard CCL; globalize so labels are unique across shards
    if impl != "legacy" and mask.dim() == 3 and connectivity == 1:
        raw, tiled_overflow = label_components_tiled_tensor(mask, impl=impl, tier=tier, site="cc")
    else:
        raw = label_components_batched(mask.unsqueeze(0), connectivity)[0]
        tiled_overflow = False
    overflow = bool(tiled_overflow)
    local = torch.where(raw == n_slab, 0, raw + 1).to(torch.int32)
    if max_labels_per_shard is None:
        if n_shards * n_slab >= 2**31:
            raise ValueError(f"{n_shards} shards of {n_slab} voxels overflow int32 labels; "
                             "pass max_labels_per_shard to compact per-shard label spaces")
        glob = torch.where(local > 0, local + rank * n_slab, 0).to(torch.int32)
        span = n_slab
    else:
        cap = int(max_labels_per_shard)
        if n_shards * (cap + 1) >= 2**31:
            raise ValueError(f"{n_shards} shards x {cap} labels still overflow int32")
        # labels are slab flat indices + 1: the true value span sizes the bitmap
        dense, n_fg = relabel_consecutive(local, max_labels=cap, value_bound=n_slab)
        overflow = overflow or int(n_fg) > cap
        glob = torch.where(dense > 0, dense + rank * (cap + 1), 0).to(torch.int32)
        span = cap + 1
    ov = None
    if return_overflow:
        # the flag is promised replicated: reduce it over the sharded axes,
        # also when there is one shard and no merge
        ov = _pmax_all(torch.tensor(int(overflow), dtype=torch.int32, device=mask.device), axes) > 0
    if n_shards == 1:
        return (glob, ov) if return_overflow else glob

    # 2. cross-shard equivalences; 3. gathered replicated solve + relabel
    pairs = _boundary_pairs(glob, axes, connectivity)
    labels = merge_labels_by_pairs(glob, pairs, axes, rank, span)
    return (labels, ov) if return_overflow else labels


def merge_labels_by_pairs(glob: torch.Tensor, pairs: torch.Tensor, axes: Sequence[ShardAxis], rank: int,
                          span: int) -> torch.Tensor:
    """Merge globalized per-shard labels through cross-shard equivalences.

    Each shard sorts and dedups its face-sized pair list to
    ``max(PAIR_CAP_FLOOR, rows / 8)`` rows (below the floor no dedup), the
    lists are gathered over every sharded axis, the boundary labels are
    compressed to a dense table, union-found (each component's minimum
    label), and the shard relabels through a direct table lookup.  The
    dedup applies only when every shard's unique pairs fit: the branch is
    chosen from a ``pmax``-replicated count, so all shards take the same
    one.  ``glob`` holds ``rank * span + local`` with local in ``1..span``.
    """
    n_in = int(pairs.shape[0])
    pair_cap = max(PAIR_CAP_FLOOR, n_in // 8)
    dev = glob.device

    def _tail(shard_pairs):
        all_pairs = shard_pairs
        for _, name, _ in axes:
            all_pairs = spmd.all_gather(all_pairs, name).reshape(-1, 2)
        # compress the (sparse) boundary labels into a dense table
        flat = all_pairs.reshape(-1)
        keys = torch.unique(torch.where(flat < 0, _INT32_MAX, flat))  # sorted
        dense = torch.searchsorted(keys, all_pairs.clamp(min=0)).to(torch.int32)
        dense = torch.where(all_pairs < 0, -1, dense).to(torch.int32)
        parent = union_find_tensor(dense, keys.numel())
        # keys are sorted ascending, so the min dense root is the min label
        rep = keys[parent.long()].to(torch.int32)
        base = rank * span
        table = torch.arange(span + 1, dtype=torch.int32, device=dev) + base
        loc = keys.long() - base  # position of each boundary label if it is ours
        mine = (keys != _INT32_MAX) & (loc >= 1) & (loc <= span)
        table[loc[mine]] = rep[mine]
        idx = (glob.long() - base).clamp(0, span)
        return torch.where(glob > 0, table[idx], 0).to(torch.int32)

    if pair_cap >= n_in:
        return _tail(pairs)

    # per-shard dedup: sort, keep the first of each run, compact to pair_cap
    a = torch.where(pairs[:, 0] < 0, _INT32_MAX, pairs[:, 0])
    b = torch.where(pairs[:, 0] < 0, _INT32_MAX, pairs[:, 1])
    order = torch.argsort(a.long() * (2**32) + b.long(), stable=True)
    a, b = a[order], b[order]
    keep = ((a != _shift1(a, 0, -1)) | (b != _shift1(b, 0, -1))) & (a != _INT32_MAX)
    (ca, cb), n_kept = _compact(keep, (a, b), pair_cap, -1)
    deduped = torch.stack([ca, cb], dim=1)
    # the branch predicate must agree on every shard (both branches gather)
    n_max = _pmax_all(n_kept.reshape(()), axes)
    return _tail(deduped) if int(n_max) <= pair_cap else _tail(pairs)


def distributed_connected_components(mask, mesh, sp_axis: Union[str, Sequence[str]] = "sp",
                                     connectivity: int = 1, max_labels_per_shard: Optional[int] = None,
                                     return_overflow: bool = False, impl: str = "legacy"):
    """CCL of a full volume sharded over ``sp_axis`` (one mesh axis: slabs
    along the leading dimension; a sequence: the leading dimensions over the
    respective axes).  Returns the global int32 labels, and with
    ``return_overflow`` a bool that is True when any shard exceeded
    ``max_labels_per_shard``.  The tiled labeller's tier mode is
    ``CT_TIER_MODE``'s."""
    from ..ops.tile_ccl import resolve_tier_mode

    names = [sp_axis] if isinstance(sp_axis, str) else list(sp_axis)
    shard_axes = sp_axes_for_mesh(mesh, sp_axis)
    tier = resolve_tier_mode(None)
    fn = spmd.shard_map(
        lambda m: sharded_label_components(m, shard_axes=shard_axes, connectivity=connectivity,
                                           max_labels_per_shard=max_labels_per_shard,
                                           return_overflow=return_overflow, impl=impl, tier=tier),
        mesh, spmd.P(*names), (spmd.P(*names), spmd.P()) if return_overflow else spmd.P(*names), name="cc",
    )
    out = fn(torch.as_tensor(mask).to(torch.bool))
    if return_overflow:
        return out[0], bool(out[1])
    return out
