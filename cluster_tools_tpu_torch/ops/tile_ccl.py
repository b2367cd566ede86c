"""Two-level connected-components labeling: tile kernels + small edge lists.

Port of ``cluster_tools_tpu/ops/tile_ccl.py``:

1. **Tile phase** (kernel B1, :func:`.kernels.tile_ccl`): exact CCL inside
   every tile; labels are global flat indices, background ``BIG``.
2. **Face phase**: label pairs across tile faces, run-deduped, compacted
   into capacity-sized edge arrays (counts past a capacity are reported
   through the overflow flag, never silently dropped).
3. **Union-find** on the deduped edge list over dense ids.
4. **Resolve**: per-tile remap tables applied by kernel B4
   (:func:`.kernels.apply_remap`), or — when a tile's table overflows
   ``table_cap`` — the gather rung (:func:`resolve_labels_gather`), as the
   reference's ``lax.cond`` does.

``lax.while_loop``/``lax.cond`` become Python loops and ``if``s on host
reads; the capacity tiers (``tier_mode``) and round bounds stay exactly as
in the reference, so labels and overflow flags are the reference's.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ..device import as_tensor, resolve_device, resolve_impl
from .ccl import _shift
from .kernels import BIG, apply_remap, count_rung, tile_ccl
from .unionfind import union_find_tensor

DEFAULT_TILE = (16, 16, 128)
DEFAULT_PAIR_CAP = 1 << 21
DEFAULT_EDGE_CAP = 1 << 21
DEFAULT_TABLE_CAP = 64


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _auto_cap(n_voxels: int, default: int, divisor: int) -> int:
    """Volume-scaled capacity, bounded by ``default``, floored at 16384."""
    return max(16384, min(default, _round_up(n_voxels // divisor, 1024)))


def _tile_for(shape: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """The reference's tile choice; tiny axes get padded up to one tile."""
    z, y, x = shape
    return (min(16, _round_up(z, 8)), min(16, _round_up(y, 8)), 128)


def _i32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=like.device)


def _shift1(x: torch.Tensor, axis: int, fill: int) -> torch.Tensor:
    """Shift by +1 along ``axis`` with ``fill`` shifted in."""
    return _shift(x, 1, axis, fill)


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` for a 1-D ``src`` and an int index tensor of any shape."""
    return src.index_select(0, idx.reshape(-1)).reshape(idx.shape)


def _scatter_set(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].set(vals, mode="drop")``: out-of-range indices drop
    (they go to a sink slot that is sliced off).  Duplicate in-range
    indices must carry equal values, as at every call site."""
    n = base.shape[0]
    idx = idx.reshape(-1).long()
    idx = torch.where((idx < 0) | (idx >= n), n, idx)
    buf = torch.cat([base, base.new_zeros(1)])
    buf.scatter_(0, idx, vals.reshape(-1).to(base.dtype))
    return buf[:n]


def _compact(flags: torch.Tensor, values, cap: int, fill: int):
    """Pack ``values[i][flags]`` into ``cap``-sized arrays (cumsum+scatter).

    Returns ``(packed_values, n_kept)``; entries beyond ``cap`` are dropped
    and callers check ``n_kept > cap`` for overflow.
    """
    flat = flags.reshape(-1)
    pos = _cumsum_i32(flat) - 1
    dest = torch.where(flat, pos, cap)
    dest = torch.where(dest >= cap, cap, dest).long()
    out = []
    for v in values:
        buf = torch.full((cap + 1,), fill, dtype=v.dtype, device=v.device)
        buf.scatter_(0, dest, v.reshape(-1))
        out.append(buf[:cap])
    n_kept = (pos[-1] + 1) if flat.numel() > 0 else _i32(0, flags)
    return tuple(out), n_kept.to(torch.int32)


# ---------------------------------------------------------------- rows ----
# The lane-batched forms below work on ``[B, ...]`` tensors: one row per
# lane, every sort, scan, compaction and scatter along the row, so each
# row computes exactly what the single-lane function computes for that
# lane alone (labels lane-local; capacities, overflow flags and round
# counts per row).  The single-lane functions are the rows with B = 1.


def _zeros_i32(b: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((b,), dtype=torch.int32, device=like.device)


def _iota_rows(b: int, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device).expand(b, n)


def _cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(torch.int32), 1, dtype=torch.int32)


def _take_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[r][idx[r]]`` per row: ``src`` ``[B, n]``, ``idx`` ``[B, ...]``."""
    b = src.shape[0]
    return torch.gather(src, 1, idx.reshape(b, -1).long()).reshape(idx.shape)


def _scatter_set_rows(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """:func:`_scatter_set` per row (out-of-range indices drop)."""
    b, n = base.shape
    idx = idx.reshape(b, -1).long()
    idx = torch.where((idx < 0) | (idx >= n), n, idx)
    buf = torch.cat([base, base.new_zeros((b, 1))], 1)
    buf.scatter_(1, idx, vals.reshape(b, -1).to(base.dtype))
    return buf[:, :n]


def _scatter_min_rows(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].min(vals, mode="drop")`` per row."""
    b, n = base.shape
    idx = idx.reshape(b, -1).long()
    idx = torch.where((idx < 0) | (idx >= n), n, idx)
    buf = torch.cat([base, base.new_zeros((b, 1))], 1)
    buf = buf.scatter_reduce(1, idx, vals.reshape(b, -1).to(base.dtype), "amin", include_self=True)
    return buf[:, :n]


def _lexsort_rows(*keys: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic sort order per row of ``[B, M]`` int32 keys
    (first key most significant) — ``lax.sort(..., num_keys=len(keys))``.
    Two keys pack into one int64; a third is sorted first (stable passes
    compose)."""
    if len(keys) == 1:
        return torch.sort(keys[0], dim=1, stable=True).indices
    perm = None
    if len(keys) == 3:
        perm = torch.sort(keys[2], dim=1, stable=True).indices
        keys = tuple(torch.gather(k, 1, perm) for k in keys[:2])
    elif len(keys) != 2:
        raise ValueError("at most three sort keys")
    packed = (keys[0].long() << 32) + (keys[1].long() + (1 << 31))
    order = torch.sort(packed, dim=1, stable=True).indices
    return order if perm is None else torch.gather(perm, 1, order)


def _gather_rows(order: torch.Tensor, *xs: torch.Tensor):
    return tuple(torch.gather(x, 1, order) for x in xs)


def _compact_rows(flags: torch.Tensor, values, cap: int, fill: int):
    """:func:`_compact` per row: ``flags`` ``[B, ...]`` and each value of
    the same shape; returns ``([B, cap] per value, n_kept [B] int32)``."""
    b = flags.shape[0]
    flat = flags.reshape(b, -1)
    pos = _cumsum_rows(flat) - 1
    dest = torch.where(flat, pos, cap)
    dest = torch.where(dest >= cap, cap, dest).long()
    out = []
    for v in values:
        buf = torch.full((b, cap + 1), fill, dtype=v.dtype, device=v.device)
        buf.scatter_(1, dest, v.reshape(b, -1))
        out.append(buf[:, :cap])
    n_kept = (pos[:, -1] + 1) if flat.shape[1] > 0 else _zeros_i32(b, flags)
    return tuple(out), n_kept.to(torch.int32)


def _lane_offsets(b: int, n: int, device) -> torch.Tensor:
    """``[B, 1, 1, 1]`` offsets ``lane * n`` of a lane stack's flat index."""
    return (torch.arange(b, dtype=torch.int32, device=device) * n).reshape(b, 1, 1, 1)


def lane_chunks(b: int, n_lane: int):
    """Lane ranges whose stacked flat indices stay below ``BIG`` (the
    kernels' sentinel): ``[(lo, hi), ...]`` covering ``range(b)``."""
    per = max(1, (BIG - 1) // max(1, n_lane))
    return [(lo, min(b, lo + per)) for lo in range(0, b, per)]


def resolve_tier_mode(mode: Optional[str] = None) -> str:
    """Capacity-tier mode: ``cond`` (both tiers, picked per input),
    ``big`` (full capacity only) or ``small`` (1/16 tier only, truncation
    reported as overflow).  ``None`` reads ``CT_TIER_MODE``."""
    if mode is None:
        mode = os.environ.get("CT_TIER_MODE", "cond")
    if mode not in ("cond", "big", "small"):
        raise ValueError(f"CT_TIER_MODE must be cond/big/small, got {mode!r}")
    return mode


def run_capacity_tiered(arrays, n_total, big_cap, core, n_padded, max_rounds,
                        tier, trunc_fold=None):
    """Run ``core(*arrays, cap, max_rounds)`` on ``[B, M]`` rows at 1/16
    capacity when the live entry count allows (see the reference's
    docstring); the first ``n_padded`` outputs are padded back to big-tier
    sizes with ``BIG``.  ``n_total`` is per row; under ``cond`` the tier is
    one decision for all rows (the small tier when every row fits).  The
    tiers give equal outputs wherever neither truncates, as the reference's
    ``vmap`` of ``lax.cond`` (a select) requires."""
    b = arrays[0].shape[0]
    small_n = min(big_cap, max(3 * 16384, arrays[0].shape[1] // 16))

    def _small(args):
        compacted, _ = _compact_rows(args[0] < BIG, args, small_n, BIG)
        out = core(*compacted, small_n, max_rounds)
        padded = []
        for x in out[:n_padded]:
            extra = (x.shape[1] // small_n) * big_cap - x.shape[1]
            padded.append(torch.cat([x, torch.full((b, extra), BIG, dtype=x.dtype, device=x.device)], 1))
        return tuple(padded) + tuple(out[n_padded:])

    def _big(args):
        return core(*args, big_cap, max_rounds)

    if tier == "big" or small_n >= big_cap:
        return _big(tuple(arrays))
    if tier == "small":
        out = _small(tuple(arrays))
        trunc = (n_total > small_n).to(torch.int32)
        last = trunc_fold(out[-1], trunc) if trunc_fold is not None else torch.maximum(out[-1], trunc)
        return tuple(out[:-1]) + (last,)
    if int(n_total.max()) <= small_n:
        return _small(tuple(arrays))
    return _big(tuple(arrays))


def _stride_slice(x: torch.Tensor, start: int, stop: int, step: int, axis: int) -> torch.Tensor:
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(start, stop, step)
    return x[tuple(idx)]


def _face_pairs_axis(labels: torch.Tensor, tile, axis: int, pair_cap: int):
    """Label pairs across tile boundaries along spatial ``axis`` of a
    ``[B, z, y, x]`` stack, run-deduped; ``([B, pair_cap] x2, kept [B])``."""
    b = labels.shape[0]
    t = tile[axis]
    n = labels.shape[axis + 1]
    if n // t <= 1:
        empty = torch.full((b, pair_cap), BIG, dtype=torch.int32, device=labels.device)
        return (empty, empty), _zeros_i32(b, labels)
    a = _stride_slice(labels, t - 1, n - 1, t, axis + 1)
    bb = _stride_slice(labels, t, n, t, axis + 1)
    valid = (a < BIG) & (bb < BIG)
    # run-dedup along the largest non-sliced axis
    dedup_axis = (2 if axis != 2 else 1) + 1
    keep = valid & ((a != _shift1(a, dedup_axis, -1)) | (bb != _shift1(bb, dedup_axis, -1)))
    return _compact_rows(keep, (a, bb), pair_cap, BIG)


def merge_face_pairs_lanes(labels, tile, pair_cap=DEFAULT_PAIR_CAP, edge_cap=DEFAULT_EDGE_CAP,
                           max_rounds: int = 64, tier: str = "cond"):
    """:func:`merge_face_pairs` over a ``[B, z, y, x]`` stack of lane-local
    labels; every output has a leading lane axis (overflow ``[B]`` bool)."""
    b = labels.shape[0]
    pair_lists = []
    overflow = _zeros_i32(b, labels)
    n_total = _zeros_i32(b, labels)
    for axis in range(3):
        (pa, pb), kept = _face_pairs_axis(labels, tile, axis, pair_cap)
        pair_lists.append((pa, pb))
        overflow = torch.maximum(overflow, (kept > pair_cap).to(torch.int32))
        n_total = n_total + torch.clamp(kept, max=pair_cap)
    a = torch.cat([p[0] for p in pair_lists], 1)
    bb = torch.cat([p[1] for p in pair_lists], 1)
    ea, eb, root_a, root_b, n_edges, core_ovf = run_capacity_tiered(
        (a, bb), n_total, edge_cap, _merge_core, 4, max_rounds, tier
    )
    overflow = torch.maximum(overflow, core_ovf)
    return ea, eb, root_a, root_b, n_edges, overflow > 0


def merge_face_pairs(labels, tile, pair_cap=DEFAULT_PAIR_CAP, edge_cap=DEFAULT_EDGE_CAP,
                     max_rounds: int = 64, tier: str = "cond"):
    """Union-find closure over tile-face equivalences.

    Returns ``(ea, eb, root_a, root_b, n_edges, overflow)`` as the
    reference does (``BIG``-padded endpoints and their merged roots).
    """
    out = merge_face_pairs_lanes(labels.unsqueeze(0), tile, pair_cap, edge_cap, max_rounds, tier)
    return tuple(o[0] for o in out[:5]) + (bool(out[5][0]),)


def _merge_core(a, b, edge_cap, max_rounds):
    """Dedup + dense-id union-find over one capacity tier, per row; outputs
    ``[B, edge_cap]`` (``BIG``-padded), overflow ``[B]`` int32."""
    rows = a.shape[0]
    order = _lexsort_rows(a, b)
    a, b = _gather_rows(order, a, b)
    dup = (a == _shift1(a, 1, -1)) & (b == _shift1(b, 1, -1))
    keep = (~dup) & (a < BIG)
    (ea, eb), n_edges = _compact_rows(keep, (a, b), edge_cap, BIG)
    overflow = (n_edges > edge_cap).to(torch.int32)

    # dense ids over the endpoint labels: the union-find table is edge-sized
    m2 = 2 * edge_cap
    vals = torch.cat([ea, eb], 1)
    svals, sslots = torch.sort(vals, dim=1, stable=True)
    is_new = svals != _shift1(svals, 1, -1)
    rank = _cumsum_rows(is_new) - 1
    uniq = _scatter_set_rows(torch.full((rows, m2), BIG, dtype=torch.int32, device=a.device), rank, svals)
    dense = torch.zeros((rows, m2), dtype=torch.int32, device=a.device)
    dense.scatter_(1, sslots, rank)
    da, db = dense[:, :edge_cap].long(), dense[:, edge_cap:].long()

    parent = _iota_rows(rows, m2, a).clone()
    changed = torch.ones((rows,), dtype=torch.bool, device=a.device)
    it = 0
    while it < max_rounds and bool(changed.any()):
        ra = torch.gather(parent, 1, da)
        rb = torch.gather(parent, 1, db)
        lo = torch.minimum(ra, rb)
        hi = torch.maximum(ra, rb)
        parent = parent.scatter_reduce(1, hi.long(), lo, "amin", include_self=True)
        parent = parent.scatter_reduce(1, da, lo, "amin", include_self=True)
        parent = parent.scatter_reduce(1, db, lo, "amin", include_self=True)
        # full path compression: the table is small, so doubling is cheap
        parent = torch.gather(parent, 1, parent.long())
        parent = torch.gather(parent, 1, parent.long())
        # a converged row's endpoints all point at their roots: later
        # rounds leave its answer as it is
        changed = (ra != rb).any(1)
        it += 1
    # a max_rounds exit leaves edges with differing roots: report, never hide
    overflow = torch.maximum(overflow, changed.to(torch.int32))
    root_a = _take_rows(uniq, torch.gather(parent, 1, da))
    root_b = _take_rows(uniq, torch.gather(parent, 1, db))
    root_a = torch.where(ea < BIG, root_a, BIG)
    root_b = torch.where(eb < BIG, root_b, BIG)
    return ea, eb, root_a, root_b, n_edges, overflow


def _tile_id_of(v: torch.Tensor, shape, tile) -> torch.Tensor:
    z, y, x = shape
    tz, ty, tx = tile
    gy, gx = y // ty, x // tx
    vz = v // (y * x)
    vy = (v // x) % y
    vx = v % x
    return ((vz // tz) * gy + (vy // ty)) * gx + (vx // tx)


def build_remap_tables_lanes(tile_ids, old_vals, new_vals, n_tiles: int,
                             table_cap: int = DEFAULT_TABLE_CAP, tier: str = "cond"):
    """Per-tile (old_label -> new_label) tables for kernel B4, per row of
    ``[B, M]`` entries.  ``tile_ids`` gives each entry's tile (``BIG``
    drops it); duplicates of (tile, old) collapse to one slot.  Returns
    ``(old_tbl, new_tbl, overflow)``: ``[B, n_tiles, table_cap]`` tables,
    unused slots -1, overflow ``[B]`` bool."""
    n_in = tile_ids.shape[1]
    small_n = max(16384, n_in // 16)
    if small_n < n_in and tier != "big":
        n_live = (tile_ids < BIG).sum(1)

        def _small(args):
            compacted, _ = _compact_rows(args[0] < BIG, args, small_n, BIG)
            return _remap_tables_core(*compacted, n_tiles, table_cap)

        if tier == "small":
            old_tbl, new_tbl, overflow = _small((tile_ids, old_vals, new_vals))
            return old_tbl, new_tbl, overflow | (n_live > small_n)
        if int(n_live.max()) <= small_n:
            return _small((tile_ids, old_vals, new_vals))
    return _remap_tables_core(tile_ids, old_vals, new_vals, n_tiles, table_cap)


def _remap_tables_core(tile_ids, old_vals, new_vals, n_tiles, table_cap):
    rows = tile_ids.shape[0]
    order = _lexsort_rows(tile_ids, old_vals)
    tid, v, r = _gather_rows(order, tile_ids, old_vals, new_vals)
    dup = (tid == _shift1(tid, 1, -1)) & (v == _shift1(v, 1, -1))
    valid = (tid < BIG) & (~dup)
    # within-tile slot rank counting only valid entries
    cnt = _cumsum_rows(valid)
    is_first = (tid != _shift1(tid, 1, -1)) & (tid < BIG)
    base = torch.cummax(torch.where(is_first, cnt - valid.to(torch.int32), -1), 1).values
    slot = torch.where(valid, cnt - 1 - base, table_cap)
    overflow = (valid & (slot >= table_cap)).any(1)
    dest = torch.where(valid & (slot < table_cap), tid * table_cap + slot, n_tiles * table_cap)
    size = n_tiles * table_cap
    old_tbl = _scatter_set_rows(torch.full((rows, size), -1, dtype=torch.int32, device=v.device), dest, v)
    new_tbl = _scatter_set_rows(torch.full((rows, size), -1, dtype=torch.int32, device=v.device), dest, r)
    return old_tbl.reshape(rows, n_tiles, table_cap), new_tbl.reshape(rows, n_tiles, table_cap), overflow


def resolve_labels_gather_lanes(labels, ea, eb, root_a, root_b) -> torch.Tensor:
    """:func:`resolve_labels_gather` per lane of a ``[B, ...]`` stack."""
    rows = labels.shape[0]
    n = labels[0].numel()
    P = _iota_rows(rows, n + 1, labels)
    P = _scatter_set_rows(P, torch.clamp(ea, max=n), torch.clamp(root_a, max=n))
    P = _scatter_set_rows(P, torch.clamp(eb, max=n), torch.clamp(root_b, max=n))
    flat = labels.reshape(rows, -1)
    out = _take_rows(P, torch.clamp(flat, max=n))
    return torch.where(flat >= BIG, BIG, out).reshape(labels.shape)


def resolve_labels_gather(labels, ea, eb, root_a, root_b) -> torch.Tensor:
    """Gather rung: scatter roots into a parent table, one full gather."""
    return resolve_labels_gather_lanes(
        labels.unsqueeze(0), ea.unsqueeze(0), eb.unsqueeze(0), root_a.unsqueeze(0), root_b.unsqueeze(0)
    )[0]


def label_components_sparse_tensor(mask: torch.Tensor, cap: Optional[int] = None):
    """:func:`label_components_sparse` on a tensor, on its own device."""
    if mask.dim() != 3:
        raise ValueError("label_components_sparse expects a 3-D mask")
    z, y, x = mask.shape
    n = z * y * x
    if n >= BIG:
        raise ValueError(f"volume {tuple(mask.shape)} has >= 2**30 voxels; shard it")
    if cap is None:
        cap = min(n, max(3 * 16384, n // 16))
    dev = mask.device
    flat = mask.reshape(-1).to(torch.bool)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    (cidx,), n_live = _compact(flat, (idx,), cap, n)
    overflow = bool(n_live > cap)
    # dense rank: slot of any set voxel (the same cumsum _compact used)
    rank = _cumsum_i32(flat) - 1
    slot_ids = torch.arange(cap, dtype=torch.int32, device=dev)
    live = cidx < n
    pair_lists = []
    for step, bound_ok in (
        (y * x, (cidx // (y * x)) + 1 < z),
        (x, (cidx // x) % y + 1 < y),
        (1, cidx % x + 1 < x),
    ):
        nb = torch.clamp(cidx + step, 0, n - 1)
        ok = live & bound_ok & _take(flat, nb)
        # (slot, neighbor slot); invalid pairs become self-loop no-ops
        pair_lists.append(
            torch.stack([torch.where(ok, slot_ids, 0), torch.where(ok, _take(rank, nb), 0)], dim=1)
        )
    parent = union_find_tensor(torch.cat(pair_lists, dim=0), cap)
    # representative flat index per slot; ascending compaction makes the
    # min slot the min flat index
    rep = _take(cidx, parent)
    out = torch.full((n,), n, dtype=torch.int32, device=dev)
    out = _scatter_set(out, torch.where(live, cidx, n), torch.where(live, rep, n))
    return out.reshape(mask.shape), overflow


def label_components_sparse(mask, cap: Optional[int] = None, device=None):
    """Connected components (connectivity 1) of a SPARSE 3-D mask.

    Labels are each component's minimum flat index in array order,
    background ``mask.size``; cost scales with the popcount capacity
    ``cap`` (default ``max(3*16384, size/16)``).  Returns
    ``(labels, overflow)`` — overflow when set voxels exceed ``cap``.
    """
    dev = resolve_device(device)
    return label_components_sparse_tensor(as_tensor(mask, dev, torch.bool), cap)


def label_components_tiled_lanes(mask: torch.Tensor, connectivity: int = 1, impl: str = "auto",
                                 tile=None, pair_cap=None, edge_cap=None,
                                 table_cap: int = DEFAULT_TABLE_CAP, tier: str = "cond",
                                 site: str = "ccl"):
    """:func:`label_components_tiled_tensor` over a ``[B, z, y, x]`` stack
    of lanes: each lane's labels and overflow flag exactly as that lane
    alone would give them.  Kernels B1 and B4 run once over the stack
    (lanes laid end to end along z, each padded to whole tiles, so no tile
    straddles two lanes); everything between them runs per row.  Returns
    ``(labels [B, z, y, x] int32, overflow [B] bool tensor)``."""
    if mask.dim() != 4:
        raise ValueError("label_components_tiled_lanes expects a [B, z, y, x] stack")
    if connectivity != 1:
        raise ValueError("tiled CCL supports connectivity=1 only")
    impl = resolve_impl(impl, mask)
    lanes, z, y, x = mask.shape
    tile = _tile_for((z, y, x)) if tile is None else tuple(tile)
    tz, ty, tx = tile
    zp, yp, xp = _round_up(z, tz), _round_up(y, ty), _round_up(x, tx)
    n_pad = zp * yp * xp
    if n_pad >= BIG:
        raise ValueError(
            f"padded volume {(zp, yp, xp)} has >= 2**30 voxels; flat-index labels "
            "would collide with the background sentinel"
        )
    chunks = lane_chunks(lanes, n_pad)
    if len(chunks) > 1:
        parts = [label_components_tiled_lanes(mask[lo:hi], connectivity, impl, tile, pair_cap, edge_cap,
                                              table_cap, tier, site) for lo, hi in chunks]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    padded = (zp, yp, xp) != (z, y, x)
    if pair_cap is None:
        pair_cap = _auto_cap(n_pad, DEFAULT_PAIR_CAP, 32)
    if edge_cap is None:
        edge_cap = _auto_cap(n_pad, DEFAULT_EDGE_CAP, 128)
    m = mask.to(torch.bool)
    if padded:
        m = torch.nn.functional.pad(m, (0, xp - x, 0, yp - y, 0, zp - z))
    m = m.contiguous()

    stacked = tile_ccl(m.reshape(lanes * zp, yp, xp), tile=tile, impl=impl).reshape(lanes, zp, yp, xp)
    # the kernel's labels are flat indices into the stack: back to the lane's
    labels = torch.where(stacked < BIG, stacked - _lane_offsets(lanes, n_pad, m.device), BIG)
    ea, eb, root_a, root_b, n_edges, overflow = merge_face_pairs_lanes(
        labels, tile, pair_cap=pair_cap, edge_cap=edge_cap, tier=tier
    )
    n_tiles = (zp // tz) * (yp // ty) * (xp // tx)
    v = torch.cat([ea, eb], 1)
    r = torch.cat([root_a, root_b], 1)
    changed = (v < BIG) & (r != v)
    tids = torch.where(changed, _tile_id_of(v, (zp, yp, xp), tile), BIG)
    old_tbl, new_tbl, tbl_overflow = build_remap_tables_lanes(tids, v, r, n_tiles, table_cap=table_cap, tier=tier)
    if bool(tbl_overflow.any()):
        # a lane whose table overflows takes the gather rung; both rungs
        # give the same labels, so the whole stack takes it
        count_rung(f"{site}:gather")
        resolved = resolve_labels_gather_lanes(labels, ea, eb, root_a, root_b)
    else:
        count_rung(f"{site}:table")
        resolved = apply_remap(
            labels.reshape(lanes * zp, yp, xp).contiguous(), old_tbl.reshape(lanes * n_tiles, table_cap),
            new_tbl.reshape(lanes * n_tiles, table_cap), tile=tile, cap=table_cap, impl=impl,
        ).reshape(lanes, zp, yp, xp)

    n_orig = z * y * x
    if padded:
        resolved = resolved[:, :z, :y, :x]
        # padded-flat representative -> original-flat representative
        vz = resolved // (yp * xp)
        vy = (resolved // xp) % yp
        vx = resolved % xp
        orig = ((vz * y + vy) * x + vx).to(torch.int32)
        out = torch.where(resolved >= BIG, n_orig, orig)
    else:
        out = torch.where(resolved >= BIG, n_orig, resolved)
    return out.to(torch.int32).contiguous(), overflow


def label_components_tiled_tensor(mask: torch.Tensor, connectivity: int = 1, impl: str = "auto",
                                  tile=None, pair_cap=None, edge_cap=None,
                                  table_cap: int = DEFAULT_TABLE_CAP, tier: str = "cond",
                                  site: str = "ccl"):
    """:func:`label_components_tiled` on a tensor, on its own device;
    ``site`` names the remap site in ``kernels.RUNGS``."""
    if mask.dim() != 3:
        raise ValueError("label_components_tiled expects a 3-D mask")
    out, overflow = label_components_tiled_lanes(
        mask.unsqueeze(0), connectivity=connectivity, impl=impl, tile=tile, pair_cap=pair_cap,
        edge_cap=edge_cap, table_cap=table_cap, tier=tier, site=site,
    )
    return out[0], bool(overflow[0])


def label_components_tiled(mask, connectivity: int = 1, impl: str = "auto", tile=None,
                           pair_cap=None, edge_cap=None, table_cap: int = DEFAULT_TABLE_CAP,
                           tier_mode: Optional[str] = None, device=None):
    """Two-level CCL of a 3-D bool mask.

    Returns ``(labels, overflow)``: int32 labels holding the component's
    minimum flat index in the *padded, tiled* order (mapped back to the
    mask's own shape), background ``mask.size``; ``overflow`` is True when
    an internal capacity was exceeded.  ``impl``: ``auto``/``cuda``/``torch``.
    """
    dev = resolve_device(device)
    return label_components_tiled_tensor(
        as_tensor(mask, dev, torch.bool), connectivity=connectivity, impl=impl, tile=tile,
        pair_cap=pair_cap, edge_cap=edge_cap, table_cap=table_cap, tier=resolve_tier_mode(tier_mode),
    )

