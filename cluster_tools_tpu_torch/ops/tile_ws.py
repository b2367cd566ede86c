"""Two-level seeded watershed: in-tile pointer flow + small basin graphs.

Port of ``cluster_tools_tpu/ops/tile_ws.py`` (the main-path functions):

1. **Descent directions** (dense shifts): each voxel's 0..6 code of its
   lexicographic-min ``(height, flat_index)`` neighbour.
2. **In-tile flow** (kernel B2, :func:`.kernels.tile_ws_propagate`).
3. **Exit chase**: unique exit codes from tile boundary strips, chased
   across tiles on capacity-sized arrays.
4. **Apply**: per-tile remap tables (kernel B4) or the gather rung.
5. **Unseeded-basin fill** across the lowest saddles (Boruvka rounds):
   ``capacity`` (compacted edge lists + sorts, the default on the card) or
   ``dense`` (sort-free face-list rounds, the default on the CPU).

The structure follows the reference's kernel path (``impl="pallas"``): the
CUDA route launches the kernels, the torch route runs their twins in the
same places.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..device import as_tensor, resolve_device, resolve_impl
from .ccl import _compress, _shift
from .kernels import WS_OFFS, apply_remap, count_rung, row_scan, tile_ws_propagate
from .tile_ccl import (
    BIG,
    DEFAULT_TABLE_CAP,
    _auto_cap,
    _compact_rows,
    _cumsum_rows,
    _gather_rows,
    _iota_rows,
    _lane_offsets,
    _lexsort_rows,
    _round_up,
    _scatter_min_rows,
    _scatter_set_rows,
    _shift1,
    _stride_slice,
    _take_rows,
    _tile_for,
    _tile_id_of,
    _zeros_i32,
    build_remap_tables_lanes,
    label_components_sparse_tensor,
    label_components_tiled_lanes,
    lane_chunks,
    resolve_tier_mode,
    run_capacity_tiered,
)

_BIGF = float(np.float32(3e38))
_I32MAX = int(np.iinfo(np.int32).max)

DEFAULT_EXIT_CAP = 1 << 21
DEFAULT_FILL_CAP = 1 << 21
DEFAULT_ADJ_CAP = 1 << 18


def _auto_fill_rounds(n_pad: int) -> int:
    """Boruvka round bound: ``ceil(log2(n)) + 1`` suffices for any input."""
    return max(16, int(np.ceil(np.log2(max(2, n_pad)))) + 1)


def resolve_fill_mode(fill_mode: Optional[str], device: torch.device) -> str:
    """``dense``/``capacity``; ``auto`` is ``dense`` on the CPU and
    ``capacity`` on the card (the reference's substrate rule).  ``None``
    reads ``CT_FILL_MODE``."""
    if fill_mode is None:
        fill_mode = os.environ.get("CT_FILL_MODE", "auto")
    if fill_mode == "auto":
        fill_mode = "dense" if device.type == "cpu" else "capacity"
    if fill_mode not in ("dense", "capacity"):
        raise ValueError(f"CT_FILL_MODE must be auto/capacity/dense, got {fill_mode!r}")
    return fill_mode


def resolve_seed_mode(seed_mode: Optional[str]) -> str:
    """``tiled``/``sparse`` seed-plateau CCL; ``None`` reads ``CT_SEED_CCL``."""
    if seed_mode is None:
        seed_mode = os.environ.get("CT_SEED_CCL", "tiled")
    if seed_mode not in ("tiled", "sparse"):
        raise ValueError(f"CT_SEED_CCL must be tiled/sparse, got {seed_mode!r}")
    return seed_mode


def _sortable_float_key(f: torch.Tensor) -> torch.Tensor:
    """Monotone float32 -> int32 key (total order, NaN-free inputs)."""
    u = f.to(torch.float32).contiguous().view(torch.int32)
    return u ^ ((u >> 31) & 0x7FFFFFFF)


def descent_directions(height: torch.Tensor, is_seed: torch.Tensor, valid: torch.Tensor,
                       lead: int = 0) -> torch.Tensor:
    """Code 0..6 of each voxel's steepest-descent target (0 = self):
    lexicographic min of ``(height, flat_index)`` over the closed
    6-neighbourhood; seeds and invalid voxels are terminals.  ``lead``
    leading axes are lanes (no neighbour across them)."""
    shape = height.shape
    vol = shape[lead:]
    n = int(np.prod(vol))
    dev = height.device
    idx = torch.arange(n, dtype=torch.int32, device=dev).reshape(vol)
    idx = idx.expand(shape)
    h = torch.where(valid, height.to(torch.float32), _BIGF)
    best_h, best_i = h, idx
    best_d = torch.zeros(shape, dtype=torch.int32, device=dev)
    for code, off in enumerate(WS_OFFS, start=1):
        nh, ni = h, idx
        for ax, s in enumerate(off):
            if s:
                nh = _shift(nh, -s, lead + ax, _BIGF)
                ni = _shift(ni, -s, lead + ax, n)
        better = (nh < best_h) | ((nh == best_h) & (ni < best_i))
        best_h = torch.where(better, nh, best_h)
        best_i = torch.where(better, ni, best_i)
        best_d = torch.where(better, code, best_d)
    return torch.where(is_seed | ~valid, 0, best_d).to(torch.int32).contiguous()


def _strip_entries(values: torch.Tensor, tile, axis: int, side: int):
    """(value, tile_id) arrays for one family of tile-boundary slabs of a
    ``[B, z, y, x]`` stack (lane-local tile ids)."""
    t = tile[axis]
    n = values.shape[axis + 1]
    start = 0 if side == 0 else t - 1
    sl = _stride_slice(values, start, n, t, axis + 1)
    shape = sl.shape[1:]
    dev = values.device
    ids = []
    for ax in range(3):
        view = [1, 1, 1]
        view[ax] = shape[ax]
        io = torch.arange(shape[ax], dtype=torch.int32, device=dev).reshape(view)
        ids.append(io if ax == axis else io // tile[ax])
    _, _, y, x = values.shape
    gy, gx = y // tile[1], x // tile[2]
    tid = ((ids[0] * gy + ids[1]) * gx + ids[2]).expand(sl.shape)
    return sl, tid


def collect_negative_values_lanes(values: torch.Tensor, tile, cap: int, tier: str = "cond",
                                  impl: str = "auto"):
    """Deduped (value, tile_id) pairs for negative labels on tile
    boundaries, per lane of a ``[B, z, y, x]`` stack (lane-local tile
    ids); returns ``(vals [B, *], tids [B, *], overflow [B] bool)``."""
    lanes = values.shape[0]
    vs, ts = [], []
    overflow = _zeros_i32(lanes, values)
    n_total = _zeros_i32(lanes, values)
    for axis in range(3):
        for side in (0, 1):
            sl, tid = _strip_entries(values, tile, axis, side)
            fam_cap = max(1024, min(cap, sl[0].numel()))
            neg = sl <= -2
            dedup_axis = (2 if axis != 2 else 1) + 1
            prev = _shift1(sl, dedup_axis, -1)
            prev_t = _shift1(tid, dedup_axis, -1)
            keep = neg & ((sl != prev) | (tid != prev_t))
            (v, t_), kept = _compact_rows(keep, (sl, tid), fam_cap, BIG, impl)
            overflow = torch.maximum(overflow, (kept > fam_cap).to(torch.int32))
            n_total = n_total + torch.clamp(kept, max=fam_cap)
            vs.append(v)
            ts.append(t_)
    v = torch.cat(vs, 1)
    t_ = torch.cat(ts, 1)
    cv, ct, n_kept = run_capacity_tiered(
        (v, t_), n_total, cap, _collect_core, 2, 0, tier, impl,
        # the last output is a COUNT checked against ``cap`` below
        trunc_fold=lambda n, trunc: torch.where(trunc > 0, cap + 1, n),
    )
    overflow = torch.maximum(overflow, (n_kept > cap).to(torch.int32))
    return cv, ct, overflow > 0


def _collect_core(v, t_, cap, _max_rounds, impl):
    """Sort-dedup one (value, tile) tier per row; outputs ``[B, cap]``."""
    order = _lexsort_rows(v, t_)
    v, t_ = _gather_rows(order, v, t_)
    dup = (v == _shift1(v, 1, BIG)) & (t_ == _shift1(t_, 1, BIG))
    keep = (~dup) & (v < BIG)
    (cv, ct), n_kept = _compact_rows(keep, (v, t_), cap, BIG, impl)
    return cv, ct, n_kept


def value_join_lanes(query_vals, table_vals, table_finals, tier: str = "cond", impl: str = "auto"):
    """For each query value, the table's final (or the query itself if
    absent): a sort-based join per row of ``[B, M]`` arrays, tiered like
    the reference's ``value_join``; under ``cond`` the tier is one decision
    for all rows (both tiers give every live query the same answer)."""
    lanes, nq = query_vals.shape
    nt = table_vals.shape[1]
    small_q = max(16384, nq // 16)
    small_t = max(16384, nt // 16)
    # tier "small" keeps the cond: value_join has no overflow channel
    if tier == "big":
        return _value_join_core(query_vals, table_vals, table_finals, impl)
    if small_q < nq and small_t < nt:
        n_q = int((query_vals < BIG).sum(1).max())
        n_t = int((table_vals < BIG).sum(1).max())
        if n_q <= small_q and n_t <= small_t:
            (cq, slots), _ = _compact_rows(
                query_vals < BIG, (query_vals, _iota_rows(lanes, nq, query_vals)), small_q, BIG, impl,
            )
            (ctv, ctf), _ = _compact_rows(table_vals < BIG, (table_vals, table_finals), small_t, BIG, impl)
            res = _value_join_core(cq, ctv, ctf, impl)
            return _scatter_set_rows(query_vals, slots, res)
    return _value_join_core(query_vals, table_vals, table_finals, impl)


def _value_join_core(query_vals, table_vals, table_finals, impl):
    lanes, nq = query_vals.shape
    nt = table_vals.shape[1]
    dev = query_vals.device
    keys = torch.cat([table_vals, query_vals], 1)
    is_query = torch.cat([
        torch.zeros((lanes, nt), dtype=torch.int32, device=dev),
        torch.ones((lanes, nq), dtype=torch.int32, device=dev),
    ], 1)
    payload = torch.cat([table_finals, query_vals], 1)
    slot = torch.cat([
        torch.full((lanes, nt), -1, dtype=torch.int32, device=dev),
        _iota_rows(lanes, nq, query_vals),
    ], 1)
    order = _lexsort_rows(keys, is_query)
    keys, is_query, payload, slot = _gather_rows(order, keys, is_query, payload, slot)
    pos = _iota_rows(lanes, nt + nq, query_vals)
    last_tbl = row_scan(torch.where(is_query == 0, pos, -1), "max", impl)
    at = torch.clamp(last_tbl, 0, nt + nq - 1)
    tbl_key = _take_rows(keys, at)
    tbl_fin = _take_rows(payload, at)
    res = torch.where((last_tbl >= 0) & (tbl_key == keys), tbl_fin, keys)
    out = torch.zeros((lanes, nq), dtype=torch.int32, device=dev)
    return _scatter_set_rows(out, torch.where(is_query == 1, slot, nq), res)


def chase_exits_lanes(values: torch.Tensor, codes: torch.Tensor, max_hops: int = 256, tier: str = "cond",
                      impl: str = "auto"):
    """Resolve exit codes by following values across tiles, per lane:
    ``values`` ``[B, ...]``, ``codes`` ``[B, C]``.  Returns ``(finals [B,
    C], unconverged [B] bool)``: each code's chain end (seed label, 0, or
    its basin's unseeded terminal code), and True where a chain exceeded
    ``max_hops``."""
    lanes = values.shape[0]
    n = values[0].numel()
    flat = values.reshape(lanes, -1)

    def _core(c):
        active0 = c <= -2
        g = torch.where(active0, -c - 2, 0)
        val = torch.where(active0, _take_rows(flat, torch.clamp(g, 0, n - 1)), c)
        moved = torch.ones((lanes,), dtype=torch.bool, device=c.device)
        hops = 0
        while hops < max_hops and bool(moved.any()):
            active = (val <= -2) & (val != -g - 2)
            g = torch.where(active, -val - 2, g)
            val = torch.where(active, _take_rows(flat, torch.clamp(g, 0, n - 1)), val)
            moved = active.any(1)
            hops += 1
        return torch.where(active0, val, c), moved

    cap = codes.shape[1]
    small_n = max(16384, cap // 16)
    if small_n >= cap or tier == "big":
        return _core(codes)

    def _small(c):
        (pc, slots), _ = _compact_rows(c <= -2, (c, _iota_rows(lanes, cap, c)), small_n, BIG, impl)
        fin_s, moved = _core(pc)
        # non-active codes map to themselves; padded slots (BIG) drop
        return _scatter_set_rows(c, slots, fin_s), moved

    n_active = (codes <= -2).sum(1)
    if tier == "small":
        fin, moved = _small(codes)
        return fin, moved | (n_active > small_n)
    if int(n_active.max()) <= small_n:
        return _small(codes)
    return _core(codes)


def _resolve_codes_gather_lanes(values: torch.Tensor, codes, finals) -> torch.Tensor:
    """Gather rung per lane of a ``[B, ...]`` stack: scatter code
    resolutions into a voxel-indexed table."""
    lanes = values.shape[0]
    n = values[0].numel()
    table = -_iota_rows(lanes, n, values) - 2
    pos = torch.where(codes <= -2, -codes - 2, n)
    table = _scatter_set_rows(table, pos, finals)
    flat = values.reshape(lanes, -1)
    looked = _take_rows(table, torch.clamp(-flat - 2, 0, n - 1))
    return torch.where(flat <= -2, looked, flat).reshape(values.shape)


def _resolve_codes_gather(values: torch.Tensor, codes, finals) -> torch.Tensor:
    """:func:`_resolve_codes_gather_lanes` of one volume."""
    return _resolve_codes_gather_lanes(values.unsqueeze(0), codes.unsqueeze(0), finals.unsqueeze(0))[0]


def fill_unseeded_basins_lanes(labels, height, fill_cap: int = DEFAULT_FILL_CAP,
                               max_rounds: Optional[int] = None, adj_cap: Optional[int] = None,
                               tier: str = "cond", impl: str = "auto"):
    """Merge unseeded basins across their lowest saddles (Boruvka rounds on
    the compacted basin-boundary edge list), per lane of a ``[B, z, y, x]``
    stack.  Returns ``(edge_vals [B, *], edge_finals [B, *], overflow [B]
    bool)``: old basin code -> final label (0 if unreachable) for every
    unseeded basin seen on a boundary."""
    lanes = labels.shape[0]
    n_lane = labels[0].numel()
    if max_rounds is None:
        max_rounds = _auto_fill_rounds(n_lane)
    h = height.to(torch.float32)
    evs_a, evs_b, evs_h = [], [], []
    overflow = _zeros_i32(lanes, labels)
    n_total = _zeros_i32(lanes, labels)
    for axis in range(3):
        na = labels.shape[axis + 1]
        a = labels.narrow(axis + 1, 0, na - 1)
        b = labels.narrow(axis + 1, 1, na - 1)
        ha = h.narrow(axis + 1, 0, na - 1)
        hb = h.narrow(axis + 1, 1, na - 1)
        saddle = _sortable_float_key(torch.maximum(ha, hb))
        flag = (a != b) & (a != 0) & (b != 0) & ((a < 0) | (b < 0))
        dedup_axis = (2 if axis != 2 else 1) + 1
        keep = flag & ((a != _shift1(a, dedup_axis, 0)) | (b != _shift1(b, dedup_axis, 0)))
        (pa, pb, ph), kept = _compact_rows(keep, (a, b, saddle), fill_cap, BIG, impl)
        overflow = torch.maximum(overflow, (kept > fill_cap).to(torch.int32))
        n_total = n_total + torch.clamp(kept, max=fill_cap)
        evs_a.append(pa)
        evs_b.append(pb)
        evs_h.append(ph)
    a = torch.cat(evs_a, 1)
    b = torch.cat(evs_b, 1)
    hk = torch.cat(evs_h, 1)
    if adj_cap is None:
        adj_cap = min(3 * fill_cap, max(DEFAULT_ADJ_CAP, n_lane // 32))
    edge_vals, edge_finals, core_overflow = run_capacity_tiered(
        (a, b, hk), n_total, adj_cap, _fill_core, 2, max_rounds, tier, impl
    )
    overflow = torch.maximum(overflow, core_overflow)
    return edge_vals, edge_finals, overflow > 0


def _fill_core(a, b, hk, adj_cap, max_rounds, impl):
    """Dedup + dense ids + Boruvka rounds over one capacity tier, per row;
    outputs ``[B, 2 * adj_cap]``, overflow ``[B]`` int32."""
    dev = a.device
    lanes = a.shape[0]
    # unique (a, b) adjacencies with their min saddle
    order = _lexsort_rows(a, b, hk)
    sa, sb, sh = _gather_rows(order, a, b, hk)
    first = (sa != _shift1(sa, 1, BIG)) | (sb != _shift1(sb, 1, BIG))
    keep_adj = first & (sa < BIG)
    (a, b, hk), n_adj = _compact_rows(keep_adj, (sa, sb, sh), adj_cap, BIG, impl)
    overflow = (n_adj > adj_cap).to(torch.int32)

    # dense ids over all endpoint values
    ne = a.shape[1]
    m2 = ne * 2
    vals = torch.cat([a, b], 1)
    sv, ss = torch.sort(vals, dim=1, stable=True)
    is_new = sv != _shift1(sv, 1, -BIG)
    rank = _cumsum_rows(is_new, impl) - 1
    uniq = _scatter_set_rows(torch.full((lanes, m2), BIG, dtype=torch.int32, device=dev), rank, sv)
    dense = torch.zeros((lanes, m2), dtype=torch.int32, device=dev)
    dense.scatter_(1, ss, rank)
    da, db = dense[:, :ne], dense[:, ne:]
    edge_pad = a >= BIG

    parent = _iota_rows(lanes, m2, a)
    eid = _iota_rows(lanes, ne, a)
    me = _iota_rows(lanes, m2, a)
    changed = torch.ones((lanes,), dtype=torch.bool, device=dev)
    it = 0
    # a row that stops changing is at its fixed point: later rounds keep it
    while it < max_rounds and bool(changed.any()):
        P = parent
        ra = _take_rows(P, da)
        rb = _take_rows(P, db)
        alive = (ra != rb) & (~edge_pad)
        # orient every edge both ways; only negative-valued roots hook
        live_a = alive & (_take_rows(uniq, ra) <= -2)
        live_b = alive & (_take_rows(uniq, rb) <= -2)
        np_ = m2
        best_h = torch.full((lanes, np_), _I32MAX, dtype=torch.int32, device=dev)
        best_h = _scatter_min_rows(best_h, torch.where(live_a, ra, np_), hk)
        best_h = _scatter_min_rows(best_h, torch.where(live_b, rb, np_), hk)
        tie_a = live_a & (_take_rows(best_h, ra) == hk)
        tie_b = live_b & (_take_rows(best_h, rb) == hk)
        best_e = torch.full((lanes, np_), _I32MAX, dtype=torch.int32, device=dev)
        best_e = _scatter_min_rows(best_e, torch.where(tie_a, ra, np_), eid)
        best_e = _scatter_min_rows(best_e, torch.where(tie_b, rb, np_), eid)
        win_a = tie_a & (_take_rows(best_e, ra) == eid)
        win_b = tie_b & (_take_rows(best_e, rb) == eid)
        parent2 = me
        parent2 = _scatter_set_rows(parent2, torch.where(win_a, ra, np_), torch.where(win_a, rb, 0))
        parent2 = _scatter_set_rows(parent2, torch.where(win_b, rb, np_), torch.where(win_b, ra, 0))
        # break 2-cycles: the lower id stays a root
        pp = _take_rows(parent2, parent2)
        parent2 = torch.where((pp == me) & (me < parent2), me, parent2)
        parent2 = _compress(parent2, -1)  # closure (no sentinel: -1 never occurs)
        newP = _take_rows(parent2, P)
        changed = (newP != P).any(1)
        parent = newP
        it += 1
    # a max_rounds exit leaves basins mid-chain: report, never hide
    overflow = torch.maximum(overflow, changed.to(torch.int32))
    root_val = _take_rows(uniq, parent)
    final_of = torch.where(root_val > 0, root_val, 0)
    edge_vals = uniq
    edge_finals = torch.where(uniq <= -2, final_of, uniq)
    return edge_vals, edge_finals, overflow


def fill_unseeded_basins_dense_lanes(values, height, max_rounds: Optional[int] = None,
                                     face_cap: Optional[int] = None, impl: str = "auto"):
    """Sort-free unseeded-basin fill per lane of a ``[B, z, y, x]`` stack:
    face-list scatter-min Boruvka rounds with exact per-pair min saddles.
    ``values``: >0 seeded, <= -2 unseeded terminal code, 0 invalid, -1
    masked/padded (a hookable neighbour).  Returns ``(resolved_values,
    overflow [B] bool)``."""
    lanes = values.shape[0]
    shape = values.shape[1:]
    n = int(np.prod(shape))
    dev = values.device
    v = values.reshape(lanes, n)
    h = _sortable_float_key(height.to(torch.float32)).reshape(lanes, n)
    if face_cap is None:
        face_cap = min(1 << 24, max(1 << 16, n // 6))
    if max_rounds is None:
        max_rounds = _auto_fill_rounds(n)

    P0 = -_iota_rows(lanes, n, v) - 2

    def resolve_flat(P, x):
        return torch.where(x <= -2, _take_rows(P, torch.clamp(-x - 2, 0, n - 1)), x)

    flat_idx = _iota_rows(lanes, n, v)
    trunc = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    faces = []
    for axis in range(3):
        nb = _shift(values, -1, axis + 1, 0).reshape(lanes, n)
        ok0 = (v != nb) & (v != 0) & (nb != 0) & ((v <= -2) | (nb <= -2))
        (idx_c,), n_faces = _compact_rows(ok0, (flat_idx,), face_cap, n, impl)
        trunc = trunc | (n_faces > face_cap)
        stride = int(np.prod(shape[axis + 1:], dtype=np.int64))
        pad = idx_c >= n
        ia = torch.clamp(idx_c, 0, n - 1)
        ib = torch.clamp(idx_c + stride, 0, n - 1)
        va = torch.where(pad, 0, _take_rows(v, ia))
        vb = torch.where(pad, 0, _take_rows(v, ib))
        sad = torch.maximum(_take_rows(h, ia), _take_rows(h, ib))
        eid = torch.where(pad, _I32MAX, axis * n + idx_c)
        faces.append((va, vb, sad, eid, pad))
    me_idx = _iota_rows(lanes, n, v)

    P = P0
    changed = torch.ones((lanes,), dtype=torch.bool, device=dev)
    it = 0
    # a row that stops changing is at its fixed point: later rounds keep it
    while it < max_rounds and bool(changed.any()):
        best_h = torch.full((lanes, n), _I32MAX, dtype=torch.int32, device=dev)
        best_e = torch.full((lanes, n), _I32MAX, dtype=torch.int32, device=dev)
        sides = []
        for va, vb, sad, eid, pad in faces:
            ra = resolve_flat(P, va)
            rb = resolve_flat(P, vb)
            live = ~pad & (ra != rb)
            sides.append((ra, rb, sad, live, eid))
            sides.append((rb, ra, sad, live, eid))
        for src, dst, sad, live, eid in sides:
            m = live & (src <= -2)
            best_h = _scatter_min_rows(best_h, torch.where(m, -src - 2, n), torch.where(m, sad, _I32MAX))
        for src, dst, sad, live, eid in sides:
            m = live & (src <= -2)
            tie = m & (_take_rows(best_h, torch.clamp(-src - 2, 0, n - 1)) == sad)
            best_e = _scatter_min_rows(best_e, torch.where(tie, -src - 2, n), torch.where(tie, eid, _I32MAX))
        P2 = P
        for src, dst, sad, live, eid in sides:
            m = live & (src <= -2)
            gsafe = torch.clamp(-src - 2, 0, n - 1)
            win = m & (_take_rows(best_h, gsafe) == sad) & (_take_rows(best_e, gsafe) == eid)
            P2 = _scatter_set_rows(P2, torch.where(win, -src - 2, n), torch.where(win, dst, 0))
        # break 2-cycles: the smaller terminal index stays a root
        tgt = torch.clamp(-P2 - 2, 0, n - 1)
        mutual = (P2 <= -2) & (_take_rows(P2, tgt) == (-me_idx - 2)) & (me_idx < tgt)
        P2 = torch.where(mutual, -me_idx - 2, P2)
        # pointer-jump to closure
        while True:
            p3 = resolve_flat(P2, P2)
            if not bool((p3 != P2).any()):
                break
            P2 = p3
        changed = (P2 != P).any(1)
        P = P2
        it += 1
    resolved = resolve_flat(P, v).reshape(values.shape)
    return resolved, changed | trunc


def _ws_static_plan(shape, tile, exit_cap, fill_cap):
    """Tile/padded geometry + capacity defaults (the reference's)."""
    z, y, x = shape
    tile = _tile_for(shape) if tile is None else tuple(tile)
    tz, ty, tx = tile
    zp, yp, xp = _round_up(z, tz), _round_up(y, ty), _round_up(x, tx)
    if zp * yp * xp >= BIG:
        raise ValueError(f"padded volume {(zp, yp, xp)} has >= 2**30 voxels; shard it")
    n_pad = zp * yp * xp
    if exit_cap is None:
        exit_cap = min(1 << 24, max(_auto_cap(n_pad, DEFAULT_EXIT_CAP, 3), n_pad // 12))
    if fill_cap is None:
        fill_cap = min(1 << 24, max(_auto_cap(n_pad, DEFAULT_FILL_CAP, 1), n_pad // 8))
    return tile, (zp, yp, xp), exit_cap, fill_cap


def _ws_flow_lanes(height, seeds, mask, *, impl, tile, exit_cap, table_cap, tier):
    """Flow phase over a ``[B, z, y, x]`` stack: tile-pad each lane,
    descent directions, in-tile flow (B2 over the stack), exit chase +
    remap (B4 over the stack, or the gather rung).  Returns ``(values, h,
    overflow [B])`` at tile-padded lane shape: >0 seeded label, <= -2
    unseeded terminal code (lane-local), -1 masked/padded."""
    if height.dim() != 4:
        raise ValueError("seeded_watershed_tiled expects a 3-D volume per lane")
    lanes, z, y, x = height.shape
    tile, (zp, yp, xp), exit_cap, _ = _ws_static_plan((z, y, x), tile, exit_cap, 0)
    tz, ty, tx = tile
    padded = (zp, yp, xp) != (z, y, x)
    valid = torch.ones(height.shape, dtype=torch.bool, device=height.device) if mask is None else mask.to(torch.bool)
    h = height.to(torch.float32)
    s = seeds.to(torch.int32)
    if padded:
        pads = (0, xp - x, 0, yp - y, 0, zp - z)
        h = torch.nn.functional.pad(h, pads, value=_BIGF)
        s = torch.nn.functional.pad(s, pads)
        valid = torch.nn.functional.pad(valid, pads)

    dirs = descent_directions(h, s > 0, valid, lead=1)
    sv = torch.where(valid, s, -1).to(torch.int32).contiguous()
    stack = (lanes * zp, yp, xp)
    values = tile_ws_propagate(dirs.reshape(stack), sv.reshape(stack), tile=tile, impl=impl).reshape(h.shape)
    del dirs, sv
    if lanes > 1:
        # the kernel's codes point at stack voxels: back to the lane's own
        values = torch.where(values <= -2, values + _lane_offsets(lanes, zp * yp * xp, values.device), values)

    # cross-tile exits: collect, chase, remap
    codes, code_tiles, overflow = collect_negative_values_lanes(values, tile, exit_cap, tier, impl)
    finals, chase_unconverged = chase_exits_lanes(values, codes, tier=tier, impl=impl)
    overflow = overflow | chase_unconverged
    n_tiles = (zp // tz) * (yp // ty) * (xp // tx)
    changed = (codes <= -2) & (finals != codes)
    tids = torch.where(changed, code_tiles, BIG)
    old_tbl, new_tbl, tbl_overflow = build_remap_tables_lanes(tids, codes, finals, n_tiles, table_cap=table_cap,
                                                              tier=tier, impl=impl)
    if bool(tbl_overflow.any()):
        # both rungs give the same labels, so an overflowing lane takes
        # the whole stack to the gather rung
        count_rung("flow:gather")
        values = _resolve_codes_gather_lanes(values, codes, finals)
    else:
        count_rung("flow:table")
        values = apply_remap(values.reshape(stack).contiguous(), old_tbl.reshape(lanes * n_tiles, table_cap),
                             new_tbl.reshape(lanes * n_tiles, table_cap), tile=tile, cap=table_cap,
                             impl=impl).reshape(h.shape)
    return values, h, overflow


def _ws_flow_core(height, seeds, mask, *, impl, tile, exit_cap, table_cap, tier):
    """Flow phase of one volume (:func:`_ws_flow_lanes` of one lane)."""
    if height.dim() != 3:
        raise ValueError("seeded_watershed_tiled expects a 3-D volume")
    values, h, overflow = _ws_flow_lanes(
        height.unsqueeze(0), seeds.unsqueeze(0), None if mask is None else mask.unsqueeze(0),
        impl=impl, tile=tile, exit_cap=exit_cap, table_cap=table_cap, tier=tier,
    )
    return values[0], h[0], bool(overflow[0])


def _ws_fill_lanes(values, h, orig_shape, *, impl, tile, exit_cap, fill_cap, table_cap,
                   adj_cap, fill_rounds, fill_mode, tier):
    """Fill phase over a ``[B, zp, yp, xp]`` stack: unseeded-basin fill
    across lowest saddles, remap (B4 over the stack or the gather rung),
    leftovers to 0, crop the tile padding.  Returns ``(labels, overflow
    [B])``."""
    z, y, x = orig_shape
    lanes = values.shape[0]
    tile, (zp, yp, xp), exit_cap, fill_cap = _ws_static_plan(orig_shape, tile, exit_cap, fill_cap)
    tz, ty, tx = tile
    padded = (zp, yp, xp) != (z, y, x)
    if tuple(values.shape[1:]) != (zp, yp, xp):
        raise ValueError(f"fill phase expects tile-padded values {(zp, yp, xp)}, got {tuple(values.shape[1:])}")
    if fill_rounds is None:
        fill_rounds = _auto_fill_rounds(zp * yp * xp)
    if fill_mode == "dense":
        values, overflow = fill_unseeded_basins_dense_lanes(values, h, max_rounds=fill_rounds, impl=impl)
        out = torch.where(values > 0, values, 0).to(torch.int32)
        if padded:
            out = out[:, :z, :y, :x]
        return out.contiguous(), overflow
    fill_vals, fill_finals, overflow = fill_unseeded_basins_lanes(
        values, h, fill_cap=fill_cap, max_rounds=fill_rounds, adj_cap=adj_cap, tier=tier, impl=impl
    )
    n_tiles = (zp // tz) * (yp // ty) * (xp // tx)
    # tiles needing a basin's entry: strip incidences + the terminal's tile
    bvals, btiles, b_overflow = collect_negative_values_lanes(values, tile, exit_cap, tier, impl)
    overflow = overflow | b_overflow
    bfin = value_join_lanes(bvals, fill_vals, fill_finals, tier, impl)
    tvals = fill_vals
    t_of = _tile_id_of(torch.where(tvals <= -2, -tvals - 2, 0), (zp, yp, xp), tile)
    ttiles = torch.where(tvals <= -2, t_of, BIG)
    all_vals = torch.cat([bvals, tvals], 1)
    all_fin = torch.cat([bfin, torch.where(tvals <= -2, fill_finals, tvals)], 1)
    all_tiles = torch.cat([
        torch.where((bvals <= -2) & (bfin != bvals), btiles, BIG),
        torch.where((tvals <= -2) & (fill_finals != tvals), ttiles, BIG),
    ], 1)
    old2, new2, tbl_overflow2 = build_remap_tables_lanes(all_tiles, all_vals, all_fin, n_tiles,
                                                         table_cap=table_cap, tier=tier, impl=impl)
    if bool(tbl_overflow2.any()):
        count_rung("fill:gather")
        values = _resolve_codes_gather_lanes(values, fill_vals, fill_finals)
    else:
        count_rung("fill:table")
        stack = (lanes * zp, yp, xp)
        values = apply_remap(values.reshape(stack).contiguous(), old2.reshape(lanes * n_tiles, table_cap),
                             new2.reshape(lanes * n_tiles, table_cap), tile=tile, cap=table_cap,
                             impl=impl).reshape(values.shape)
    # leftover negatives (basins with no seeded reachable neighbour) -> 0
    out = torch.where(values > 0, values, 0).to(torch.int32)
    if padded:
        out = out[:, :z, :y, :x]
    return out.contiguous(), overflow


def _ws_fill_core(values, h, orig_shape, *, impl, tile, exit_cap, fill_cap, table_cap,
                  adj_cap, fill_rounds, fill_mode, tier):
    """Fill phase of one volume (:func:`_ws_fill_lanes` of one lane)."""
    out, overflow = _ws_fill_lanes(
        values.unsqueeze(0), h.unsqueeze(0), orig_shape, impl=impl, tile=tile, exit_cap=exit_cap,
        fill_cap=fill_cap, table_cap=table_cap, adj_cap=adj_cap, fill_rounds=fill_rounds,
        fill_mode=fill_mode, tier=tier,
    )
    return out[0], bool(overflow[0])


def seeded_watershed_tiled_lanes(height, seeds, mask=None, *, impl="auto", tile=None,
                                 exit_cap=None, fill_cap=None, table_cap=DEFAULT_TABLE_CAP,
                                 adj_cap=None, fill_rounds=None, fill_mode=None, tier="cond"):
    """:func:`seeded_watershed_tiled_tensor` over a ``[B, z, y, x]`` stack;
    returns ``(labels, overflow [B] bool)``."""
    impl = resolve_impl(impl, height)
    fill_mode = resolve_fill_mode(fill_mode, height.device)
    values, h, flow_overflow = _ws_flow_lanes(
        height, seeds, mask, impl=impl, tile=tile, exit_cap=exit_cap, table_cap=table_cap, tier=tier,
    )
    out, fill_overflow = _ws_fill_lanes(
        values, h, tuple(height.shape[1:]), impl=impl, tile=tile, exit_cap=exit_cap,
        fill_cap=fill_cap, table_cap=table_cap, adj_cap=adj_cap,
        fill_rounds=fill_rounds, fill_mode=fill_mode, tier=tier,
    )
    return out, flow_overflow | fill_overflow


def seeded_watershed_tiled_tensor(height, seeds, mask=None, *, impl="auto", tile=None,
                                  exit_cap=None, fill_cap=None, table_cap=DEFAULT_TABLE_CAP,
                                  adj_cap=None, fill_rounds=None, fill_mode=None, tier="cond"):
    """:func:`seeded_watershed_tiled` on tensors, on their own device."""
    out, overflow = seeded_watershed_tiled_lanes(
        height.unsqueeze(0), seeds.unsqueeze(0), None if mask is None else mask.unsqueeze(0),
        impl=impl, tile=tile, exit_cap=exit_cap, fill_cap=fill_cap, table_cap=table_cap,
        adj_cap=adj_cap, fill_rounds=fill_rounds, fill_mode=fill_mode, tier=tier,
    )
    return out[0], bool(overflow[0])


def seeded_watershed_tiled(height, seeds, mask=None, impl: str = "auto", tile=None,
                           exit_cap=None, fill_cap=None, table_cap: int = DEFAULT_TABLE_CAP,
                           adj_cap=None, fill_rounds=None, fill_mode: Optional[str] = None,
                           tier_mode: Optional[str] = None, device=None):
    """Seeded watershed with the two-level tile machinery.

    Labels int32, 0 outside mask / unreachable; unseeded basins take the
    label across their lowest saddle.  Returns ``(labels, overflow)``.
    ``fill_mode``: ``dense``/``capacity``/``auto`` (``None`` reads
    ``CT_FILL_MODE``).
    """
    dev = resolve_device(device)
    return seeded_watershed_tiled_tensor(
        as_tensor(height, dev, torch.float32), as_tensor(seeds, dev, torch.int32),
        None if mask is None else as_tensor(mask, dev, torch.bool),
        impl=impl, tile=tile, exit_cap=exit_cap, fill_cap=fill_cap, table_cap=table_cap,
        adj_cap=adj_cap, fill_rounds=fill_rounds, fill_mode=fill_mode,
        tier=resolve_tier_mode(tier_mode),
    )


def _seed_ccl(maxima, seed_cap, *, mode, impl, tile, pair_cap, edge_cap, table_cap, tier):
    """Label the seed plateaus of a ``[B, z, y, x]`` stack: ``tiled`` (the
    two-level CCL over the stack) or ``sparse`` (one lane at a time).
    Returns ``(raw labels, overflow [B] bool)``."""
    if mode == "sparse":
        outs = [label_components_sparse_tensor(m, cap=seed_cap) for m in maxima]
        return (torch.stack([o[0] for o in outs]),
                torch.tensor([o[1] for o in outs], dtype=torch.bool, device=maxima.device))
    return label_components_tiled_lanes(
        maxima, impl=impl, tile=tile, pair_cap=pair_cap, edge_cap=edge_cap,
        table_cap=table_cap, tier=tier, site="seeds",
    )


def _dt_seeds_lanes(boundaries, mask, *, threshold, min_seed_distance, sampling,
                    dt_max_distance, impl, tile, pair_cap, edge_cap, table_cap, seed_cap,
                    seed_mode, tier, sigma_seeds=0.0, dist=None):
    """Seed phase over a ``[B, z, y, x]`` stack: threshold -> capped EDT
    (B3 over lane-safe views) -> optional smoothing -> maxima plateaus ->
    seed CCL.  ``dist``: squared distances given by the caller (the
    mesh-exact transform), used in place of the EDT.  Returns ``(seeds,
    valid, overflow [B])``."""
    from .edt import distance_transform_squared_tensor
    from .filters import gaussian_smooth_tensor
    from .watershed import local_maxima_tensor

    dev = boundaries.device
    valid = torch.ones(boundaries.shape, dtype=torch.bool, device=dev) if mask is None else mask.to(torch.bool)
    fg = (boundaries < torch.tensor(threshold, dtype=torch.float32, device=dev)) & valid
    if dist is None:
        dist = distance_transform_squared_tensor(fg, sampling=sampling, max_distance=dt_max_distance, impl=impl,
                                                 lead=1)
    else:
        # zero the given distances outside the foreground so seed maxima
        # stay inside basins
        dist = torch.where(fg, dist.to(torch.float32), torch.tensor(np.float32(0.0), device=dev))
    if sigma_seeds > 0:
        dist = gaussian_smooth_tensor(dist, sigma_seeds, sampling=sampling, lead=1)
    msd2 = torch.tensor(np.float32(min_seed_distance * min_seed_distance), device=dev)
    maxima = local_maxima_tensor(dist, 1, lead=1) & fg & (dist >= msd2)
    del dist
    raw, seed_overflow = _seed_ccl(
        maxima, seed_cap, mode=seed_mode, impl=impl, tile=tile, pair_cap=pair_cap,
        edge_cap=edge_cap, table_cap=table_cap, tier=tier,
    )
    n = boundaries[0].numel()
    seeds = torch.where(raw == n, 0, raw + 1).to(torch.int32)
    return seeds, valid, seed_overflow


def _dt_seeds_core(boundaries, mask, dist=None, **kw):
    """Seed phase of one volume (:func:`_dt_seeds_lanes` of one lane)."""
    seeds, valid, overflow = _dt_seeds_lanes(
        boundaries.unsqueeze(0), None if mask is None else mask.unsqueeze(0),
        dist=None if dist is None else dist.unsqueeze(0), **kw
    )
    return seeds[0], valid[0], bool(overflow[0])


def dt_watershed_lanes(b, ext=None, m=None, *, threshold: float = 0.25, sigma_seeds: float = 0.0,
                       min_seed_distance: float = 0.0, sampling=None, dt_max_distance: Optional[float] = None,
                       impl: str = "auto", tile=None, pair_cap=None, edge_cap=None, exit_cap=None,
                       fill_cap=None, table_cap: int = DEFAULT_TABLE_CAP, seed_cap=None, adj_cap=None,
                       fill_rounds=None, fill_mode: Optional[str] = None, seed_mode: Optional[str] = None,
                       tier_mode: Optional[str] = None):
    """The DT watershed over a ``[B, z, y, x]`` stack of lanes: for each
    lane, exactly what :func:`_dt_watershed_core` computes for it alone
    (internal seeds, external seeds ``ext + N`` over them, the seeded
    flood), with kernels B1-B4 launched once over the stack per site.
    ``ext`` (int32 external seeds, two-pass mode) and ``m`` (bool mask)
    are stacks like ``b`` or None; the keywords are
    :func:`dt_watershed_tiled`'s.  Returns ``(labels [B, z, y, x] int32,
    overflow [B] bool tensor)``."""
    impl = resolve_impl(impl, b)
    lanes = b.shape[0]
    tile_ = _tile_for(tuple(b.shape[1:])) if tile is None else tuple(tile)
    n_pad = int(np.prod([_round_up(s, t) for s, t in zip(b.shape[1:], tile_)]))
    chunks = lane_chunks(lanes, n_pad)
    if len(chunks) > 1:
        kw = dict(threshold=threshold, sigma_seeds=sigma_seeds, min_seed_distance=min_seed_distance,
                  sampling=sampling, dt_max_distance=dt_max_distance, impl=impl, tile=tile,
                  pair_cap=pair_cap, edge_cap=edge_cap, exit_cap=exit_cap, fill_cap=fill_cap,
                  table_cap=table_cap, seed_cap=seed_cap, adj_cap=adj_cap, fill_rounds=fill_rounds,
                  fill_mode=fill_mode, seed_mode=seed_mode, tier_mode=tier_mode)
        parts = [dt_watershed_lanes(b[lo:hi], None if ext is None else ext[lo:hi],
                                    None if m is None else m[lo:hi], **kw) for lo, hi in chunks]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    tier = resolve_tier_mode(tier_mode)
    seeds, valid, seed_overflow = _dt_seeds_lanes(
        b, m, threshold=threshold, sigma_seeds=sigma_seeds, min_seed_distance=min_seed_distance,
        sampling=sampling, dt_max_distance=dt_max_distance, impl=impl, tile=tile,
        pair_cap=pair_cap, edge_cap=edge_cap, table_cap=table_cap, seed_cap=seed_cap,
        seed_mode=resolve_seed_mode(seed_mode), tier=tier,
    )
    if ext is not None:
        # external seeds dominate; internal ids live in 1..N, external in N+1..
        seeds = torch.where(ext > 0, ext + b[0].numel(), seeds)
    labels, ws_overflow = seeded_watershed_tiled_lanes(
        b, seeds, valid, impl=impl, tile=tile, exit_cap=exit_cap, fill_cap=fill_cap,
        table_cap=table_cap, adj_cap=adj_cap, fill_rounds=fill_rounds,
        fill_mode=fill_mode, tier=tier,
    )
    return labels, seed_overflow | ws_overflow


def _dt_watershed_core(b, ext, m, **kw):
    """The DT watershed on tensors: internal seeds, external seeds (if
    any) at ``+N`` over them, then the seeded flood."""
    labels, overflow = dt_watershed_lanes(
        b.unsqueeze(0), None if ext is None else ext.unsqueeze(0), None if m is None else m.unsqueeze(0), **kw
    )
    return labels[0], bool(overflow[0])


def dt_watershed_tiled(boundaries, threshold: float = 0.25, sigma_seeds: float = 0.0,
                       min_seed_distance: float = 0.0, sampling=None, mask=None,
                       dt_max_distance: Optional[float] = None, impl: str = "auto", tile=None,
                       pair_cap=None, edge_cap=None, exit_cap=None, fill_cap=None,
                       table_cap: int = DEFAULT_TABLE_CAP, seed_cap=None, adj_cap=None,
                       fill_rounds=None, fill_mode: Optional[str] = None,
                       seed_mode: Optional[str] = None, tier_mode: Optional[str] = None, device=None):
    """Distance-transform watershed on the two-level machinery: threshold
    -> capped EDT -> optional smoothing (``sigma_seeds``) -> seeds = CCL of
    DT maxima plateaus -> seeded watershed.  Returns ``(labels,
    overflow)``; labels are ``seed_rep + 1``, 0 outside mask / unreached."""
    dev = resolve_device(device)
    return _dt_watershed_core(
        as_tensor(boundaries, dev, torch.float32), None, None if mask is None else as_tensor(mask, dev, torch.bool),
        threshold=threshold, sigma_seeds=sigma_seeds, min_seed_distance=min_seed_distance,
        sampling=sampling, dt_max_distance=dt_max_distance, impl=impl, tile=tile, pair_cap=pair_cap,
        edge_cap=edge_cap, exit_cap=exit_cap, fill_cap=fill_cap, table_cap=table_cap,
        seed_cap=seed_cap, adj_cap=adj_cap, fill_rounds=fill_rounds, fill_mode=fill_mode,
        seed_mode=seed_mode, tier_mode=tier_mode,
    )


def dt_watershed_seeded_tiled(boundaries, ext_seeds, threshold: float = 0.25, sigma_seeds: float = 0.0,
                              min_seed_distance: float = 0.0, sampling=None, mask=None,
                              dt_max_distance: Optional[float] = None, impl: str = "auto", tile=None,
                              pair_cap=None, edge_cap=None, exit_cap=None, fill_cap=None,
                              table_cap: int = DEFAULT_TABLE_CAP, seed_cap=None, adj_cap=None,
                              fill_rounds=None, fill_mode: Optional[str] = None,
                              seed_mode: Optional[str] = None, tier_mode: Optional[str] = None, device=None):
    """Two-pass-mode DT watershed on the tiled machinery: ``ext_seeds``
    (int32, dense ``1..K``, 0 = none) are neighbour labels from pass one;
    internal DT seeds are planted where no external seed sits.  Output
    values above ``N`` (the voxel count) are external ids (``+N``), ``1..N``
    new internal fragments.  Returns ``(labels, overflow)``."""
    dev = resolve_device(device)
    return _dt_watershed_core(
        as_tensor(boundaries, dev, torch.float32), as_tensor(ext_seeds, dev, torch.int32),
        None if mask is None else as_tensor(mask, dev, torch.bool),
        threshold=threshold, sigma_seeds=sigma_seeds, min_seed_distance=min_seed_distance,
        sampling=sampling, dt_max_distance=dt_max_distance, impl=impl, tile=tile, pair_cap=pair_cap,
        edge_cap=edge_cap, exit_cap=exit_cap, fill_cap=fill_cap, table_cap=table_cap,
        seed_cap=seed_cap, adj_cap=adj_cap, fill_rounds=fill_rounds, fill_mode=fill_mode,
        seed_mode=seed_mode, tier_mode=tier_mode,
    )
