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
from .ccl import _shift
from .kernels import RUNGS, WS_OFFS, apply_remap, tile_ws_propagate
from .tile_ccl import (
    BIG,
    DEFAULT_TABLE_CAP,
    _auto_cap,
    _compact,
    _cumsum_i32,
    _i32,
    _lexsort,
    _round_up,
    _scatter_min,
    _scatter_set,
    _shift1,
    _stride_slice,
    _take,
    _tile_for,
    _tile_id_of,
    build_remap_tables,
    label_components_sparse_tensor,
    label_components_tiled_tensor,
    resolve_tier_mode,
    run_capacity_tiered,
)
from .unionfind import compress

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


def descent_directions(height: torch.Tensor, is_seed: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Code 0..6 of each voxel's steepest-descent target (0 = self):
    lexicographic min of ``(height, flat_index)`` over the closed
    6-neighbourhood; seeds and invalid voxels are terminals."""
    shape = height.shape
    n = int(np.prod(shape))
    dev = height.device
    idx = torch.arange(n, dtype=torch.int32, device=dev).reshape(shape)
    h = torch.where(valid, height.to(torch.float32), _BIGF)
    best_h, best_i = h, idx
    best_d = torch.zeros(shape, dtype=torch.int32, device=dev)
    for code, off in enumerate(WS_OFFS, start=1):
        nh, ni = h, idx
        for ax, s in enumerate(off):
            if s:
                nh = _shift(nh, -s, ax, _BIGF)
                ni = _shift(ni, -s, ax, n)
        better = (nh < best_h) | ((nh == best_h) & (ni < best_i))
        best_h = torch.where(better, nh, best_h)
        best_i = torch.where(better, ni, best_i)
        best_d = torch.where(better, code, best_d)
    return torch.where(is_seed | ~valid, 0, best_d).to(torch.int32).contiguous()


def _strip_entries(values: torch.Tensor, tile, axis: int, side: int):
    """(value, tile_id) arrays for one family of tile-boundary slabs."""
    t = tile[axis]
    n = values.shape[axis]
    start = 0 if side == 0 else t - 1
    sl = _stride_slice(values, start, n, t, axis)
    shape = sl.shape
    dev = values.device
    ids = []
    for ax in range(3):
        view = [1, 1, 1]
        view[ax] = shape[ax]
        io = torch.arange(shape[ax], dtype=torch.int32, device=dev).reshape(view)
        ids.append(io if ax == axis else io // tile[ax])
    _, y, x = values.shape
    gy, gx = y // tile[1], x // tile[2]
    tid = ((ids[0] * gy + ids[1]) * gx + ids[2]).expand(shape)
    return sl, tid


def collect_negative_values(values: torch.Tensor, tile, cap: int, tier: str = "cond"):
    """Deduped (value, tile_id) pairs for negative labels on tile
    boundaries; returns ``(vals, tids, overflow)``."""
    vs, ts = [], []
    overflow = _i32(0, values)
    n_total = _i32(0, values)
    for axis in range(3):
        for side in (0, 1):
            sl, tid = _strip_entries(values, tile, axis, side)
            fam_cap = max(1024, min(cap, sl.numel()))
            neg = sl <= -2
            dedup_axis = 2 if axis != 2 else 1
            prev = _shift1(sl, dedup_axis, -1)
            prev_t = _shift1(tid, dedup_axis, -1)
            keep = neg & ((sl != prev) | (tid != prev_t))
            (v, t_), kept = _compact(keep, (sl, tid), fam_cap, BIG)
            overflow = torch.maximum(overflow, (kept > fam_cap).to(torch.int32))
            n_total = n_total + torch.clamp(kept, max=fam_cap)
            vs.append(v)
            ts.append(t_)
    v = torch.cat(vs)
    t_ = torch.cat(ts)
    cv, ct, n_kept = run_capacity_tiered(
        (v, t_), n_total, cap, _collect_core, 2, 0, tier,
        # the last output is a COUNT checked against ``cap`` below
        trunc_fold=lambda n, trunc: torch.where(trunc > 0, cap + 1, n),
    )
    overflow = torch.maximum(overflow, (n_kept > cap).to(torch.int32))
    return cv, ct, bool(overflow > 0)


def _collect_core(v, t_, cap, _max_rounds):
    """Sort-dedup one (value, tile) tier; outputs sized ``cap``."""
    order = _lexsort(v, t_)
    v, t_ = v[order], t_[order]
    dup = (v == _shift1(v, 0, BIG)) & (t_ == _shift1(t_, 0, BIG))
    keep = (~dup) & (v < BIG)
    (cv, ct), n_kept = _compact(keep, (v, t_), cap, BIG)
    return cv, ct, n_kept


def value_join(query_vals, table_vals, table_finals, tier: str = "cond"):
    """For each query value, the table's final (or the query itself if
    absent) — a sort-based join, tiered like the reference's."""
    nq = query_vals.shape[0]
    nt = table_vals.shape[0]
    small_q = max(16384, nq // 16)
    small_t = max(16384, nt // 16)
    # tier "small" keeps the cond: value_join has no overflow channel
    if tier == "big":
        return _value_join_core(query_vals, table_vals, table_finals)
    if small_q < nq and small_t < nt:
        n_q = int((query_vals < BIG).sum())
        n_t = int((table_vals < BIG).sum())
        if n_q <= small_q and n_t <= small_t:
            dev = query_vals.device
            (cq, slots), _ = _compact(
                query_vals < BIG,
                (query_vals, torch.arange(nq, dtype=torch.int32, device=dev)),
                small_q, BIG,
            )
            (ctv, ctf), _ = _compact(table_vals < BIG, (table_vals, table_finals), small_t, BIG)
            res = _value_join_core(cq, ctv, ctf)
            return _scatter_set(query_vals, slots, res)
    return _value_join_core(query_vals, table_vals, table_finals)


def _value_join_core(query_vals, table_vals, table_finals):
    nq = query_vals.shape[0]
    nt = table_vals.shape[0]
    dev = query_vals.device
    keys = torch.cat([table_vals, query_vals])
    is_query = torch.cat([
        torch.zeros((nt,), dtype=torch.int32, device=dev),
        torch.ones((nq,), dtype=torch.int32, device=dev),
    ])
    payload = torch.cat([table_finals, query_vals])
    slot = torch.cat([
        torch.full((nt,), -1, dtype=torch.int32, device=dev),
        torch.arange(nq, dtype=torch.int32, device=dev),
    ])
    order = _lexsort(keys, is_query)
    keys, is_query, payload, slot = keys[order], is_query[order], payload[order], slot[order]
    pos = torch.arange(nt + nq, dtype=torch.int32, device=dev)
    last_tbl = torch.cummax(torch.where(is_query == 0, pos, -1), 0).values
    at = torch.clamp(last_tbl, 0, nt + nq - 1)
    tbl_key = _take(keys, at)
    tbl_fin = _take(payload, at)
    res = torch.where((last_tbl >= 0) & (tbl_key == keys), tbl_fin, keys)
    out = torch.zeros((nq,), dtype=torch.int32, device=dev)
    return _scatter_set(out, torch.where(is_query == 1, slot, nq), res)


def chase_exits(values: torch.Tensor, codes: torch.Tensor, max_hops: int = 256, tier: str = "cond"):
    """Resolve exit codes by following values across tiles.

    Returns ``(finals, unconverged)``: each code's chain end (seed label,
    0, or its basin's unseeded terminal code), and True when a chain
    exceeded ``max_hops``.
    """
    n = values.numel()
    flat = values.reshape(-1)

    def _core(c):
        active0 = c <= -2
        g = torch.where(active0, -c - 2, 0)
        val = torch.where(active0, _take(flat, torch.clamp(g, 0, n - 1)), c)
        moved, hops = True, 0
        while moved and hops < max_hops:
            active = (val <= -2) & (val != -g - 2)
            g = torch.where(active, -val - 2, g)
            val = torch.where(active, _take(flat, torch.clamp(g, 0, n - 1)), val)
            moved = bool(active.any())
            hops += 1
        return torch.where(active0, val, c), moved

    cap = codes.shape[0]
    small_n = max(16384, cap // 16)
    if small_n >= cap or tier == "big":
        return _core(codes)

    def _small(c):
        (pc, slots), _ = _compact(
            c <= -2, (c, torch.arange(cap, dtype=torch.int32, device=c.device)), small_n, BIG
        )
        fin_s, moved = _core(pc)
        # non-active codes map to themselves; padded slots (BIG) drop
        return _scatter_set(c, slots, fin_s), moved

    n_active = int((codes <= -2).sum())
    if tier == "small":
        fin, moved = _small(codes)
        return fin, moved or (n_active > small_n)
    if n_active <= small_n:
        return _small(codes)
    return _core(codes)


def _resolve_codes_gather(values: torch.Tensor, codes, finals) -> torch.Tensor:
    """Gather rung: scatter code resolutions into a voxel-indexed table."""
    n = values.numel()
    table = -torch.arange(n, dtype=torch.int32, device=values.device) - 2
    pos = torch.where(codes <= -2, -codes - 2, n)
    table = _scatter_set(table, pos, finals)
    flat = values.reshape(-1)
    looked = _take(table, torch.clamp(-flat - 2, 0, n - 1))
    return torch.where(flat <= -2, looked, flat).reshape(values.shape)


def fill_unseeded_basins(labels, height, fill_cap: int = DEFAULT_FILL_CAP,
                         max_rounds: Optional[int] = None, adj_cap: Optional[int] = None,
                         tier: str = "cond"):
    """Merge unseeded basins across their lowest saddles (Boruvka rounds on
    the compacted basin-boundary edge list).  Returns ``(edge_vals,
    edge_finals, overflow)``: old basin code -> final label (0 if
    unreachable) for every unseeded basin seen on a boundary."""
    if max_rounds is None:
        max_rounds = _auto_fill_rounds(labels.numel())
    h = height.to(torch.float32)
    evs_a, evs_b, evs_h = [], [], []
    overflow = _i32(0, labels)
    n_total = _i32(0, labels)
    for axis in range(3):
        na = labels.shape[axis]
        a = labels.narrow(axis, 0, na - 1)
        b = labels.narrow(axis, 1, na - 1)
        ha = h.narrow(axis, 0, na - 1)
        hb = h.narrow(axis, 1, na - 1)
        saddle = _sortable_float_key(torch.maximum(ha, hb))
        flag = (a != b) & (a != 0) & (b != 0) & ((a < 0) | (b < 0))
        dedup_axis = 2 if axis != 2 else 1
        keep = flag & ((a != _shift1(a, dedup_axis, 0)) | (b != _shift1(b, dedup_axis, 0)))
        (pa, pb, ph), kept = _compact(keep, (a, b, saddle), fill_cap, BIG)
        overflow = torch.maximum(overflow, (kept > fill_cap).to(torch.int32))
        n_total = n_total + torch.clamp(kept, max=fill_cap)
        evs_a.append(pa)
        evs_b.append(pb)
        evs_h.append(ph)
    a = torch.cat(evs_a)
    b = torch.cat(evs_b)
    hk = torch.cat(evs_h)
    if adj_cap is None:
        adj_cap = min(3 * fill_cap, max(DEFAULT_ADJ_CAP, labels.numel() // 32))
    edge_vals, edge_finals, core_overflow = run_capacity_tiered(
        (a, b, hk), n_total, adj_cap, _fill_core, 2, max_rounds, tier
    )
    overflow = torch.maximum(overflow, core_overflow)
    return edge_vals, edge_finals, bool(overflow > 0)


def _fill_core(a, b, hk, adj_cap, max_rounds):
    """Dedup + dense ids + Boruvka rounds over one capacity tier; outputs
    sized ``2 * adj_cap``, overflow as int32."""
    dev = a.device
    overflow = _i32(0, a)
    # unique (a, b) adjacencies with their min saddle
    order = _lexsort(a, b, hk)
    sa, sb, sh = a[order], b[order], hk[order]
    first = (sa != _shift1(sa, 0, BIG)) | (sb != _shift1(sb, 0, BIG))
    keep_adj = first & (sa < BIG)
    (a, b, hk), n_adj = _compact(keep_adj, (sa, sb, sh), adj_cap, BIG)
    overflow = torch.maximum(overflow, (n_adj > adj_cap).to(torch.int32))

    # dense ids over all endpoint values
    m2 = a.shape[0] * 2
    vals = torch.cat([a, b])
    sv, ss = torch.sort(vals, stable=True)
    is_new = sv != _shift1(sv, 0, -BIG)
    rank = _cumsum_i32(is_new) - 1
    uniq = _scatter_set(torch.full((m2,), BIG, dtype=torch.int32, device=dev), rank, sv)
    dense = torch.zeros((m2,), dtype=torch.int32, device=dev)
    dense[ss] = rank
    da, db = dense[: a.shape[0]], dense[a.shape[0]:]
    edge_pad = a >= BIG

    parent = torch.arange(m2, dtype=torch.int32, device=dev)
    eid = torch.arange(a.shape[0], dtype=torch.int32, device=dev)
    me = torch.arange(m2, dtype=torch.int32, device=dev)
    changed, it = True, 0
    while changed and it < max_rounds:
        P = parent
        ra = _take(P, da)
        rb = _take(P, db)
        alive = (ra != rb) & (~edge_pad)
        # orient every edge both ways; only negative-valued roots hook
        live_a = alive & (_take(uniq, ra) <= -2)
        live_b = alive & (_take(uniq, rb) <= -2)
        np_ = m2
        best_h = torch.full((np_,), _I32MAX, dtype=torch.int32, device=dev)
        best_h = _scatter_min(best_h, torch.where(live_a, ra, np_), hk)
        best_h = _scatter_min(best_h, torch.where(live_b, rb, np_), hk)
        tie_a = live_a & (_take(best_h, ra) == hk)
        tie_b = live_b & (_take(best_h, rb) == hk)
        best_e = torch.full((np_,), _I32MAX, dtype=torch.int32, device=dev)
        best_e = _scatter_min(best_e, torch.where(tie_a, ra, np_), eid)
        best_e = _scatter_min(best_e, torch.where(tie_b, rb, np_), eid)
        win_a = tie_a & (_take(best_e, ra) == eid)
        win_b = tie_b & (_take(best_e, rb) == eid)
        parent2 = me
        parent2 = _scatter_set(parent2, torch.where(win_a, ra, np_), torch.where(win_a, rb, 0))
        parent2 = _scatter_set(parent2, torch.where(win_b, rb, np_), torch.where(win_b, ra, 0))
        # break 2-cycles: the lower id stays a root
        pp = parent2[parent2.long()]
        parent2 = torch.where((pp == me) & (me < parent2), me, parent2)
        parent2 = compress(parent2)
        newP = parent2[P.long()]
        changed = bool((newP != P).any())
        parent = newP
        it += 1
    # a max_rounds exit leaves basins mid-chain: report, never hide
    overflow = torch.maximum(overflow, _i32(int(changed), a))
    root_val = _take(uniq, parent)
    final_of = torch.where(root_val > 0, root_val, 0)
    edge_vals = uniq
    edge_finals = torch.where(uniq <= -2, final_of, uniq)
    return edge_vals, edge_finals, overflow


def fill_unseeded_basins_dense(values, height, max_rounds: Optional[int] = None,
                               face_cap: Optional[int] = None):
    """Sort-free unseeded-basin fill: face-list scatter-min Boruvka rounds
    with exact per-pair min saddles.  ``values``: >0 seeded, <= -2 unseeded
    terminal code, 0 invalid, -1 masked/padded (a hookable neighbour).
    Returns ``(resolved_values, overflow)``."""
    shape = values.shape
    n = int(np.prod(shape))
    dev = values.device
    v = values.reshape(-1)
    h = _sortable_float_key(height.to(torch.float32)).reshape(-1)
    if face_cap is None:
        face_cap = min(1 << 24, max(1 << 16, n // 6))
    if max_rounds is None:
        max_rounds = _auto_fill_rounds(n)

    P0 = -torch.arange(n, dtype=torch.int32, device=dev) - 2

    def resolve_flat(P, x):
        return torch.where(x <= -2, _take(P, torch.clamp(-x - 2, 0, n - 1)), x)

    flat_idx = torch.arange(n, dtype=torch.int32, device=dev)
    trunc = 0
    faces = []
    for axis in range(3):
        nb = _shift(values, -1, axis, 0).reshape(-1)
        ok0 = (v != nb) & (v != 0) & (nb != 0) & ((v <= -2) | (nb <= -2))
        (idx_c,), n_faces = _compact(ok0, (flat_idx,), face_cap, n)
        trunc = max(trunc, int(n_faces > face_cap))
        stride = int(np.prod(shape[axis + 1:], dtype=np.int64))
        pad = idx_c >= n
        ia = torch.clamp(idx_c, 0, n - 1)
        ib = torch.clamp(idx_c + stride, 0, n - 1)
        va = torch.where(pad, 0, _take(v, ia))
        vb = torch.where(pad, 0, _take(v, ib))
        sad = torch.maximum(_take(h, ia), _take(h, ib))
        eid = torch.where(pad, _I32MAX, axis * n + idx_c)
        faces.append((va, vb, sad, eid, pad))
    me_idx = torch.arange(n, dtype=torch.int32, device=dev)

    P = P0
    changed, it = True, 0
    while changed and it < max_rounds:
        best_h = torch.full((n,), _I32MAX, dtype=torch.int32, device=dev)
        best_e = torch.full((n,), _I32MAX, dtype=torch.int32, device=dev)
        sides = []
        for va, vb, sad, eid, pad in faces:
            ra = resolve_flat(P, va)
            rb = resolve_flat(P, vb)
            live = ~pad & (ra != rb)
            sides.append((ra, rb, sad, live, eid))
            sides.append((rb, ra, sad, live, eid))
        for src, dst, sad, live, eid in sides:
            m = live & (src <= -2)
            best_h = _scatter_min(best_h, torch.where(m, -src - 2, n), torch.where(m, sad, _I32MAX))
        for src, dst, sad, live, eid in sides:
            m = live & (src <= -2)
            tie = m & (_take(best_h, torch.clamp(-src - 2, 0, n - 1)) == sad)
            best_e = _scatter_min(best_e, torch.where(tie, -src - 2, n), torch.where(tie, eid, _I32MAX))
        P2 = P
        for src, dst, sad, live, eid in sides:
            m = live & (src <= -2)
            gsafe = torch.clamp(-src - 2, 0, n - 1)
            win = m & (_take(best_h, gsafe) == sad) & (_take(best_e, gsafe) == eid)
            P2 = _scatter_set(P2, torch.where(win, -src - 2, n), torch.where(win, dst, 0))
        # break 2-cycles: the smaller terminal index stays a root
        tgt = torch.clamp(-P2 - 2, 0, n - 1)
        mutual = (P2 <= -2) & (_take(P2, tgt) == (-me_idx - 2)) & (me_idx < tgt)
        P2 = torch.where(mutual, -me_idx - 2, P2)
        # pointer-jump to closure
        while True:
            p3 = resolve_flat(P2, P2)
            if not bool((p3 != P2).any()):
                break
            P2 = p3
        changed = bool((P2 != P).any())
        P = P2
        it += 1
    resolved = resolve_flat(P, v).reshape(shape)
    return resolved, bool(changed) or bool(trunc)


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


def _ws_flow_core(height, seeds, mask, *, impl, tile, exit_cap, table_cap, tier):
    """Flow phase: tile-pad, descent directions, in-tile flow (B2), exit
    chase + remap (B4 or the gather rung).  Returns ``(values, h,
    overflow)`` at tile-padded shape: >0 seeded label, <= -2 unseeded
    terminal code, -1 masked/padded."""
    if height.dim() != 3:
        raise ValueError("seeded_watershed_tiled expects a 3-D volume")
    z, y, x = height.shape
    tile, (zp, yp, xp), exit_cap, _ = _ws_static_plan(height.shape, tile, exit_cap, 0)
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

    dirs = descent_directions(h, s > 0, valid)
    sv = torch.where(valid, s, -1).to(torch.int32).contiguous()
    values = tile_ws_propagate(dirs, sv, tile=tile, impl=impl)
    del dirs, sv

    # cross-tile exits: collect, chase, remap
    codes, code_tiles, overflow = collect_negative_values(values, tile, exit_cap, tier)
    finals, chase_unconverged = chase_exits(values, codes, tier=tier)
    overflow = overflow or chase_unconverged
    n_tiles = (zp // tz) * (yp // ty) * (xp // tx)
    changed = (codes <= -2) & (finals != codes)
    tids = torch.where(changed, code_tiles, BIG)
    old_tbl, new_tbl, tbl_overflow = build_remap_tables(tids, codes, finals, n_tiles, table_cap=table_cap, tier=tier)
    if tbl_overflow:
        RUNGS["flow:gather"] += 1
        values = _resolve_codes_gather(values, codes, finals)
    else:
        RUNGS["flow:table"] += 1
        values = apply_remap(values, old_tbl, new_tbl, tile=tile, cap=table_cap, impl=impl)
    return values, h, overflow


def _ws_fill_core(values, h, orig_shape, *, impl, tile, exit_cap, fill_cap, table_cap,
                  adj_cap, fill_rounds, fill_mode, tier):
    """Fill phase: unseeded-basin fill across lowest saddles, remap (B4 or
    the gather rung), leftovers to 0, crop the tile padding."""
    z, y, x = orig_shape
    tile, (zp, yp, xp), exit_cap, fill_cap = _ws_static_plan(orig_shape, tile, exit_cap, fill_cap)
    tz, ty, tx = tile
    padded = (zp, yp, xp) != (z, y, x)
    if tuple(values.shape) != (zp, yp, xp):
        raise ValueError(f"fill phase expects tile-padded values {(zp, yp, xp)}, got {tuple(values.shape)}")
    if fill_rounds is None:
        fill_rounds = _auto_fill_rounds(zp * yp * xp)
    if fill_mode == "dense":
        values, overflow = fill_unseeded_basins_dense(values, h, max_rounds=fill_rounds)
        out = torch.where(values > 0, values, 0).to(torch.int32)
        if padded:
            out = out[:z, :y, :x]
        return out.contiguous(), overflow
    fill_vals, fill_finals, overflow = fill_unseeded_basins(
        values, h, fill_cap=fill_cap, max_rounds=fill_rounds, adj_cap=adj_cap, tier=tier
    )
    n_tiles = (zp // tz) * (yp // ty) * (xp // tx)
    # tiles needing a basin's entry: strip incidences + the terminal's tile
    bvals, btiles, b_overflow = collect_negative_values(values, tile, exit_cap, tier)
    overflow = overflow or b_overflow
    bfin = value_join(bvals, fill_vals, fill_finals, tier)
    tvals = fill_vals
    t_of = _tile_id_of(torch.where(tvals <= -2, -tvals - 2, 0), (zp, yp, xp), tile)
    ttiles = torch.where(tvals <= -2, t_of, BIG)
    all_vals = torch.cat([bvals, tvals])
    all_fin = torch.cat([bfin, torch.where(tvals <= -2, fill_finals, tvals)])
    all_tiles = torch.cat([
        torch.where((bvals <= -2) & (bfin != bvals), btiles, BIG),
        torch.where((tvals <= -2) & (fill_finals != tvals), ttiles, BIG),
    ])
    old2, new2, tbl_overflow2 = build_remap_tables(all_tiles, all_vals, all_fin, n_tiles, table_cap=table_cap, tier=tier)
    if tbl_overflow2:
        RUNGS["fill:gather"] += 1
        values = _resolve_codes_gather(values, fill_vals, fill_finals)
    else:
        RUNGS["fill:table"] += 1
        values = apply_remap(values, old2, new2, tile=tile, cap=table_cap, impl=impl)
    # leftover negatives (basins with no seeded reachable neighbour) -> 0
    out = torch.where(values > 0, values, 0).to(torch.int32)
    if padded:
        out = out[:z, :y, :x]
    return out.contiguous(), overflow


def seeded_watershed_tiled_tensor(height, seeds, mask=None, *, impl="auto", tile=None,
                                  exit_cap=None, fill_cap=None, table_cap=DEFAULT_TABLE_CAP,
                                  adj_cap=None, fill_rounds=None, fill_mode=None, tier="cond"):
    """:func:`seeded_watershed_tiled` on tensors, on their own device."""
    impl = resolve_impl(impl, height)
    fill_mode = resolve_fill_mode(fill_mode, height.device)
    values, h, flow_overflow = _ws_flow_core(
        height, seeds, mask, impl=impl, tile=tile, exit_cap=exit_cap,
        table_cap=table_cap, tier=tier,
    )
    out, fill_overflow = _ws_fill_core(
        values, h, tuple(height.shape), impl=impl, tile=tile, exit_cap=exit_cap,
        fill_cap=fill_cap, table_cap=table_cap, adj_cap=adj_cap,
        fill_rounds=fill_rounds, fill_mode=fill_mode, tier=tier,
    )
    return out, flow_overflow or fill_overflow


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
    """Label seed plateaus: ``tiled`` (the two-level CCL) or ``sparse``."""
    if mode == "sparse":
        return label_components_sparse_tensor(maxima, cap=seed_cap)
    return label_components_tiled_tensor(
        maxima, impl=impl, tile=tile, pair_cap=pair_cap, edge_cap=edge_cap,
        table_cap=table_cap, tier=tier, site="seeds",
    )


def _dt_seeds_core(boundaries, mask, *, threshold, min_seed_distance, sampling,
                   dt_max_distance, impl, tile, pair_cap, edge_cap, table_cap, seed_cap,
                   seed_mode, tier, sigma_seeds=0.0):
    """Seed phase: threshold -> capped EDT (B3) -> optional smoothing ->
    maxima plateaus -> seed CCL.  Returns ``(seeds, valid, overflow)`` at
    the input shape."""
    from .edt import distance_transform_squared_tensor
    from .filters import gaussian_smooth_tensor
    from .watershed import local_maxima_tensor

    dev = boundaries.device
    valid = torch.ones(boundaries.shape, dtype=torch.bool, device=dev) if mask is None else mask.to(torch.bool)
    fg = (boundaries < torch.tensor(threshold, dtype=torch.float32, device=dev)) & valid
    dist = distance_transform_squared_tensor(fg, sampling=sampling, max_distance=dt_max_distance, impl=impl)
    if sigma_seeds > 0:
        dist = gaussian_smooth_tensor(dist, sigma_seeds, sampling=sampling)
    msd2 = torch.tensor(np.float32(min_seed_distance * min_seed_distance), device=dev)
    maxima = local_maxima_tensor(dist, 1) & fg & (dist >= msd2)
    del dist
    raw, seed_overflow = _seed_ccl(
        maxima, seed_cap, mode=seed_mode, impl=impl, tile=tile, pair_cap=pair_cap,
        edge_cap=edge_cap, table_cap=table_cap, tier=tier,
    )
    n = boundaries.numel()
    seeds = torch.where(raw == n, 0, raw + 1).to(torch.int32)
    return seeds, valid, seed_overflow


def _dt_watershed_core(b, ext, m, *, threshold, sigma_seeds, min_seed_distance, sampling,
                       dt_max_distance, impl, tile, pair_cap, edge_cap, exit_cap, fill_cap,
                       table_cap, seed_cap, adj_cap, fill_rounds, fill_mode, seed_mode, tier_mode):
    """The DT watershed on tensors: internal seeds, external seeds (if
    any) at ``+N`` over them, then the seeded flood."""
    impl = resolve_impl(impl, b)
    tier = resolve_tier_mode(tier_mode)
    seeds, valid, seed_overflow = _dt_seeds_core(
        b, m, threshold=threshold, sigma_seeds=sigma_seeds, min_seed_distance=min_seed_distance,
        sampling=sampling, dt_max_distance=dt_max_distance, impl=impl, tile=tile,
        pair_cap=pair_cap, edge_cap=edge_cap, table_cap=table_cap, seed_cap=seed_cap,
        seed_mode=resolve_seed_mode(seed_mode), tier=tier,
    )
    if ext is not None:
        # external seeds dominate; internal ids live in 1..N, external in N+1..
        seeds = torch.where(ext > 0, ext + b.numel(), seeds)
    labels, ws_overflow = seeded_watershed_tiled_tensor(
        b, seeds, valid, impl=impl, tile=tile, exit_cap=exit_cap, fill_cap=fill_cap,
        table_cap=table_cap, adj_cap=adj_cap, fill_rounds=fill_rounds,
        fill_mode=fill_mode, tier=tier,
    )
    return labels, seed_overflow or ws_overflow


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
