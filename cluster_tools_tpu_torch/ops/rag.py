"""Region-adjacency-graph extraction.

Port of ``cluster_tools_tpu/ops/rag.py``: per-block RAG extraction from a
label volume, plus per-edge statistics of a boundary map.  The reference
runs the scan and the dedup as XLA programs (no Pallas kernel), so they
port as PyTorch on the block's device: every axis-adjacent voxel pair with
two different non-zero labels gives ``(min, max, max(value, value))``, one
stable sort over a 64-bit ``(lo << 32) | hi`` key groups the pairs of an
edge, and segmented reductions give each edge's count, sum, min, max and
second moment.  Outputs are sized from the data (the reference's static
``edge_cap`` and its doubling loop are not needed in torch).

Summation order: the pairs of an edge are summed in float32, one after the
other, in the order of the stable sort (axis 0 pairs first, then 1, then
2, each in C order) -- the order in which the reference's ``segment_sum``
adds them on the CPU.  ``torch.segment_reduce`` takes one sequential loop
a segment for 2-D data on both devices (its 1-D CUDA path is a tree
reduction), so the sums are reduced as columns of a 2-D tensor and do
not depend on the device or the run.  The variance's shift (the mean of all
pair values) is a plain ``sum`` and may differ by ulps between devices.

Halo convention for blockwise extraction: each block is read with a +1
voxel halo on its *upper* faces only.  For the scan along axis ``a`` the
input is sliced to the inner extent along every other axis and inner+1
along ``a``, so every voxel-face pair of the volume is owned by exactly one
block and per-edge counts add up correctly across blocks.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..device import as_tensor, resolve_device

# per-edge accumulated statistics, in column order
FEATURE_NAMES = ("mean", "min", "max", "count", "variance")


def _scan_bb(inner, shape, axis):
    """The block-ownership halo convention: inner+1 along the scan axis,
    inner along the others."""
    return tuple(
        slice(0, min(inner[d] + 1, shape[d])) if d == axis else slice(0, inner[d]) for d in range(len(shape))
    )


def axis_edge_scan(seg: torch.Tensor, values: Optional[torch.Tensor], axis: int, with_values: bool = False):
    """Scan adjacent voxel pairs along one axis.

    For every pair ``(x, x+e_axis)`` with two *different, non-zero* labels,
    emits the pair (as min/max) and, if ``with_values``, the boundary value
    ``max(values[x], values[x+e_axis])``.  Returns flat ``(lo, hi, val,
    valid)`` over all ``prod(shape)/shape[axis]*(shape[axis]-1)`` pairs;
    invalid slots have ``lo == hi == 0``.
    """
    n = seg.shape[axis]
    u = seg.narrow(axis, 0, max(n - 1, 0)).reshape(-1)
    v = seg.narrow(axis, min(1, n), max(n - 1, 0)).reshape(-1)
    valid = (u != v) & (u != 0) & (v != 0)
    lo = torch.where(valid, torch.minimum(u, v), 0)
    hi = torch.where(valid, torch.maximum(u, v), 0)
    if with_values:
        va = values.narrow(axis, 0, max(n - 1, 0)).reshape(-1)
        vb = values.narrow(axis, min(1, n), max(n - 1, 0)).reshape(-1)
        val = torch.where(valid, torch.maximum(va, vb), 0)
    else:
        val = torch.zeros(lo.shape, dtype=torch.float32, device=seg.device)
    return lo, hi, val, valid


def device_edge_aggregate(seg: torch.Tensor, values: Optional[torch.Tensor], with_values: bool = True,
                          inner_shape: Optional[Tuple[int, ...]] = None):
    """Sorted, deduplicated RAG edges + per-edge stats on ``seg``'s device.

    ``seg``: non-negative int32 labels (0 = background); callers with
    uint64 ids densify first.  Returns ``(lo, hi, count, vsum, vsumsq,
    vmin, vmax, shift, n_edges)``, each of length ``n_edges`` (lo/hi int32
    in ascending ``(lo, hi)`` order, count int64, stats float32);
    ``vsumsq`` is the second moment about ``shift``, the mean of all the
    block's pair values (values clustered away from 0 would cancel
    catastrophically in ``E[x^2] - mean^2``).
    """
    inner = tuple(inner_shape) if inner_shape is not None else tuple(seg.shape)
    los, his, vals = [], [], []
    for axis in range(seg.dim()):
        bb = _scan_bb(inner, seg.shape, axis)
        lo, hi, val, valid = axis_edge_scan(seg[bb], None if values is None else values[bb], axis, with_values)
        los.append(lo[valid])
        his.append(hi[valid])
        if with_values:
            vals.append(val[valid])
    key = (torch.cat(los).long() << 32) | torch.cat(his).long()
    key, order = torch.sort(key, stable=True)
    uniq, count = torch.unique_consecutive(key, return_counts=True)
    n_edges = int(uniq.numel())
    out_lo = (uniq >> 32).int()
    out_hi = (uniq & 0xFFFFFFFF).int()
    f32 = dict(dtype=torch.float32, device=seg.device)
    if not with_values or n_edges == 0:
        z = torch.zeros(n_edges, **f32)
        return out_lo, out_hi, count, z, z, z, z, torch.zeros((), **f32), n_edges
    val = torch.cat(vals).float()[order]
    shift = val.sum() / max(val.numel(), 1)
    d = val - shift
    # one [n, 2] reduction: the sequential per-segment loop (see module docstring)
    vsum, vsumsq = torch.segment_reduce(torch.stack([val, d * d], 1), "sum", lengths=count).unbind(1)
    vmin = torch.segment_reduce(val, "min", lengths=count)
    vmax = torch.segment_reduce(val, "max", lengths=count)
    return out_lo, out_hi, count, vsum, vsumsq, vmin, vmax, shift, n_edges


def _densify_on(seg: np.ndarray, dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Densify a label block to int32 ids on ``dev``: returns ``(dense
    int32, table int64)`` with ``table[dense] == seg`` (as int64 bits) and
    ``table[0] == 0`` (background keeps slot 0).  The sign bit is flipped
    before the sort, which orders uint64 labels (even those of 2^63 or
    more) as unsigned and puts label 0 first."""
    seg = np.ascontiguousarray(seg)
    bits = seg.view(np.int64) if seg.dtype == np.uint64 else seg.astype(np.int64, copy=False)
    flip = torch.iinfo(torch.int64).min
    uniq, inv = torch.unique(as_tensor(bits, dev) ^ flip, return_inverse=True)
    if uniq.numel() == 0 or int(uniq[0]) != flip:
        uniq = torch.cat([torch.full((1,), flip, dtype=uniq.dtype, device=dev), uniq])
        inv = inv + 1
    if uniq.numel() >= 2**31:
        raise ValueError("block has too many labels for int32 densification")
    return inv.int(), uniq ^ flip


def device_rag_costs(seg: torch.Tensor, values: torch.Tensor, beta: float,
                     inner_shape: Optional[Tuple[int, ...]] = None):
    """RAG -> costs -> dense node remap on ``seg``'s device.

    Extends :func:`device_edge_aggregate` with the ``probs_to_costs``
    transform (``tasks/costs.py``) of each edge's mean boundary value, in
    float32, and the dense node compaction of the edge endpoints.  Returns
    ``(node_table, n_nodes, lo_dense, hi_dense, costs, count, mean,
    n_edges)``: ``node_table`` maps dense node ids to ``seg`` labels.
    """
    lo, hi, count, vsum, _, _, _, _, n_edges = device_edge_aggregate(seg, values, True, inner_shape)
    mean = vsum / count.clamp_min(1).float()
    eps = 1e-5
    p = mean.clamp(eps, 1.0 - eps)
    b = torch.tensor(beta, dtype=torch.float32, device=seg.device).clamp(eps, 1.0 - eps)
    costs = torch.log((1.0 - p) / p) + torch.log((1.0 - b) / b)
    node_table, inv = torch.unique(torch.cat([lo, hi]), return_inverse=True)
    return node_table, int(node_table.numel()), inv[:n_edges], inv[n_edges:], costs, count, mean, n_edges


def block_rag_fused(seg: np.ndarray, values: np.ndarray, beta: float = 0.5,
                    inner_shape: Optional[Sequence[int]] = None, device=None):
    """Solver-ready block problem straight from the label volume.

    :func:`device_rag_costs` on ``device`` extracts the RAG, deduplicates
    edges, turns mean boundary values into signed multicut costs and
    compacts node ids; the host sees only edge-scale arrays.  Labels that
    do not fit int32 are densified first.

    Returns ``(nodes, edges, costs, sizes, mean)``: ``nodes`` the original
    labels (dense index -> label, ascending), ``edges`` int64 [m, 2] in
    dense indices, ``costs`` float32, ``sizes`` int64 contact counts,
    ``mean`` float32 mean boundary value.
    """
    if seg.ndim != 3:
        raise ValueError("block_rag_fused expects a 3-D block")
    dev = resolve_device(device)
    inner = tuple(inner_shape) if inner_shape is not None else seg.shape
    table = None
    if seg.dtype.kind not in "iu" or (
        np.iinfo(seg.dtype).max >= np.iinfo(np.int32).max and seg.size and int(seg.max()) >= np.iinfo(np.int32).max
    ):
        seg_t, table = _densify_on(seg, dev)
    else:
        seg_t = as_tensor(seg.astype(np.int32, copy=False), dev)
    node_table, _, lo, hi, costs, count, mean, _ = device_rag_costs(
        seg_t, as_tensor(values, dev, torch.float32), float(beta), inner)
    if table is None:
        nodes = node_table.long().cpu().numpy()
    else:
        # densified: the original labels, in their own dtype
        nodes = table[node_table.long()].cpu().numpy()
        nodes = nodes.view(np.uint64) if seg.dtype == np.uint64 else nodes.astype(seg.dtype)
    return (
        nodes,
        torch.stack([lo, hi], 1).long().cpu().numpy(),
        costs.cpu().numpy(),
        count.long().cpu().numpy(),
        mean.cpu().numpy(),
    )


def block_rag(seg: np.ndarray, values: Optional[np.ndarray] = None, inner_shape: Optional[Sequence[int]] = None,
              return_nodes: bool = False, device=None):
    """Extract the RAG of one block: unique undirected edges + edge sizes
    (+ per-edge boundary statistics if ``values`` given).

    ``seg`` may include a +1 upper-face halo; pass the halo-free extent as
    ``inner_shape`` (module halo convention).

    Returns ``(uv, sizes, feats)``: ``uv`` uint64 [m, 2] lexsorted with
    ``uv[:, 0] < uv[:, 1]`` and label 0 excluded, ``sizes`` int64 voxel-face
    contacts per edge, ``feats`` float32 [m, 5] (:data:`FEATURE_NAMES`) or
    None.  With ``return_nodes`` a fourth element is appended: the sorted
    unique non-zero labels of the inner region.

    3-D blocks run on ``device`` (:func:`device_edge_aggregate`); other
    ranks take the host path (:func:`_block_rag_host`, the oracle).
    """
    inner = tuple(inner_shape) if inner_shape is not None else seg.shape
    if seg.ndim == 3:
        return _block_rag_device(seg, values, inner, return_nodes=return_nodes, device=device)
    out = _block_rag_host(seg, values, inner)
    if return_nodes:
        nodes = np.unique(np.asarray(seg[tuple(slice(0, s) for s in inner)]))
        out = out + (nodes[nodes != 0],)
    return out


def unique_pair_counts(pairs: np.ndarray):
    """``np.unique(pairs, axis=0, return_counts=True)`` for ``[m, 2]``
    non-negative integer rows, through one 64-bit key when both columns fit
    in 32 bits (same rows, same order), else the structured sort.  Returns
    ``(rows, counts)``; rows keep ``pairs``' dtype."""
    if len(pairs) and int(pairs.max()) < 2**32 and (pairs.dtype.kind == "u" or int(pairs.min()) >= 0):
        uk, counts = np.unique(_packed_keys(pairs), return_counts=True)
        rows = np.stack([uk >> np.uint64(32), uk & np.uint64(0xFFFFFFFF)], axis=1).astype(pairs.dtype)
        return rows, counts
    return np.unique(pairs, axis=0, return_counts=True)


def unique_pairs(pairs: np.ndarray):
    """``np.unique(pairs, axis=0, return_inverse=True)`` for ``[m, 2]``
    non-negative integer rows: through one 64-bit key when both columns
    fit in 32 bits (same rows, same order), else the structured sort.
    Returns ``(rows, inverse)``; rows keep ``pairs``' dtype."""
    if len(pairs) and int(pairs.max()) < 2**32 and (pairs.dtype.kind == "u" or int(pairs.min()) >= 0):
        uk, inv = np.unique(_packed_keys(pairs), return_inverse=True)
        rows = np.stack([uk >> np.uint64(32), uk & np.uint64(0xFFFFFFFF)], axis=1).astype(pairs.dtype)
        return rows, inv.ravel()
    rows, inv = np.unique(pairs, axis=0, return_inverse=True)
    return rows, inv.ravel()


def _block_rag_host(seg: np.ndarray, values: Optional[np.ndarray], inner: Tuple[int, ...]):
    """Host RAG extraction in plain numpy (unique over all adjacent pairs,
    float64 statistics): the oracle of the device path."""
    seg = np.asarray(seg)
    with_values = values is not None
    los, his, vals = [], [], []
    for axis in range(seg.ndim):
        bb = _scan_bb(inner, seg.shape, axis)
        s = seg[bb]
        n = s.shape[axis]
        u = np.take(s, range(0, n - 1), axis=axis).ravel()
        v = np.take(s, range(1, n), axis=axis).ravel()
        valid = (u != v) & (u != 0) & (v != 0)
        los.append(np.minimum(u, v)[valid])
        his.append(np.maximum(u, v)[valid])
        if with_values:
            w = np.asarray(values, np.float32)[bb]
            vals.append(np.maximum(np.take(w, range(0, n - 1), axis=axis).ravel(),
                                   np.take(w, range(1, n), axis=axis).ravel())[valid])
    lo = np.concatenate(los)
    hi = np.concatenate(his)
    if len(lo) == 0:
        feats = np.zeros((0, len(FEATURE_NAMES)), np.float32) if with_values else None
        return np.zeros((0, 2), np.uint64), np.zeros(0, np.int64), feats
    uv, inv = unique_pairs(np.stack([lo, hi], axis=1).astype(np.uint64))
    m = len(uv)
    sizes = np.bincount(inv, minlength=m).astype(np.int64)
    if not with_values:
        return uv, sizes, None
    v = np.concatenate(vals).astype(np.float64)
    s = np.bincount(inv, weights=v, minlength=m)
    sq = np.bincount(inv, weights=v * v, minlength=m)
    mn = np.full(m, np.inf)
    np.minimum.at(mn, inv, v)
    mx = np.full(m, -np.inf)
    np.maximum.at(mx, inv, v)
    mean = s / sizes
    var = np.maximum(sq / sizes - mean * mean, 0.0)
    feats = np.stack([mean, mn, mx, sizes.astype(np.float64), var], axis=1).astype(np.float32)
    return uv, sizes, feats


def _block_rag_device(seg: np.ndarray, values: Optional[np.ndarray], inner: Tuple[int, ...],
                      return_nodes: bool = False, device=None):
    """Device path of :func:`block_rag` (3-D blocks): labels densified on
    the device, aggregated there, mapped back to the original ids."""
    dev = resolve_device(device)
    with_values = values is not None
    dense, uniq = _densify_on(seg, dev)
    vals_t = as_tensor(values, dev, torch.float32) if with_values else None
    lo, hi, count, vsum, vsumsq, vmin, vmax, shift, n = device_edge_aggregate(dense, vals_t, with_values, inner)
    # the table holds the labels' int64 bits: a view restores uint64 ids
    uv = torch.stack([uniq[lo.long()], uniq[hi.long()]], 1).cpu().numpy().view(np.uint64)
    sizes = count.long().cpu().numpy()
    nodes: Tuple = ()
    if return_nodes:
        inner_ids = torch.unique(dense[tuple(slice(0, s) for s in inner)])
        lab = uniq[inner_ids.long()].cpu().numpy()
        lab = lab.view(np.uint64) if seg.dtype == np.uint64 else lab.astype(seg.dtype)
        nodes = (lab[lab != 0],)
    if not with_values:
        return (uv, sizes, None) + nodes
    s = vsum.cpu().numpy().astype(np.float64)
    sq = vsumsq.cpu().numpy().astype(np.float64)
    mean = s / np.maximum(sizes, 1)
    # sq is the second moment about the global shift c:
    # var = E[(x-c)^2] - (mean-c)^2
    c = float(shift)
    var = np.maximum(sq / np.maximum(sizes, 1) - (mean - c) ** 2, 0.0)
    feats = np.stack([mean, vmin.cpu().numpy().astype(np.float64), vmax.cpu().numpy().astype(np.float64),
                      sizes.astype(np.float64), var], axis=1).astype(np.float32)
    return (uv, sizes, feats) + nodes


def merge_edge_lists(edge_lists) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-block ``(uv, sizes)`` lists into one global edge list.

    Returns ``(uv, sizes)`` with unique lexsorted rows; sizes summed across
    blocks (each voxel-face contact is counted by exactly one block).
    """
    edge_lists = list(edge_lists)
    uvs = [uv for uv, _ in edge_lists if len(uv)]
    if not uvs:
        return np.zeros((0, 2), np.uint64), np.zeros(0, np.int64)
    all_sz = np.concatenate([sz for _, sz in edge_lists if len(sz)])
    uv, inv = unique_pairs(np.concatenate(uvs))
    # counts stay exact in float64 (far below 2^53)
    return uv, np.bincount(inv, weights=all_sz, minlength=len(uv)).astype(np.int64)


def merge_feature_lists(uv_global: np.ndarray, parts) -> np.ndarray:
    """Weighted merge of per-block edge features onto the global edge list.

    ``parts`` iterates ``(uv, feats)`` with feats columns
    :data:`FEATURE_NAMES`.  Mean is count-weighted; min/max are reduced;
    counts are summed; variance merges through the streaming (Chan)
    parallel combine (running mean + second moment about it).  Edges absent
    from all parts get zeros.  The sums run in the host C++ rung
    (:func:`..native.merge_edge_features`); the Python path below runs
    inside ``native.force_python()``.
    """
    merged = native.merge_edge_features(parts, uv_global)
    if merged is not None:
        return _finish_features(*merged)
    m = len(uv_global)
    mean = np.zeros(m, np.float64)
    m2 = np.zeros(m, np.float64)
    mn = np.full(m, np.inf)
    mx = np.full(m, -np.inf)
    cnt = np.zeros(m, np.float64)
    find = edge_id_finder(uv_global)
    for uv, feats in parts:
        if len(uv) == 0:
            continue
        feats = np.asarray(feats)
        if feats.ndim != 2 or feats.shape[1] != len(FEATURE_NAMES):
            raise ValueError(
                f"edge-feature block has shape {feats.shape}, expected (m, {len(FEATURE_NAMES)}) "
                f"{FEATURE_NAMES} -- regenerate per-block features written by an older format"
            )
        ids = find(uv)
        ok = ids >= 0
        ids = ids[ok]
        f = feats[ok].astype(np.float64)
        nb = f[:, 3]
        pos = nb > 0
        ids, f, nb = ids[pos], f[pos], nb[pos]
        # fancy-index updates are last-write-wins on duplicate ids
        if len(ids) != len(np.unique(ids)):
            raise ValueError(
                "edge-feature part contains duplicate edge rows -- merge duplicates (np.unique per block) "
                "before merge_feature_lists"
            )
        na = cnt[ids]
        ntot = na + nb
        delta = f[:, 0] - mean[ids]
        mean[ids] += delta * nb / ntot
        m2[ids] += f[:, 4] * nb + delta * delta * na * nb / ntot
        np.minimum.at(mn, ids, f[:, 1])
        np.maximum.at(mx, ids, f[:, 2])
        cnt[ids] = ntot
    return _finish_features(mean, m2, mn, mx, cnt)


def _finish_features(mean, m2, mn, mx, cnt) -> np.ndarray:
    """The merged columns from the running sums: variance = M2 / count;
    zeros where no part had the edge."""
    m = len(cnt)
    has = cnt > 0
    var = np.zeros(m, np.float64)
    var[has] = np.maximum(m2[has] / cnt[has], 0.0)
    mean = np.where(has, mean, 0.0)
    mn[~has] = 0.0
    mx[~has] = 0.0
    return np.stack([mean, mn, mx, cnt, var], axis=1).astype(np.float32)


def _packed_keys(uv: np.ndarray) -> np.ndarray:
    return (uv[:, 0].astype(np.uint64) << np.uint64(32)) | uv[:, 1].astype(np.uint64)


def edge_id_finder(uv_sorted: np.ndarray):
    """``find_edge_ids(uv_sorted, .)`` as a function, with ``uv_sorted``'s
    search keys built once (for callers that query one global edge list
    block by block)."""
    n = len(uv_sorted)
    dt = uv_sorted.dtype
    if n and int(uv_sorted.max()) < 2**32 and int(uv_sorted.min()) >= 0:
        # one 64-bit key a row; a query row with a label outside 32 bits
        # cannot be in the list
        keys = _packed_keys(uv_sorted)

        def find(uv_query: np.ndarray) -> np.ndarray:
            if len(uv_query) == 0:
                return np.zeros(0, np.int64)
            q = uv_query.astype(dt, copy=False)
            fits = np.all((q >= 0) & (q < 2**32), axis=1)
            qk = _packed_keys(np.where(fits[:, None], q, 0))
            idx = np.clip(np.searchsorted(keys, qk), 0, n - 1)
            return np.where(fits & (keys[idx] == qk), idx, -1).astype(np.int64)

        return find
    # structured dtype: field-wise *numeric* comparison (a raw-bytes void
    # view would compare little-endian integers in byte order)
    struct_dt = np.dtype([("u", dt), ("v", dt)])

    def as_struct(arr):
        st = np.empty(len(arr), dtype=struct_dt)
        st["u"] = arr[:, 0]
        st["v"] = arr[:, 1]
        return st

    av = as_struct(uv_sorted) if n else None

    def find(uv_query: np.ndarray) -> np.ndarray:
        if len(uv_query) == 0:
            return np.zeros(0, np.int64)
        if n == 0:
            return np.full(len(uv_query), -1, np.int64)
        qv = as_struct(uv_query.astype(dt, copy=False))
        idx = np.clip(np.searchsorted(av, qv), 0, n - 1)
        return np.where(av[idx] == qv, idx, -1).astype(np.int64)

    return find


def find_edge_ids(uv_sorted: np.ndarray, uv_query: np.ndarray) -> np.ndarray:
    """Row index of each query edge in a lexsorted unique edge array;
    missing edges map to -1.

    When every label of the list fits in 32 bits the rows are searched as
    one 64-bit key each; otherwise as a structured (numeric field-wise)
    dtype, which avoids overflow of packed keys for large label spaces.
    """
    return edge_id_finder(uv_sorted)(uv_query)
