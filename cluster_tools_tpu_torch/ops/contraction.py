"""Round-based parallel edge contraction -- the vectorized agglomeration core.

Port of ``cluster_tools_tpu/ops/contraction.py``.  The sequential solvers
in :mod:`.multicut` (GAEC heap) and :mod:`.agglomeration` (average-linkage
heap) contract one edge per step; this engine keeps their policy (contract
the most attractive edge first) by mutual-best-edge matching:

    repeat until no contractible edge remains:
      1. every node picks its best incident contractible edge
         (max cost for GAEC, min mean-probability for average linkage;
         ties broken toward the smallest edge id)
      2. edges selected by BOTH endpoints contract (a matching, so the
         union is one parent[hi] = lo scatter, pointer depth 1)
      3. endpoints remap through the new roots; parallel edges merge by
         segment sums (costs add for GAEC; (weight*size, size) sums for
         average linkage)

The globally best contractible edge is mutual-best, so every round
contracts at least one edge.

Rungs (``impl``):

- ``"numpy"`` the vectorized host implementation, and the oracle;
- ``"torch"`` the same rounds on the solve's device (the counterpart of
  the reference's ``_contract_rounds_jax`` / ``_device_contract``): a
  scatter-max best priority, a scatter-min best edge id, a depth-1 parent
  scatter, then a stable sort over one 64-bit key and sequential segment
  sums for the re-aggregation.  It computes in float64 and sums each
  group in the order of the stable sort, which is the numpy rung's order
  (``sum_by_key``), so the priorities compare the same bits and the rung
  gives the numpy rung's labels, on every run and on either device;
- ``"heap"`` the sequential solvers of :mod:`.multicut` /
  :mod:`.agglomeration`;
- ``"auto"`` resolves to ``"torch"`` when the solve's device is a CUDA
  device, else to ``"numpy"``.

The reference's host C++ rung (``impl="native"``) is not ported: ROADMAP
Queue A item 13.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

NATIVE_REFUSAL = ("impl='native' (the host C++ contraction rung, native/ct_native.cpp) is not ported: "
                  "ROADMAP Queue A item 13")

# -- process-wide solver metrics (snapshot/delta, as the task runtime reads
# them around a solve); ``solver_rounds`` is counted by the numpy and torch
# rungs
_METRICS_LOCK = threading.Lock()
_SOLVER_COUNTERS = {
    "solver_calls": 0,      # parallel_contraction invocations
    "solver_rounds": 0,     # contraction rounds (numpy and torch rungs)
    "solver_edges_in": 0,   # edges entering the solves
    "solver_edges_out": 0,  # inter-cluster edges remaining after them
}


def solver_snapshot() -> Dict[str, float]:
    """Current process-wide contraction-solver counters (monotonic; diff
    two snapshots with :func:`solver_delta`)."""
    with _METRICS_LOCK:
        return dict(_SOLVER_COUNTERS)


def solver_delta(snapshot: Dict[str, float]) -> Dict[str, float]:
    """Counter movement since ``snapshot`` (same keys)."""
    cur = solver_snapshot()
    return {k: cur[k] - snapshot.get(k, 0) for k in cur}


def _record_solver_metrics(**deltas) -> None:
    with _METRICS_LOCK:
        for k, v in deltas.items():
            _SOLVER_COUNTERS[k] += int(v)


def _resolve_impl(impl: str, device=None) -> str:
    if impl == "native":
        raise NotImplementedError(NATIVE_REFUSAL)
    if impl == "auto":
        return "torch" if resolve_device(device).type == "cuda" else "numpy"
    if impl not in ("numpy", "torch"):
        raise ValueError(f"unknown impl {impl!r} (expected auto, numpy, torch or heap)")
    return impl


def _relabel_consecutive(roots: np.ndarray) -> np.ndarray:
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int64)


def sum_by_key(key: np.ndarray, payload: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Group-by-key payload-column sums: ``(unique_keys_sorted, sums)``.

    Stable argsort + bincount: each group sums in the original order of its
    rows -- the documented summation order of the contraction engine."""
    order = np.argsort(key, kind="stable")
    ks = key[order]
    first = np.ones(len(ks), bool)
    first[1:] = ks[1:] != ks[:-1]
    uniq = ks[first]
    inv = np.empty(len(ks), np.int64)
    inv[order] = np.cumsum(first) - 1
    out = np.empty((len(uniq), payload.shape[1]), np.float64)
    for c in range(payload.shape[1]):
        out[:, c] = np.bincount(inv, weights=payload[:, c], minlength=len(uniq))
    return uniq, out


def _canonical_edges(n_nodes: int, edges: np.ndarray, payload: np.ndarray):
    """Canonical (lo < hi) unique edges with payload columns summed over
    parallel edges; rows lexsorted -- edge id == row index, the documented
    tie-break order."""
    u = np.minimum(edges[:, 0], edges[:, 1])
    v = np.maximum(edges[:, 0], edges[:, 1])
    keep = u != v
    u, v, payload = u[keep], v[keep], payload[keep]
    if len(u) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros((0, payload.shape[1]), np.float64)
    key = u.astype(np.int64) * np.int64(n_nodes) + v.astype(np.int64)
    uniq, out = sum_by_key(key, payload)
    return (uniq // n_nodes).astype(np.int64), (uniq % n_nodes).astype(np.int64), out


def _contract_rounds_numpy(n_nodes: int, edges: np.ndarray, payload: np.ndarray, mode: str,
                           threshold: float) -> np.ndarray:
    """Vectorized host implementation of the round scheme.

    ``payload``: [m, k] float64 columns summed on merge.  Priority is
    ``payload[:, 0]`` for k == 1 (GAEC cost) and ``payload[:, 0] /
    payload[:, 1]`` for k == 2 (size-weighted mean).  ``mode="max"``
    contracts while priority > threshold (GAEC); ``mode="min"`` while
    priority < threshold (average linkage).
    """
    n_nodes = int(n_nodes)
    labels = np.arange(n_nodes, dtype=np.int64)
    u, v, payload = _canonical_edges(n_nodes, edges, payload)
    sign = 1.0 if mode == "max" else -1.0
    thr = sign * float(threshold)
    rounds = 0

    while len(u):
        prio = payload[:, 0] if payload.shape[1] == 1 else (payload[:, 0] / np.maximum(payload[:, 1], 1e-300))
        prio = sign * prio  # always maximize
        elig = prio > thr
        if not elig.any():
            break
        eid = np.arange(len(u), dtype=np.int64)
        # step 1: per-node best priority over incident contractible edges
        best_p = np.full(n_nodes, -np.inf)
        np.maximum.at(best_p, u[elig], prio[elig])
        np.maximum.at(best_p, v[elig], prio[elig])
        # among priority-ties, the smallest edge id wins (documented order)
        best_e = np.full(n_nodes, len(u), dtype=np.int64)
        cand_u = elig & (prio == best_p[u])
        cand_v = elig & (prio == best_p[v])
        np.minimum.at(best_e, u[cand_u], eid[cand_u])
        np.minimum.at(best_e, v[cand_v], eid[cand_v])
        # step 2: mutual picks form a matching -> depth-1 union
        mutual = elig & (best_e[u] == eid) & (best_e[v] == eid)
        rounds += 1
        root = np.arange(n_nodes, dtype=np.int64)
        root[v[mutual]] = u[mutual]
        labels = root[labels]
        # step 3: remap + re-aggregate parallel edges
        u, v, payload = _canonical_edges(n_nodes, np.stack([root[u], root[v]], axis=1), payload)
    _record_solver_metrics(solver_rounds=rounds)
    return _relabel_consecutive(labels)


def _canonical_edges_torch(n_nodes: int, u: torch.Tensor, v: torch.Tensor, pay: torch.Tensor):
    """:func:`_canonical_edges` on tensors: a stable sort over the key
    ``lo * n + hi``, then each group's payload summed in sorted order
    (``torch.segment_reduce`` over the 2-D payload: one sequential loop a
    group on both devices -- its 1-D CUDA path is a tree reduction -- so
    the sums are :func:`sum_by_key`'s, bit for bit, on either device)."""
    lo = torch.minimum(u, v)
    hi = torch.maximum(u, v)
    keep = lo != hi
    lo, hi, pay = lo[keep], hi[keep], pay[keep]
    if lo.numel() == 0:
        return lo, hi, pay
    key, order = torch.sort(lo * n_nodes + hi, stable=True)
    uniq, counts = torch.unique_consecutive(key, return_counts=True)
    return uniq // n_nodes, uniq % n_nodes, torch.segment_reduce(pay[order], "sum", lengths=counts, unsafe=True)


def _contract_rounds_torch(n_nodes: int, edges: np.ndarray, payload: np.ndarray, mode: str, threshold: float,
                           device=None) -> np.ndarray:
    """The round scheme on ``device``, step for step the numpy rung's
    (float64 payloads, int64 ids, the same comparisons).  Scatters aimed at
    no node go to a spare slot ``n``, so a round reads the host only to end
    the loop and to compact the surviving edges."""
    dev = resolve_device(device)
    n = int(n_nodes)
    e = torch.from_numpy(edges).to(dev)
    u, v, pay = _canonical_edges_torch(n, e[:, 0], e[:, 1],
                                       torch.from_numpy(np.ascontiguousarray(payload, np.float64)).to(dev))
    labels = torch.arange(n, dtype=torch.int64, device=dev)
    sign = 1.0 if mode == "max" else -1.0
    thr = sign * float(threshold)
    rounds = 0
    while u.numel():
        prio = pay[:, 0] if pay.shape[1] == 1 else pay[:, 0] / pay[:, 1].clamp_min(1e-300)
        prio = sign * prio
        elig = prio > thr
        m = u.numel()
        eid = torch.arange(m, dtype=torch.int64, device=dev)
        ue, ve = torch.where(elig, u, n), torch.where(elig, v, n)
        best_p = torch.full((n + 1,), -np.inf, dtype=torch.float64, device=dev)
        best_p.scatter_reduce_(0, ue, prio, "amax")
        best_p.scatter_reduce_(0, ve, prio, "amax")
        # among priority-ties, the smallest edge id wins (documented order)
        best_e = torch.full((n + 1,), m, dtype=torch.int64, device=dev)
        best_e.scatter_reduce_(0, torch.where(elig & (prio == best_p[u]), u, n), eid, "amin")
        best_e.scatter_reduce_(0, torch.where(elig & (prio == best_p[v]), v, n), eid, "amin")
        mutual = elig & (best_e[u] == eid) & (best_e[v] == eid)
        # the globally best eligible edge is mutual: none means none eligible
        if not bool(mutual.any()):
            break
        rounds += 1
        root = torch.arange(n + 1, dtype=torch.int64, device=dev)
        root.scatter_(0, torch.where(mutual, v, n), torch.where(mutual, u, n))
        labels = root[labels]
        u, v, pay = _canonical_edges_torch(n, root[u], root[v], pay)
    _record_solver_metrics(solver_rounds=rounds)
    return torch.unique(labels, return_inverse=True)[1].cpu().numpy().astype(np.int64)


def parallel_contraction(n_nodes: int, edges: np.ndarray, payload: np.ndarray, mode: str, threshold: float,
                         impl: str = "auto", device=None) -> np.ndarray:
    """Run the round engine; returns int64 labels 0..k-1.

    See the module docstring for ``mode``/``payload`` semantics and the
    ``impl`` rungs; ``device`` is the solve's device (``None``: the card),
    read by ``"auto"`` and ``"torch"``.
    """
    n_nodes = int(n_nodes)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if mode not in ("max", "min"):
        raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
    if impl == "native":
        raise NotImplementedError(NATIVE_REFUSAL)
    if n_nodes == 0 or len(edges) == 0:
        return np.arange(n_nodes, dtype=np.int64)
    resolved = _resolve_impl(impl, device)
    payload = np.asarray(payload, dtype=np.float64).reshape(len(edges), -1)
    if resolved == "torch":
        labels = _contract_rounds_torch(n_nodes, edges, payload, mode, threshold, device)
    else:
        labels = _contract_rounds_numpy(n_nodes, edges, payload, mode, threshold)
    _record_solver_metrics(
        solver_calls=1,
        solver_edges_in=len(edges),
        solver_edges_out=int((labels[edges[:, 0]] != labels[edges[:, 1]]).sum()),
    )
    return labels


def gaec_parallel(n_nodes: int, edges: np.ndarray, costs: np.ndarray, stop_cost: float = 0.0,
                  impl: str = "auto", device=None) -> np.ndarray:
    """Parallel GAEC: round-based contraction of mutually-best positive
    edges; parallel edges merge additively.  Drop-in for
    :func:`.multicut.greedy_additive` (approximate greedy order)."""
    if impl == "heap":
        from .multicut import greedy_additive

        return greedy_additive(n_nodes, edges, costs, stop_cost)
    costs = np.asarray(costs, dtype=np.float64).reshape(-1, 1)
    return parallel_contraction(n_nodes, edges, costs, "max", float(stop_cost), impl=impl, device=device)


def average_parallel(n_nodes: int, edges: np.ndarray, probs: np.ndarray, sizes: Optional[np.ndarray] = None,
                     threshold: float = 0.5, impl: str = "auto", device=None) -> np.ndarray:
    """Parallel average-linkage agglomeration: contract mutually-cheapest
    edges while the size-weighted mean boundary probability is below
    ``threshold``.  Drop-in for :func:`.agglomeration.average_agglomeration`."""
    if impl == "heap":
        from .agglomeration import average_agglomeration

        return average_agglomeration(n_nodes, edges, probs, np.ones(len(edges)) if sizes is None else sizes,
                                     threshold)
    probs = np.asarray(probs, dtype=np.float64)
    s = np.ones(len(probs), np.float64) if sizes is None else np.maximum(np.asarray(sizes, np.float64), 1e-12)
    payload = np.stack([probs * s, s], axis=1)
    return parallel_contraction(n_nodes, edges, payload, "min", float(threshold), impl=impl, device=device)
