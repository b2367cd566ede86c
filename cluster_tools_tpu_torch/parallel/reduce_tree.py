"""Distributed agglomeration: the global solve sharded over a reduce tree.

Port of ``cluster_tools_tpu/parallel/reduce_tree.py``.  The hierarchical
multicut funnels every boundary edge of the reduced RAG into one final
solve; this module shards it:

1. **Partition** the graph's nodes into ``solver_shards`` spatially
   contiguous shards: Morton order over the owning blocks' grid positions
   (:func:`morton_node_shards`), or id ranges (:func:`contiguous_node_shards`).
2. **Solve each shard** with frontier-aware contraction rounds
   (:func:`frontier_contraction`): the shard's still-external boundary
   edges compete in every node's best pick but never match, so a node whose
   strongest edge crosses the shard boundary abstains until the tree level
   where that edge is internal.
3. **Merge up a reduce tree** of ``fanout`` children a group: at each level
   the edges between the children become internal and are solved; the rest
   relabel through the children's contractions and move up.

Every step is deterministic (groups in index order, members ascending,
parallel edges summed in the contraction engine's order, label offsets in
group order after a level's solves), so the labels are the same on every
run, for every pool width and for every driver:

- :func:`sharded_solve`, in one process: a level's groups solve on a thread
  pool (the **packet plane**, host work), or all together as one
  collective program over a sibling mesh (the **collective plane**,
  :class:`CollectiveReducePlane`);
- :func:`solve_over_workers`, over a :func:`~.multihost.launch_workers`
  group: groups dealt round-robin over the workers, their packets
  exchanged through a scratch directory (atomic ``os.replace`` publishes),
  every worker folding every level from all packets; or, where the group
  can run collectives, the collective plane over the pod's mesh.

:func:`solve_with_reduce_tree` is the entry point the tasks call:
``solver_shards=1`` is the single-host solve, and any sharded failure
degrades to it with a ``degraded:unsharded_solve`` record in
``failures.json``.  The collective plane's failures degrade to the packet
plane first (``degraded:packet_plane``).

Faults and traces, as in the reference: a ``solve`` fault at the task
entry degrades to the unsharded solve (inside a worker, targeted by worker
id, it SIGKILLs the worker); a ``hop`` fault (at the plane's init, or a
hang or error at a level) degrades to the packet plane.  Spans:
``solve.level_solve``/``level_merge``/``group``/``collective_level`` in
process, ``solve.worker``/``hop_wait`` in a worker and
``solve.worker_group`` around the group; instants ``degraded:packet_plane``
and ``degraded:unsharded_solve``.  A traced driver hands its shard
directory to the workers (``CTT_TRACE``).  Lifted edges ride the tree
as in the reference: contracted endpoints relabel, parallel lifted edges
add, and a node with lifted edges runs the lifted GAEC on the packet plane
and in the worker group; the collective plane refuses them
(:func:`..ops.multicut.lifted_frontier_capable`).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..runtime import trace as trace_mod
from ..utils import function_utils as fu

#: env knobs of the worker-group driver (inherited by the workers)
_ENV_DIR = "CT_RT_DIR"
_ENV_WAIT = "CT_RT_WAIT_S"

#: default patience of a worker polling for a sibling's packet before it
#: declares the reduce hop lost and fails
DEFAULT_HOP_WAIT_S = 120.0


class ShardedSolveError(RuntimeError):
    """The sharded solve could not complete (worker death, lost packet,
    malformed shard state).  Callers degrade to the single-host solver."""


def _host_impl(impl: Optional[str] = None) -> str:
    """Concrete host-side contraction rung, never ``auto``: the host C++
    rung (``native``), or ``numpy`` inside ``native.force_python()``."""
    if impl and impl not in ("auto", "host"):
        return impl
    return "native" if native.available() else "numpy"


# -- process-wide solver metrics (snapshot/delta: the task runtime merges a
# task's delta into its manifest and io_metrics.json) ------------------------

_METRICS_LOCK = threading.Lock()
_SOLVE_COUNTERS = {
    "sharded_solves": 0,        # sharded_solve invocations (any driver)
    "unsharded_fallbacks": 0,   # degraded:unsharded_solve degradations
    "solve_shards": 0,          # leaf shards solved
    "solve_levels": 0,          # reduce-tree levels traversed
    "tree_rounds": 0,           # frontier-contraction rounds across nodes
    "tree_solve_s": 0.0,        # wall time inside per-group solver calls
    "tree_merge_s": 0.0,        # wall time relabeling/merging boundary edges
    "boundary_edges_in": 0,     # edges entering the reduce tree (leaf level)
    "boundary_edges_out": 0,    # edges surviving to the root solve
    # -- collective reduce plane --
    "collective_hops": 0,          # per-level all_gather exchanges
    "packet_fallbacks": 0,         # degraded:packet_plane degradations
    "bytes_over_interconnect": 0,  # bytes the collective hops moved
    "contraction_dispatches": 0,   # host round dispatches + level programs
    "host_syncs": 0,               # the collective plane's host reads
}


def solve_snapshot() -> Dict[str, float]:
    """Current process-wide reduce-tree counters (monotonic; diff two
    snapshots with :func:`solve_delta`)."""
    with _METRICS_LOCK:
        return dict(_SOLVE_COUNTERS)


def solve_delta(snapshot: Dict[str, float]) -> Dict[str, float]:
    """Counter movement since ``snapshot`` (same keys)."""
    cur = solve_snapshot()
    return {k: cur[k] - snapshot.get(k, 0) for k in cur}


def _record_solve_metrics(**deltas) -> None:
    with _METRICS_LOCK:
        for k, v in deltas.items():
            _SOLVE_COUNTERS[k] += v


# -- tree topology and partitions ----------------------------------------------


def reduce_tree_levels(n_shards: int, fanout: int) -> List[List[Tuple[int, ...]]]:
    """Merge-group plan, one entry per level: ``levels[0]`` is the leaf
    level (one singleton group per shard); each later level's groups are
    tuples of previous-level node indices, ``fanout`` consecutive children a
    group, down to one root group.  One shard yields just the root level."""
    n_shards = int(n_shards)
    fanout = int(fanout)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if fanout < 2:
        raise ValueError(f"fanout must be >= 2, got {fanout}")
    levels: List[List[Tuple[int, ...]]] = [[(s,) for s in range(n_shards)]]
    width = n_shards
    while width > 1:
        groups = [tuple(range(i, min(i + fanout, width))) for i in range(0, width, fanout)]
        levels.append(groups)
        width = len(groups)
    return levels


def morton_argsort(positions: np.ndarray) -> np.ndarray:
    """Indices sorting integer grid ``positions`` [k, d] along the Z-order
    curve (bit interleave, axis 0 most significant within each bit plane)."""
    pos = np.asarray(positions, dtype=np.int64)
    if pos.ndim != 2:
        raise ValueError(f"positions must be [k, d], got shape {pos.shape}")
    if len(pos) == 0:
        return np.zeros(0, np.int64)
    nbits = max(1, int(pos.max()).bit_length())
    codes = np.zeros(len(pos), dtype=np.int64)
    d = pos.shape[1]
    for bit in range(nbits):
        for ax in range(d):
            codes |= ((pos[:, ax] >> bit) & 1) << (bit * d + (d - 1 - ax))
    return np.argsort(codes, kind="stable")


def morton_node_shards(positions: np.ndarray, n_shards: int) -> np.ndarray:
    """Shard id per row of ``positions``: the Morton curve split into
    ``n_shards`` near-equal contiguous runs."""
    order = morton_argsort(positions)
    shards = np.empty(len(order), np.int64)
    shards[order] = np.arange(len(order), dtype=np.int64) * int(n_shards) // max(1, len(order))
    return shards


def contiguous_node_shards(n_nodes: int, n_shards: int) -> np.ndarray:
    """Id-range partition: blockwise supervoxel labels make consecutive ids
    spatial neighbours, so contiguous ranges approximate Morton octants."""
    n_nodes = int(n_nodes)
    k = max(1, min(int(n_shards), max(1, n_nodes)))
    return np.arange(n_nodes, dtype=np.int64) * k // max(1, n_nodes)


# -- the level machinery (shared by every driver) -------------------------------


def _as_payload(costs: np.ndarray, m: int) -> np.ndarray:
    payload = np.asarray(costs, dtype=np.float64)
    if payload.ndim == 1:
        payload = payload.reshape(-1, 1)
    if len(payload) != m:
        raise ValueError(f"payload rows {len(payload)} != edges {m}")
    return payload


def _aggregate_frontier(f_node: np.ndarray, f_ghost: np.ndarray, f_payload: np.ndarray):
    """Merge parallel frontier edges per (member node, ghost) pair through
    the contraction engine's :func:`..ops.contraction.sum_by_key`."""
    if len(f_node) == 0:
        return f_node, f_ghost, f_payload
    from ..ops.contraction import sum_by_key

    mult = np.int64(int(f_ghost.max()) + 1)
    key = f_node.astype(np.int64) * mult + f_ghost.astype(np.int64)
    uniq, out = sum_by_key(key, f_payload)
    return (uniq // mult).astype(np.int64), (uniq % mult).astype(np.int64), out


def frontier_contraction(n_nodes: int, edges: np.ndarray, payload: np.ndarray, f_node: np.ndarray,
                         f_ghost: np.ndarray, f_payload: np.ndarray, mode: str = "max",
                         threshold: float = 0.0) -> np.ndarray:
    """Mutual-best contraction rounds with frontier abstention (numpy).

    The rounds of :func:`..ops.contraction._contract_rounds_numpy`, except
    that the frontier edges (``f_node``, a member, to ``f_ghost``, an opaque
    remote supernode key, with ``f_payload`` columns) compete in the
    best-pick scatter but never match: a node whose best edge is external
    abstains this round.  Frontier edges re-aggregate as their member
    endpoints merge.  Returns int64 labels 0..k-1 over the members.
    """
    n = int(n_nodes)
    sign = 1.0 if mode == "max" else -1.0
    thr = sign * float(threshold)
    labels = np.arange(n, dtype=np.int64)
    if n == 0 or len(edges) == 0:
        return labels
    from ..ops.contraction import _canonical_edges

    u, v, payload = _canonical_edges(n, edges, payload)
    f_node = np.asarray(f_node, dtype=np.int64)
    f_ghost = np.asarray(f_ghost, dtype=np.int64)
    f_payload = _as_payload(f_payload, len(f_node))
    f_node, f_ghost, f_payload = _aggregate_frontier(f_node, f_ghost, f_payload)
    rounds = 0

    def prio_of(pay):
        p = pay[:, 0] if pay.shape[1] == 1 else pay[:, 0] / np.maximum(pay[:, 1], 1e-300)
        return sign * p

    while len(u):
        prio = prio_of(payload)
        elig = prio > thr
        if not elig.any():
            break
        eid = np.arange(len(u), dtype=np.int64)
        best_p = np.full(n, -np.inf)
        np.maximum.at(best_p, u[elig], prio[elig])
        np.maximum.at(best_p, v[elig], prio[elig])
        if len(f_node):
            fprio = prio_of(f_payload)
            felig = fprio > thr
            if felig.any():
                # external competition: raises best_p, places no edge id
                np.maximum.at(best_p, f_node[felig], fprio[felig])
        best_e = np.full(n, len(u), dtype=np.int64)
        cand_u = elig & (prio == best_p[u])
        cand_v = elig & (prio == best_p[v])
        np.minimum.at(best_e, u[cand_u], eid[cand_u])
        np.minimum.at(best_e, v[cand_v], eid[cand_v])
        mutual = elig & (best_e[u] == eid) & (best_e[v] == eid)
        if not mutual.any():
            break
        rounds += 1
        root = np.arange(n, dtype=np.int64)
        root[v[mutual]] = u[mutual]
        labels = root[labels]
        u, v, payload = _canonical_edges(n, np.stack([root[u], root[v]], axis=1), payload)
        if len(f_node):
            f_node, f_ghost, f_payload = _aggregate_frontier(root[f_node], f_ghost, f_payload)
    # one host-driven dispatch per mutual-best round
    _record_solve_metrics(tree_rounds=rounds, contraction_dispatches=rounds)
    _, out = np.unique(labels, return_inverse=True)
    return out.astype(np.int64)


def default_tree_solver(mode: str = "max", threshold: float = 0.0, impl: str = "auto", device=None) -> Callable:
    """The default per-tree-node solver: frontier-aware contraction rounds
    (GAEC for ``mode='max'``, average linkage for ``'min'``); a node with no
    frontier runs the contraction engine (``impl`` on ``device``: the torch
    rung on the card).  A node with lifted edges runs the lifted GAEC on the
    host (boundary-blind: the lifted objective has no frontier
    formulation)."""

    def solve(n, edges, payload, frontier, lifted_edges, lifted_payload):
        if lifted_edges is not None and len(lifted_edges):
            from ..ops.multicut import lifted_greedy_additive

            return lifted_greedy_additive(n, edges, payload[:, 0], lifted_edges, lifted_payload[:, 0])
        if len(edges) == 0:
            return np.arange(n, dtype=np.int64)
        if frontier is not None and len(frontier[0]):
            return frontier_contraction(n, edges, payload, *frontier, mode=mode, threshold=threshold)
        from ..ops.contraction import parallel_contraction

        return parallel_contraction(n, edges, payload, mode, threshold, impl=impl, device=device)

    return solve


class _TreeState:
    """Mutable per-level solve state: the current contracted problem, and
    the owner of each edge's endpoints (``edge_owner``), taken once a level
    for all of its groups."""

    __slots__ = ("n", "edges", "payload", "ledges", "lpayload", "owner", "node_to_cur", "edge_owner")

    def __init__(self, n_nodes, edges, payload, ledges, lpayload, node_shard):
        self.n = int(n_nodes)
        self.edges = edges
        self.payload = payload
        self.ledges = ledges
        self.lpayload = lpayload
        self.owner = np.asarray(node_shard, dtype=np.int64).copy()
        self.node_to_cur = np.arange(self.n, dtype=np.int64)
        self._own_edges()

    def _own_edges(self) -> None:
        self.edge_owner = (self.owner[self.edges[:, 0]], self.owner[self.edges[:, 1]])


def _aggregate(n_new: int, edges: np.ndarray, payload: np.ndarray):
    """Canonical (lo < hi) unique edges, payload summed over parallels."""
    from ..ops.contraction import _canonical_edges

    if len(edges) == 0:
        return edges.reshape(0, 2), payload.reshape(0, payload.shape[-1])
    u, v, pay = _canonical_edges(n_new, edges, payload)
    return np.stack([u, v], axis=1), pay


def _group_problem(state: _TreeState, children: Tuple[int, ...]):
    """One merge group's subproblem: ``(members, sub_edges, sub_payload,
    frontier, sub_le, sub_lp, n_internal)``; ``members`` ascend (the local
    index), ``frontier`` is ``(f_node, f_ghost, f_payload)`` or None.  The
    packet plane's solves and the collective plane's lanes see the same
    problems."""
    members = np.flatnonzero(np.isin(state.owner, children))
    if len(members) == 0:
        return (members, np.zeros((0, 2), np.int64), np.zeros((0, state.payload.shape[-1])), None, None, None, 0)

    def side_masks(edges):
        return np.isin(state.owner[edges[:, 0]], children), np.isin(state.owner[edges[:, 1]], children)

    in_u, in_v = (np.isin(o, children) for o in state.edge_owner)
    e_mask = in_u & in_v
    sub_edges = np.searchsorted(members, state.edges[e_mask])
    sub_payload = state.payload[e_mask]
    cross = in_u ^ in_v
    frontier = None
    if cross.any():
        ce = state.edges[cross]
        member_side = in_u[cross]
        f_node = np.searchsorted(members, np.where(member_side, ce[:, 0], ce[:, 1]))
        f_ghost = np.where(member_side, ce[:, 1], ce[:, 0])
        frontier = (f_node, f_ghost, state.payload[cross])
    sub_le, sub_lp = None, None
    if state.ledges is not None and len(state.ledges):
        lin_u, lin_v = side_masks(state.ledges)
        l_mask = lin_u & lin_v
        sub_le = np.searchsorted(members, state.ledges[l_mask])
        sub_lp = state.lpayload[l_mask]
    return members, sub_edges, sub_payload, frontier, sub_le, sub_lp, int(e_mask.sum())


def _solve_group(state: _TreeState, children: Tuple[int, ...], solver: Callable):
    """Solve one merge group: ``(members, sub_labels, n_internal_edges)``."""
    members, sub_edges, sub_payload, frontier, sub_le, sub_lp, n_int = _group_problem(state, children)
    if len(members) == 0:
        return members, np.zeros(0, np.int64), 0
    labels = np.asarray(solver(len(members), sub_edges, sub_payload, frontier, sub_le, sub_lp), dtype=np.int64)
    if len(labels) != len(members):
        raise ShardedSolveError(f"group solver returned {len(labels)} labels for {len(members)} supernodes")
    return members, labels, n_int


def _apply_level(state: _TreeState, groups: List[Tuple[int, ...]],
                 results: Dict[int, Tuple[np.ndarray, np.ndarray]]) -> int:
    """Fold one level's group solutions into the state (offsets in group
    order, edges re-aggregated canonically); returns the supernode count."""
    new_map = np.full(len(state.owner), -1, np.int64)
    owner_new: List[int] = []
    offset = 0
    for gi in range(len(groups)):
        members, labels = results[gi]
        k = int(labels.max()) + 1 if len(labels) else 0
        new_map[members] = offset + labels
        owner_new.extend([gi] * k)
        offset += k
    if (new_map < 0).any():
        raise ShardedSolveError("level left supernodes unmapped")
    state.node_to_cur = new_map[state.node_to_cur]
    state.edges, state.payload = _aggregate(offset, new_map[state.edges], state.payload)
    if state.ledges is not None and len(state.ledges):
        state.ledges, state.lpayload = _aggregate(offset, new_map[state.ledges], state.lpayload)
    state.owner = np.asarray(owner_new, dtype=np.int64)
    state._own_edges()
    return offset


def _final_labels(state: _TreeState) -> np.ndarray:
    """Compose the per-level relabelings down to original nodes (dense)."""
    _, labels = np.unique(state.node_to_cur, return_inverse=True)
    return labels.astype(np.int64)


# -- collective reduce plane ------------------------------------------------------
# A tree level's groups are dealt as padded lanes over the sibling mesh; each
# shard contracts its lanes with ops/contraction.py's lane_frontier_rounds on
# its device, and one all_gather over the sibling axis replaces the packet
# exchange.  The lanes stage through the ragged pool's descriptors and the
# resident device page pool, so a warm re-solve sends no bytes to the card.
# The labels equal the packet plane's; any failure degrades to it,
# attributed ``degraded:packet_plane``.

#: plane selection: operator env overrides the task knob (auto|collective|packet)
_ENV_PLANE = "CT_REDUCE_PLANE"
#: force-disable switch: the plane's init refuses
_ENV_COLLECTIVES_OFF = "CT_COLLECTIVES_DISABLED"
#: wall-clock budget for one level's collective program
_ENV_HOP_DEADLINE = "CT_HOP_DEADLINE_S"
DEFAULT_HOP_DEADLINE_S = 60.0
#: ``reduce_plane='auto'`` floor: below this many live edges stay on host
_ENV_AUTO_MIN_EDGES = "CT_REDUCE_PLANE_MIN_EDGES"
_AUTO_MIN_EDGES = 20_000

#: lane-capacity floors; capacities are powers of two above them
_MIN_LANE_NODES = 64
_MIN_LANE_EDGES = 128


def _pow2_at_least(n: int, floor: int) -> int:
    cap = int(floor)
    while cap < int(n):
        cap *= 2
    return cap


def _hop_deadline_s(explicit: Optional[float] = None) -> float:
    if explicit is not None:
        return float(explicit)
    return float(os.environ.get(_ENV_HOP_DEADLINE, DEFAULT_HOP_DEADLINE_S))


_DEVICE_LOCKS: Dict[str, threading.Lock] = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def _device_lock(device: torch.device) -> threading.Lock:
    """The lock the collective plane's shards on ``device`` take to solve
    their lanes one at a time."""
    with _DEVICE_LOCKS_GUARD:
        return _DEVICE_LOCKS.setdefault(str(device), threading.Lock())


def _record_packet_degrade(failures_path: Optional[str], task_name: str, err: BaseException,
                           record: bool = True) -> None:
    """Attribute one collective -> packet degradation: the
    ``packet_fallbacks`` counter, a ``degraded:packet_plane`` trace
    instant and, when ``record``, a resolved ``failures.json`` record at
    the ``hop`` site.  ``record`` is False only for ``reduce_plane='auto'``
    passing the plane by up front."""
    _record_solve_metrics(packet_fallbacks=1)
    trace_mod.instant("degraded:packet_plane", task=task_name, error=f"{type(err).__name__}: {err}"[:200])
    if not record or not failures_path:
        return
    try:
        fu.record_failures(failures_path, task_name, [{
            "block_id": None,
            "sites": {"hop": 1},
            "error": fu.cap_traceback(f"{type(err).__name__}: {err}"),
            "quarantined": False,
            "resolved": True,
            "resolution": "degraded:packet_plane",
        }])
    except Exception:
        pass  # attribution is best effort; the solve must still land


class CollectiveReducePlane:
    """One tree level as one collective program over a sibling mesh.

    Construction is the degrade ladder's first rung: it raises (-> packet
    plane) when collectives are force-disabled, the mode or payload width
    has no lane program, or the sibling mesh has fewer than two shards.
    :meth:`solve_level` marshals every group of a level into fixed-capacity
    lanes, stages them through the resident device page pool and runs the
    level under the hop deadline; its failures are the ladder's second rung.

    ``mesh`` is a sibling mesh (default :func:`~.mesh.sibling_mesh` on
    ``device``, the card unless the caller names the CPU); a worker group
    passes its pod's mesh.  ``device_pool_bytes`` is
    the resident page pool's budget (the tasks' knob of that name; ``None``
    keeps the pool's).
    """

    def __init__(self, mode: str, threshold: float, k: int, *, hop_deadline_s: Optional[float] = None,
                 device=None, mesh=None, device_pool_bytes: Optional[int] = None):
        if os.environ.get(_ENV_COLLECTIVES_OFF):
            raise ShardedSolveError(f"collectives force-disabled ({_ENV_COLLECTIVES_OFF})")
        # the init rung of the ``hop`` fault site: the plane refuses to
        # wire up
        from ..runtime import faults as faults_mod

        faults_mod.get_injector().maybe_fail("hop")
        if mode not in ("max", "min"):
            raise ShardedSolveError(f"unsupported mode {mode!r}")
        if int(k) not in (1, 2):
            raise ShardedSolveError(f"no lane program for payload width {k} (expected 1 or 2)")
        from ..device import resolve_device
        from .mesh import SIBLING_AXIS, sibling_mesh

        self.mode = mode
        self.threshold = float(threshold)
        self.k = int(k)
        self.hop_deadline_s = _hop_deadline_s(hop_deadline_s)
        self.device_pool_bytes = device_pool_bytes
        if mesh is None:
            mesh = sibling_mesh(devices=None if device is None else resolve_device(device))
        if mesh.axis_names != (SIBLING_AXIS,):
            raise ShardedSolveError(f"the collective plane needs a 1-D {SIBLING_AXIS!r} mesh, got {mesh.axis_names}")
        self.mesh = mesh
        self.ndev = int(mesh.size)
        if self.ndev < 2:
            raise ShardedSolveError("collective plane needs >= 2 shards on the sibling mesh")

    # -- the per-level program ---------------------------------------------

    def _program(self, Wn: int, stop: threading.Event) -> Callable:
        from ..ops.contraction import lane_frontier_rounds
        from . import spmd
        from .mesh import SIBLING_AXIS

        mode, k, thr = self.mode, self.k, self.threshold

        def per_shard(up, vp, pp, fnp, fgp, fpp, tabs):
            # tabs [local_lanes, 6]: this shard's lanes' page slots, one per
            # pool -- the ragged page-table indirection on the device.  The
            # shards of one device solve their lanes in turn: threads that
            # interleave launch-and-read loops convoy on the interpreter
            # lock (8 leaf lanes on one card took 5.6x their time in turn).
            labels, rounds = [], []
            with _device_lock(up.device):
                for t in tabs.tolist():
                    lab, r = lane_frontier_rounds(up[t[0]], vp[t[1]], pp[t[2]], fnp[t[3]], fgp[t[4]], fpp[t[5]],
                                                  thr, n_pad=Wn, mode=mode, k=k, stop=stop.is_set)
                    labels.append(lab)
                    rounds.append(r)
            labels = torch.stack(labels)
            rounds = torch.tensor(rounds, dtype=torch.int64, device=labels.device)
            # the reduce hop: every sibling's lane labels in one gather
            return (spmd.all_gather(labels, SIBLING_AXIS, tiled=True),
                    spmd.all_gather(rounds, SIBLING_AXIS, tiled=True))

        P = spmd.P
        return spmd.shard_map(per_shard, self.mesh, (P(),) * 6 + (P(SIBLING_AXIS),), (P(), P()),
                              name="reduce_level")

    # -- lane marshalling ---------------------------------------------------

    def _marshal(self, probs: List[tuple]):
        """Pack the level's group problems into one 6-spec ragged batch:
        fixed ``(We,)``/``(We, k)``/``(Wf,)``/``(Wf, k)`` pages, one page a
        lane, the lane count padded to a multiple of the shard count."""
        from .block_pool import RaggedArgSpec, RaggedBatch, _quantize_pages

        Wn = _pow2_at_least(max(len(m) for _, m, _, _, _ in probs), _MIN_LANE_NODES)
        We = _pow2_at_least(max(max((len(e) for _, _, e, _, _ in probs), default=0), 1), _MIN_LANE_EDGES)
        Wf = _pow2_at_least(max(max((len(f[0]) for _, _, _, _, f in probs if f is not None), default=0), 1),
                            _MIN_LANE_EDGES)
        lanes = -(-len(probs) // self.ndev) * self.ndev
        k = self.k
        # (page_shape, dtype, fill) per pool: u, v, pay, f_node, f_ghost,
        # f_pay.  Wn is the lane program's padding sentinel for endpoints.
        layout = [((We,), np.int64, Wn), ((We,), np.int64, Wn), ((We, k), np.float64, 0.0),
                  ((Wf,), np.int64, Wn), ((Wf,), np.int64, 0), ((Wf, k), np.float64, 0.0)]
        specs, pools, tables, valids = [], [], [], []
        for shape, dtype, fill in layout:
            cap = _quantize_pages(1 + len(probs))
            pools.append(np.full((cap,) + shape, fill, dtype))
            specs.append(RaggedArgSpec((1,) * len(shape), shape, np.dtype(dtype).name,
                                       fill if isinstance(fill, float) else int(fill), cap))
            tables.append(np.zeros((lanes, 1), np.int32))
            valids.append(np.zeros((lanes, len(shape)), np.int32))
        for li, (_gi, _members, sub_edges, sub_payload, frontier) in enumerate(probs):
            m = len(sub_edges)
            pools[0][1 + li, :m] = sub_edges[:, 0] if m else 0
            pools[1][1 + li, :m] = sub_edges[:, 1] if m else 0
            pools[2][1 + li, :m] = sub_payload
            rows = [(m,), (m,), (m, k)]
            if frontier is not None:
                f_node, f_ghost, f_pay = frontier
                fm = len(f_node)
                pools[3][1 + li, :fm] = f_node
                pools[4][1 + li, :fm] = f_ghost
                pools[5][1 + li, :fm] = np.asarray(f_pay, np.float64)
                rows += [(fm,), (fm,), (fm, k)]
            else:
                rows += [(0,), (0,), (0, k)]
            for a, extent in enumerate(rows):
                tables[a][li, 0] = 1 + li
                valids[a][li] = extent
        rb = RaggedBatch(specs, pools, tables, valids, n_lanes=len(probs), width=lanes,
                         pages_in_use=6 * len(probs))
        return rb, Wn

    # -- one level, one program, one hop ------------------------------------

    def solve_level(self, state: _TreeState, groups: List[Tuple[int, ...]], *, level: int,
                    deadline_s: Optional[float] = None):
        """Solve every group of one tree level collectively; returns the
        ``{group: (members, labels)}`` results for :func:`_apply_level` and
        the level's internal-edge total.  ``deadline_s`` (default: the
        plane's hop deadline) caps the whole program; a level that misses
        it raises :class:`ShardedSolveError` and the caller degrades."""
        deadline = self.hop_deadline_s if deadline_s is None else float(deadline_s)
        results: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        probs: List[tuple] = []
        internal_total = 0
        for gi, children in enumerate(groups):
            members, sub_edges, sub_payload, frontier, sub_le, sub_lp, n_int = _group_problem(state, children)
            if sub_le is not None and len(sub_le):
                from ..ops.multicut import lifted_frontier_capable

                if not lifted_frontier_capable():
                    raise ShardedSolveError("lifted edges have no frontier formulation — collective plane refuses "
                                            "the group")
            internal_total += n_int
            if len(members) == 0:
                results[gi] = (members, np.zeros(0, np.int64))
                continue
            probs.append((gi, members, sub_edges, sub_payload, frontier))
        if not probs:
            return results, internal_total
        raw = self._dispatch(probs, level, deadline)
        for li, (gi, members, _, _, _) in enumerate(probs):
            # the lane returns raw union roots; the consecutive relabel is
            # the np.unique the host rung applies
            _, labels = np.unique(raw[li, : len(members)], return_inverse=True)
            results[gi] = (members, labels.astype(np.int64))
        return results, internal_total

    def _dispatch(self, probs: List[tuple], level: int, deadline: float) -> np.ndarray:
        from .device_pool import get_device_pool

        from ..runtime import faults as faults_mod

        rb, Wn = self._marshal(probs)
        injector = faults_mod.get_injector()
        box: Dict[str, object] = {}
        stop = threading.Event()

        def run():
            try:
                # hop chaos: a hang is a wedged interconnect the deadline
                # must notice, an error a failed collective
                injector.maybe_hang("hop", block_id=level)
                injector.maybe_fail("hop", block_id=level)
                pool = get_device_pool(self.device_pool_bytes)
                # the arenas update in place: hold the pool until the lanes
                # have been read out of it
                with pool.lock_for(self.mesh.devices[0]):
                    sb = pool.stage(rb, self.mesh.devices[0], block_id=level)
                    tabs = torch.from_numpy(np.concatenate(sb.tables, axis=1).astype(np.int64))
                    labels, rounds = self._program(Wn, stop)(*sb.pools, tabs)
                    box["labels"] = labels.cpu().numpy()
                    box["rounds"] = rounds.cpu().numpy()
            # handed across the thread boundary and re-raised by the caller
            except BaseException as e:  # noqa: BLE001
                box["error"] = e

        t = threading.Thread(target=run, name=f"collective-hop-l{level}", daemon=True)
        # the span ends at the join: the lanes were read back to the host
        # (a sync) inside the thread
        with trace_mod.span("solve.collective_level", level=level, groups=len(probs), devices=self.ndev):
            t.start()
            t.join(timeout=deadline)
        if t.is_alive():
            # a stranded program cannot be cancelled mid-kernel: it stops at
            # its lanes' next round boundary and releases the device pool
            stop.set()
            raise ShardedSolveError(f"collective hop deadline: level {level} program exceeded {deadline:g}s")
        if "error" in box:
            err = box["error"]
            if isinstance(err, BaseException) and not isinstance(err, Exception):
                raise err
            raise ShardedSolveError(f"collective level {level} failed: {type(err).__name__}: {err}") from err
        out, rounds = box["labels"], box["rounds"]
        # interconnect accounting: the all_gather hands every shard all other
        # shards' part -- (ndev-1)/ndev of the gathered bytes
        moved = int((out.nbytes + rounds.nbytes) * (self.ndev - 1) // self.ndev)
        _record_solve_metrics(
            collective_hops=1,
            contraction_dispatches=1,
            bytes_over_interconnect=moved,
            tree_rounds=int(rounds.sum()),
            # a lane of r rounds reads the host r + 1 times; the gathered
            # labels are one more read
            host_syncs=int(rounds.sum()) + len(rounds) + 1,
        )
        return out


# -- in-process driver -------------------------------------------------------------


def _plane_request(reduce_plane: Optional[str]) -> str:
    plane_req = os.environ.get(_ENV_PLANE) or (reduce_plane or "auto")
    if plane_req not in ("auto", "collective", "packet"):
        raise ValueError(f"reduce_plane must be auto|collective|packet, got {plane_req!r}")
    return plane_req


def sharded_solve(n_nodes: int, edges: np.ndarray, payload: np.ndarray, node_shard: np.ndarray, *,
                  fanout: int = 2, solver: Optional[Callable] = None, mode: str = "max", threshold: float = 0.0,
                  lifted_edges: Optional[np.ndarray] = None, lifted_payload: Optional[np.ndarray] = None,
                  max_workers: int = 1, reduce_plane: str = "auto", hop_deadline_s: Optional[float] = None,
                  failures_path: Optional[str] = None, task_name: str = "sharded_solve",
                  device=None, device_pool_bytes: Optional[int] = None) -> Tuple[np.ndarray, Dict]:
    """Shard-contract-merge in one process.  Returns ``(labels, info)``:
    int64 labels 0..k-1 over the original nodes and the per-level stats.

    ``solver(n, edges, payload, frontier, lifted_edges, lifted_payload) ->
    labels`` runs once per tree node (default :func:`default_tree_solver`
    on ``device``: the torch rung on the card, the host C++ rung on the
    CPU).  A level's group solves fan out on ``max_workers`` threads; the
    result does not depend on their completion order.

    ``reduce_plane`` (``CT_REDUCE_PLANE`` overrides): ``collective`` demands
    the :class:`CollectiveReducePlane` on a sibling mesh of
    :func:`~.mesh.visible_shards` shards on ``device`` and attributes
    ``degraded:packet_plane`` if it cannot run; ``auto`` uses it when
    eligible (>= 2 shards, >= ``CT_REDUCE_PLANE_MIN_EDGES`` edges, default
    solver, no lifted edges), else stays on the host silently; ``packet``
    never touches the plane.  The labels are the same on every plane.
    ``hop_deadline_s`` caps each collective level (``CT_HOP_DEADLINE_S``).
    ``device``: the solve's device (``None``: the card);
    ``device_pool_bytes``: the collective plane's page-pool budget.
    """
    n_nodes = int(n_nodes)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    payload = _as_payload(payload, len(edges))
    node_shard = np.asarray(node_shard, dtype=np.int64)
    if len(node_shard) != n_nodes:
        raise ValueError(f"node_shard has {len(node_shard)} entries for {n_nodes} nodes")
    custom_solver = solver is not None
    if solver is None:
        solver = default_tree_solver(mode, threshold, device=device)
    ledges = np.asarray(lifted_edges, dtype=np.int64).reshape(-1, 2) if lifted_edges is not None else None
    lpayload = _as_payload(lifted_payload, len(ledges)) if ledges is not None else None

    n_shards = int(node_shard.max()) + 1 if n_nodes else 1
    levels = reduce_tree_levels(n_shards, fanout)
    state = _TreeState(n_nodes, edges, payload, ledges, lpayload, node_shard)

    plane_req = _plane_request(reduce_plane)
    hop_deadline = _hop_deadline_s(hop_deadline_s)
    plane: Optional[CollectiveReducePlane] = None
    if plane_req != "packet":
        has_lifted = ledges is not None and len(ledges) > 0
        auto_floor = int(os.environ.get(_ENV_AUTO_MIN_EDGES, _AUTO_MIN_EDGES))
        if plane_req == "collective" or (not custom_solver and not has_lifted and len(edges) >= auto_floor):
            try:
                if custom_solver or has_lifted:
                    raise ShardedSolveError("collective plane needs the default solver and no lifted edges")
                plane = CollectiveReducePlane(mode, threshold, payload.shape[1], hop_deadline_s=hop_deadline,
                                              device=device, device_pool_bytes=device_pool_bytes)
            except Exception as e:
                # init-failure rung: attributed when the plane was demanded,
                # counter-only when auto was probing
                _record_packet_degrade(failures_path, task_name, e, record=(plane_req == "collective"))

    info: Dict = {
        "sharded": True,
        "shards": n_shards,
        "fanout": int(fanout),
        "reduce_plane": "collective" if plane is not None else "host",
        "levels": [],
    }
    _record_solve_metrics(sharded_solves=1, solve_shards=n_shards, boundary_edges_in=len(edges))

    from concurrent.futures import ThreadPoolExecutor

    # group results land here as solves finish; offsets are assigned later,
    # in group order, so completion order is invisible
    merge_lock = threading.Lock()

    for li, groups in enumerate(levels):
        edges_in = len(state.edges)
        results: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        internal_total = 0
        # the level spans are the solve_s/merge_s clocks
        solve_span = trace_mod.begin("solve.level_solve", level=li, groups=len(groups), edges_in=int(edges_in))
        level_plane = "host"
        if plane is not None:
            try:
                results, internal_total = plane.solve_level(state, groups, level=li, deadline_s=hop_deadline)
                level_plane = "collective"
            except Exception as e:
                # runtime rung (hop deadline, a failed collective, pool
                # exhaustion): this and every later level re-solve on the
                # host; the plane was live, so the degradation is attributed
                _record_packet_degrade(failures_path, task_name, e)
                info["degraded_plane"] = f"{type(e).__name__}: {e}"[:200]
                info["reduce_plane"] = "host"
                plane = None
                results = {}
                internal_total = 0
        if level_plane == "host":

            def run_group(gi, _groups=groups, _li=li):
                with trace_mod.span("solve.group", level=_li, group=gi):
                    members, labels, n_int = _solve_group(state, _groups[gi], solver)
                with merge_lock:
                    results[gi] = (members, labels)
                return n_int

            if max_workers > 1 and len(groups) > 1:
                with ThreadPoolExecutor(max_workers=int(max_workers)) as pool:
                    internal_total = sum(pool.map(run_group, range(len(groups))))
            else:
                internal_total = sum(run_group(gi) for gi in range(len(groups)))
        t_solve = solve_span.end()

        merge_span = trace_mod.begin("solve.level_merge", level=li)
        _apply_level(state, groups, results)
        t_merge = merge_span.end()
        info["levels"].append({
            "level": li,
            "groups": len(groups),
            "plane": level_plane,
            "edges_in": int(edges_in),
            "internal_edges": int(internal_total),
            "edges_out": int(len(state.edges)),
            "solve_s": round(t_solve, 6),
            "merge_s": round(t_merge, 6),
        })
        _record_solve_metrics(solve_levels=1, tree_solve_s=t_solve, tree_merge_s=t_merge)

    _record_solve_metrics(boundary_edges_out=len(state.edges))
    info["boundary_edges_root"] = int(len(state.edges))
    return _final_labels(state), info


# -- worker-group driver (inter-process reduce hops) -------------------------------


def _packet_path(scratch: str, level: int, group: int) -> str:
    return os.path.join(scratch, f"packet_l{level}_g{group}.npz")


def _publish_npz(path: str, **arrays) -> None:
    """Atomic packet publish: a reader sees the whole packet or none."""
    tmp = f"{path}.{os.getpid()}.tmp"
    np.savez(tmp, **arrays)
    if not tmp.endswith(".npz") and os.path.exists(tmp + ".npz"):
        tmp = tmp + ".npz"
    os.replace(tmp, path)


def _worker_pid_path(scratch: str, worker: int) -> str:
    return os.path.join(scratch, f"worker_{int(worker)}.json")


def _read_worker_os_pid(pid_path: str) -> Optional[int]:
    """The OS pid a reduce worker advertised at boot, or None while the
    file has not landed yet."""
    try:
        with open(pid_path) as f:
            return int(json.load(f)["os_pid"])
    except (OSError, ValueError, KeyError, TypeError):
        return None


def _wait_npz(path: str, wait_s: float, *, deadline: Optional[float] = None,
              owner_pid_path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Poll for a sibling's packet with ``wait_s`` of patience, re-armed for
    every packet.  Two fast paths bound the worst case: ``deadline`` (an
    absolute ``time.monotonic()``) caps the whole level's wait, and
    ``owner_pid_path`` names the publisher's boot-time pid record, probed
    ~4 times a second (``os.kill(pid, 0)``), so a dead publisher fails the
    hop in a quarter second, naming its pid."""
    hop_deadline = time.monotonic() + wait_s
    if deadline is not None:
        hop_deadline = min(hop_deadline, float(deadline))
    next_probe = time.monotonic() + 0.25
    while True:
        if os.path.exists(path):
            try:
                with np.load(path, allow_pickle=False) as f:
                    return {k: f[k] for k in f.files}
            except (OSError, ValueError) as e:
                # packets publish through os.replace: a torn file is real
                # corruption, not a read in mid-write
                raise ShardedSolveError(f"unreadable packet {path}: {e}")
        now = time.monotonic()
        if now > hop_deadline:
            raise ShardedSolveError(
                f"reduce hop lost: packet {os.path.basename(path)} did not arrive within {wait_s:g}s"
                + (" (level deadline)" if deadline is not None and hop_deadline == float(deadline) else "")
                + " (worker death?)")
        if owner_pid_path is not None and now >= next_probe:
            next_probe = now + 0.25
            owner_pid = _read_worker_os_pid(owner_pid_path)
            if owner_pid is not None:
                try:
                    os.kill(owner_pid, 0)
                except ProcessLookupError:
                    raise ShardedSolveError(f"reduce hop lost: worker owning {os.path.basename(path)} "
                                            f"(os pid {owner_pid}) is dead")
                except (PermissionError, OSError):
                    pass  # alive but unprobeable: keep the deadlines
        time.sleep(0.02)


def _group_owner(level: int, group: int, n_workers: int) -> int:
    """Deterministic round-robin deal of tree nodes over the worker group."""
    return int(group) % max(1, int(n_workers))


def reduce_worker_main() -> None:
    """SPMD body of one reduce-tree worker (entered through
    :func:`~.multihost.worker_main`, after the process joined the group).
    Solves the shards and merge groups this worker owns, publishes their
    packets, and folds every level from all packets, so its state stays the
    same as its siblings'.  Worker 0 publishes the final labels.

    A worker that fails flushes its traceback and then SIGKILLs itself: a
    normal exit would wait in the process group's teardown for siblings
    that may be dead."""
    import sys
    import traceback

    try:
        _reduce_worker_body()
    except Exception:
        import signal as signal_mod

        traceback.print_exc()
        sys.stderr.flush()
        sys.stdout.flush()
        try:
            # a failing worker's shard is the one the post-mortem needs
            trace_mod.flush()
        except Exception:
            pass
        os.kill(os.getpid(), signal_mod.SIGKILL)


def _reduce_worker_body() -> None:
    from ..runtime import faults as faults_mod
    from . import multihost
    from .mesh import SIBLING_AXIS

    scratch = os.environ[_ENV_DIR]
    pid = int(os.environ[multihost._ENV_PID])
    n_workers = int(os.environ[multihost._ENV_NPROC])
    hop_wait_s = float(os.environ.get(_ENV_WAIT, DEFAULT_HOP_WAIT_S))
    # boot-time pid record: siblings probe it to fail fast on this worker's
    # death (_wait_npz)
    fu.atomic_write_json(_worker_pid_path(scratch, pid), {"os_pid": os.getpid()})
    # the worker's lifetime span: tracing is on when the driver exported
    # CTT_TRACE=<its shard directory>
    worker_span = trace_mod.begin("solve.worker", worker=pid, workers=n_workers)

    with open(os.path.join(scratch, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(scratch, "problem.npz"), allow_pickle=False) as f:
        edges = f["edges"].astype(np.int64)
        payload = f["payload"].astype(np.float64)
        node_shard = f["node_shard"].astype(np.int64)
        ledges = f["lifted_edges"].astype(np.int64) if "lifted_edges" in f.files else None
        lpayload = f["lifted_payload"].astype(np.float64) if "lifted_payload" in f.files else None
    # a ``solve`` fault targeted at this worker id is a host lost
    # mid-reduce: die like hardware, so the siblings see a lost hop and the
    # driver degrades
    try:
        faults_mod.get_injector().maybe_fail("solve", block_id=pid)
    except Exception:
        import signal as signal_mod

        os.kill(os.getpid(), signal_mod.SIGKILL)

    n_nodes = int(meta["n_nodes"])
    # the tree-node solves are host work here: the numpy rung, never the card
    solver = default_tree_solver(meta["mode"], float(meta["threshold"]), impl=_host_impl(meta.get("impl")),
                                 device="cpu")
    levels = reduce_tree_levels(int(meta["n_shards"]), int(meta["fanout"]))
    state = _TreeState(n_nodes, edges, payload, ledges, lpayload, node_shard)

    # the plane is chosen once, the same way in every worker, before any
    # level: a worker cannot switch rungs mid-solve -- its siblings would
    # wait on packets that never come
    plane: Optional[CollectiveReducePlane] = None
    plane_reason = "packet plane requested"
    plane_req = str(meta.get("reduce_plane", "packet"))
    hop_deadline = _hop_deadline_s(meta.get("hop_deadline_s"))
    if plane_req in ("auto", "collective"):
        supported, reason = multihost.collectives_supported(deadline_s=hop_deadline)
        if not supported:
            plane_reason = f"collectives unsupported: {reason}"
        elif ledges is not None and len(ledges):
            plane_reason = "lifted edges have no frontier formulation"
        else:
            try:
                plane = CollectiveReducePlane(meta["mode"], float(meta["threshold"]),
                                              payload.shape[1] if payload.ndim > 1 else 1,
                                              hop_deadline_s=hop_deadline,
                                              mesh=multihost.pod_mesh(axis_names=(SIBLING_AXIS,)),
                                              device_pool_bytes=meta.get("device_pool_bytes"))
                plane_reason = "collective"
            except Exception as e:
                plane_reason = f"plane init failed: {e}"[:200]

    for li, groups in enumerate(levels):
        if plane is not None:
            # one SPMD program solves every group of the level over the
            # pod's mesh; its all_gather is the hop.  A failure here is a
            # worker failure; the driver retries on the packet plane.
            results, _ = plane.solve_level(state, groups, level=li, deadline_s=hop_deadline)
            _apply_level(state, groups, results)
            _flush_trace_quietly()
            continue
        for gi in range(len(groups)):
            if _group_owner(li, gi, n_workers) != pid:
                continue
            with trace_mod.span("solve.group", level=li, group=gi, worker=pid):
                members, labels, n_int = _solve_group(state, groups[gi], solver)
            _publish_npz(_packet_path(scratch, li, gi), members=members, labels=labels, n_internal=np.int64(n_int))
        # the level deadline is armed after this worker's own solves: a dead
        # group fails within one patience window, not one a hop
        level_deadline = time.monotonic() + hop_wait_s
        results = {}
        for gi in range(len(groups)):
            # one span an awaited packet: the hop latency, by worker and level
            with trace_mod.span("solve.hop_wait", level=li, group=gi, worker=pid):
                pkt = _wait_npz(_packet_path(scratch, li, gi), hop_wait_s, deadline=level_deadline,
                                owner_pid_path=_worker_pid_path(scratch, _group_owner(li, gi, n_workers)))
            results[gi] = (pkt["members"].astype(np.int64), pkt["labels"].astype(np.int64))
        _apply_level(state, groups, results)
        # each level's flush rewrites the whole shard: a worker killed at
        # level N leaves its spans through level N-1
        _flush_trace_quietly()

    if pid == 0:
        _publish_npz(os.path.join(scratch, "result.npz"), labels=_final_labels(state),
                     boundary_edges_root=np.int64(len(state.edges)),
                     plane_used=np.str_("collective" if plane is not None else "packet"),
                     plane_reason=np.str_(plane_reason))
    worker_span.end()
    _flush_trace_quietly()
    print(f"REDUCE_TREE_OK pid={pid} workers={n_workers}", flush=True)


def _flush_trace_quietly() -> None:
    """A tracing write failure never fails a healthy worker."""
    try:
        trace_mod.flush()
    except Exception:
        pass


def solve_over_workers(n_nodes: int, edges: np.ndarray, payload: np.ndarray, node_shard: np.ndarray, *,
                       fanout: int = 2, mode: str = "max", threshold: float = 0.0,
                       lifted_edges: Optional[np.ndarray] = None, lifted_payload: Optional[np.ndarray] = None,
                       n_workers: int = 2, scratch_dir: str, timeout: Optional[float] = None,
                       hop_wait_s: Optional[float] = None, impl: Optional[str] = None, reduce_plane: str = "packet",
                       hop_deadline_s: Optional[float] = None, device=None,
                       device_pool_bytes: Optional[int] = None) -> Tuple[np.ndarray, Dict]:
    """Run the reduce tree over a :func:`~.multihost.launch_workers` group.

    The problem is staged once into ``scratch_dir``; each worker solves the
    shards and groups it owns, and the packets between levels are the
    inter-process hops.  Raises :class:`ShardedSolveError` on any worker
    failure or lost packet.

    ``reduce_plane``: ``packet`` runs the workers on the CPU (numpy rung;
    they never touch the card); ``auto``/``collective`` run them on
    ``device`` (``None``: the card), and each probes
    :func:`~.multihost.collectives_supported` once: where the group can run
    collectives it solves each level as one program over the pod's sibling
    mesh, else all workers stay on packets.  ``info["reduce_plane"]`` is the
    rung that ran, ``info["plane_reason"]`` why.
    """
    from .multihost import launch_workers

    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    payload = _as_payload(payload, len(edges))
    node_shard = np.asarray(node_shard, dtype=np.int64)
    n_shards = int(node_shard.max()) + 1 if int(n_nodes) else 1
    os.makedirs(scratch_dir, exist_ok=True)
    for stale in os.listdir(scratch_dir):
        if stale.startswith(("packet_", "result", "worker_")):
            try:
                os.unlink(os.path.join(scratch_dir, stale))
            except OSError:
                pass
    arrays = {"edges": edges, "payload": payload, "node_shard": node_shard}
    if lifted_edges is not None and len(lifted_edges):
        arrays["lifted_edges"] = np.asarray(lifted_edges, np.int64)
        arrays["lifted_payload"] = _as_payload(lifted_payload, len(arrays["lifted_edges"]))
    _publish_npz(os.path.join(scratch_dir, "problem.npz"), **arrays)
    fu.atomic_write_json(os.path.join(scratch_dir, "meta.json"), {
        "n_nodes": int(n_nodes),
        "n_shards": n_shards,
        "fanout": int(fanout),
        "mode": mode,
        "threshold": float(threshold),
        # resolved in this process, so force_python() here reaches the workers
        "impl": _host_impl(impl),
        "reduce_plane": str(reduce_plane),
        "hop_deadline_s": _hop_deadline_s(hop_deadline_s),
        "device_pool_bytes": device_pool_bytes,
    })
    if timeout is None:
        # the group's patience must outlast the workers' own hop wait, so a
        # lost packet surfaces as a worker's exit code, not a group kill
        timeout = float(os.environ.get("CT_RT_TIMEOUT_S", "600"))
    extra_env = {
        _ENV_DIR: scratch_dir,
        # explicit argument > operator env > default (launch_workers applies
        # extra_env over os.environ)
        _ENV_WAIT: str(hop_wait_s if hop_wait_s is not None else os.environ.get(_ENV_WAIT, DEFAULT_HOP_WAIT_S)),
    }
    if trace_mod.enabled() and trace_mod.trace_dir():
        # a traced driver hands the workers its shard directory: the value
        # both turns their tracing on and pins the directory
        extra_env[trace_mod.ENV_VAR] = trace_mod.trace_dir()
    group_span = trace_mod.begin("solve.worker_group", workers=int(n_workers), shards=n_shards)
    try:
        results = launch_workers(int(n_workers), "cluster_tools_tpu_torch.parallel.reduce_tree:reduce_worker_main",
                                 timeout=timeout, extra_env=extra_env,
                                 device="cpu" if str(reduce_plane) == "packet" else device)
    except TimeoutError as e:
        group_span.end(error=True)
        raise ShardedSolveError(f"worker group timed out: {e}") from e
    failed = [(pid, rc, (err or "")[-500:]) for pid, (rc, _, err) in enumerate(results) if rc != 0]
    if failed:
        group_span.end(error=True)
        raise ShardedSolveError("worker(s) died during the sharded solve: "
                                + "; ".join(f"pid {p} rc={rc}" for p, rc, _ in failed)
                                + "\n" + "\n".join(t for _, _, t in failed))
    result_path = os.path.join(scratch_dir, "result.npz")
    if not os.path.exists(result_path):
        group_span.end(error=True)
        raise ShardedSolveError("worker group finished without a result packet")
    with np.load(result_path, allow_pickle=False) as f:
        labels = f["labels"].astype(np.int64)
        root_edges = int(f["boundary_edges_root"]) if "boundary_edges_root" in f.files else 0
        plane_used = str(f["plane_used"]) if "plane_used" in f.files else "packet"
        plane_reason = str(f["plane_reason"]) if "plane_reason" in f.files else ""
    wall = group_span.end()
    levels = reduce_tree_levels(n_shards, fanout)
    info = {
        "sharded": True,
        "shards": n_shards,
        "fanout": int(fanout),
        "workers": int(n_workers),
        "reduce_plane": plane_used,
        "plane_reason": plane_reason,
        "levels": [{"level": i, "groups": len(g)} for i, g in enumerate(levels)],
        "wall_s": round(wall, 4),
        "boundary_edges_root": root_edges,
        # the rounds tick inside the workers, invisible to this process's
        # counters: a worker-group solve reports rounds=0 by design
    }
    _record_solve_metrics(sharded_solves=1, solve_shards=n_shards, solve_levels=len(levels),
                          boundary_edges_in=len(edges), boundary_edges_out=root_edges, tree_solve_s=wall)
    return labels, info


# -- the attributed task entry point -------------------------------------------------


def solve_with_reduce_tree(n_nodes: int, edges: np.ndarray, payload: np.ndarray, *, node_shard, solver_shards: int,
                           fanout: int, failures_path: str, task_name: str, unsharded: Callable[[], np.ndarray],
                           solver: Optional[Callable] = None, mode: str = "max", threshold: float = 0.0,
                           lifted_edges: Optional[np.ndarray] = None, lifted_payload: Optional[np.ndarray] = None,
                           workers: int = 1, scratch_dir: Optional[str] = None,
                           worker_timeout: Optional[float] = None, max_workers: int = 1,
                           reduce_plane: str = "auto", hop_deadline_s: Optional[float] = None,
                           device=None, device_pool_bytes: Optional[int] = None) -> Tuple[np.ndarray, Dict]:
    """Sharded solve with the single-host solve as the degenerate case and
    the fallback.  Returns ``(labels, info)``.

    ``node_shard``: the partition array, a zero-argument callable building
    it (resolved inside the fallback ladder, so a failing partition
    degrades), or None (single-host, no failure record).
    ``solver_shards <= 1`` (or an empty graph) runs ``unsharded()``.
    Otherwise the reduce tree runs in this process on ``device``, or over a
    ``workers``-process group when ``workers > 1`` (default solver only);
    any failure in it is recorded in ``failures.json`` as
    ``degraded:unsharded_solve`` and ``unsharded()`` produces the answer.
    ``BaseException``\\ s that are not ``Exception``\\ s pass through.

    ``reduce_plane``/``hop_deadline_s``/``device_pool_bytes`` configure the
    level engine (see :func:`sharded_solve`); ``collective`` rides the
    ladder collective -> packet -> unsharded, each rung attributed.  The
    fault injector's ``solve`` site fires first, inside the ladder.
    """
    shards = int(solver_shards or 1)
    if shards <= 1 or node_shard is None or int(n_nodes) == 0 or len(edges) == 0:
        return unsharded(), {"sharded": False, "shards": 1}
    no_partition = False
    try:
        from ..runtime import faults as faults_mod

        faults_mod.get_injector().maybe_fail("solve")
        if callable(node_shard):
            node_shard = node_shard()
            if node_shard is None:
                # nothing to shard by (no block geometry): single-host, and
                # not a failure worth attributing
                no_partition = True
                raise ShardedSolveError("no block geometry to shard by")
        plane_req = _plane_request(reduce_plane)
        if int(workers) > 1:
            if scratch_dir is None:
                raise ShardedSolveError("worker-group solve needs a scratch_dir for the hops")

            def worker_solve(rp):
                return solve_over_workers(n_nodes, edges, payload, node_shard, fanout=fanout, mode=mode,
                                          threshold=threshold, lifted_edges=lifted_edges,
                                          lifted_payload=lifted_payload, n_workers=int(workers),
                                          scratch_dir=scratch_dir, timeout=worker_timeout, reduce_plane=rp,
                                          hop_deadline_s=hop_deadline_s, device=device,
                                          device_pool_bytes=device_pool_bytes)

            if plane_req != "collective":
                return worker_solve(plane_req)
            # demanded collective: one retry on the packet plane before the
            # unsharded ladder below
            try:
                labels, winfo = worker_solve("collective")
            except ShardedSolveError as hop_err:
                _record_packet_degrade(failures_path, task_name, hop_err)
                labels, winfo = worker_solve("packet")
                winfo["degraded_plane"] = str(hop_err)[:200]
                return labels, winfo
            if winfo.get("reduce_plane") != "collective":
                # the workers degraded up front: attribute it here, once
                _record_packet_degrade(failures_path, task_name, ShardedSolveError(
                    winfo.get("plane_reason") or "collective plane unavailable in the worker group"))
            return labels, winfo
        return sharded_solve(n_nodes, edges, payload, node_shard, fanout=fanout, solver=solver, mode=mode,
                             threshold=threshold, lifted_edges=lifted_edges, lifted_payload=lifted_payload,
                             max_workers=max_workers, reduce_plane=plane_req, hop_deadline_s=hop_deadline_s,
                             failures_path=failures_path, task_name=task_name, device=device,
                             device_pool_bytes=device_pool_bytes)
    except Exception as e:
        if no_partition:
            return unsharded(), {"sharded": False, "shards": 1}
        _record_solve_metrics(unsharded_fallbacks=1)
        trace_mod.instant("degraded:unsharded_solve", task=task_name, error=f"{type(e).__name__}: {e}"[:200])
        try:
            fu.record_failures(failures_path, task_name, [{
                "block_id": None,
                "sites": {"solve": 1},
                "error": fu.cap_traceback(f"{type(e).__name__}: {e}"),
                "quarantined": False,
                "resolved": True,
                "resolution": "degraded:unsharded_solve",
            }])
        except Exception:
            pass  # attribution is best effort; the solve must still land
        labels = unsharded()
        return labels, {"sharded": False, "shards": shards, "degraded": "unsharded_solve", "error": str(e)[:300]}
