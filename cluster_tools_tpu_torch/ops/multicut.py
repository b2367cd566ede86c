"""Multicut solvers: GAEC, Kernighan-Lin, fusion moves, decomposition.

Port of ``cluster_tools_tpu/ops/multicut.py`` (numpy and Python): the
reference's solver core behind ``utils/segmentation_utils.py``'s registry.

- :func:`greedy_additive` -- GAEC: contract the currently-most-attractive
  edge until none is positive (heap + neighbour maps);
- :func:`kernighan_lin` -- KL for multicut (Keuper et al.'s KLj): pairwise
  two-set refinement with gain sequences rolled back to the best prefix,
  plus join moves;
- :func:`fusion_moves` -- proposals from GAEC on perturbed costs, fused
  with the incumbent on the intersection-contracted graph;
- :func:`decompose_solve` -- solve each component of the attractive
  subgraph on its own;
- :func:`multicut_energy` -- the objective, the sum of the costs of cut
  edges (costs > 0 attractive, < 0 repulsive; minimised).

The reference calls its host C++ library for GAEC and KL when it is
built; the port carries only their Python paths, which compute the same
labels (the C++ rung is ROADMAP Queue A item 13).  The lifted solvers
wait for item 12.

Sign convention matches ``probs_to_costs``: ``w = log((1-p)/p)``.
"""

from __future__ import annotations

import hashlib
import heapq
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from zipfile import BadZipFile

from .rag import unique_pairs


class SolverCheckpoint:
    """Preemption-safe intermediate state for long solves (SURVEY.md §5.3).

    The reference's resume grain is task/block; a long global solve dying
    mid-run lost everything.  This persists the partition after every KL
    outer sweep (atomic tmp+rename, like the block markers), fingerprinted
    by the problem's (edges, costs) bytes so a stale checkpoint from a
    different reduced problem can never seed a resume.
    """

    def __init__(self, path: str, edges: np.ndarray, costs: np.ndarray):
        self.path = path
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(edges).tobytes())
        h.update(np.ascontiguousarray(costs).tobytes())
        self.problem_key = h.hexdigest()

    def load(self) -> Optional[Tuple[np.ndarray, int]]:
        """(labels, next_sweep) from a matching checkpoint, else None."""
        if not os.path.exists(self.path):
            return None
        try:
            with np.load(self.path, allow_pickle=False) as f:
                if str(f["problem_key"]) != self.problem_key:
                    return None
                return f["labels"].astype(np.int64), int(f["sweep"])
        except (OSError, ValueError, KeyError, BadZipFile):
            # torn write from a crash mid-save: ignore, solve from scratch
            return None

    def save(self, labels: np.ndarray, sweep: int, energy: float) -> None:
        self._sweep_temps()  # a kill inside a prior save orphans its temp
        tmp = f"{self.path}.{os.getpid()}.tmp"
        np.savez(
            tmp,
            labels=np.asarray(labels, np.int64),
            sweep=np.int64(sweep),
            energy=np.float64(energy),
            problem_key=self.problem_key,
        )
        # np.savez appends .npz to names without it
        if not tmp.endswith(".npz") and os.path.exists(tmp + ".npz"):
            tmp = tmp + ".npz"
        os.replace(tmp, self.path)

    def clear(self) -> None:
        self._sweep_temps()
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def _sweep_temps(self) -> None:
        import glob

        for stale in glob.glob(f"{self.path}.*.tmp*"):
            try:
                os.unlink(stale)
            except OSError:
                pass


def multicut_energy(
    edges: np.ndarray, costs: np.ndarray, node_labels: np.ndarray
) -> float:
    """Objective value: sum of costs over cut edges (lower is better)."""
    if len(edges) == 0:
        return 0.0
    cut = node_labels[edges[:, 0]] != node_labels[edges[:, 1]]
    return float(costs[cut].sum())


def _relabel_consecutive(parent: np.ndarray) -> np.ndarray:
    _, labels = np.unique(parent, return_inverse=True)
    return labels.astype(np.int64)


def greedy_additive(
    n_nodes: int, edges: np.ndarray, costs: np.ndarray, stop_cost: float = 0.0
) -> np.ndarray:
    """Greedy additive edge contraction (GAEC, Keuper et al. style).

    Repeatedly contracts the highest-cost edge while it exceeds
    ``stop_cost`` (default 0: only attractive edges merge); parallel edges
    arising from a contraction have their costs *added*.  Returns int64
    node labels 0..k-1.

    Tie-breaking is deterministic and documented: heap entries are
    ``(-cost, u, v)`` tuples, so among equal-cost edges the smallest
    ``(u, v)`` endpoint pair (current cluster representatives at push time)
    contracts first.
    """
    n_nodes = int(n_nodes)
    edges = np.asarray(edges, dtype=np.int64)
    costs = np.asarray(costs, dtype=np.float64)

    # union-find
    parent = np.arange(n_nodes, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    # neighbor cost maps, symmetric
    nbrs: list = [dict() for _ in range(n_nodes)]
    for (u, v), w in zip(edges, costs):
        if u == v:
            continue
        u, v = int(u), int(v)
        nbrs[u][v] = nbrs[u].get(v, 0.0) + w
        nbrs[v][u] = nbrs[v].get(u, 0.0) + w
    heap: list = [
        (-w, u, v) for u in range(n_nodes) for v, w in nbrs[u].items() if u < v
    ]
    heapq.heapify(heap)

    while heap:
        neg_w, u, v = heapq.heappop(heap)
        w = -neg_w
        if w <= stop_cost:
            break
        ru, rv = find(u), find(v)
        if ru == rv:
            continue
        # stale entry: the edge's current weight must match
        if nbrs[ru].get(rv) != w:
            continue
        # contract rv into ru (ru keeps the larger neighbor map)
        if len(nbrs[ru]) < len(nbrs[rv]):
            ru, rv = rv, ru
        parent[rv] = ru
        del nbrs[ru][rv]
        for x, wx in nbrs[rv].items():
            if x == ru:
                continue
            new_w = nbrs[ru].get(x, 0.0) + wx
            nbrs[ru][x] = new_w
            nbrs[x][ru] = new_w
            del nbrs[x][rv]
            if new_w > stop_cost:
                heapq.heappush(heap, (-new_w, ru, x))
        nbrs[rv].clear()

    roots = np.array([find(i) for i in range(n_nodes)], dtype=np.int64)
    return _relabel_consecutive(roots)


def greedy_node_moves(
    n_nodes: int,
    edges: np.ndarray,
    costs: np.ndarray,
    init_labels: np.ndarray | None = None,
    max_passes: int = 10,
) -> np.ndarray:
    """Greedy single-node move refinement (hill climbing): move boundary
    nodes to the adjacent partition with the best immediate gain.  Cheaper
    and weaker than :func:`kernighan_lin` — no gain sequences, cannot escape
    single-move local minima."""
    edges = np.asarray(edges, dtype=np.int64)
    costs = np.asarray(costs, dtype=np.float64)
    labels = (
        greedy_additive(n_nodes, edges, costs)
        if init_labels is None
        else np.asarray(init_labels, dtype=np.int64).copy()
    )
    if len(edges) == 0:
        return _relabel_consecutive(labels)
    # adjacency with costs
    adj: list = [[] for _ in range(n_nodes)]
    for (u, v), w in zip(edges, costs):
        if u == v:
            continue
        adj[int(u)].append((int(v), w))
        adj[int(v)].append((int(u), w))

    for _ in range(max_passes):
        moved = False
        for u in range(n_nodes):
            if not adj[u]:
                continue
            lu = labels[u]
            # gain of moving u to partition L = sum of edge costs to L
            # minus sum of edge costs to current partition
            gains: Dict[int, float] = {}
            stay = 0.0
            for v, w in adj[u]:
                lv = labels[v]
                if lv == lu:
                    stay += w
                else:
                    gains[lv] = gains.get(lv, 0.0) + w
            if not gains:
                continue
            best_l, best_w = max(gains.items(), key=lambda kv: kv[1])
            if best_w > stay + 1e-12:
                labels[u] = best_l
                moved = True
        if not moved:
            break
    return _relabel_consecutive(labels)


def _kl_refine_pair(
    nodes_a: List[int],
    nodes_b: List[int],
    labels: np.ndarray,
    adj: List[List[Tuple[int, float]]],
    epsilon: float,
) -> float:
    """One KL inner loop on the two partitions holding ``nodes_a/b``.

    Builds the full tentative move sequence (every node of both sets flipped
    exactly once, always the unmoved node with maximal gain next — negative
    gains included), then applies the best positive prefix, or the A|B join
    if that is better.  Returns the realized energy improvement; mutates
    ``labels`` in place.
    """
    la = labels[nodes_a[0]]
    lb = labels[nodes_b[0]]
    members = nodes_a + nodes_b
    in_pair = {u: i for i, u in enumerate(members)}
    side = np.array([0] * len(nodes_a) + [1] * len(nodes_b), dtype=np.int8)

    # D[i] = gain of flipping member i = c(i, other side) - c(i, own side),
    # edges within the pair only (edges to other partitions stay cut either
    # way); cut_ab = total cost currently cut between A and B (join gain)
    d = np.zeros(len(members))
    cut_ab = 0.0
    for i, u in enumerate(members):
        for v, w in adj[u]:
            j = in_pair.get(v)
            if j is None:
                continue
            if side[j] == side[i]:
                d[i] -= w
            else:
                d[i] += w
                if i < j:
                    cut_ab += w
    join_gain = cut_ab

    # tentative sequence with rollback to the best prefix
    moved = np.zeros(len(members), bool)
    order: List[int] = []
    cum = 0.0
    cum_seq: List[float] = []
    for _ in range(len(members)):
        cand = np.where(~moved)[0]
        i = cand[np.argmax(d[cand])]
        moved[i] = True
        order.append(int(i))
        cum += d[i]
        cum_seq.append(cum)
        u = members[i]
        old_side = side[i]
        side[i] = 1 - old_side
        for v, w in adj[u]:
            j = in_pair.get(v)
            if j is None or moved[j]:
                continue
            d[j] += 2.0 * w if side[j] == old_side else -2.0 * w

    best_k = int(np.argmax(cum_seq)) + 1
    best_gain = cum_seq[best_k - 1]

    if join_gain > best_gain and join_gain > epsilon:
        for u in nodes_b:
            labels[u] = la
        return join_gain
    if best_gain > epsilon:
        # flipping ALL nodes is a relabeling no-op (A and B swap names);
        # treat it as no gain to avoid cycling
        if best_k == len(members):
            return 0.0
        for i in order[:best_k]:
            labels[members[i]] = lb if labels[members[i]] == la else la
        return best_gain
    return 0.0


def kernighan_lin(
    n_nodes: int,
    edges: np.ndarray,
    costs: np.ndarray,
    init_labels: np.ndarray | None = None,
    max_outer: int = 20,
    epsilon: float = 1e-9,
    checkpoint: Optional[SolverCheckpoint] = None,
) -> np.ndarray:
    """Kernighan-Lin for multicut (Keuper et al.'s KLj scheme).

    Starting from an initial partition (GAEC by default), repeatedly refines
    every pair of adjacent partitions with the classic KL inner loop — a
    *gain sequence* of tentative node flips (negative gains included)
    rolled back to its best prefix — and considers joining the pair
    outright.  Iterates until a full sweep yields no improvement.  Energy is
    monotonically non-increasing from the initial partition.

    With ``checkpoint``, the solve becomes preemption-safe: the partition
    persists after the GAEC init and after EVERY outer sweep (one sweep per
    solver call), and a killed run resumes from the last persisted sweep —
    identical sweep sequence, identical result.  ``checkpoint.clear()`` is
    the caller's responsibility on success (the task layer owns artifact
    lifecycle).
    """
    edges = np.asarray(edges, dtype=np.int64)
    costs = np.asarray(costs, dtype=np.float64)
    start_sweep = 0
    resumed = checkpoint.load() if checkpoint is not None else None
    if resumed is not None:
        labels, start_sweep = resumed
        labels = labels.copy()
    else:
        labels = (
            greedy_additive(n_nodes, edges, costs)
            if init_labels is None
            else np.asarray(init_labels, dtype=np.int64).copy()
        )
    if len(edges) == 0:
        return _relabel_consecutive(labels)

    if checkpoint is None:
        return _kernighan_lin_python(
            n_nodes, edges, costs, labels, max_outer, epsilon
        )

    # checkpointed mode: one outer sweep per call, persist between sweeps.
    # Each call recomputes partition pairs from the current labels — exactly
    # what the fused outer loop does — so the sweep sequence (and result)
    # matches an uninterrupted checkpointed run after any kill+resume.
    prev_e = multicut_energy(edges, costs, labels)
    if resumed is None:
        checkpoint.save(labels, 0, prev_e)
    for sweep in range(start_sweep, max_outer):
        refined = _kernighan_lin_python(
            n_nodes, edges, costs, labels.copy(), 1, epsilon
        )
        e = multicut_energy(edges, costs, refined)
        labels = np.asarray(refined, np.int64)
        checkpoint.save(labels, sweep + 1, e)
        if prev_e - e <= epsilon:
            break
        prev_e = e
    return _relabel_consecutive(labels)


def _kernighan_lin_python(
    n_nodes: int,
    edges: np.ndarray,
    costs: np.ndarray,
    labels: np.ndarray,
    max_outer: int = 20,
    epsilon: float = 1e-9,
) -> np.ndarray:
    """Pure-Python KL sweeps.  Mutates ``labels`` and returns a relabelled
    copy."""
    adj: List[List[Tuple[int, float]]] = [[] for _ in range(n_nodes)]
    for (u, v), w in zip(edges, costs):
        if u == v:
            continue
        adj[int(u)].append((int(v), float(w)))
        adj[int(v)].append((int(u), float(w)))

    for _ in range(max_outer):
        # adjacent pairs from the current cut edges
        pairs = set()
        for (u, v) in edges:
            lu, lv = int(labels[u]), int(labels[v])
            if lu != lv:
                pairs.add((min(lu, lv), max(lu, lv)))

        improved = 0.0
        for la, lb in sorted(pairs):
            # membership MUST be read fresh per pair: earlier refinements in
            # this sweep move/join nodes, and _kl_refine_pair's gain
            # accounting assumes its member lists are exactly the nodes
            # currently labeled la/lb (stale lists once caused energy
            # increases by treating in-pair edges as fixed cut edges)
            a = np.where(labels == la)[0].tolist()
            b = np.where(labels == lb)[0].tolist()
            if not a or not b:
                continue
            improved += _kl_refine_pair(a, b, labels, adj, epsilon)
        if improved <= epsilon:
            break
    return _relabel_consecutive(labels)


def fusion_moves(
    n_nodes: int,
    edges: np.ndarray,
    costs: np.ndarray,
    n_iterations: int = 8,
    noise_scale: float = 1.0,
    seed: int = 0,
    refine_with_kl: bool = True,
) -> np.ndarray:
    """Fusion-move multicut solver (Beier et al. style).

    The incumbent starts at GAEC.  Each round draws a proposal partition —
    GAEC on costs perturbed with Gaussian noise (scaled by the cost std and
    annealed over rounds) — and *fuses* it with the incumbent: nodes agreeing
    in both partitions are contracted, the small fused problem is solved with
    GAEC+KL, and the result is accepted iff the energy improves.  Since the
    fused search space contains both inputs, energy never increases; with KL
    refinement the solution matches or beats both GAEC and plain KL in
    practice.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    costs = np.asarray(costs, dtype=np.float64)
    best = greedy_additive(n_nodes, edges, costs)
    if refine_with_kl:
        best = kernighan_lin(n_nodes, edges, costs, init_labels=best)
    best_e = multicut_energy(edges, costs, best)
    if len(edges) == 0:
        return best
    rng = np.random.default_rng(seed)
    scale0 = float(np.std(costs)) if len(costs) else 1.0

    for it in range(n_iterations):
        sigma = noise_scale * scale0 * (1.0 - it / max(n_iterations, 1) * 0.5)
        proposal = greedy_additive(
            n_nodes, edges, costs + rng.normal(0.0, sigma, len(costs))
        )
        # intersection partition: same cluster iff same in BOTH partitions
        inter = np.unique(
            np.stack([best, proposal], axis=1), axis=0, return_inverse=True
        )[1].astype(np.int64)
        c_edges, c_costs = contract_graph(edges, costs, inter)
        k = int(inter.max()) + 1
        sub = greedy_additive(k, c_edges, c_costs)
        if refine_with_kl:
            sub = kernighan_lin(k, c_edges, c_costs, init_labels=sub)
        cand = sub[inter]
        cand_e = multicut_energy(edges, costs, cand)
        if cand_e < best_e - 1e-12:
            best, best_e = cand, cand_e
    return _relabel_consecutive(best)


def decompose_solve(
    n_nodes: int,
    edges: np.ndarray,
    costs: np.ndarray,
    sub_solver=None,
) -> np.ndarray:
    """Decomposition solver: split over attractive-edge components first.

    Components connected only through repulsive (cost <= 0) edges can never
    profitably merge, so the graph decomposes into the connected components
    of the attractive subgraph, each solved independently (nifty's
    decomposition-solver pattern).  ``sub_solver(n, edges, costs)`` defaults
    to :func:`fusion_moves`.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    costs = np.asarray(costs, dtype=np.float64)
    if sub_solver is None:
        sub_solver = fusion_moves
    if len(edges) == 0:
        return np.arange(int(n_nodes), dtype=np.int64)

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as cc

    pos = edges[costs > 0]
    if len(pos) == 0:
        return np.arange(int(n_nodes), dtype=np.int64)
    g = coo_matrix(
        (np.ones(len(pos)), (pos[:, 0], pos[:, 1])), shape=(n_nodes, n_nodes)
    )
    n_comp, comp = cc(g, directed=False)
    # group nodes and intra-component edges per component with one sort each
    # (a per-component remap/scan would be quadratic when the graph shatters)
    node_order = np.argsort(comp, kind="stable")
    node_starts = np.searchsorted(comp[node_order], np.arange(n_comp + 1))
    node_rank = np.empty(n_nodes, dtype=np.int64)
    node_rank[node_order] = np.arange(n_nodes) - node_starts[comp[node_order]]
    ecomp = comp[edges[:, 0]]
    same = ecomp == comp[edges[:, 1]]
    se, sc, ec = edges[same], costs[same], ecomp[same]
    edge_order = np.argsort(ec, kind="stable")
    edge_starts = np.searchsorted(ec[edge_order], np.arange(n_comp + 1))

    labels = np.zeros(n_nodes, dtype=np.int64)
    offset = 0
    for c in range(n_comp):
        nodes = node_order[node_starts[c] : node_starts[c + 1]]
        if len(nodes) == 1:
            labels[nodes] = offset
            offset += 1
            continue
        eidx = edge_order[edge_starts[c] : edge_starts[c + 1]]
        sub_edges = node_rank[se[eidx]]
        sub = sub_solver(len(nodes), sub_edges, sc[eidx])
        labels[nodes] = sub + offset
        offset += int(sub.max()) + 1 if len(sub) else 1
    return _relabel_consecutive(labels)


def contract_graph(
    edges: np.ndarray,
    costs: np.ndarray,
    node_labels: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Contract a graph by a node labeling: map endpoints through labels,
    drop self-edges, sum parallel-edge costs.  Returns (new_edges,
    new_costs) on the label id space — the reduce step of the hierarchical
    multicut (reference: ``reduce_problem.py``)."""
    if len(edges) == 0:
        return edges.reshape(0, 2).astype(np.int64), costs.astype(np.float64)
    u = node_labels[edges[:, 0]]
    v = node_labels[edges[:, 1]]
    lo = np.minimum(u, v)
    hi = np.maximum(u, v)
    keep = lo != hi
    pairs = np.stack([lo[keep], hi[keep]], axis=1)
    w = np.asarray(costs, dtype=np.float64)[keep]
    if len(pairs) == 0:
        return np.zeros((0, 2), np.int64), np.zeros(0, np.float64)
    # rows through one 64-bit key where ids fit; bincount adds in index
    # order from 0.0, as np.add.at does, so the sums are the same bits
    new_edges, inv = unique_pairs(pairs)
    new_costs = np.bincount(inv, weights=w, minlength=len(new_edges))
    return new_edges.astype(np.int64), new_costs
