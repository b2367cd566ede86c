"""Average-linkage agglomerative clustering of a region graph (GASP-style).

The reference's ``cluster_tools/agglomerative_clustering/`` ran nifty/elf
agglomeration on the RAG from merged features (SURVEY.md §2a).  This module
implements the host-side core: merge the currently-cheapest edge (lowest
size-weighted mean boundary probability) while it is below ``threshold``;
contractions combine parallel edges by size-weighted averaging — i.e.
average linkage, the GASP default.

Same heap + neighbor-map scheme as :mod:`.multicut`'s GAEC (lazy
invalidation by current-value check), with (weight-sum, size-sum) payloads
instead of additive costs.
"""

from __future__ import annotations

import heapq

import numpy as np


def average_agglomeration(
    n_nodes: int,
    edges: np.ndarray,
    probs: np.ndarray,
    sizes: np.ndarray,
    threshold: float,
) -> np.ndarray:
    """Average-linkage agglomeration.  Returns int64 labels 0..k-1.

    ``probs``: per-edge mean boundary probability (low = merge);
    ``sizes``: per-edge contact areas (the averaging weights).

    Tie-breaking is deterministic and documented: heap entries are
    ``(mean, u, v, size_sum)`` tuples, so among equal-mean edges the
    smallest ``(u, v)`` endpoint pair (cluster representatives at push
    time) merges first — the same ordering contract as
    :func:`..ops.multicut.greedy_additive`, keeping impl-ladder parity
    tests stable across platforms.
    """
    n_nodes = int(n_nodes)
    edges = np.asarray(edges, dtype=np.int64)
    probs = np.asarray(probs, dtype=np.float64)
    sizes = np.asarray(sizes, dtype=np.float64)

    parent = np.arange(n_nodes, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    # neighbor maps: nbrs[u][v] = (weight_sum, size_sum); mean = ws / ss
    nbrs: list = [dict() for _ in range(n_nodes)]
    for (u, v), p, s in zip(edges, probs, sizes):
        if u == v:
            continue
        u, v = int(u), int(v)
        s = max(float(s), 1e-12)
        ws, ss = nbrs[u].get(v, (0.0, 0.0))
        nbrs[u][v] = (ws + p * s, ss + s)
        nbrs[v][u] = nbrs[u][v]

    heap = [
        (ws / ss, u, v, ss)
        for u in range(n_nodes)
        for v, (ws, ss) in nbrs[u].items()
        if u < v
    ]
    heapq.heapify(heap)

    while heap:
        mean_p, u, v, ss = heapq.heappop(heap)
        if mean_p >= threshold:
            break
        ru, rv = find(u), find(v)
        if ru == rv:
            continue
        cur = nbrs[ru].get(rv)
        # stale unless the entry still matches the popped priority
        if cur is None or abs(cur[0] / cur[1] - mean_p) > 1e-12 or cur[1] != ss:
            continue
        if len(nbrs[ru]) < len(nbrs[rv]):
            ru, rv = rv, ru
        parent[rv] = ru
        del nbrs[ru][rv]
        for x, (ws_x, ss_x) in nbrs[rv].items():
            if x == ru:
                continue
            ws0, ss0 = nbrs[ru].get(x, (0.0, 0.0))
            combined = (ws0 + ws_x, ss0 + ss_x)
            nbrs[ru][x] = combined
            nbrs[x][ru] = combined
            del nbrs[x][rv]
            new_mean = combined[0] / combined[1]
            if new_mean < threshold:
                heapq.heappush(heap, (new_mean, ru, x, combined[1]))
        nbrs[rv].clear()

    roots = np.array([find(i) for i in range(n_nodes)], dtype=np.int64)
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int64)
