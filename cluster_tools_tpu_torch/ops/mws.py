"""Mutex watershed over affinity maps with offset vectors.

Port of ``cluster_tools_tpu/ops/mws.py``: the per-block Kruskal-style
mutex watershed (Wolf et al.).  All attractive and repulsive edges are
processed in order of decreasing priority; an attractive edge unions its
endpoints unless a mutex forbids it, a repulsive edge installs a mutex
between its endpoints' clusters.

Edge generation and the priority sort are vectorized numpy; the
constraint loop is sequential over the sorted edges and runs in the host
C++ rung (:func:`..native.mutex_watershed`), or in
:func:`python_constraint_loop` inside ``native.force_python()``.  Both give
the same partition.

Convention: ``offsets[:ndim]`` are the unit ("attractive") offsets; all
further offsets are long-range ("repulsive").  High affinity means strong
attraction on attractive channels and strong repulsion on repulsive ones.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .. import native


def offset_edges(
    shape: Sequence[int], offsets: Sequence[Sequence[int]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (u, v, channel) edges induced by ``offsets`` on a ``shape`` grid.

    Returns flat voxel indices ``u``, ``v`` and the channel index per edge;
    edges whose endpoint falls outside the volume are dropped.
    """
    shape = tuple(shape)
    us, vs, cs = [], [], []
    idx = np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape)
    for c, off in enumerate(offsets):
        src = tuple(
            slice(max(0, -o), s - max(0, o)) for o, s in zip(off, shape)
        )
        dst = tuple(
            slice(max(0, o), s - max(0, -o)) for o, s in zip(off, shape)
        )
        u = idx[src].ravel()
        v = idx[dst].ravel()
        us.append(u)
        vs.append(v)
        cs.append(np.full(len(u), c, np.int32))
    return np.concatenate(us), np.concatenate(vs), np.concatenate(cs)


def _affinity_values(
    affs: np.ndarray, offsets: Sequence[Sequence[int]]
) -> np.ndarray:
    """Per-edge affinity values matching :func:`offset_edges` order."""
    shape = affs.shape[1:]
    vals = []
    for c, off in enumerate(offsets):
        src = tuple(
            slice(max(0, -o), s - max(0, o)) for o, s in zip(off, shape)
        )
        vals.append(affs[c][src].ravel())
    return np.concatenate(vals)


class _MutexUnionFind:
    """Union-find with per-cluster mutex sets (small-set merging)."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.rank = np.zeros(n, np.int8)
        self.mutexes: dict = {}

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def has_mutex(self, ra: int, rb: int) -> bool:
        ma = self.mutexes.get(ra)
        return ma is not None and rb in ma

    def add_mutex(self, ra: int, rb: int):
        self.mutexes.setdefault(ra, set()).add(rb)
        self.mutexes.setdefault(rb, set()).add(ra)

    def merge(self, ra: int, rb: int):
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        elif self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        self.parent[rb] = ra
        mb = self.mutexes.pop(rb, None)
        if mb:
            ma = self.mutexes.setdefault(ra, set())
            for x in mb:
                sx = self.mutexes.get(x)
                if sx is not None:
                    sx.discard(rb)
                    sx.add(ra)
                ma.add(x)


def python_constraint_loop(
    n: int,
    u: np.ndarray,
    v: np.ndarray,
    is_attractive: np.ndarray,
    order: np.ndarray,
) -> np.ndarray:
    """Pure-Python mutex constraint loop, the host C++ rung's parity oracle.

    Same contract as ``native.mutex_watershed``: process edges in ``order``,
    merging attractive pairs unless a mutex forbids it, installing mutexes
    for repulsive pairs; returns per-voxel int64 roots (the partition, not
    the representatives, equals the C++ loop's).
    """
    uf = _MutexUnionFind(n)
    for i in order:
        ru, rv = uf.find(int(u[i])), uf.find(int(v[i]))
        if ru == rv:
            continue
        if is_attractive[i]:
            if not uf.has_mutex(ru, rv):
                uf.merge(ru, rv)
        else:
            uf.add_mutex(ru, rv)
    return np.array([uf.find(i) for i in range(n)], dtype=np.int64)


def mutex_watershed(
    affs: np.ndarray,
    offsets: Sequence[Sequence[int]],
    mask: Optional[np.ndarray] = None,
    strides: Optional[Sequence[int]] = None,
    randomize_strides: bool = False,
    seed: int = 0,
) -> np.ndarray:
    """Cluster a volume from affinities: returns int64 labels (1-based;
    0 where masked out).

    ``strides`` subsamples repulsive edges: on a regular grid by default, or
    uniformly at random with the same keep fraction when
    ``randomize_strides`` (avoids grid-aligned repulsion artifacts);
    attractive edges are always dense.
    """
    ndim = affs.ndim - 1
    shape = affs.shape[1:]
    n = int(np.prod(shape))
    u, v, c = offset_edges(shape, offsets)
    w = _affinity_values(np.asarray(affs, np.float64), offsets)
    is_attractive = c < ndim

    if strides is not None:
        keep = is_attractive.copy()
        rep = ~is_attractive
        if randomize_strides:
            frac = 1.0 / float(np.prod([int(s) for s in strides]))
            rnd = np.random.default_rng(seed).random(len(u)) < frac
            keep |= rep & rnd
        else:
            # keep repulsive edges only at strided source voxels
            coords = np.unravel_index(u, shape)
            on_grid = np.ones(len(u), bool)
            for d, s in enumerate(strides):
                on_grid &= coords[d] % int(s) == 0
            keep |= rep & on_grid
        u, v, c, w, is_attractive = (
            u[keep],
            v[keep],
            c[keep],
            w[keep],
            is_attractive[keep],
        )

    if mask is not None:
        m = np.asarray(mask).astype(bool).ravel()
        keep = m[u] & m[v]
        u, v, w, is_attractive = u[keep], v[keep], w[keep], is_attractive[keep]

    order = np.argsort(-w, kind="stable")

    roots = native.mutex_watershed(n, u, v, is_attractive, order)
    if roots is None:
        roots = python_constraint_loop(n, u, v, is_attractive, order)
    _, labels = np.unique(roots, return_inverse=True)
    labels = labels.astype(np.int64).reshape(shape) + 1
    if mask is not None:
        labels[~np.asarray(mask).astype(bool)] = 0
    return labels
