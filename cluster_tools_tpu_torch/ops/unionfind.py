"""Union-find over label-equivalence pairs as a device fixpoint iteration.

Port of ``cluster_tools_tpu/ops/unionfind.py::union_find``: repeat
scatter-min hooking of each pair's larger root onto its smaller root, then
full path compression, until stable.  Each label ends at its component's
minimum label.  :func:`union_find_host` is the host path with the same
contract (the host C++ union-find; scipy under ``native.force_python``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..device import as_tensor, resolve_device


def compress(p: torch.Tensor) -> torch.Tensor:
    """Compose a parent table to closure (``p = p[p]`` until stable)."""
    while True:
        p2 = p[p.long()]
        if not bool((p2 != p).any()):
            return p
        p = p2


def union_find_tensor(pairs: torch.Tensor, n_labels: int) -> torch.Tensor:
    """:func:`union_find` on a tensor, on the tensor's own device."""
    n = int(n_labels)
    parent = torch.arange(n, dtype=torch.int32, device=pairs.device)
    # out-of-range endpoints turn the whole pair into a (0, 0) no-op
    u, v = pairs[:, 0], pairs[:, 1]
    valid = (u >= 0) & (u < n) & (v >= 0) & (v < n)
    u = torch.where(valid, u, 0).long()
    v = torch.where(valid, v, 0).long()
    while True:
        ru = parent[u]
        rv = parent[v]
        lo = torch.minimum(ru, rv)
        hi = torch.maximum(ru, rv)
        p2 = parent.scatter_reduce(0, hi.long(), lo, "amin", include_self=True)
        p2 = compress(p2)
        if not bool((p2 != parent).any()):
            return p2
        parent = p2


def union_find(pairs, n_labels: int, device=None) -> torch.Tensor:
    """Resolve equivalence ``pairs`` (int32 ``[m, 2]``) over labels
    ``[0, n_labels)``; returns each label's component minimum (int32).
    Invalid pairs may be encoded as ``(i, i)`` self-loops."""
    dev = resolve_device(device)
    return union_find_tensor(as_tensor(pairs, dev, torch.int32), n_labels)


def apply_assignment(labels, assignment, n_labels: int) -> torch.Tensor:
    """Relabel a block through an assignment table (reference: ``write``
    task), on the labels' own device: labels outside ``[0, n_labels)`` are
    clipped into it, and the result keeps the labels' dtype."""
    labels = torch.as_tensor(labels)
    table = torch.as_tensor(assignment, device=labels.device)
    if labels.dtype == torch.uint64:
        # no clamp for uint64: clip its int64 view, where a label of 2**63
        # or more reads negative and belongs at the top
        wide = labels.view(torch.int64)
        flat = torch.where(wide < 0, n_labels - 1, wide.clamp(0, n_labels - 1))
    else:
        flat = labels.long().clamp(0, n_labels - 1)
    return table[flat].to(labels.dtype)


def union_find_host(pairs: np.ndarray, n_labels: int) -> np.ndarray:
    """Host path of :func:`union_find`: each label mapped to the minimum
    label of its component (int64), by the host C++ union-find
    (:func:`..native.union_find`), or by scipy's sparse connected
    components inside :func:`..native.force_python`."""
    pairs = np.asarray(pairs)
    if pairs.size == 0:
        return np.arange(n_labels, dtype=np.int64)
    roots = native.union_find(pairs.astype(np.int64, copy=False), n_labels)
    if roots is not None:
        return roots

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    g = coo_matrix((np.ones(len(pairs), dtype=np.uint8), (pairs[:, 0], pairs[:, 1])),
                   shape=(n_labels, n_labels))
    _, comp = connected_components(g, directed=False)
    # sorted by component, then label: each component's first entry is its minimum
    order = np.argsort(comp, kind="stable")
    comp_sorted = comp[order]
    first = np.ones(len(order), dtype=bool)
    first[1:] = comp_sorted[1:] != comp_sorted[:-1]
    comp_min = np.zeros(comp.max() + 1, dtype=np.int64)
    comp_min[comp_sorted[first]] = order[first]
    return comp_min[comp]
