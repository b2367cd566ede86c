"""Sparse lifted edges and lifted costs from node labels.

Port of ``cluster_tools_tpu/tasks/lifted_features.py``: the sparse lifted
neighbourhood (node pairs within graph distance ``max_graph_distance``
that are not direct RAG neighbours), and lifted costs from a node-label
attribution (e.g. nucleus or semantic labels mapped onto supervoxels by
the node_labels workflow): same label attractive, different labels
repulsive.

Both tasks act on the merged graph artifacts on the host (scipy sparse
powers and numpy, as in the reference) on every target; the voxel-scale
work happened in the graph and node_labels passes.

Artifacts (in ``tmp_folder/lifted``):

    lifted_edges.npy    int64 [m, 2]  dense node ids, lexsorted
    lifted_problem.npz  {edges, costs}: the costed lifted problem
"""

from __future__ import annotations

import os

import numpy as np

from ..runtime.task import BaseTask
from .graph import load_global_graph
from .node_labels import node_labels_path


def lifted_dir(tmp_folder: str) -> str:
    d = os.path.join(tmp_folder, "lifted")
    os.makedirs(d, exist_ok=True)
    return d


def lifted_edges_path(tmp_folder: str) -> str:
    return os.path.join(lifted_dir(tmp_folder), "lifted_edges.npy")


def lifted_costs_path(tmp_folder: str) -> str:
    return os.path.join(lifted_dir(tmp_folder), "lifted_costs.npy")


def lifted_problem_path(tmp_folder: str) -> str:
    """The costed lifted problem {edges, costs}: apart from the raw
    neighbourhood, so a rerun with another attribution filters the whole
    neighbourhood again."""
    return os.path.join(lifted_dir(tmp_folder), "lifted_problem.npz")


def sparse_lifted_neighborhood(n_nodes: int, edges: np.ndarray, max_graph_distance: int) -> np.ndarray:
    """Node pairs at graph distance in [2, max_graph_distance], ``u < v``,
    lexsorted: boolean sparse matrix powers of the adjacency."""
    from scipy.sparse import coo_matrix, eye

    if len(edges) == 0 or max_graph_distance < 2:
        return np.zeros((0, 2), np.int64)
    data = np.ones(len(edges), bool)
    a = coo_matrix((data, (edges[:, 0], edges[:, 1])), shape=(n_nodes, n_nodes))
    a = ((a + a.T) > 0).tocsr()
    reach = a.copy()
    acc = a.copy()
    for _ in range(max_graph_distance - 1):
        reach = ((reach @ a) > 0).tocsr()
        acc = ((acc + reach) > 0).tocsr()
    lifted = acc.astype(np.int8) - a.astype(np.int8) - eye(n_nodes, dtype=np.int8)
    lifted = (lifted > 0).tocoo()
    uv = np.stack([lifted.row, lifted.col], axis=1).astype(np.int64)
    uv = uv[uv[:, 0] < uv[:, 1]]
    order = np.lexsort((uv[:, 1], uv[:, 0]))
    return uv[order]


class SparseLiftedNeighborhoodBase(BaseTask):
    """Params: ``max_graph_distance`` (default 2)."""

    task_name = "sparse_lifted_neighborhood"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "max_graph_distance": 2}

    def run_impl(self):
        cfg = self.get_config()
        nodes, _, edges, _ = load_global_graph(self.tmp_folder)
        uv = sparse_lifted_neighborhood(len(nodes), edges.astype(np.int64), int(cfg.get("max_graph_distance", 2)))
        np.save(lifted_edges_path(self.tmp_folder), uv)
        return {"n_lifted_edges": int(len(uv))}


class SparseLiftedNeighborhoodLocal(SparseLiftedNeighborhoodBase):
    target = "local"


class SparseLiftedNeighborhoodGPU(SparseLiftedNeighborhoodBase):
    target = "gpu"


class CostsFromNodeLabelsBase(BaseTask):
    """Lifted costs from a node-label attribution.

    Reads the node_labels table (segment id -> attributed label); a lifted
    pair whose endpoints are both attributed costs ``+w_attractive`` when
    the labels agree and ``-w_repulsive`` when they differ; pairs with an
    unattributed endpoint are dropped.  ``include_local_edges`` (default
    True) adds the attributed direct RAG neighbours to the lifted set, so
    the attribution biases adjacent supervoxels too.
    """

    task_name = "costs_from_node_labels"

    @staticmethod
    def default_task_config():
        return {
            "threads_per_job": 1,
            "device_batch": 1,
            "w_attractive": 1.0,
            "w_repulsive": 1.0,
            "include_local_edges": True,
        }

    def run_impl(self):
        cfg = self.get_config()
        nodes, _, local_edges, _ = load_global_graph(self.tmp_folder)
        uv = np.load(lifted_edges_path(self.tmp_folder))
        if cfg.get("include_local_edges", True) and len(local_edges):
            uv = np.unique(np.concatenate([uv, local_edges.astype(np.int64)]), axis=0)
        with np.load(node_labels_path(self.tmp_folder)) as f:
            keys, values = f["keys"], f["values"]
        # segment (original uint64) -> attribution, through the dense node table
        attr = np.zeros(len(nodes), np.uint64)
        idx = np.searchsorted(keys, nodes)
        idx_c = np.clip(idx, 0, max(len(keys) - 1, 0))
        if len(keys):
            matched = keys[idx_c] == nodes
            attr[matched] = values[idx_c[matched]]
        a_u = attr[uv[:, 0]]
        a_v = attr[uv[:, 1]]
        labeled = (a_u != 0) & (a_v != 0)
        uv = uv[labeled]
        same = a_u[labeled] == a_v[labeled]
        costs = np.where(same, float(cfg.get("w_attractive", 1.0)), -float(cfg.get("w_repulsive", 1.0)))
        np.savez(lifted_problem_path(self.tmp_folder), edges=uv, costs=costs.astype(np.float64))
        return {"n_lifted_edges": int(len(uv)), "n_attractive": int(same.sum())}


class CostsFromNodeLabelsLocal(CostsFromNodeLabelsBase):
    target = "local"


class CostsFromNodeLabelsGPU(CostsFromNodeLabelsBase):
    target = "gpu"
