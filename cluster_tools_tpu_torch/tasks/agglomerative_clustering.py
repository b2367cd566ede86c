"""Agglomerative clustering of the RAG (alternative to multicut).

Port of ``cluster_tools_tpu/tasks/agglomerative_clustering.py``:
average-linkage agglomeration over the merged edge features, stopping at a
boundary-probability threshold, on the task's device
(:func:`..ops.contraction.average_parallel`), or sharded over the reduce
tree (``solver_shards > 1``).

Emits a write-task-compatible assignment table
(``agglomerative_assignments.npz``).
"""

from __future__ import annotations

import os

import numpy as np

from ..ops import contraction as contraction_mod
from ..runtime import handoff
from ..runtime.task import BaseTask
from .features import features_path
from .graph import load_global_graph
from .multicut import _solver_manifest


def agglomerative_assignments_path(tmp_folder: str) -> str:
    return os.path.join(tmp_folder, "agglomerative_assignments.npz")


class AgglomerativeClusteringBase(BaseTask):
    """Params: ``threshold`` (merge edges while the mean boundary
    probability is below it, default 0.5); ``impl`` selects the contraction
    rung (:mod:`..ops.contraction`: ``auto`` is ``torch`` on the card and
    ``numpy`` on the CPU; ``heap`` is the sequential oracle).

    ``solver_shards > 1`` shards the agglomeration over the reduce tree
    (:mod:`..parallel.reduce_tree`) with the size-weighted mean payload
    ``(w * size, size)`` carried through every level; supervoxel id ranges
    stand in for block octants (blockwise labels number each block's
    fragments consecutively).  The unsharded solve stays the
    ``solver_shards=1`` case and the ``degraded:unsharded_solve``
    fallback."""

    task_name = "agglomerative_clustering"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "threshold": 0.5, "impl": "auto"}

    def run_impl(self):
        from ..parallel import reduce_tree as reduce_tree_mod

        cfg = self.get_config()
        nodes, _, edges, sizes = load_global_graph(self.tmp_folder)
        feats = handoff.load_array(features_path(self.tmp_folder))
        threshold = float(cfg.get("threshold", 0.5))
        shards = int(cfg.get("solver_shards", 1) or 1)
        solver_snap = contraction_mod.solver_snapshot()
        tree_snap = reduce_tree_mod.solve_snapshot()

        def unsharded():
            return contraction_mod.average_parallel(len(nodes), edges.astype(np.int64), feats[:, 0], sizes,
                                                    threshold, impl=str(cfg.get("impl", "auto")),
                                                    device=self.device)

        if shards > 1 and len(edges):
            # the average-linkage payload: (prob * size, size), summed on merge
            s = np.maximum(np.asarray(sizes, np.float64), 1e-12)
            payload = np.stack([np.asarray(feats[:, 0], np.float64) * s, s], axis=1)
            labels, solve_info = reduce_tree_mod.solve_with_reduce_tree(
                len(nodes), edges.astype(np.int64), payload,
                node_shard=reduce_tree_mod.contiguous_node_shards(len(nodes), shards),
                solver_shards=shards,
                fanout=int(cfg.get("reduce_fanout", 2) or 2),
                reduce_plane=str(cfg.get("reduce_plane", "auto") or "auto"),
                hop_deadline_s=cfg.get("hop_deadline_s"),
                failures_path=self.failures_path,
                task_name=self.uid,
                unsharded=unsharded,
                mode="min",
                threshold=threshold,
                workers=int(cfg.get("solver_workers", 1) or 1),
                scratch_dir=os.path.join(self.tmp_folder, "reduce_tree"),
                max_workers=max(1, self.max_jobs),
                device=self.device,
                device_pool_bytes=cfg.get("device_pool_bytes"),
            )
        else:
            labels = unsharded()
            solve_info = {"sharded": False, "shards": 1}
        np.savez(agglomerative_assignments_path(self.tmp_folder), keys=nodes, values=(labels + 1).astype(np.uint64))
        return {
            "n_nodes": int(len(nodes)),
            "n_clusters": int(labels.max()) + 1 if len(labels) else 0,
            # no signed multicut objective here: edge movement and rounds only
            "solver": _solver_manifest(None, edges, labels, contraction_mod.solver_delta(solver_snap),
                                       reduce_tree_mod.solve_delta(tree_snap), solve_info),
        }


class AgglomerativeClusteringLocal(AgglomerativeClusteringBase):
    target = "local"


class AgglomerativeClusteringGPU(AgglomerativeClusteringBase):
    target = "gpu"
