"""Agglomerative clustering of the RAG (alternative to multicut).

Port of ``cluster_tools_tpu/tasks/agglomerative_clustering.py``, its
unsharded path: average-linkage agglomeration over the merged edge
features, stopping at a boundary-probability threshold, on the task's
device (:func:`..ops.contraction.average_parallel`).  The sharded solve
(``solver_shards > 1``) is ROADMAP Queue A item 10.

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
from .multicut import _solver_manifest, refuse_sharded_solve


def agglomerative_assignments_path(tmp_folder: str) -> str:
    return os.path.join(tmp_folder, "agglomerative_assignments.npz")


class AgglomerativeClusteringBase(BaseTask):
    """Params: ``threshold`` (merge edges while the mean boundary
    probability is below it, default 0.5); ``impl`` selects the contraction
    rung (:mod:`..ops.contraction`: ``auto`` is ``torch`` on the card and
    ``numpy`` on the CPU; ``heap`` is the sequential oracle)."""

    task_name = "agglomerative_clustering"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "threshold": 0.5, "impl": "auto"}

    def run_impl(self):
        cfg = self.get_config()
        refuse_sharded_solve(cfg)
        nodes, _, edges, sizes = load_global_graph(self.tmp_folder)
        feats = handoff.load_array(features_path(self.tmp_folder))
        solver_snap = contraction_mod.solver_snapshot()
        labels = contraction_mod.average_parallel(
            len(nodes), edges.astype(np.int64), feats[:, 0], sizes, float(cfg.get("threshold", 0.5)),
            impl=str(cfg.get("impl", "auto")), device=self.device,
        )
        np.savez(agglomerative_assignments_path(self.tmp_folder), keys=nodes, values=(labels + 1).astype(np.uint64))
        return {
            "n_nodes": int(len(nodes)),
            "n_clusters": int(labels.max()) + 1 if len(labels) else 0,
            # no signed multicut objective here: edge movement and rounds only
            "solver": _solver_manifest(None, edges, labels, contraction_mod.solver_delta(solver_snap)),
        }


class AgglomerativeClusteringLocal(AgglomerativeClusteringBase):
    target = "local"


class AgglomerativeClusteringGPU(AgglomerativeClusteringBase):
    target = "gpu"
