"""Segmentation evaluation at scale: sparse contingency table -> VI / RAND.

Port of ``cluster_tools_tpu/tasks/evaluation.py``: blockwise sparse
contingency tables between a segmentation and ground truth (the
node-labels vote pass), merged, then variation of information (split and
merge entropies) and adapted-RAND from the merged table, in float64 and in
the reference's order, in the main process.

Metrics (label 0 ignored in both volumes):

- ``vi_split``  = H(seg | gt)   (over-segmentation distance, nats)
- ``vi_merge``  = H(gt | seg)   (under-segmentation distance, nats)
- ``adapted_rand_error`` = 1 - F1 of RAND precision/recall (CREMI style)
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..ops.rag import unique_pairs
from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils import function_utils as fu
from ..utils.volume_utils import blocks_in_volume, file_reader
from .node_labels import BlockNodeLabelsBase, _nl_dir


def contingency_metrics(pairs: np.ndarray, counts: np.ndarray) -> Dict[str, float]:
    """VI and adapted-RAND from a sparse contingency table.

    ``pairs[:, 0]`` = segmentation ids, ``pairs[:, 1]`` = ground-truth ids,
    ``counts`` = co-occurrence voxel counts (label 0 already excluded).
    """
    if len(pairs) == 0:
        return {"vi_split": 0.0, "vi_merge": 0.0, "adapted_rand_error": 0.0, "n_pairs": 0}
    n = counts.sum()
    p_ij = counts.astype(np.float64) / n
    seg_ids, seg_inv = np.unique(pairs[:, 0], return_inverse=True)
    gt_ids, gt_inv = np.unique(pairs[:, 1], return_inverse=True)
    p_seg = np.zeros(len(seg_ids))
    np.add.at(p_seg, seg_inv.ravel(), p_ij)
    p_gt = np.zeros(len(gt_ids))
    np.add.at(p_gt, gt_inv.ravel(), p_ij)

    # conditional entropies from the joint and the marginals
    h_joint = -np.sum(p_ij * np.log(p_ij))
    h_seg = -np.sum(p_seg * np.log(p_seg))
    h_gt = -np.sum(p_gt * np.log(p_gt))
    vi_split = h_joint - h_gt   # H(seg|gt)
    vi_merge = h_joint - h_seg  # H(gt|seg)

    # adapted RAND (CREMI): precision = sum p_ij^2 / sum p_seg^2,
    # recall = sum p_ij^2 / sum p_gt^2, ARE = 1 - F1
    sum_ij = np.sum(p_ij**2)
    prec = sum_ij / np.sum(p_seg**2)
    rec = sum_ij / np.sum(p_gt**2)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    return {"vi_split": float(max(vi_split, 0.0)), "vi_merge": float(max(vi_merge, 0.0)),
            "adapted_rand_error": float(1.0 - f1), "rand_precision": float(prec), "rand_recall": float(rec),
            "n_pairs": int(len(pairs))}


class ContingencyTableBase(BlockNodeLabelsBase):
    """Blockwise (seg, gt) co-occurrence counts: the node-labels vote pass
    with both zero-ignores on."""

    task_name = "contingency_table"


class ContingencyTableLocal(ContingencyTableBase):
    target = "local"


class ContingencyTableGPU(ContingencyTableBase):
    target = "gpu"


class MeasuresBase(BaseTask):
    """Merge the contingency parts and compute the metrics; writes
    ``evaluation.json``."""

    task_name = "measures"

    def run_impl(self):
        cfg = self.get_config()
        shape = file_reader(cfg["input_path"])[cfg["input_key"]].shape
        block_ids = blocks_in_volume(shape, tuple(cfg["block_shape"]), cfg.get("roi_begin"), cfg.get("roi_end"))
        d = _nl_dir(self.tmp_folder, "contingency_table_parts")
        all_pairs, all_counts = [], []
        for b in block_ids:
            p = os.path.join(d, f"block_{b}.npz")
            if os.path.exists(p):
                with np.load(p) as f:
                    all_pairs.append(f["pairs"])
                    all_counts.append(f["counts"])
        if any(len(p) for p in all_pairs):
            pairs = np.concatenate([p for p in all_pairs if len(p)])
            counts = np.concatenate([c for c in all_counts if len(c)])
            uv, inv = unique_pairs(pairs)
            merged = np.zeros(len(uv), np.int64)
            np.add.at(merged, inv, counts)
        else:
            uv, merged = np.zeros((0, 2), np.uint64), np.zeros(0, np.int64)
        metrics = contingency_metrics(uv, merged)
        # atomic: the report is a shared tmp_folder manifest
        fu.atomic_write_json(os.path.join(self.tmp_folder, "evaluation.json"), metrics)
        return metrics


class MeasuresLocal(MeasuresBase):
    target = "local"


class MeasuresGPU(MeasuresBase):
    target = "gpu"


class EvaluationWorkflow(WorkflowBase):
    """contingency_table -> measures.  Params: ``input_path/input_key``
    (segmentation), ``labels_path/labels_key`` (ground truth)."""

    task_name = "evaluation_workflow"

    def requires(self):
        from . import evaluation as ev_mod

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        kw = {k: p[k] for k in ("input_path", "input_key", "labels_path", "labels_key", "block_shape", "roi_begin",
                                "roi_end") if k in p}
        t1 = get_task_cls(ev_mod, "ContingencyTable", self.target)(**common, dependencies=self.dependencies, **kw)
        return [get_task_cls(ev_mod, "Measures", self.target)(**common, dependencies=[t1], **kw)]
