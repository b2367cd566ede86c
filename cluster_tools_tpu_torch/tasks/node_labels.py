"""Node labels: map segment ids to labels of an overlapping volume.

Port of ``cluster_tools_tpu/tasks/node_labels.py``: per block, the
co-occurrence counts of (segment, overlap label) pairs
(:func:`overlap_votes`); the merge sums the votes over the blocks and
gives each segment its max-overlap label, the smaller label among ties.
Typical uses: ground-truth ids onto supervoxels, or semantic classes onto
segments.  Numpy on the host threads on every target, as in the reference;
the (segment, label) rows are sorted and counted through one 64-bit key a
row when both ids fit in 32 bits (:func:`..ops.rag.unique_pair_counts`,
the same rows in the same order as ``np.unique(axis=0)``).

Artifacts: ``<task_name>_parts/block_<id>.npz`` {pairs [m, 2], counts [m]}
and the write-task-compatible table ``node_labels/node_labels.npz``
(sorted uint64 ``keys`` = segment ids, ``values`` = max-overlap label).
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.rag import unique_pair_counts, unique_pairs
from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


def _nl_dir(tmp_folder: str, name: str = "node_labels") -> str:
    # per-task-name parts dir: the contingency-table task reuses this
    # machinery and must not collide with a node-labels run in the same
    # tmp_folder
    d = os.path.join(tmp_folder, name)
    os.makedirs(d, exist_ok=True)
    return d


def node_labels_path(tmp_folder: str) -> str:
    return os.path.join(_nl_dir(tmp_folder), "node_labels.npz")


def parts_dir_for(task) -> str:
    """Parts dir of a block-vote task, keyed by its task_name."""
    return _nl_dir(task.tmp_folder, task.task_name + "_parts")


def overlap_votes(seg: np.ndarray, overlap: np.ndarray, ignore_overlap_zero=True):
    """Co-occurrence counts of (segment id, overlap label) pairs."""
    m = seg != 0
    if ignore_overlap_zero:
        m &= overlap != 0
    pairs = np.stack([seg[m].ravel(), overlap[m].ravel()], axis=1)
    if len(pairs) == 0:
        return np.zeros((0, 2), np.uint64), np.zeros(0, np.int64)
    uv, counts = unique_pair_counts(pairs.astype(np.uint64))
    return uv, counts.astype(np.int64)


class BlockNodeLabelsBase(BaseTask):
    """Per-block overlap votes.

    Params: ``input_path/input_key`` (segments), ``labels_path/labels_key``
    (the overlapping label volume); ``ignore_overlap_zero`` (default True:
    background of the overlap volume casts no votes).
    """

    task_name = "block_node_labels"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "ignore_overlap_zero": True}

    def run_impl(self):
        cfg = self.get_config()
        ds_seg = file_reader(cfg["input_path"])[cfg["input_key"]]
        ds_lab = file_reader(cfg["labels_path"])[cfg["labels_key"]]
        shape = ds_seg.shape
        block_shape = tuple(cfg["block_shape"])
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        ignore0 = bool(cfg.get("ignore_overlap_zero", True))
        d = parts_dir_for(self)

        def process(block_id):
            bb = blocking.get_block(block_id).bb
            uv, counts = overlap_votes(np.asarray(ds_seg[bb]), np.asarray(ds_lab[bb]), ignore0)
            np.savez(os.path.join(d, f"block_{block_id}.npz"), pairs=uv, counts=counts)

        n = self.host_block_map(block_ids, process)
        return {"n_blocks": n}


class BlockNodeLabelsLocal(BlockNodeLabelsBase):
    target = "local"


class BlockNodeLabelsGPU(BlockNodeLabelsBase):
    target = "gpu"


class MergeNodeLabelsBase(BaseTask):
    """Sum the votes and take the max-overlap label per segment."""

    task_name = "merge_node_labels"

    def run_impl(self):
        cfg = self.get_config()
        shape = file_reader(cfg["input_path"])[cfg["input_key"]].shape
        block_ids = blocks_in_volume(shape, tuple(cfg["block_shape"]), cfg.get("roi_begin"), cfg.get("roi_end"))
        d = _nl_dir(self.tmp_folder, "block_node_labels_parts")
        all_pairs, all_counts = [], []
        for b in block_ids:
            p = os.path.join(d, f"block_{b}.npz")
            if os.path.exists(p):
                with np.load(p) as f:
                    all_pairs.append(f["pairs"])
                    all_counts.append(f["counts"])
        if not sum(len(p) for p in all_pairs):
            np.savez(node_labels_path(self.tmp_folder), keys=np.zeros(0, np.uint64), values=np.zeros(0, np.uint64))
            return {"n_segments": 0}
        pairs = np.concatenate([p for p in all_pairs if len(p)])
        counts = np.concatenate([c for c in all_counts if len(c)])
        uv, inv = unique_pairs(pairs)
        votes = np.zeros(len(uv), np.int64)
        np.add.at(votes, inv, counts)
        # per segment, the overlap label with the most votes; ties break to
        # the smaller label (the first in the lexsorted uv order)
        seg_ids, seg_start = np.unique(uv[:, 0], return_index=True)
        values = np.zeros(len(seg_ids), np.uint64)
        bounds = np.append(seg_start, len(uv))
        for i in range(len(seg_ids)):
            sl = slice(bounds[i], bounds[i + 1])
            values[i] = uv[sl][np.argmax(votes[sl]), 1]
        np.savez(node_labels_path(self.tmp_folder), keys=seg_ids, values=values)
        return {"n_segments": int(len(seg_ids))}


class MergeNodeLabelsLocal(MergeNodeLabelsBase):
    target = "local"


class MergeNodeLabelsGPU(MergeNodeLabelsBase):
    target = "gpu"


class NodeLabelWorkflow(WorkflowBase):
    """block_node_labels -> merge_node_labels."""

    task_name = "node_label_workflow"

    def requires(self):
        from . import node_labels as nl_mod

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        kw = {k: p[k] for k in ("input_path", "input_key", "labels_path", "labels_key", "ignore_overlap_zero",
                                "block_shape", "roi_begin", "roi_end") if k in p}
        t1 = get_task_cls(nl_mod, "BlockNodeLabels", self.target)(**common, dependencies=self.dependencies, **kw)
        return [get_task_cls(nl_mod, "MergeNodeLabels", self.target)(**common, dependencies=[t1], **kw)]
