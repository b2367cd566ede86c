"""Postprocessing: the size filter.

Port of the size-filter family of ``cluster_tools_tpu/tasks/postprocess.py``
(its lines 20-167): per-block label histograms (``BlockLabelSizes``), the
merged keep/drop assignment (``SizeFilterAssignments``) and
:class:`SizeFilterWorkflow`, which writes it through the generic write
task (staged first when the write is in place).
``ThresholdedComponentsWorkflow`` chains it after connected components.
The rest of the reference module — hole filling, connected components on
a segmentation and the graph-watershed reassignment — is ROADMAP item 12b.
"""

from __future__ import annotations

import os

import numpy as np

from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


def _sizes_dir(tmp_folder):
    d = os.path.join(tmp_folder, "label_sizes")
    os.makedirs(d, exist_ok=True)
    return d


class BlockLabelSizesBase(BaseTask):
    """Per-block label histograms (unique labels + voxel counts)."""

    task_name = "block_label_sizes"

    def run_impl(self):
        cfg = self.get_config()
        ds = file_reader(cfg["input_path"])[cfg["input_key"]]
        shape = ds.shape
        block_shape = tuple(cfg["block_shape"])
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        d = _sizes_dir(self.tmp_folder)

        def process(block_id):
            labels = ds[blocking.get_block(block_id).bb]
            u, c = np.unique(labels[labels != 0], return_counts=True)
            np.savez(os.path.join(d, f"block_{block_id}.npz"), labels=u, counts=c)

        n = self.host_block_map(block_ids, process)
        return {"n_blocks": n}


class BlockLabelSizesLocal(BlockLabelSizesBase):
    target = "local"


class BlockLabelSizesGPU(BlockLabelSizesBase):
    target = "gpu"


class SizeFilterAssignmentsBase(BaseTask):
    """Merge histograms -> assignment keeping labels with
    ``min_size <= size < max_size`` (others -> 0), optionally relabeled
    consecutively (``relabel=True``, default)."""

    task_name = "size_filter_assignments"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "min_size": 1, "max_size": None, "relabel": True}

    def run_impl(self):
        cfg = self.get_config()
        shape = file_reader(cfg["input_path"])[cfg["input_key"]].shape
        block_ids = blocks_in_volume(shape, tuple(cfg["block_shape"]), cfg.get("roi_begin"), cfg.get("roi_end"))
        d = _sizes_dir(self.tmp_folder)
        all_labels = {}
        for b in block_ids:
            f = os.path.join(d, f"block_{b}.npz")
            if not os.path.exists(f):
                continue
            with np.load(f) as npz:
                for lab, cnt in zip(npz["labels"], npz["counts"]):
                    all_labels[int(lab)] = all_labels.get(int(lab), 0) + int(cnt)
        keys = np.array(sorted(all_labels), dtype=np.uint64)
        sizes = np.array([all_labels[int(k)] for k in keys], dtype=np.int64)
        min_size = int(cfg.get("min_size") or 1)
        max_size = cfg.get("max_size")
        keep = sizes >= min_size
        if max_size is not None:
            keep &= sizes < int(max_size)
        if cfg.get("relabel", True):
            values = np.zeros(len(keys), np.uint64)
            values[keep] = np.arange(1, int(keep.sum()) + 1, dtype=np.uint64)
        else:
            values = np.where(keep, keys, np.uint64(0))
        np.savez(os.path.join(self.tmp_folder, "size_filter_assignments.npz"), keys=keys, values=values)
        return {"n_labels": int(len(keys)), "n_kept": int(keep.sum()), "n_filtered": int((~keep).sum())}


class SizeFilterAssignmentsLocal(SizeFilterAssignmentsBase):
    target = "local"


class SizeFilterAssignmentsGPU(SizeFilterAssignmentsBase):
    target = "gpu"


class SizeFilterWorkflow(WorkflowBase):
    """sizes -> filter assignment -> write (the reference's ``SizeFilterWorkflow``)."""

    task_name = "size_filter_workflow"

    def requires(self):
        from . import postprocess as pp_mod
        from .relabel import staged_write_tasks

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        bs = {k: p[k] for k in ("block_shape",) if k in p}
        io = dict(input_path=p["input_path"], input_key=p["input_key"])
        t1 = get_task_cls(pp_mod, "BlockLabelSizes", self.target)(**common, dependencies=self.dependencies, **io, **bs)
        t2 = get_task_cls(pp_mod, "SizeFilterAssignments", self.target)(
            **common, dependencies=[t1], **io, **bs,
            **{k: p[k] for k in ("min_size", "max_size", "relabel") if k in p},
        )
        t3 = staged_write_tasks(
            self, [t2], assignment_path=os.path.join(self.tmp_folder, "size_filter_assignments.npz"),
            input_path=p["input_path"], input_key=p["input_key"],
            output_path=p.get("output_path", p["input_path"]), output_key=p.get("output_key", p["input_key"]),
            stage_name="size_filter", bs=bs,
        )
        return [t3]

    def run_impl(self):
        return {}
