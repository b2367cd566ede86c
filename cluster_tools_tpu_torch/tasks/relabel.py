"""Relabeling: make segmentation labels dense (``1..K``).

Port of ``cluster_tools_tpu/tasks/relabel.py``: ``FindUniques`` (per
block), ``FindLabeling`` (merge into one table), then the generic write
task applies it.  The watershed and connected-components tasks emit
globally unique but sparse uint64 labels; this workflow is their finisher.
"""

from __future__ import annotations

import os

import numpy as np

from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


def _uniques_dir(tmp_folder: str) -> str:
    d = os.path.join(tmp_folder, "relabel_uniques")
    os.makedirs(d, exist_ok=True)
    return d


class FindUniquesBase(BaseTask):
    """Per-block unique labels -> npy files."""

    task_name = "find_uniques"

    def run_impl(self):
        cfg = self.get_config()
        ds = file_reader(cfg["input_path"])[cfg["input_key"]]
        shape = ds.shape
        block_shape = tuple(cfg["block_shape"])
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        d = _uniques_dir(self.tmp_folder)

        def process(block_id):
            u = np.unique(ds[blocking.get_block(block_id).bb])
            np.save(os.path.join(d, f"block_{block_id}.npy"), u[u != 0])

        return {"n_blocks": self.host_block_map(block_ids, process)}


class FindUniquesLocal(FindUniquesBase):
    target = "local"


class FindUniquesGPU(FindUniquesBase):
    target = "gpu"


class FindLabelingBase(BaseTask):
    """Merge per-block uniques -> dense assignment table (labels 1..K)."""

    task_name = "find_labeling"

    def run_impl(self):
        cfg = self.get_config()
        shape = file_reader(cfg["input_path"])[cfg["input_key"]].shape
        block_ids = blocks_in_volume(shape, tuple(cfg["block_shape"]), cfg.get("roi_begin"), cfg.get("roi_end"))
        d = _uniques_dir(self.tmp_folder)
        files = [os.path.join(d, f"block_{b}.npy") for b in block_ids
                 if os.path.exists(os.path.join(d, f"block_{b}.npy"))]
        uniques = np.unique(np.concatenate([np.load(f) for f in files])) if files else np.zeros(0, np.uint64)
        values = np.arange(1, len(uniques) + 1, dtype=np.uint64)
        np.savez(os.path.join(self.tmp_folder, cfg.get("assignment_name", "relabel_assignments") + ".npz"),
                 keys=uniques, values=values)
        return {"n_labels": int(len(uniques))}


class FindLabelingLocal(FindLabelingBase):
    target = "local"


class FindLabelingGPU(FindLabelingBase):
    target = "gpu"


def staged_write_tasks(workflow: WorkflowBase, deps, assignment_path: str, input_path: str, input_key: str,
                       output_path: str, output_key: str, stage_name: str, bs):
    """The final write step, staging the input labels to a scratch dataset
    first when writing in place (an in-place write is not idempotent at
    the block grain: a crash between a block's write and its marker would
    remap already relabelled values on resume)."""
    from . import copy_volume as cv_mod
    from . import write as write_mod

    common = dict(tmp_folder=workflow.tmp_folder, config_dir=workflow.config_dir, max_jobs=workflow.max_jobs)
    if output_path == input_path and output_key == input_key:
        staged_path = os.path.join(workflow.tmp_folder, f"{stage_name}_src.zarr")
        t_copy = get_task_cls(cv_mod, "CopyVolume", workflow.target)(
            **common, dependencies=deps, input_path=input_path, input_key=input_key,
            output_path=staged_path, output_key="labels", **bs,
        )
        deps = [t_copy]
        input_path, input_key = staged_path, "labels"
    return get_task_cls(write_mod, "Write", workflow.target)(
        **common, dependencies=deps, input_path=input_path, input_key=input_key,
        output_path=output_path, output_key=output_key, assignment_path=assignment_path, **bs,
    )


class RelabelWorkflow(WorkflowBase):
    """find_uniques -> find_labeling -> write (the reference's relabel workflow)."""

    task_name = "relabel_workflow"

    def requires(self):
        from . import relabel as rl_mod

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        bs = {k: p[k] for k in ("block_shape",) if k in p}
        assignment_name = p.get("assignment_name", "relabel_assignments")
        t1 = get_task_cls(rl_mod, "FindUniques", self.target)(
            **common, dependencies=self.dependencies, input_path=p["input_path"], input_key=p["input_key"], **bs,
        )
        t2 = get_task_cls(rl_mod, "FindLabeling", self.target)(
            **common, dependencies=[t1], input_path=p["input_path"], input_key=p["input_key"],
            assignment_name=assignment_name, **bs,
        )
        return [staged_write_tasks(
            self, [t2], assignment_path=os.path.join(self.tmp_folder, assignment_name + ".npz"),
            input_path=p["input_path"], input_key=p["input_key"],
            output_path=p.get("output_path", p["input_path"]), output_key=p.get("output_key", p["input_key"]),
            stage_name="relabel", bs=bs,
        )]
