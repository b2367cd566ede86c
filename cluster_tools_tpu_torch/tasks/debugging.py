"""Sanity checks on intermediate artifacts.

Port of ``cluster_tools_tpu/tasks/debugging.py``.  Two checkers:

- :class:`CheckSubGraphsBase`: re-extract every block's region graph from
  the segmentation with :func:`..ops.rag.block_rag` on the task's device
  (the card for ``gpu``) and compare it with the stored per-block graph
  artifacts (catches stale graph caches after a re-run with changed
  labels).
- :class:`CheckBlocksBase`: scan a dataset blockwise for NaN/Inf and
  all-zero blocks.

Both write a JSON report and fail the task (so the DAG halts) when
violations are found, unless ``warn_only``.  Checks use no block-level
resume markers: a failed check must re-inspect every block on retry,
otherwise the rerun would skip the flagged blocks and pass.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..ops.rag import block_rag
from ..runtime import handoff
from ..runtime.task import BaseTask
from ..utils import function_utils as fu
from ..utils.volume_utils import Blocking, blocks_in_volume
from .graph import _upper_halo_bb, block_graph_path


def _scan_all(task, block_ids, process):
    """Run ``process`` over ALL blocks (no resume markers), surfacing every
    exception."""
    with ThreadPoolExecutor(max_workers=max(1, task.max_jobs)) as pool:
        list(pool.map(process, block_ids))


def _report(task, cfg, name: str, block_ids, bad, what: str):
    report = {"n_blocks": len(block_ids), "violations": bad}
    # atomic: the report is a shared tmp_folder manifest
    fu.atomic_write_json(os.path.join(task.tmp_folder, f"{name}.json"), report)
    if bad and not cfg.get("warn_only", False):
        raise RuntimeError(f"{what} check failed for {len(bad)} blocks (see {name}.json)")
    return report


class CheckSubGraphsBase(BaseTask):
    """Validate stored block graphs against the segmentation."""

    task_name = "check_sub_graphs"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "warn_only": False}

    def run_impl(self):
        cfg = self.get_config()
        # the volume under validation may live only in a handoff handle
        ds = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"])
        shape = ds.shape
        block_shape = tuple(cfg["block_shape"])
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        dev = self.device
        bad = []

        def process(block_id):
            p = block_graph_path(self.tmp_folder, block_id)
            if not handoff.array_exists(p):
                bad.append({"block": block_id, "error": "missing graph artifact"})
                return
            block = blocking.get_block(block_id)
            uv, sizes, _ = block_rag(np.asarray(ds[_upper_halo_bb(block, shape)]), inner_shape=block.shape,
                                     device=dev)
            f = handoff.load_arrays(p)
            if not (f["uv"].shape == uv.shape and (f["uv"] == uv).all() and (f["sizes"] == sizes).all()):
                bad.append({"block": block_id, "error": "graph mismatch"})

        _scan_all(self, block_ids, process)
        return _report(self, cfg, "check_sub_graphs", block_ids, bad, "sub-graph")


class CheckSubGraphsLocal(CheckSubGraphsBase):
    target = "local"


class CheckSubGraphsGPU(CheckSubGraphsBase):
    target = "gpu"


class CheckBlocksBase(BaseTask):
    """Scan a dataset for NaN/Inf and all-zero blocks."""

    task_name = "check_blocks"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "warn_only": False, "check_all_zero": True}

    def run_impl(self):
        cfg = self.get_config()
        # the volume under validation may live only in a handoff handle
        ds = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"])
        shape = ds.shape
        block_shape = tuple(cfg["block_shape"])
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        check_zero = bool(cfg.get("check_all_zero", True))
        bad = []

        def process(block_id):
            data = np.asarray(ds[blocking.get_block(block_id).bb])
            if np.issubdtype(data.dtype, np.floating) and not np.isfinite(data).all():
                bad.append({"block": block_id, "error": "non-finite values"})
                return
            if check_zero and not data.any():
                bad.append({"block": block_id, "error": "all-zero block"})

        _scan_all(self, block_ids, process)
        return _report(self, cfg, "check_blocks", block_ids, bad, "block")


class CheckBlocksLocal(CheckBlocksBase):
    target = "local"


class CheckBlocksGPU(CheckBlocksBase):
    target = "gpu"
