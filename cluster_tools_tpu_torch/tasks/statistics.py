"""Blockwise data statistics: per-block partial moments + a merge pass ->
global count/min/max/mean/std, written to the success manifest and to
``statistics.json``.

Port of ``cluster_tools_tpu/tasks/statistics.py``.  Numpy on the host
threads on every target: each block's float64 ``[size, sum, sum of
squares, min, max]``, merged with float64 sums over the blocks in their
grid order, as in the reference.
"""

from __future__ import annotations

import os

import numpy as np

from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils import function_utils as fu
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


def _stats_dir(tmp_folder):
    d = os.path.join(tmp_folder, "block_statistics")
    os.makedirs(d, exist_ok=True)
    return d


class BlockStatisticsBase(BaseTask):
    task_name = "block_statistics"

    def run_impl(self):
        cfg = self.get_config()
        ds = file_reader(cfg["input_path"])[cfg["input_key"]]
        shape = ds.shape
        block_shape = tuple(cfg["block_shape"])
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        d = _stats_dir(self.tmp_folder)

        def process(block_id):
            data = ds[blocking.get_block(block_id).bb].astype(np.float64)
            np.save(os.path.join(d, f"block_{block_id}.npy"),
                    np.array([data.size, data.sum(), (data**2).sum(), data.min(), data.max()]))

        n = self.host_block_map(block_ids, process)
        return {"n_blocks": n}


class BlockStatisticsLocal(BlockStatisticsBase):
    target = "local"


class BlockStatisticsGPU(BlockStatisticsBase):
    target = "gpu"


class MergeStatisticsBase(BaseTask):
    task_name = "merge_statistics"

    def run_impl(self):
        cfg = self.get_config()
        shape = file_reader(cfg["input_path"])[cfg["input_key"]].shape
        block_ids = blocks_in_volume(shape, tuple(cfg["block_shape"]), cfg.get("roi_begin"), cfg.get("roi_end"))
        d = _stats_dir(self.tmp_folder)
        files = [os.path.join(d, f"block_{b}.npy") for b in block_ids]
        parts = np.stack([np.load(f) for f in files if os.path.exists(f)])
        n = parts[:, 0].sum()
        s1, s2 = parts[:, 1].sum(), parts[:, 2].sum()
        mean = s1 / n
        var = max(s2 / n - mean**2, 0.0)
        stats = {"count": float(n), "mean": float(mean), "std": float(np.sqrt(var)),
                 "min": float(parts[:, 3].min()), "max": float(parts[:, 4].max())}
        # atomic: the report is a shared tmp_folder manifest
        fu.atomic_write_json(os.path.join(self.tmp_folder, "statistics.json"), stats)
        return stats


class MergeStatisticsLocal(MergeStatisticsBase):
    target = "local"


class MergeStatisticsGPU(MergeStatisticsBase):
    target = "gpu"


class DataStatisticsWorkflow(WorkflowBase):
    task_name = "data_statistics_workflow"

    def requires(self):
        from . import statistics as st_mod

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        kw = {k: p[k] for k in ("input_path", "input_key", "block_shape") if k in p}
        t1 = get_task_cls(st_mod, "BlockStatistics", self.target)(**common, dependencies=self.dependencies, **kw)
        return [get_task_cls(st_mod, "MergeStatistics", self.target)(**common, dependencies=[t1], **kw)]
