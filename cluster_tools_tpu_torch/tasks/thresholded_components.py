"""Threshold -> connected components -> size filter, as one workflow.

Port of ``cluster_tools_tpu/tasks/thresholded_components.py``.  The CC
machinery already fuses thresholding into its first pass, so this workflow
is ``ConnectedComponentsWorkflow`` with a threshold, then an optional
``SizeFilterWorkflow`` (``tasks/postprocess.py``).  A standalone
``Threshold`` task materializes a binary mask for pipelines that need one
(e.g. as an input mask for other ops); it is numpy on the host IO threads
on every target.
"""

from __future__ import annotations

import numpy as np

from ..runtime import handoff
from ..runtime.executor import region_verifier
from ..runtime.task import BaseTask, WorkflowBase
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


class ThresholdBase(BaseTask):
    """Materialize a binary (uint8) mask: ``input > / < / == threshold``."""

    task_name = "threshold"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "threshold": 0.5, "threshold_mode": "greater"}

    def run_impl(self):
        cfg = self.get_config()
        # fusable input edge: a live in-memory producer handle (e.g. an
        # inference probability map) is consumed without a storage read
        inp = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"])
        shape = inp.shape
        block_shape = tuple(cfg["block_shape"])
        out = file_reader(cfg["output_path"]).require_dataset(
            cfg["output_key"], shape=shape, chunks=block_shape, dtype="uint8"
        )
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        thr = float(cfg["threshold"])
        mode = cfg.get("threshold_mode", "greater")
        ops = {"greater": lambda d: d > thr, "less": lambda d: d < thr, "equal": lambda d: d == thr}
        if mode not in ops:
            raise ValueError(f"unknown threshold_mode {mode!r}")

        def process(block_id):
            bb = blocking.get_block(block_id).bb
            out[bb] = ops[mode](inp[bb]).astype(np.uint8)

        # per-block retries/deadline/schedule from the config, and each
        # block verified against its digest sidecar after its store
        n = self.host_block_map(block_ids, process, store_verify_fn=region_verifier(out), blocking=blocking)
        return {"n_blocks": n}


class ThresholdLocal(ThresholdBase):
    target = "local"


class ThresholdGPU(ThresholdBase):
    target = "gpu"


class ThresholdedComponentsWorkflow(WorkflowBase):
    """CC with thresholding, then optional size filtering.

    Params: CC params (``input_path/input_key/output_path/output_key/
    threshold/threshold_mode``) plus optional ``min_size``/``max_size``.
    """

    task_name = "thresholded_components_workflow"

    def requires(self):
        from .connected_components import ConnectedComponentsWorkflow
        from .postprocess import SizeFilterWorkflow

        p = dict(self.params)
        min_size = p.pop("min_size", None)
        max_size = p.pop("max_size", None)
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs,
                      target=self.target)
        cc = ConnectedComponentsWorkflow(**common, dependencies=self.dependencies, **p)
        if not min_size and not max_size:
            return [cc]
        sf = SizeFilterWorkflow(
            **common, dependencies=[cc], input_path=p["output_path"], input_key=p["output_key"],
            output_path=p["output_path"], output_key=p["output_key"], min_size=min_size, max_size=max_size,
            **{k: p[k] for k in ("block_shape",) if k in p},
        )
        return [sf]

    def run_impl(self):
        return {}
