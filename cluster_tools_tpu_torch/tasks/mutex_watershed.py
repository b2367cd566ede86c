"""Blockwise mutex watershed over affinity maps.

Port of ``cluster_tools_tpu/tasks/mutex_watershed.py``: a mutex watershed
a block on its affinities with offset vectors (+halo), globally unique
labels by the block-offset encoding ``block_id * (n_outer + 1) + inner``,
an optional mask.  Cross-block consistency comes from the stitching tasks
(:mod:`.stitching`): faces merge by the mean attractive affinity between
the adjacent labels, then a union-find assignment is written blockwise.
The constraint loop runs in the host C++ rung (:mod:`..ops.mws`) on the
host threads on every target, as in the reference.

Params: ``input_path/input_key`` (affinities, leading channel axis),
``output_path/output_key``, ``offsets`` (list of int vectors, the first
ndim the unit offsets), ``strides``, optional ``mask_path/mask_key``,
``halo``.
"""

from __future__ import annotations

import numpy as np

from ..ops.mws import mutex_watershed
from ..runtime.executor import region_verifier
from ..runtime import handoff
from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


DEFAULT_OFFSETS = [
    [-1, 0, 0], [0, -1, 0], [0, 0, -1],
    [-2, 0, 0], [0, -3, 0], [0, 0, -3],
    [-3, -3, 0], [-3, 0, -3], [0, -3, -3],
]


class MwsBlocksBase(BaseTask):
    """A mutex watershed a block (reference: ``MwsBlocksBase``)."""

    task_name = "mws_blocks"

    @staticmethod
    def default_task_config():
        return {
            "threads_per_job": 1,
            "device_batch": 1,
            "offsets": DEFAULT_OFFSETS,
            "strides": None,
            "halo": [4, 4, 4],
        }

    def run_impl(self):
        cfg = self.get_config()
        # a fusable input edge: a live in-memory affinity handle resolves here
        ds_in = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"])
        offsets = [list(map(int, o)) for o in cfg.get("offsets") or DEFAULT_OFFSETS]
        shape = ds_in.shape[1:]
        ndim = len(shape)
        for off in offsets[:ndim]:
            if sum(abs(o) for o in off) != 1:
                raise ValueError(f"offsets[:{ndim}] must be unit (attractive) offsets, got {off}")
        block_shape = tuple(cfg["block_shape"])
        halo = tuple(cfg.get("halo") or [0] * ndim)
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        out = file_reader(cfg["output_path"]).require_dataset(cfg["output_key"], shape=shape, chunks=block_shape,
                                                              dtype="uint64")
        mask_ds = file_reader(cfg["mask_path"])[cfg["mask_key"]] if cfg.get("mask_path") else None
        strides = cfg.get("strides")
        n_outer = int(np.prod([b + 2 * h for b, h in zip(block_shape, halo)]))

        def process(block_id):
            block = blocking.get_block(block_id, halo)
            affs = np.asarray(ds_in[(slice(None),) + block.outer_bb]).astype(np.float64)
            mask = np.asarray(mask_ds[block.outer_bb]) > 0 if mask_ds is not None else None
            inner = mutex_watershed(affs, offsets, mask=mask, strides=strides)[block.inner_in_outer_bb]
            out[block.bb] = np.where(inner > 0, np.uint64(block.block_id) * np.uint64(n_outer + 1)
                                     + inner.astype(np.uint64), np.uint64(0))

        # the store verifier re-reads each block's written region against
        # its digest sidecar, so a corrupt chunk is re-run while this task
        # still owns the block
        n = self.host_block_map(block_ids, process, store_verify_fn=region_verifier(out), blocking=blocking)
        return {"n_blocks": n}


class MwsBlocksLocal(MwsBlocksBase):
    target = "local"


class MwsBlocksGPU(MwsBlocksBase):
    target = "gpu"


class MwsWorkflow(WorkflowBase):
    """MWS blocks, then affinity-consensus stitching and the write (the
    cross-block pass; reference: ``TwoPassMws`` / the MWS stitching
    workflows).  ``stitch=False`` keeps the independent blocks."""

    task_name = "mws_workflow"

    def requires(self):
        from . import mutex_watershed as mws_mod
        from .stitching import StitchingWorkflow

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        t1 = get_task_cls(mws_mod, "MwsBlocks", self.target)(
            **common, dependencies=self.dependencies,
            **{k: p[k] for k in ("input_path", "input_key", "output_path", "output_key", "offsets", "strides", "halo",
                                 "mask_path", "mask_key", "block_shape", "roi_begin", "roi_end") if k in p},
        )
        if not p.get("stitch", True):
            return [t1]
        # each face scored by the attractive channel along its axis; high
        # affinity merges
        return [StitchingWorkflow(
            **common, target=self.target, dependencies=[t1], seg_path=p["output_path"], seg_key=p["output_key"],
            input_path=p["input_path"], input_key=p["input_key"], axis_channels=list(range(3)), merge_mode="greater",
            **{k: p[k] for k in ("stitch_threshold", "block_shape", "roi_begin", "roi_end") if k in p},
        )]
