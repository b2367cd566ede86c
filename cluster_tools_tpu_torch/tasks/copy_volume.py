"""Blockwise dataset copy/convert.

Port of ``cluster_tools_tpu/tasks/copy_volume.py``: zarr <-> N5 <-> HDF5,
dtype casts (integer targets clip, never wrap), chunk re-shaping
(``out_chunks``), channel slicing, optional affine scaling and
``fit_to_roi``.  Pure host bandwidth — parallelized over the IO thread
pool.  Blocks straddling a non-aligned ROI edge copy only the inside, and
the post-store verifier checks the region that was written.  The relabel
and size-filter workflows stage their in-place writes through it, and it
is the canonical job of the cluster targets (``runtime/cluster.py``).
"""

from __future__ import annotations

import numpy as np

from ..runtime.executor import region_verifier
from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


class CopyVolumeBase(BaseTask):
    """Params: ``input_path/input_key``, ``output_path/output_key``; optional
    ``dtype`` (cast), ``out_chunks``, ``channel`` (int: slice a leading
    channel axis), ``scale_factor``/``offset`` (affine y = x*scale + offset,
    applied before the cast), ``fit_to_roi``."""

    task_name = "copy_volume"

    @staticmethod
    def default_task_config():
        return {
            "threads_per_job": 1,
            "device_batch": 1,
            "dtype": None,
            "out_chunks": None,
            "channel": None,
            "scale_factor": None,
            "offset": None,
            "fit_to_roi": False,
        }

    def run_impl(self):
        cfg = self.get_config()
        inp = file_reader(cfg["input_path"])[cfg["input_key"]]
        channel = cfg.get("channel")
        in_shape = inp.shape[1:] if channel is not None else inp.shape
        block_shape = tuple(cfg["block_shape"])
        out_chunks = tuple(cfg.get("out_chunks") or block_shape)
        if any(b % c for b, c in zip(block_shape, out_chunks)):
            # race safety: parallel block writes must tile whole output
            # chunks — the container guard can only compare the requested
            # chunks, not the write grid, so enforce it here
            raise ValueError(f"block_shape {block_shape} must be a per-axis multiple of "
                             f"out_chunks {out_chunks} for chunk-aligned parallel writes")
        dtype = cfg.get("dtype") or str(inp.dtype)
        scale, offset = cfg.get("scale_factor"), cfg.get("offset")
        roi_begin, roi_end = cfg.get("roi_begin"), cfg.get("roi_end")
        fit_to_roi = bool(cfg.get("fit_to_roi")) and roi_begin is not None
        if fit_to_roi:
            # output covers exactly the ROI, shifted to the origin
            re = roi_end if roi_end is not None else in_shape
            out_shape = tuple(int(e) - int(b) for b, e in zip(roi_begin, re))
            shift = tuple(int(b) for b in roi_begin)
        else:
            out_shape = in_shape
            shift = tuple(0 for _ in in_shape)

        out = file_reader(cfg["output_path"]).require_dataset(
            cfg["output_key"], shape=out_shape, chunks=out_chunks, dtype=dtype
        )
        blocking = Blocking(in_shape, block_shape)
        block_ids = blocks_in_volume(in_shape, block_shape, roi_begin, roi_end)

        def convert(data):
            if scale is not None or offset is not None:
                data = data.astype(np.float64) * (1.0 if scale is None else scale) + (0.0 if offset is None else offset)
            target = np.dtype(dtype)
            if np.issubdtype(target, np.integer) and target != data.dtype:
                info = np.iinfo(target)
                if np.issubdtype(data.dtype, np.integer):
                    # narrowing / sign-changing int casts must clip, not wrap
                    src = np.iinfo(data.dtype)
                    data = np.clip(data, max(int(info.min), int(src.min)), min(int(info.max), int(src.max)))
                else:
                    data = np.clip(np.round(data), info.min, info.max)
            return data.astype(dtype)

        roi_lo = tuple(int(b) for b in (roi_begin or [0] * len(in_shape)))
        roi_hi = tuple(int(e) for e in (roi_end if roi_end is not None else in_shape))

        def in_bb(block):
            # clipped to the ROI: blocks straddling a non-aligned ROI edge
            # must not read/write outside it
            return tuple(slice(max(b.start, lo), min(b.stop, hi)) for b, lo, hi in zip(block.bb, roi_lo, roi_hi))

        def out_bb(block):
            # the region process() wrote: ROI-clipped, shifted to the
            # output's origin
            return tuple(slice(b.start - s, b.stop - s) for b, s in zip(in_bb(block), shift))

        def process(block_id):
            block = blocking.get_block(block_id)
            bb = in_bb(block)
            data = inp[(channel,) + bb] if channel is not None else inp[bb]
            out[out_bb(block)] = convert(data)

        n = self.host_block_map(block_ids, process, store_verify_fn=region_verifier(out, bb_of=out_bb),
                                blocking=blocking)
        return {"n_blocks": n, "shape": list(out_shape), "dtype": dtype}


class CopyVolumeLocal(CopyVolumeBase):
    target = "local"


class CopyVolumeGPU(CopyVolumeBase):
    target = "gpu"


class CopyVolumeWorkflow(WorkflowBase):
    task_name = "copy_volume_workflow"

    def requires(self):
        from . import copy_volume as cv_mod

        return [get_task_cls(cv_mod, "CopyVolume", self.target)(
            tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs,
            dependencies=self.dependencies, **self.params,
        )]

    def run_impl(self):
        return {}
