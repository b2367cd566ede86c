"""Blockwise multiscale pyramid: per-scale blockwise downsampling (mean for
raw data, nearest/mode for labels, min/max), chained over scale levels by
the workflow, with paintera-style multiscale metadata
(``downsamplingFactors``) in the dataset attributes.

Port of ``cluster_tools_tpu/tasks/downscaling.py``.  Numpy on the host
threads on every target, as in the reference: a gather and a small
reduction a cell, whose output is a fraction of the input (``mode`` sorts
the cells and ranks runs of equal values, where the reference calls
``np.unique`` a cell: the same values).  An integer
``mean`` rounds half to even and clips back to the input dtype, as the
reference does, so the pyramid keeps s0's dtype; each block's store is
verified against its digest sidecar.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..runtime.executor import region_verifier
from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


def _reduce_block(data: np.ndarray, factor: Sequence[int], mode: str) -> np.ndarray:
    """Downsample one region by integer ``factor`` per axis."""
    factor = tuple(int(f) for f in factor)
    if mode == "nearest":
        return data[tuple(slice(None, None, f) for f in factor)]
    # pad up to a multiple with edge values so edge cells average real data
    pad = [(0, (-s) % f) for s, f in zip(data.shape, factor)]
    if any(p[1] for p in pad):
        data = np.pad(data, pad, mode="edge")
    new_shape = []
    for s, f in zip(data.shape, factor):
        new_shape += [s // f, f]
    blocks = data.reshape(new_shape)
    axes = tuple(range(1, 2 * data.ndim, 2))
    if mode == "mean":
        m = blocks.mean(axes)
        if np.issubdtype(data.dtype, np.integer):
            info = np.iinfo(data.dtype)
            m = np.clip(np.round(m), info.min, info.max)
        return m.astype(data.dtype)
    if mode == "max":
        return blocks.max(axes)
    if mode == "min":
        return blocks.min(axes)
    if mode == "mode":
        # majority vote per cell (labels): the most frequent value, the
        # smallest among ties, as a per-cell ``np.unique`` + ``np.argmax``
        flat = np.moveaxis(blocks, axes, range(data.ndim, 2 * data.ndim))
        grid = flat.shape[: data.ndim]
        return _cell_modes(flat.reshape(int(np.prod(grid)), -1)).reshape(grid)
    raise ValueError(f"unknown downscaling mode {mode!r}")


def _cell_modes(cells: np.ndarray) -> np.ndarray:
    """Per row of ``cells``, the most frequent value, the smallest among
    ties (NaNs count as one value, the largest, as in ``np.unique``): the
    rows sorted, each element ranked within its run of equal values, and
    the first element whose rank is the row's longest run."""
    srt = np.sort(cells, axis=1)
    starts = np.ones(srt.shape, bool)
    starts[:, 1:] = srt[:, 1:] != srt[:, :-1]
    if srt.dtype.kind == "f":
        starts[:, 1:] &= ~(np.isnan(srt[:, 1:]) & np.isnan(srt[:, :-1]))
    idx = np.arange(srt.shape[1])
    rank = idx - np.maximum.accumulate(np.where(starts, idx, 0), axis=1)
    first = np.argmax(rank == rank.max(axis=1, keepdims=True), axis=1)
    return srt[np.arange(len(srt)), first]


class DownscalingBase(BaseTask):
    """One scale step: ``input_path/input_key`` (scale s) ->
    ``output_path/output_key`` (scale s+1), by ``scale_factor`` with
    ``mode`` in mean/nearest/mode/max/min."""

    task_name = "downscaling"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "scale_factor": [2, 2, 2], "mode": "mean"}

    def run_impl(self):
        cfg = self.get_config()
        inp = file_reader(cfg["input_path"])[cfg["input_key"]]
        factor = tuple(int(f) for f in cfg["scale_factor"])
        mode = cfg.get("mode", "mean")
        in_shape = inp.shape
        out_shape = tuple((s + f - 1) // f for s, f in zip(in_shape, factor))
        block_shape = tuple(cfg["block_shape"])
        dtype = str(inp.dtype)
        out = file_reader(cfg["output_path"]).require_dataset(cfg["output_key"], shape=out_shape, chunks=block_shape,
                                                              dtype=dtype)
        blocking = Blocking(out_shape, block_shape)
        block_ids = blocks_in_volume(out_shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))

        def process(block_id):
            block = blocking.get_block(block_id)
            in_bb = tuple(slice(b.start * f, min(b.stop * f, s)) for b, f, s in zip(block.bb, factor, in_shape))
            out[block.bb] = _reduce_block(inp[in_bb], factor, mode).astype(dtype)

        n = self.host_block_map(block_ids, process, store_verify_fn=region_verifier(out), blocking=blocking)
        # per-step factor; workflows overwrite with the cumulative factor
        out.update_attrs(downsamplingFactors=list(factor), downscalingMode=mode)
        return {"n_blocks": n, "out_shape": list(out_shape)}


class DownscalingLocal(DownscalingBase):
    target = "local"


class DownscalingGPU(DownscalingBase):
    target = "gpu"


class DownscalingWorkflow(WorkflowBase):
    """Chain scale levels: writes ``<output_key_prefix>/s1..sN`` from
    ``input_key`` (= s0), with cumulative ``downsamplingFactors`` metadata."""

    task_name = "downscaling_workflow"

    def requires(self):
        from . import downscaling as ds_mod

        p = self.params
        factors: List[Sequence[int]] = p["scale_factors"]
        prefix = p.get("output_key_prefix", "")
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        bs = {k: p[k] for k in ("block_shape",) if k in p}
        prev_key, prev = p["input_key"], None
        for level, factor in enumerate(factors, start=1):
            key = (prefix + "/" if prefix else "") + f"s{level}"
            prev = get_task_cls(ds_mod, "Downscaling", self.target)(
                **common, dependencies=self.dependencies if prev is None else [prev],
                input_path=p["input_path"] if prev is None else p["output_path"], input_key=prev_key,
                output_path=p["output_path"], output_key=key, scale_factor=list(factor), mode=p.get("mode", "mean"),
                **bs)
            prev_key = key
        return [prev] if prev is not None else []

    def run_impl(self):
        p = self.params
        prefix = p.get("output_key_prefix", "")
        out = file_reader(p["output_path"])
        # downsamplingFactors are cumulative relative to s0: each level's
        # attrs are rewritten here
        cum = []
        acc = np.ones(len(p["scale_factors"][0]), int)
        for level, f in enumerate(p["scale_factors"], start=1):
            acc = acc * np.asarray(f, int)
            cum.append([int(x) for x in acc])
            key = (prefix + "/" if prefix else "") + f"s{level}"
            out[key].update_attrs(downsamplingFactors=[int(x) for x in acc])
        return {"cumulative_factors": cum}
