"""Paintera-style dataset conversion: block-label indexes + pyramid, and
the BigDataViewer layout.

Port of ``cluster_tools_tpu/tasks/paintera.py``: a segmentation becomes
the layout interactive proof-reading tools need, a multiscale label
pyramid (mode downsampling, :mod:`.downscaling`) plus

- **unique labels per block** (``unique_labels/s<level>/block_<id>.npy``),
- **label-to-block mapping**, the inverted index label -> block ids
  (``label_to_blocks.npz``: CSR over sorted labels),
- dataset attributes ``maxId``, ``resolution`` and ``offset``.

:class:`PainteraToBdvWorkflow` copies the levels into
``setup0/timepoint0/s<level>`` through ``CopyVolume`` and stamps the bdv
``downsamplingFactors`` and ``resolution``.  Numpy on the host threads on
every target, as in the reference; the containers are the port's own
(zarr, N5, HDF5, ``memory://``).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


def unique_labels_dir(tmp_folder: str, level: int) -> str:
    d = os.path.join(tmp_folder, "unique_labels", f"s{level}")
    os.makedirs(d, exist_ok=True)
    return d


def label_to_blocks_path(tmp_folder: str) -> str:
    return os.path.join(tmp_folder, "label_to_blocks.npz")


class UniqueBlockLabelsBase(BaseTask):
    """Unique labels per block of one dataset.  Params:
    ``input_path/input_key``, ``level`` (for the artifact path)."""

    task_name = "unique_block_labels"

    def run_impl(self):
        cfg = self.get_config()
        ds = file_reader(cfg["input_path"])[cfg["input_key"]]
        shape = ds.shape
        block_shape = tuple(cfg["block_shape"])
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        d = unique_labels_dir(self.tmp_folder, int(cfg.get("level", 0)))

        def process(block_id):
            u = np.unique(np.asarray(ds[blocking.get_block(block_id).bb]))
            np.save(os.path.join(d, f"block_{block_id}.npy"), u[u != 0])

        n = self.host_block_map(block_ids, process)
        return {"n_blocks": n}


class UniqueBlockLabelsLocal(UniqueBlockLabelsBase):
    target = "local"


class UniqueBlockLabelsGPU(UniqueBlockLabelsBase):
    target = "gpu"


class LabelBlockMappingBase(BaseTask):
    """Invert the per-block uniques into label -> blocks (CSR over sorted
    labels) and stamp ``maxId``, ``resolution`` and ``offset`` on the
    dataset."""

    task_name = "label_block_mapping"

    def run_impl(self):
        cfg = self.get_config()
        shape = file_reader(cfg["input_path"])[cfg["input_key"]].shape
        block_ids = blocks_in_volume(shape, tuple(cfg["block_shape"]), cfg.get("roi_begin"), cfg.get("roi_end"))
        d = unique_labels_dir(self.tmp_folder, int(cfg.get("level", 0)))
        pairs_label: List[np.ndarray] = []
        pairs_block: List[np.ndarray] = []
        for b in block_ids:
            p = os.path.join(d, f"block_{b}.npy")
            if not os.path.exists(p):
                continue
            u = np.load(p)
            pairs_label.append(u)
            pairs_block.append(np.full(len(u), b, np.int64))
        if pairs_label:
            labs = np.concatenate(pairs_label)
            blks = np.concatenate(pairs_block)
            order = np.lexsort((blks, labs))
            labs, blks = labs[order], blks[order]
            uniq, starts = np.unique(labs, return_index=True)
            offsets = np.append(starts, len(labs)).astype(np.int64)
        else:
            uniq, blks, offsets = np.zeros(0, np.uint64), np.zeros(0, np.int64), np.zeros(1, np.int64)
        np.savez(label_to_blocks_path(self.tmp_folder), labels=uniq, offsets=offsets, blocks=blks)
        max_id = int(uniq.max()) if len(uniq) else 0
        file_reader(cfg["input_path"])[cfg["input_key"]].update_attrs(
            maxId=max_id, resolution=list(cfg.get("resolution") or [1.0] * len(shape)),
            offset=list(cfg.get("offset") or [0.0] * len(shape)))
        return {"n_labels": int(len(uniq)), "maxId": max_id}


class LabelBlockMappingLocal(LabelBlockMappingBase):
    target = "local"


class LabelBlockMappingGPU(LabelBlockMappingBase):
    target = "gpu"


class PainteraConversionWorkflow(WorkflowBase):
    """segmentation -> label pyramid (mode downsampling) + per-block unique
    labels + label-to-block index + attributes.

    Params: ``input_path/input_key``, ``output_path``,
    ``output_key_prefix``, ``scale_factors`` (e.g. [[2,2,2],[2,2,2]]),
    ``resolution``, ``offset``."""

    task_name = "paintera_conversion_workflow"

    def requires(self):
        from . import paintera as pt_mod
        from .downscaling import DownscalingWorkflow

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        bs = {k: p[k] for k in ("block_shape",) if k in p}
        seg = dict(input_path=p["input_path"], input_key=p["input_key"])
        pyramid = DownscalingWorkflow(**common, target=self.target, dependencies=self.dependencies, **seg,
                                      output_path=p["output_path"],
                                      output_key_prefix=p.get("output_key_prefix", "paintera"),
                                      scale_factors=p["scale_factors"], mode="mode", **bs)
        uniq = get_task_cls(pt_mod, "UniqueBlockLabels", self.target)(**common, dependencies=[pyramid], **seg,
                                                                      level=0, **bs)
        mapping = get_task_cls(pt_mod, "LabelBlockMapping", self.target)(
            **common, dependencies=[uniq], **seg, level=0, **{k: p[k] for k in ("resolution", "offset") if k in p},
            **bs)
        return [mapping]


class PainteraToBdvWorkflow(WorkflowBase):
    """A paintera-style pyramid in the BigDataViewer layout: each scale
    level copied to ``setup0/timepoint0/s<level>`` with bdv
    ``downsamplingFactors`` and ``resolution`` attributes.

    Params: ``input_path``, ``input_key`` (the s0 label dataset),
    ``input_key_prefix`` (the pyramid levels ``<prefix>/s1..sN``, as written
    by :class:`PainteraConversionWorkflow`), ``output_path``,
    ``scale_factors`` (per level), ``resolution``."""

    task_name = "paintera_to_bdv_workflow"

    def requires(self):
        from . import copy_volume as cv_mod

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        bs = {k: p[k] for k in ("block_shape",) if k in p}
        prefix = p.get("input_key_prefix", "paintera")
        levels = [p["input_key"]] + [f"{prefix}/s{i}" for i in range(1, len(p["scale_factors"]) + 1)]
        tasks = []
        deps = list(self.dependencies)
        for level, key in enumerate(levels):
            t = get_task_cls(cv_mod, "CopyVolume", self.target)(
                **common, dependencies=deps, input_path=p["input_path"], input_key=key,
                output_path=p["output_path"], output_key=f"setup0/timepoint0/s{level}", **bs)
            tasks.append(t)
            deps = [t]
        return tasks

    def run_impl(self):
        p = self.params
        out = file_reader(p["output_path"])
        res = np.asarray(p.get("resolution") or [1.0, 1.0, 1.0], float)
        cum = np.ones(3, int)
        factors = [[1, 1, 1]] + [list(f) for f in p["scale_factors"]]
        for level, f in enumerate(factors):
            cum = cum * np.asarray(f, int)
            out[f"setup0/timepoint0/s{level}"].update_attrs(downsamplingFactors=[int(x) for x in cum],
                                                            resolution=[float(r * c) for r, c in zip(res, cum)])
        return {"n_levels": len(factors)}
