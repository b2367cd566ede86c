"""Per-object morphology statistics, blockwise + merge.

Port of ``cluster_tools_tpu/tasks/morphology.py``: per block, the object
sizes, coordinate sums (for the centre of mass) and bounding boxes in
global coordinates (``block_morphology``); the merge sums and reduces the
per-block partials in block order into one table keyed by sorted segment
id.  Numpy on the host threads on every target, as in the reference, with
its float64 sums in its order:

    morphology.npz: ids [n], sizes [n], com [n, d] (centre of mass, voxel
    coords), bb_min [n, d], bb_max [n, d] (inclusive-exclusive bounding box)
"""

from __future__ import annotations

import os

import numpy as np

from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


def _morph_dir(tmp_folder: str) -> str:
    d = os.path.join(tmp_folder, "morphology")
    os.makedirs(d, exist_ok=True)
    return d


def morphology_path(tmp_folder: str) -> str:
    return os.path.join(_morph_dir(tmp_folder), "morphology.npz")


def block_morphology(labels: np.ndarray, offset) -> dict:
    """Partial morphology of one block: per local object, voxel count,
    coordinate sum (for the centre of mass) and bounding box, in *global*
    coordinates given the block ``offset``."""
    ids, inv = np.unique(labels, return_inverse=True)
    inv = inv.ravel()
    fg = ids != 0
    n = len(ids)
    counts = np.bincount(inv, minlength=n).astype(np.int64)
    ndim = labels.ndim
    coord_sum = np.zeros((n, ndim), np.float64)
    bb_min = np.zeros((n, ndim), np.int64)
    bb_max = np.zeros((n, ndim), np.int64)
    grids = np.meshgrid(*[np.arange(s, dtype=np.int64) for s in labels.shape], indexing="ij")
    for d in range(ndim):
        g = grids[d].ravel() + int(offset[d])
        coord_sum[:, d] = np.bincount(inv, weights=g, minlength=n)
        mn = np.full(n, np.iinfo(np.int64).max)
        np.minimum.at(mn, inv, g)
        mx = np.full(n, -1)
        np.maximum.at(mx, inv, g)
        bb_min[:, d] = mn
        bb_max[:, d] = mx + 1  # exclusive
    return {"ids": ids[fg].astype(np.uint64), "counts": counts[fg], "coord_sum": coord_sum[fg],
            "bb_min": bb_min[fg], "bb_max": bb_max[fg]}


class BlockMorphologyBase(BaseTask):
    """Per-block partial morphology."""

    task_name = "block_morphology"

    def run_impl(self):
        cfg = self.get_config()
        ds = file_reader(cfg["input_path"])[cfg["input_key"]]
        shape = ds.shape
        block_shape = tuple(cfg["block_shape"])
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        d = _morph_dir(self.tmp_folder)

        def process(block_id):
            block = blocking.get_block(block_id)
            np.savez(os.path.join(d, f"block_{block_id}.npz"), **block_morphology(np.asarray(ds[block.bb]),
                                                                                  block.begin))

        n = self.host_block_map(block_ids, process)
        return {"n_blocks": n}


class BlockMorphologyLocal(BlockMorphologyBase):
    target = "local"


class BlockMorphologyGPU(BlockMorphologyBase):
    target = "gpu"


class MergeMorphologyBase(BaseTask):
    """Merge the partial morphologies, in block order, into the global table."""

    task_name = "merge_morphology"

    def run_impl(self):
        cfg = self.get_config()
        shape = file_reader(cfg["input_path"])[cfg["input_key"]].shape
        block_ids = blocks_in_volume(shape, tuple(cfg["block_shape"]), cfg.get("roi_begin"), cfg.get("roi_end"))
        d = _morph_dir(self.tmp_folder)
        parts = []
        for b in block_ids:
            p = os.path.join(d, f"block_{b}.npz")
            if os.path.exists(p):
                with np.load(p) as f:
                    parts.append({k: f[k] for k in f.files})
        ndim = len(shape)
        if not parts:
            np.savez(morphology_path(self.tmp_folder), ids=np.zeros(0, np.uint64), sizes=np.zeros(0, np.int64),
                     com=np.zeros((0, ndim)), bb_min=np.zeros((0, ndim), np.int64),
                     bb_max=np.zeros((0, ndim), np.int64))
            return {"n_objects": 0}
        ids, inv = np.unique(np.concatenate([p["ids"] for p in parts]), return_inverse=True)
        inv = inv.ravel()
        n = len(ids)
        sizes = np.zeros(n, np.int64)
        np.add.at(sizes, inv, np.concatenate([p["counts"] for p in parts]))
        coord_sum = np.zeros((n, ndim), np.float64)
        bb_min = np.full((n, ndim), np.iinfo(np.int64).max)
        bb_max = np.zeros((n, ndim), np.int64)
        cs = np.concatenate([p["coord_sum"] for p in parts])
        mn = np.concatenate([p["bb_min"] for p in parts])
        mx = np.concatenate([p["bb_max"] for p in parts])
        for dd in range(ndim):
            np.add.at(coord_sum[:, dd], inv, cs[:, dd])
            np.minimum.at(bb_min[:, dd], inv, mn[:, dd])
            np.maximum.at(bb_max[:, dd], inv, mx[:, dd])
        np.savez(morphology_path(self.tmp_folder), ids=ids, sizes=sizes, com=coord_sum / sizes[:, None],
                 bb_min=bb_min, bb_max=bb_max)
        return {"n_objects": int(n)}


class MergeMorphologyLocal(MergeMorphologyBase):
    target = "local"


class MergeMorphologyGPU(MergeMorphologyBase):
    target = "gpu"


class MorphologyWorkflow(WorkflowBase):
    """block_morphology -> merge_morphology."""

    task_name = "morphology_workflow"

    def requires(self):
        from . import morphology as m_mod

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        kw = {k: p[k] for k in ("input_path", "input_key", "block_shape", "roi_begin", "roi_end") if k in p}
        t1 = get_task_cls(m_mod, "BlockMorphology", self.target)(**common, dependencies=self.dependencies, **kw)
        return [get_task_cls(m_mod, "MergeMorphology", self.target)(**common, dependencies=[t1], **kw)]
