"""Object-pair boundary distances, blockwise.

Port of ``cluster_tools_tpu/tasks/distances.py``: for every pair of
distinct objects whose surfaces come within ``max_distance`` of each
other, the minimum boundary-to-boundary distance:

1. per block (read with a ``max_distance`` halo): the boundary voxels of
   each object, a kd-tree query (scipy's ``cKDTree``, as in the reference)
   between the object pairs in the window, per-pair minima;
2. merge: the global minimum per pair.

Host work on every target, as in the reference.  Artifacts:
``distances/block_<id>.npz`` parts and the merged
``distances/distances.npz`` {pairs [m, 2], dists [m]}.
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


def distances_dir(tmp_folder: str) -> str:
    d = os.path.join(tmp_folder, "distances")
    os.makedirs(d, exist_ok=True)
    return d


def distances_path(tmp_folder: str) -> str:
    return os.path.join(distances_dir(tmp_folder), "distances.npz")


def boundary_voxels(seg: np.ndarray) -> np.ndarray:
    """Mask of voxels adjacent (face connectivity) to a different label."""
    b = np.zeros(seg.shape, bool)
    for axis in range(seg.ndim):
        sl_a = [slice(None)] * seg.ndim
        sl_b = [slice(None)] * seg.ndim
        sl_a[axis] = slice(0, -1)
        sl_b[axis] = slice(1, None)
        diff = seg[tuple(sl_a)] != seg[tuple(sl_b)]
        b[tuple(sl_a)] |= diff
        b[tuple(sl_b)] |= diff
    return b


def block_pair_distances(seg: np.ndarray, max_distance: float, sampling=(1.0, 1.0, 1.0)):
    """Min distances between boundary voxels of object pairs within one
    window.  Returns (pairs [m, 2] uint64, dists [m])."""
    from scipy.spatial import cKDTree

    bmask = boundary_voxels(seg) & (seg != 0)
    labels = seg[bmask]
    coords = np.argwhere(bmask).astype(np.float64) * np.asarray(sampling)
    ids = np.unique(labels)
    trees = {obj: cKDTree(coords[labels == obj]) for obj in ids}
    result = {}
    for i, a in enumerate(ids):
        for b in ids[i + 1:]:
            m = trees[a].sparse_distance_matrix(trees[b], max_distance=float(max_distance), output_type="coo_matrix")
            if m.nnz:
                result[(int(a), int(b))] = float(m.data.min())
    if not result:
        return np.zeros((0, 2), np.uint64), np.zeros(0)
    pairs = np.array(sorted(result), dtype=np.uint64)
    return pairs, np.array([result[tuple(p)] for p in pairs])


class BlockDistancesBase(BaseTask):
    """Per-block pair distances (window = block + max_distance halo)."""

    task_name = "block_distances"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "max_distance": 10.0, "sampling": [1.0, 1.0, 1.0]}

    def run_impl(self):
        cfg = self.get_config()
        ds = file_reader(cfg["input_path"])[cfg["input_key"]]
        shape = ds.shape
        block_shape = tuple(cfg["block_shape"])
        max_dist = float(cfg.get("max_distance", 10.0))
        sampling = tuple(cfg.get("sampling") or (1.0,) * len(shape))
        halo = tuple(int(np.ceil(max_dist / s)) for s in sampling)
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        d = distances_dir(self.tmp_folder)

        def process(block_id):
            block = blocking.get_block(block_id, halo)
            pairs, dists = block_pair_distances(np.asarray(ds[block.outer_bb]), max_dist, sampling)
            np.savez(os.path.join(d, f"block_{block_id}.npz"), pairs=pairs, dists=dists)

        n = self.host_block_map(block_ids, process)
        return {"n_blocks": n}


class BlockDistancesLocal(BlockDistancesBase):
    target = "local"


class BlockDistancesGPU(BlockDistancesBase):
    target = "gpu"


class MergeDistancesBase(BaseTask):
    """Global minimum per object pair."""

    task_name = "merge_distances"

    def run_impl(self):
        cfg = self.get_config()
        shape = file_reader(cfg["input_path"])[cfg["input_key"]].shape
        block_ids = blocks_in_volume(shape, tuple(cfg["block_shape"]), cfg.get("roi_begin"), cfg.get("roi_end"))
        d = distances_dir(self.tmp_folder)
        best = defaultdict(lambda: np.inf)
        for b in block_ids:
            p = os.path.join(d, f"block_{b}.npz")
            if not os.path.exists(p):
                continue
            with np.load(p) as f:
                for (a, c), dist in zip(f["pairs"], f["dists"]):
                    key = (int(a), int(c))
                    if dist < best[key]:
                        best[key] = float(dist)
        pairs = np.array(sorted(best), dtype=np.uint64).reshape(-1, 2)
        dists = np.array([best[tuple(map(int, p))] for p in pairs])
        np.savez(distances_path(self.tmp_folder), pairs=pairs, dists=dists)
        return {"n_pairs": int(len(pairs))}


class MergeDistancesLocal(MergeDistancesBase):
    target = "local"


class MergeDistancesGPU(MergeDistancesBase):
    target = "gpu"


class PairwiseDistanceWorkflow(WorkflowBase):
    task_name = "pairwise_distance_workflow"

    def requires(self):
        from . import distances as dist_mod

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        kw = {k: p[k] for k in ("input_path", "input_key", "max_distance", "sampling", "block_shape", "roi_begin",
                                "roi_end") if k in p}
        t1 = get_task_cls(dist_mod, "BlockDistances", self.target)(**common, dependencies=self.dependencies, **kw)
        return [get_task_cls(dist_mod, "MergeDistances", self.target)(**common, dependencies=[t1], **kw)]
