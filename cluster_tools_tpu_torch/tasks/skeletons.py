"""Blockwise object skeletonization + SWC export.

Port of ``cluster_tools_tpu/tasks/skeletons.py``: skeletons from medial
structure, per object on its bounding-box crop from the morphology table,
on the host on every target, as in the reference (crops are small and
irregular, a poor fit for a fixed-shape device EDT):

1. per object: the Euclidean distance transform of the bbox crop (scipy),
2. medial nodes = EDT local maxima inside the object,
3. topology = the minimum spanning tree over the medial nodes (edge weight
   = euclidean distance, edges only between nodes within ``link_radius``),
   rooted at the node of maximal EDT.

Radii are the EDT value at each node.  Artifacts: ``skeletons/<id>.npz``
{nodes [n, 3+1] (z, y, x, radius), edges [m, 2]} and optional ``<id>.swc``.
"""

from __future__ import annotations

import os

import numpy as np

from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import file_reader
from .morphology import MorphologyWorkflow, morphology_path


def skeleton_dir(tmp_folder: str) -> str:
    d = os.path.join(tmp_folder, "skeletons")
    os.makedirs(d, exist_ok=True)
    return d


def skeletonize_object(mask: np.ndarray, offset=(0, 0, 0), sampling=(1.0, 1.0, 1.0), link_radius: float = 10.0):
    """Skeletonize one binary object: returns (nodes [n, 4], edges [m, 2]).

    Node columns: z, y, x (global coords) and the medial radius (EDT).
    """
    from scipy import ndimage

    if not mask.any():
        return np.zeros((0, 4)), np.zeros((0, 2), np.int64)
    # pad with one background voxel: beyond the object's bounding box is
    # background, otherwise an object filling its bbox has no EDT zero set
    mask_p = np.pad(mask, 1)
    edt = ndimage.distance_transform_edt(mask_p, sampling=sampling)
    # medial nodes: local maxima of the EDT on the object
    mx = ndimage.maximum_filter(edt, size=3)
    medial = (edt >= mx - 1e-9) & mask_p
    coords = np.argwhere(medial).astype(np.float64) - 1.0
    radii = edt[medial]
    if len(coords) == 0:
        coords = np.argwhere(mask)[:1].astype(np.float64)
        radii = np.array([1.0])
    nodes = np.concatenate([coords + np.asarray(offset, np.float64), radii[:, None]], axis=1)
    # MST over the medial nodes (kd-tree neighbourhood graph)
    n = len(coords)
    if n == 1:
        return nodes, np.zeros((0, 2), np.int64)
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree
    from scipy.spatial import cKDTree

    world = coords * np.asarray(sampling)
    tree = cKDTree(world)
    pairs = tree.query_pairs(r=float(link_radius), output_type="ndarray")
    if len(pairs) == 0:
        # nearest-neighbour linkage so the graph is connected
        _, j = tree.query(world, k=2)
        pairs = np.stack([np.arange(n), j[:, 1]], axis=1)
    d = np.linalg.norm(world[pairs[:, 0]] - world[pairs[:, 1]], axis=1)
    mst = minimum_spanning_tree(coo_matrix((d, (pairs[:, 0], pairs[:, 1])), shape=(n, n))).tocoo()
    return nodes, np.stack([mst.row, mst.col], axis=1).astype(np.int64)


def write_swc(path: str, nodes: np.ndarray, edges: np.ndarray):
    """Export a skeleton as SWC (id, type, x, y, z, radius, parent)."""
    n = len(nodes)
    parent = np.full(n, -1, np.int64)
    # orient every connected component from its thickest node (the MST may
    # be a forest when medial clusters are farther apart than link_radius)
    if n:
        adj = [[] for _ in range(n)]
        for a, b in edges:
            adj[a].append(b)
            adj[b].append(a)
        seen = set()
        for root in np.argsort(-nodes[:, 3]):  # thickest first
            root = int(root)
            if root in seen:
                continue
            seen.add(root)
            stack = [root]
            while stack:
                cur = stack.pop()
                for nb in adj[cur]:
                    if nb not in seen:
                        seen.add(nb)
                        parent[nb] = cur
                        stack.append(nb)
    with open(path, "w") as f:
        f.write("# id type x y z radius parent\n")
        for i, (z, y, x, r) in enumerate(nodes):
            p = parent[i]
            f.write(f"{i + 1} 0 {x:.2f} {y:.2f} {z:.2f} {r:.3f} {p + 1 if p >= 0 else -1}\n")


class SkeletonizeBase(BaseTask):
    """Skeletonize objects using the morphology table's bounding boxes.
    Params: ``input_path/input_key`` (segmentation), optional
    ``object_ids`` (default: all), ``sampling`` (voxel size),
    ``link_radius``, ``min_size``, ``export_swc``."""

    task_name = "skeletonize"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "sampling": [1.0, 1.0, 1.0], "link_radius": 10.0,
                "min_size": 1, "export_swc": False, "object_ids": None}

    def run_impl(self):
        cfg = self.get_config()
        ds = file_reader(cfg["input_path"])[cfg["input_key"]]
        with np.load(morphology_path(self.tmp_folder)) as f:
            ids, sizes, bb_min, bb_max = f["ids"], f["sizes"], f["bb_min"], f["bb_max"]
        wanted = cfg.get("object_ids")
        sel = sizes >= int(cfg.get("min_size") or 1)
        if wanted is not None:
            sel &= np.isin(ids, np.asarray(wanted, dtype=ids.dtype))
        sampling = tuple(cfg.get("sampling") or (1.0, 1.0, 1.0))
        link_radius = float(cfg.get("link_radius", 10.0))
        export_swc = bool(cfg.get("export_swc", False))
        d = skeleton_dir(self.tmp_folder)

        def process(idx):
            obj = ids[idx]
            lo, hi = bb_min[idx], bb_max[idx]
            mask = np.asarray(ds[tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))]) == obj
            nodes, edges = skeletonize_object(mask, offset=lo, sampling=sampling, link_radius=link_radius)
            np.savez(os.path.join(d, f"{int(obj)}.npz"), nodes=nodes, edges=edges)
            if export_swc:
                write_swc(os.path.join(d, f"{int(obj)}.swc"), nodes, edges)

        # the object index doubles as the "block" id for resume markers
        n = self.host_block_map([int(i) for i in np.flatnonzero(sel)], process)
        return {"n_objects": n}


class SkeletonizeLocal(SkeletonizeBase):
    target = "local"


class SkeletonizeGPU(SkeletonizeBase):
    target = "gpu"


class SkeletonWorkflow(WorkflowBase):
    """morphology (for bounding boxes) -> skeletonize."""

    task_name = "skeleton_workflow"

    def requires(self):
        from . import skeletons as sk_mod

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        grid = {k: p[k] for k in ("input_path", "input_key", "block_shape", "roi_begin", "roi_end") if k in p}
        morph = MorphologyWorkflow(**common, target=self.target, dependencies=self.dependencies, **grid)
        opts = {k: p[k] for k in ("sampling", "link_radius", "min_size", "export_swc", "object_ids") if k in p}
        return [get_task_cls(sk_mod, "Skeletonize", self.target)(**common, dependencies=[morph], **grid, **opts)]
