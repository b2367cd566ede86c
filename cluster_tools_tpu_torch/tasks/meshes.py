"""Per-object surface meshes from a segmentation.

Port of ``cluster_tools_tpu/tasks/meshes.py``: each object's surface is
its exposed voxel faces on its bounding-box crop from the morphology table
(exact, watertight, orientation-consistent quads split into triangles,
vertices deduplicated on the corner grid), optionally relaxed by a few
Laplacian smoothing iterations.  Triangles wind so normals point out of
the object: the divergence-theorem signed volume of an unsmoothed mesh
(:func:`mesh_signed_volume`) equals the voxel count.  Numpy on the host on
every target, as in the reference.

Artifacts: ``meshes/<id>.npz`` {vertices [n, 3] float64 (z, y, x in global
coords), faces [m, 3] int64} and optional ``<id>.obj``.
"""

from __future__ import annotations

import os

import numpy as np

from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import file_reader
from .morphology import MorphologyWorkflow, morphology_path


def mesh_dir(tmp_folder: str) -> str:
    d = os.path.join(tmp_folder, "meshes")
    os.makedirs(d, exist_ok=True)
    return d


# ring orientation of the two in-plane axes (u, w) = the other two axes in
# ascending order: e_u x e_w = +e_k for k in {0, 2}, -e_k for k = 1
_RING_SIGN = {0: 1.0, 1: -1.0, 2: 1.0}


def _face_quads(mask: np.ndarray, axis: int, positive: bool):
    """Quad corner coordinates [q, 4, 3] for exposed faces along ``axis``.

    A face is exposed where the object voxel's ``axis``-neighbour (in the
    ``positive`` direction) is background; the quad lies on the corner
    plane between them, wound so the normal points toward background.
    """
    m = np.pad(mask, [(1, 1) if a == axis else (0, 0) for a in range(3)])
    inside = np.take(m, range(1, m.shape[axis] - 1), axis=axis)
    nb = np.take(m, range(2, m.shape[axis]) if positive else range(0, m.shape[axis] - 2), axis=axis)
    vox = np.argwhere(inside & ~nb).astype(np.float64)  # [q, 3]
    if len(vox) == 0:
        return np.zeros((0, 4, 3))
    u, w = [a for a in range(3) if a != axis]
    plane = vox[:, axis] + (1.0 if positive else 0.0)
    ring = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
    if _RING_SIGN[axis] * (1.0 if positive else -1.0) < 0:
        ring = ring[::-1]
    quads = np.empty((len(vox), 4, 3))
    for c, (du, dw) in enumerate(ring):
        quads[:, c, axis] = plane
        quads[:, c, u] = vox[:, u] + du
        quads[:, c, w] = vox[:, w] + dw
    return quads


def mesh_object(mask: np.ndarray, offset=(0, 0, 0), smoothing_iterations: int = 0, smoothing_lambda: float = 0.5):
    """Mesh one binary object: returns (vertices [n, 3], faces [m, 3]).

    Vertices are in global (z, y, x) coordinates (``offset`` = bounding-box
    origin); faces wind outward.
    """
    quads = np.concatenate([_face_quads(mask, axis, positive) for axis in range(3) for positive in (True, False)])
    if len(quads) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    # dedup corners on the (Z+1, Y+1, X+1) corner grid
    dims = np.asarray(mask.shape, np.int64) + 1
    flat = quads.reshape(-1, 3).astype(np.int64)
    lin = (flat[:, 0] * dims[1] + flat[:, 1]) * dims[2] + flat[:, 2]
    uniq, inverse = np.unique(lin, return_inverse=True)
    vertices = np.stack([uniq // (dims[1] * dims[2]), (uniq // dims[2]) % dims[1], uniq % dims[2]],
                        axis=1).astype(np.float64)
    corner_ids = inverse.reshape(-1, 4)
    faces = np.concatenate([corner_ids[:, [0, 1, 2]], corner_ids[:, [0, 2, 3]]]).astype(np.int64)

    if smoothing_iterations > 0:
        # uniform-weight Laplacian relaxation over the face edge graph
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
        lam = float(smoothing_lambda)
        deg = np.zeros(len(vertices))
        np.add.at(deg, e[:, 0], 1.0)
        np.add.at(deg, e[:, 1], 1.0)
        deg = np.maximum(deg, 1.0)[:, None]
        for _ in range(int(smoothing_iterations)):
            acc = np.zeros_like(vertices)
            np.add.at(acc, e[:, 0], vertices[e[:, 1]])
            np.add.at(acc, e[:, 1], vertices[e[:, 0]])
            vertices = vertices + lam * (acc / deg - vertices)

    return vertices + np.asarray(offset, np.float64), faces


def mesh_signed_volume(vertices: np.ndarray, faces: np.ndarray) -> float:
    """Divergence-theorem volume; equals the voxel count for an unsmoothed
    outward-wound voxel-face mesh."""
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    return float(np.einsum("ij,ij->i", v0, np.cross(v1, v2)).sum() / 6.0)


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray):
    """Wavefront OBJ export (x y z vertex order, 1-based faces)."""
    with open(path, "w") as f:
        for z, y, x in vertices:
            f.write(f"v {x:.4f} {y:.4f} {z:.4f}\n")
        for a, b, c in faces + 1:
            f.write(f"f {a} {b} {c}\n")


class MeshesBase(BaseTask):
    """Mesh objects using the morphology table's bounding boxes.  Params:
    ``input_path/input_key`` (segmentation), optional ``object_ids``,
    ``min_size``, ``smoothing_iterations``, ``smoothing_lambda``,
    ``export_obj``."""

    task_name = "meshes"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "min_size": 1, "smoothing_iterations": 0,
                "smoothing_lambda": 0.5, "export_obj": False, "object_ids": None}

    def run_impl(self):
        cfg = self.get_config()
        ds = file_reader(cfg["input_path"])[cfg["input_key"]]
        with np.load(morphology_path(self.tmp_folder)) as f:
            ids, sizes, bb_min, bb_max = f["ids"], f["sizes"], f["bb_min"], f["bb_max"]
        wanted = cfg.get("object_ids")
        sel = sizes >= int(cfg.get("min_size") or 1)
        if wanted is not None:
            sel &= np.isin(ids, np.asarray(wanted, dtype=ids.dtype))
        smooth_n = int(cfg.get("smoothing_iterations") or 0)
        smooth_lam = float(cfg.get("smoothing_lambda", 0.5))
        export_obj = bool(cfg.get("export_obj", False))
        d = mesh_dir(self.tmp_folder)

        def process(idx):
            obj = ids[idx]
            lo, hi = bb_min[idx], bb_max[idx]
            mask = np.asarray(ds[tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))]) == obj
            vertices, faces = mesh_object(mask, offset=lo, smoothing_iterations=smooth_n,
                                          smoothing_lambda=smooth_lam)
            np.savez(os.path.join(d, f"{int(obj)}.npz"), vertices=vertices, faces=faces)
            if export_obj:
                write_obj(os.path.join(d, f"{int(obj)}.obj"), vertices, faces)

        n = self.host_block_map([int(i) for i in np.flatnonzero(sel)], process)
        return {"n_objects": n}


class MeshesLocal(MeshesBase):
    target = "local"


class MeshesGPU(MeshesBase):
    target = "gpu"


class MeshWorkflow(WorkflowBase):
    """morphology (for bounding boxes) -> meshes."""

    task_name = "mesh_workflow"

    def requires(self):
        from . import meshes as me_mod

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        grid = {k: p[k] for k in ("input_path", "input_key", "block_shape", "roi_begin", "roi_end") if k in p}
        morph = MorphologyWorkflow(**common, target=self.target, dependencies=self.dependencies, **grid)
        opts = {k: p[k] for k in ("min_size", "smoothing_iterations", "smoothing_lambda", "export_obj", "object_ids")
                if k in p}
        return [get_task_cls(me_mod, "Meshes", self.target)(**common, dependencies=[morph], **grid, **opts)]


class MeshesWorkflow(MeshWorkflow):
    """Alias of :class:`MeshWorkflow` under the reference's other name."""

    task_name = "meshes_workflow"
