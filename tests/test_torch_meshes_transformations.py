"""``tasks/meshes.py`` and ``tasks/transformations.py`` against the JAX
package with zero tolerance.

The ten cases of the reference's ``tests/test_meshes_transformations.py``
run on both packages on the same seeded numpy input: meshes (vertices,
faces, OBJ text) and skeletons are equal bit for bit; the affine
transforms are equal bit for bit too — order 0 is the same host gather,
and order 1's torch resample (on the CPU for ``target="local"``) computes
the corner weights and their sum in the op order of the reference's
``jax.scipy.ndimage.map_coordinates`` under XLA on the CPU, fused
multiply-adds included, so its float32 samples are the reference's
exactly.  Each case keeps the reference's own oracle check
(scipy's ``affine_transform`` at atol 1e-3, signed mesh volumes equal to
voxel counts).  The JAX runs are shared through a module-scoped fixture.
"""

import importlib
import json
import os
import signal

import numpy as np
import pytest
import scipy.ndimage as ndi

from cluster_tools_tpu.runtime import supervision as jsup
from cluster_tools_tpu_torch.runtime import supervision as psup

from .helpers import random_blobs


@pytest.fixture(autouse=True, scope="module")
def _restore_drain_handlers():
    """Both packages' executors arm a SIGTERM/SIGUSR1 drain handler in the
    main thread and keep it: after this file's last case, restore both
    signals, both packages' armed flags and their drain latches, so a later
    file in this worker (the reference's preempt test above all) finds them
    as they were (ROADMAP fact 19)."""
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGUSR1)}
    flags = [(mod, mod._drain_installed) for mod in (jsup, psup)]
    yield
    for sig, handler in saved.items():
        signal.signal(sig, handler)
    for mod, flag in flags:
        mod._drain_installed = flag
        mod.reset_drain()


PKG = {"jax": "cluster_tools_tpu", "port": "cluster_tools_tpu_torch"}


def _mod(side, name):
    return importlib.import_module(f"{PKG[side]}.{name}")


def _reader(side):
    return _mod(side, "utils.volume_utils").file_reader


def _workspace(root):
    config_dir = os.path.join(root, "config")
    os.makedirs(config_dir, exist_ok=True)
    with open(os.path.join(config_dir, "global.config"), "w") as f:
        json.dump({"block_shape": [16, 16, 16]}, f)
    return dict(tmp_folder=os.path.join(root, "tmp"), config_dir=config_dir, max_jobs=2)


def _dataset(side, root, name, data, chunks=(16, 16, 16)):
    path = os.path.join(root, f"{name}.zarr")
    _reader(side)(path).require_dataset(name, shape=data.shape, chunks=chunks, dtype=str(data.dtype))[...] = data
    return path


def _edge_counts(faces):
    e = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    return counts


# ---------------------------------------------------------------- meshes


def _blob_mask():
    return ndi.binary_closing(np.random.default_rng(31).random((12, 14, 10)) < 0.45, iterations=2)


def _mesh_fns(side, root):
    me = _mod(side, "tasks.meshes")
    out = {}
    for tag, mask, kw in (("cube", np.ones((3, 3, 3), bool), {}), ("blob", _blob_mask(), {"offset": (5, 7, 9)}),
                          ("cube4", np.ones((4, 4, 4), bool), {}),
                          ("cube4_smooth", np.ones((4, 4, 4), bool), {"smoothing_iterations": 5})):
        v, f = me.mesh_object(mask, **kw)
        out.update({f"{tag}/v": v, f"{tag}/f": f, f"{tag}/volume": np.float64(me.mesh_signed_volume(v, f))})
    return out


def _mesh_files(tmp_folder, ids, subdir, exts):
    out = {}
    for obj in ids:
        base = os.path.join(tmp_folder, subdir, str(int(obj)))
        with np.load(base + ".npz") as f:
            out.update({f"{obj}/{k}": f[k] for k in f.files})
        for ext in exts:
            out[f"{obj}/{ext}"] = np.frombuffer(open(base + ext, "rb").read(), np.uint8)
    return out


def _blob_seg():
    return ndi.label(random_blobs(np.random.default_rng(32), (32, 32, 32), p=0.3))[0].astype(np.uint64)


def _mesh_workflow(side, root):
    seg = _blob_seg()
    path = _dataset(side, root, "seg", seg)
    ws = _workspace(root)
    assert _mod(side, "runtime.task").build([_mod(side, "tasks.meshes").MeshWorkflow(
        **ws, target="local", input_path=path, input_key="seg", block_shape=[16, 16, 16], export_obj=True)])
    return _mesh_files(ws["tmp_folder"], [i for i in np.unique(seg) if i != 0], "meshes", [".obj"])


def _em_seg():
    from cluster_tools_tpu.utils.synthetic import synthetic_em_volume

    _, gt, mask = synthetic_em_volume(shape=(16, 48, 48), n_objects=4, sampling=(40.0, 4.0, 4.0), seed=11)
    return (gt * mask).astype(np.uint64)


def _capstone(side, root):
    seg = _em_seg()
    path = _dataset(side, root, "seg", seg, chunks=(8, 16, 16))
    ws = _workspace(root)
    common = dict(**ws, target="local", input_path=path, input_key="seg", block_shape=[8, 16, 16])
    build = _mod(side, "runtime.task").build
    assert build([_mod(side, "tasks.meshes").MeshWorkflow(export_obj=True, **common)])
    assert build([_mod(side, "tasks.skeletons").SkeletonWorkflow(export_swc=True, sampling=[40.0, 4.0, 4.0],
                                                                 link_radius=80.0, **common)])
    ids = [int(i) for i in np.unique(seg) if i != 0]
    return {**_mesh_files(ws["tmp_folder"], ids, "meshes", [".obj"]),
            **{f"sk/{k}": v for k, v in _mesh_files(ws["tmp_folder"], ids, "skeletons", [".swc"]).items()}}


# ------------------------------------------------------- transformations

ROT = np.array([[1, 0, 0], [0, np.cos(0.3), -np.sin(0.3)], [0, np.sin(0.3), np.cos(0.3)]]) * 1.1
AFFINE = {
    # name: (data, matrix, offset, order, fill, out_shape)
    "identity": (lambda: (np.random.default_rng(41).random((24, 24, 24)) * 100).astype(np.float32),
                 np.eye(3), np.zeros(3), 1, 0.0, None),
    "order1": (lambda: (np.random.default_rng(42).random((24, 24, 24)) * 100).astype(np.float32),
               ROT, np.array([1.5, -2.0, 3.25]), 1, 0.0, None),
    "order0_labels": (lambda: np.random.default_rng(43).integers(0, 7, size=(24, 24, 24)).astype(np.uint32),
                      np.diag([0.5, 0.5, 0.5]), np.array([2.0, 0.0, -1.0]), 0, 0.0, None),
    "order0_huge_ids": (lambda: np.random.default_rng(44).integers(1, 1000, size=(24, 24, 24)).astype(np.uint64)
                        + np.uint64(1 << 24), np.diag([0.9, 1.0, 1.1]), np.array([0.4, -0.6, 1.1]), 0, 0.0, None),
    "fill_out_shape": (lambda: (np.random.default_rng(45).random((24, 24, 24)) * 100).astype(np.float32),
                       np.eye(3), np.array([-20.0, 0.0, 0.0]), 1, 7.5, (32, 24, 24)),
}


def _affine(name):
    make, matrix, offset, order, fill, out_shape = AFFINE[name]

    def run(side, root):
        path = _dataset(side, root, "vol", make())
        assert _mod(side, "runtime.task").build([_mod(side, "tasks.transformations").TransformationsWorkflow(
            **_workspace(root), target="local", input_path=path, input_key="vol", output_path=path,
            output_key="warped", matrix=[list(map(float, r)) for r in matrix], offset=[float(o) for o in offset],
            order=order, fill_value=fill, out_shape=list(out_shape) if out_shape else None,
            block_shape=[16, 16, 16])])
        return {"warped": _reader(side)(path)["warped"][...]}

    return run


def _scipy_affine(name):
    make, matrix, offset, order, fill, out_shape = AFFINE[name]
    data = make()
    if order == 1:
        data = data.astype(np.float64)
    return ndi.affine_transform(data, matrix, offset=offset, order=order, mode="constant", cval=fill,
                                output_shape=out_shape or data.shape)


CASES = {"mesh_fns": _mesh_fns, "mesh_workflow": _mesh_workflow, "capstone": _capstone,
         **{f"affine_{k}": _affine(k) for k in AFFINE}}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's run of a case, once per module."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = CASES[case]("jax", str(tmp_path_factory.mktemp(f"jax-{case}")))
        return cache[case]

    return get


def _both(case, tmp_path, jax_run):
    got, want = CASES[case]("port", str(tmp_path)), jax_run(case)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


def test_mesh_object_cube_exact(tmp_path, jax_run):
    """A 3x3x3 solid cube: 54 quads -> 108 triangles, 56 corner vertices,
    watertight, and the signed volume equals the voxel count."""
    m = _both("mesh_fns", tmp_path, jax_run)
    assert len(m["cube/f"]) == 6 * 9 * 2
    assert len(m["cube/v"]) == 6 * 9 + 2
    assert (_edge_counts(m["cube/f"]) == 2).all()
    assert m["cube/volume"] == pytest.approx(27.0)


def test_mesh_object_random_blob_volume_and_watertight(tmp_path, jax_run):
    m = _both("mesh_fns", tmp_path, jax_run)
    mask = _blob_mask()
    assert mask.any()
    v = m["blob/v"]
    assert (_edge_counts(m["blob/f"]) == 2).all()
    assert m["blob/volume"] == pytest.approx(float(mask.sum()))
    assert v[:, 0].min() >= 5 and v[:, 1].min() >= 7 and v[:, 2].min() >= 9


def test_mesh_smoothing_keeps_topology_shrinks_volume(tmp_path, jax_run):
    m = _both("mesh_fns", tmp_path, jax_run)
    np.testing.assert_array_equal(m["cube4/f"], m["cube4_smooth/f"])  # connectivity untouched
    assert (_edge_counts(m["cube4_smooth/f"]) == 2).all()
    assert 0.5 * 64 < m["cube4_smooth/volume"] < 64


def test_mesh_workflow_end_to_end(tmp_path, jax_run):
    out = _both("mesh_workflow", tmp_path, jax_run)
    me = _mod("port", "tasks.meshes")
    seg = _blob_seg()
    for obj in [i for i in np.unique(seg) if i != 0]:
        # a closed surface's volume == the voxel count (additive over parts)
        assert me.mesh_signed_volume(out[f"{obj}/vertices"], out[f"{obj}/faces"]) == pytest.approx(
            float((seg == obj).sum()))
        assert len(out[f"{obj}/.obj"])


def test_derived_artifacts_capstone_on_synthetic_em(tmp_path, jax_run):
    """segmentation -> morphology -> meshes + skeletons on EM-shaped
    anisotropic objects: mesh volumes equal voxel counts, skeleton nodes
    lie inside their objects' bounding boxes."""
    out = _both("capstone", tmp_path, jax_run)
    me = _mod("port", "tasks.meshes")
    seg = _em_seg()
    ids = [int(i) for i in np.unique(seg) if i != 0]
    assert ids
    for obj in ids:
        assert me.mesh_signed_volume(out[f"{obj}/vertices"], out[f"{obj}/faces"]) == pytest.approx(
            float((seg == obj).sum()))
        nodes = out[f"sk/{obj}/nodes"]
        assert len(nodes)
        zyx = np.argwhere(seg == obj)
        assert (nodes[:, :3] >= zyx.min(axis=0)).all() and (nodes[:, :3] <= zyx.max(axis=0)).all()
        assert (nodes[:, 3] > 0).all()
        assert len(out[f"sk/{obj}/.swc"])


def test_affine_identity_roundtrip(tmp_path, jax_run):
    got = _both("affine_identity", tmp_path, jax_run)["warped"]
    np.testing.assert_allclose(got, AFFINE["identity"][0](), rtol=1e-5, atol=1e-4)


def test_affine_matches_scipy_order1(tmp_path, jax_run):
    """Rotation + scale + translation against scipy.ndimage.affine_transform."""
    got = _both("affine_order1", tmp_path, jax_run)["warped"]
    np.testing.assert_allclose(got, _scipy_affine("order1").astype(np.float32), atol=1e-3)


def test_affine_matches_scipy_order0_labels(tmp_path, jax_run):
    """Nearest neighbour on integer labels: exact, labels preserved."""
    got = _both("affine_order0_labels", tmp_path, jax_run)["warped"]
    np.testing.assert_array_equal(got, _scipy_affine("order0_labels"))


def test_affine_order0_preserves_huge_label_ids(tmp_path, jax_run):
    """Nearest neighbour is exact for label ids above 2^24 (where a float32
    round trip merges ids): the host gather."""
    got = _both("affine_order0_huge_ids", tmp_path, jax_run)["warped"]
    np.testing.assert_array_equal(got, _scipy_affine("order0_huge_ids"))
    assert got.max() > np.uint64(1 << 24)


def test_affine_fill_value_and_out_shape(tmp_path, jax_run):
    """A translation past the volume edge reads fill_value; the output grid
    can differ from the input grid."""
    got = _both("affine_fill_out_shape", tmp_path, jax_run)["warped"]
    assert got.shape == (32, 24, 24)
    np.testing.assert_allclose(got, _scipy_affine("fill_out_shape").astype(np.float32), atol=1e-3)
