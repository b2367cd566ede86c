"""The port's filters, feature banks, forest and ``IlastikPredictionWorkflow``
against the JAX package's, on the CPU.

Tolerances are the reference's own (``tests/test_inference.py``):

- ``gradient_1d``: exact (the same float32 arithmetic);
- ``gradient_magnitude``, ``hessian_eigenvalues``,
  ``structure_tensor_eigenvalues``, the eigenvalue closed form and the
  feature banks: atol 2e-4 (``test_symmetric3_eigenvalues_vs_lapack``;
  the smoothing underneath differs by a few float32 ulps, ROADMAP Queue C);
- ``forest_predict_proba`` on identical features: atol 1e-6
  (``test_vigra_forest_parse_and_predict``);
- the workflow's probabilities: atol 2e-3 between the packages
  (``test_ilp_trained_forest_end_to_end``; for the forest on the voxels
  whose features lie clear of every split threshold) and sums within 1e-5
  of 1 (``test_pixel_classification_end_to_end``).

The classifiers come from the JAX package: ``train_pixel_classifier`` for
the linear one and ``import_ilp`` of a synthetic ``.ilp`` (vigra forests
over all six feature ids) for the forest.
"""

import json
import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cluster_tools_tpu.ops.filters as jf
import cluster_tools_tpu.tasks.ilastik as ji
from cluster_tools_tpu.runtime.task import build as j_build
from cluster_tools_tpu.utils.volume_utils import Blocking as JBlocking
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
import cluster_tools_tpu_torch.ops.filters as pf
import cluster_tools_tpu_torch.tasks.ilastik as pi
from cluster_tools_tpu_torch.runtime.task import build as p_build
from cluster_tools_tpu_torch.utils.volume_utils import file_reader as p_reader

torch.set_num_threads(1)

ATOL = 2e-4


def _volume(kind, shape=(12, 14, 16), seed=0):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.random(shape).astype(np.float32)
    if kind == "near_constant":
        # exercises the 1e-10 floor of the eigenvalue scale and the clip
        return (0.3 + 1e-7 * rng.random(shape)).astype(np.float32)
    z, y, x = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij")
    c = [s / 2 for s in shape]
    return np.exp(-((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2) / 18.0).astype(np.float32)


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(12, 14, 16), (1, 5, 7), (2, 3, 9)])
def test_gradient_1d_is_exact(shape):
    x = _volume("noise", shape)
    for axis in range(3):
        want = np.asarray(jf.gradient_1d(jnp.asarray(x), axis))
        got = pf.gradient_1d(x, axis, device="cpu").numpy()
        np.testing.assert_array_equal(got, want)


class _CpuFilters:
    """The port's filter wrappers with ``device="cpu"``, called as the
    reference's module is."""

    @staticmethod
    def gradient_magnitude(x, sigma, sampling=None):
        return pf.gradient_magnitude(x, sigma, sampling, device="cpu")

    @staticmethod
    def hessian_eigenvalues(x, sigma, sampling=None):
        return pf.hessian_eigenvalues(x, sigma, sampling, device="cpu")

    @staticmethod
    def structure_tensor_eigenvalues(x, sigma, rho=None):
        return pf.structure_tensor_eigenvalues(x, sigma, rho, device="cpu")


FILTERS = {
    "gradient_magnitude": lambda m, x: m.gradient_magnitude(x, 1.2),
    "gradient_magnitude_sigma0_aniso": lambda m, x: m.gradient_magnitude(x, 0.0, (1.0, 1.0, 2.0)),
    "hessian": lambda m, x: m.hessian_eigenvalues(x, 1.0),
    "hessian_aniso": lambda m, x: m.hessian_eigenvalues(x, 1.6, (2.0, 1.0, 1.0)),
    "structure_tensor": lambda m, x: m.structure_tensor_eigenvalues(x, 1.6),
    "structure_tensor_rho": lambda m, x: m.structure_tensor_eigenvalues(x, 1.0, 0.7),
}


@pytest.mark.parametrize("kind", ["noise", "near_constant", "blob"])
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filters_match(name, kind):
    x = _volume(kind)
    want = np.asarray(FILTERS[name](jf, jnp.asarray(x)))
    got = FILTERS[name](_CpuFilters, x).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if kind == "near_constant" and got.ndim == 4:
        # the floor keeps the near-zero matrices finite: every eigenvalue ~ 0
        assert np.isfinite(got).all() and np.abs(got).max() < 1e-5


def test_symmetric3_eigenvalues_match_reference_and_lapack():
    rng = np.random.default_rng(3)
    m = rng.normal(0, 1, (200, 3, 3)).astype(np.float32)
    sym = (m + np.transpose(m, (0, 2, 1))) / 2
    # degenerate matrices: zero, a multiple of the identity, a double root
    sym[0] = 0.0
    sym[1] = 0.5 * np.eye(3)
    sym[2] = np.diag([1.0, 1.0, -2.0])
    args = [sym[:, i, j] for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]
    want = np.asarray(jf._symmetric3_eigenvalues(*map(jnp.asarray, args)))
    got = pf.symmetric3_eigenvalues(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, np.linalg.eigvalsh(sym)[:, ::-1], atol=ATOL)


def test_eigenvalue_filters_refuse_2d():
    with pytest.raises(ValueError, match="3-D"):
        pf.hessian_eigenvalues(np.zeros((4, 4), np.float32), 1.0, device="cpu")


# ---------------------------------------------------------------------------
# feature banks
# ---------------------------------------------------------------------------


def test_feature_bank_matches_and_wraps_at_the_borders():
    x = _volume("noise", (12, 14, 16), seed=4)
    want = np.asarray(ji.feature_bank(jnp.asarray(x)))
    got = pi.feature_bank(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (12, 14, 16, pi.n_features()) == (12, 14, 16, ji.n_features())
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the laplacian of sigma 0.7 (channel 3) wraps around the block: at the
    # first and last voxel of each axis the outside neighbour is the far side
    sm, lap = got[..., 1], got[..., 3]
    for corner in ((0, 0, 0), (11, 13, 15), (0, 7, 15)):
        want_lap = sum(sm[tuple((c + d) % n if a == ax else c for a, (c, n) in enumerate(zip(corner, sm.shape)))]
                       for ax in range(3) for d in (1, -1)) - 6 * sm[corner]
        np.testing.assert_allclose(lap[corner], want_lap, atol=1e-5)


@pytest.mark.parametrize("fid", pi.ILP_SUPPORTED_FEATURES)
def test_ilp_feature_bank_matches_per_feature(fid):
    assert pi.ILP_SUPPORTED_FEATURES == ji.ILP_SUPPORTED_FEATURES
    x = _volume("noise", (10, 12, 14), seed=5)
    sel = ((fid, 1.3), (fid, 0.7))
    want = np.asarray(ji.ilp_feature_bank(jnp.asarray(x), sel))
    got = pi.ilp_feature_bank(torch.from_numpy(x), sel).numpy()
    assert got.shape == want.shape == (10, 12, 14, pi.ilp_feature_channels(sel)) == \
        (10, 12, 14, ji.ilp_feature_channels(sel))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_ilp_feature_bank_refuses_unknown_ids():
    with pytest.raises(ValueError, match="Vesselness"):
        pi.ilp_feature_bank(torch.zeros(4, 4, 4), (("Vesselness", 1.0),))


# ---------------------------------------------------------------------------
# the forest
# ---------------------------------------------------------------------------


def _vigra_tree_arrays(spec, class_count, column_count):
    """A nested tree spec in vigra's ``topology_``/``parameters_`` layout
    (copy of ``tests/test_inference.py::_vigra_tree_arrays``)."""
    topo = [column_count, class_count]
    par = []

    def emit(node):
        addr = len(topo)
        if "probs" in node:
            topo.extend([0x40000000, len(par)])
            par.append(float(sum(node["probs"])))
            par.extend(float(p) for p in node["probs"])
        else:
            topo.extend([0, len(par), -1, -1, node["col"]])
            par.extend([1.0, float(node["thr"])])
            topo[addr + 2] = emit(node["left"])
            topo[addr + 3] = emit(node["right"])
        return addr

    emit(spec)
    return np.asarray(topo, np.int32), np.asarray(par, np.float64)


def _write_vigra_forests(f, forests, class_count, column_count):
    """Tree-spec lists as ``Forest0000``, ``Forest0001``, ... (copy of
    ``tests/test_inference.py::_write_vigra_forests``)."""
    base = f.require_group("PixelClassification/ClassifierForests")
    for fi, trees in enumerate(forests):
        g = base.create_group(f"Forest{fi:04d}")
        ext = g.create_group("_ext_param")
        ext.create_dataset("class_count_", data=np.int32(class_count))
        ext.create_dataset("column_count_", data=np.int32(column_count))
        ext.create_dataset("classes", data=np.arange(1, class_count + 1, dtype=np.uint32))
        for ti, spec in enumerate(trees):
            topo, par = _vigra_tree_arrays(spec, class_count, column_count)
            tg = g.create_group(f"Tree_{ti}")
            tg.create_dataset("topology_", data=topo)
            tg.create_dataset("parameters_", data=par)


def _dense_forest(rng, n_trees=6, depth=5, n_features=4, n_classes=3):
    """Complete trees in breadth-first layout, leaves pointing at themselves."""
    n = 2 ** (depth + 1) - 1
    inner = 2 ** depth - 1
    children = np.stack([2 * np.arange(n) + 1, 2 * np.arange(n) + 2], -1)
    children[inner:] = np.arange(inner, n)[:, None]
    probs = rng.random((n_trees, n, n_classes)).astype(np.float32)
    return dict(feature=rng.integers(0, n_features, (n_trees, n)).astype(np.int32),
                threshold=rng.random((n_trees, n)).astype(np.float32),
                children=np.broadcast_to(children, (n_trees, n, 2)).astype(np.int32).copy(),
                leaf_probs=probs / probs.sum(-1, keepdims=True), depth=depth)


def test_forest_predict_proba_matches(tmp_path):
    """A dense random forest, and vigra forests parsed by the reference
    (two lanes, a single-leaf tree), on identical features."""
    rng = np.random.default_rng(6)
    forest = _dense_forest(rng)
    t0 = {"col": 0, "thr": 0.5, "left": {"probs": [3, 1]}, "right": {"probs": [0, 4]}}
    t1 = {"col": 1, "thr": 0.3, "left": {"probs": [2, 0]},
          "right": {"col": 0, "thr": 0.7, "left": {"probs": [1, 1]}, "right": {"probs": [0, 2]}}}
    t2 = {"probs": [1, 3]}
    ilp = str(tmp_path / "trained.ilp")
    with h5py.File(ilp, "w") as f:
        _write_vigra_forests(f, [[t0, t1], [t2]], 2, 2)
    for fo, n_feat in ((forest, 4), (ji.load_ilp_forest(ilp), 2)):
        X = rng.random((500, n_feat)).astype(np.float32)
        args = [fo[k] for k in ("feature", "threshold", "children", "leaf_probs")]
        want = np.asarray(ji.forest_predict_proba(*map(jnp.asarray, args), jnp.asarray(X), fo["depth"]))
        got = pi.forest_predict_proba(*map(torch.from_numpy, args), torch.from_numpy(X), fo["depth"]).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# the workflow
# ---------------------------------------------------------------------------

SHAPE = (24, 32, 32)
BLOCK = [16, 16, 16]
HALO = 12  # the task's default
SIDES = {"jax": (ji.IlastikPredictionWorkflow, j_build, j_reader),
         "port": (pi.IlastikPredictionWorkflow, p_build, p_reader)}
# the forest's project: every feature id, 10 columns
ILP_IDS = list(ji.ILP_SUPPORTED_FEATURES)
ILP_SCALES = [0.7, 1.0]
ILP_MATRIX = [[True, False], [False, True], [False, True], [False, True], [False, True], [True, False]]
# no split on columns 8 and 9: the structure tensor's smaller eigenvalues
# are ~1e-5 on this volume, under the features' tolerance (2e-4), where the
# closed form's arccos near +-1 lets the packages differ by ~1e-5
TREE_COLUMNS = ((0, 4, 5), (1, 6, 7), (2, 3))


def _forest_project(root, raw):
    """A trained ``.ilp`` (no labels): the six feature ids and four trees
    whose splits sit at the medians of the reference's features of
    ``raw``; returns the ``import_ilp`` npz, the reference's features as
    the blockwise task computes them (each block edge-padded to its outer
    shape) and the split thresholds per column."""
    ilp = os.path.join(root, "forest.ilp")
    with h5py.File(ilp, "w") as f:
        fs = f.create_group("FeatureSelections")
        fs.create_dataset("FeatureIds", data=np.array([s.encode() for s in ILP_IDS]))
        fs.create_dataset("Scales", data=np.asarray(ILP_SCALES, np.float64))
        fs.create_dataset("SelectionMatrix", data=np.asarray(ILP_MATRIX, bool))
        selections = ji._load_ilp_selections(f)
    feats = np.zeros(SHAPE + (10,), np.float32)
    blocking = JBlocking(SHAPE, BLOCK)
    outer = tuple(b + 2 * HALO for b in BLOCK)
    for i in range(blocking.n_blocks):
        blk = blocking.get_block(i, [HALO] * 3)
        x = np.pad(raw[blk.outer_bb], [(0, o - s) for s, o in zip(blk.outer_shape, outer)], mode="edge")
        feats[blk.bb] = np.asarray(ji.ilp_feature_bank(jnp.asarray(x), selections))[blk.inner_in_outer_bb]
    med = np.median(feats.reshape(-1, 10), axis=0)
    rng = np.random.default_rng(7)

    def leaf():
        return {"probs": list(rng.integers(1, 9, 2))}

    def tree(cols):
        node = leaf()
        for c in reversed(cols):
            node = {"col": int(c), "thr": float(med[c]), "left": leaf(), "right": node}
        return node

    with h5py.File(ilp, "a") as f:
        _write_vigra_forests(f, [[tree(c) for c in TREE_COLUMNS]], 2, 10)
    ckpt = os.path.join(root, "forest.npz")
    assert ji.import_ilp(ilp, ckpt) == 2
    return ckpt, feats, {c: med[c] for cols in TREE_COLUMNS for c in cols}


def _run(side, root, name, ckpt):
    wf_cls, build, reader = SIDES[side]
    d = os.path.join(root, f"{name}-{side}")
    os.makedirs(os.path.join(d, "cfg"), exist_ok=True)
    with open(os.path.join(d, "cfg", "global.config"), "w") as f:
        json.dump({"block_shape": BLOCK}, f)
    data = os.path.join(root, f"{side}.zarr")
    wf = wf_cls(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=2, target="local",
                input_path=data, input_key="raw", output_path=data, output_key=name, checkpoint_path=ckpt,
                block_shape=BLOCK)
    assert build([wf]), side
    return np.asarray(reader(data)[name][...])


@pytest.fixture(scope="module")
def workflow_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ilastik"))
    rng = np.random.default_rng(8)
    gt = np.zeros(SHAPE, np.uint8)
    gt[:, 16:, :] = 1
    raw = (np.where(gt == 1, 0.8, 0.2) + rng.normal(0, 0.05, SHAPE)).astype(np.float32)
    for side in SIDES:
        SIDES[side][2](os.path.join(root, f"{side}.zarr")).require_dataset(
            "raw", shape=SHAPE, chunks=(16, 16, 16), dtype="float32")[...] = raw
    labels = np.zeros(SHAPE, np.uint8)
    scribble = rng.random(SHAPE) < 0.01
    labels[scribble] = gt[scribble] + 1
    W, b = ji.train_pixel_classifier(raw, labels, n_steps=100)
    linear = os.path.join(root, "linear.npz")
    np.savez(linear, W=W, b=b, sigmas=np.array(ji.DEFAULT_SIGMAS))
    forest, feats, thresholds = _forest_project(root, raw)
    runs = {name: {side: _run(side, root, name, ckpt) for side in SIDES}
            for name, ckpt in (("linear", linear), ("forest", forest))}
    return runs, gt, feats, thresholds


def test_linear_prediction_matches_jax(workflow_runs):
    runs, gt, _, _ = workflow_runs
    want, got = runs["linear"]["jax"], runs["linear"]["port"]
    assert got.shape == want.shape == (2,) + SHAPE and got.dtype == np.float32
    np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert (got.argmax(0) == gt).mean() > 0.95


def test_forest_prediction_matches_jax(workflow_runs):
    runs, _, feats, thresholds = workflow_runs
    want, got = runs["forest"]["jax"], runs["forest"]["port"]
    assert got.shape == want.shape == (2,) + SHAPE
    np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-5)
    # voxels whose blockwise features lie clear of every split threshold by
    # more than the features' tolerance
    clear = np.ones(SHAPE, bool)
    for c, t in thresholds.items():
        clear &= np.abs(feats[..., c] - t) > ATOL
    assert clear.sum() > 1000
    np.testing.assert_allclose(np.moveaxis(got, 0, -1)[clear], np.moveaxis(want, 0, -1)[clear], atol=2e-3)
