"""The port's training, ``.ilp`` ingestion and flax ``.msgpack`` reader
against the JAX package, on the CPU.

- ``utils/jax_random.py``: the Threefry bits, the float32 uniform and the
  normal equal ``jax.random`` bit for bit for several seeds and shapes,
  and the normal transform and ``log1p`` equal XLA:CPU's on a grid of
  their inputs.
- ``fit_linear_classifier`` and ``train_pixel_classifier`` on the input of
  ``tests/test_inference.py::test_pixel_classification_end_to_end``:
  ``W`` and ``b`` within ``TRAIN_RTOL`` of the largest entry of the
  reference's (Adam's op order and the feature bank's smoothing differ
  from XLA's in float32 ulps, ROADMAP fact 6), the predicted classes equal.
- The ``.ilp`` readers on the projects ``tests/test_inference.py`` builds
  with h5py: ``load_ilp_project`` and ``load_ilp_forest`` exactly,
  ``import_ilp``'s forest checkpoint byte for byte, ``train_from_ilp``'s
  within ``TRAIN_RTOL``, the same errors for malformed projects, and an
  ``ImportError`` naming h5py without it.
- ``utils/flax_msgpack.py`` against ``flax.serialization.msgpack_restore``
  on every type flax writes, chunked leaves included.
"""

import json
import os
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_tools_tpu.tasks import ilastik as jil
from cluster_tools_tpu_torch.tasks import ilastik as pil
from cluster_tools_tpu_torch.utils import flax_msgpack
from cluster_tools_tpu_torch.utils import jax_random as jr

#: a trained W or b against the reference's, relative to its largest entry
#: (the initial W is the reference's bit for bit; the runs measure up to
#: 9.9e-6 apart)
TRAIN_RTOL = 5e-5


# -- the Threefry normal ----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 123456789, -1, 2 ** 40 + 5])
@pytest.mark.parametrize("shape", [(10, 2), (7,), (3, 5, 4), (4097,)])
def test_threefry_matches_jax_random(seed, shape):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(np.asarray(jax.random.key_data(key)), jr.seed_key(seed))
    np.testing.assert_array_equal(jr.random_bits(jr.seed_key(seed), shape),
                                  np.asarray(jax.random.bits(key, shape, dtype=jnp.uint32)))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    for a, b in ((0.0, 1.0), (lo, 1.0), (-3.0, 5.0)):
        want = np.asarray(jax.random.uniform(key, shape, jnp.float32, a, b))
        got = jr.uniform(jr.seed_key(seed), shape, a, b)
        assert got.dtype == np.float32 and np.array_equal(got.view(np.int32), want.view(np.int32)), (a, b)
    want = np.asarray(jax.random.normal(key, shape))
    got = jr.normal(seed, shape)
    assert got.dtype == np.float32 and np.array_equal(got.view(np.int32), want.view(np.int32))


def test_erfinv_edges():
    x = np.array([-1.0, 1.0, 0.0, np.nextafter(np.float32(-1), np.float32(0)), 0.5], np.float32)
    got = jr.erfinv_f32(x)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert got[0] == -np.inf and got[1] == np.inf and got[2] == 0
    assert np.array_equal(got[3:].view(np.int32), want[3:].view(np.int32))


def test_normal_transform_equals_jax_on_every_eighth_uniform():
    """The normal transform (``sqrt(2) * erfinv(u)``) on every eighth of
    the 2^23 uniforms on (-1, 1) that the normal can draw, and ``log1p``
    over (-1, 1e3] on a log grid, bit for bit against XLA:CPU."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    m = np.arange(0, 1 << 23, 8, dtype=np.uint32)
    u = (m | np.float32(1).view(np.uint32)).view(np.float32) - np.float32(1)
    u = np.maximum(lo, u * (np.float32(1) - lo) + lo).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.float32(np.sqrt(2)) * jax.lax.erf_inv(v))(u))
    got = (np.float32(np.sqrt(2)) * jr.erfinv_f32(u)).astype(np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    x = np.concatenate([-np.logspace(-30, 0, 4000)[:-1], np.logspace(-30, 3, 4000), [0.0]]).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.log1p)(x))
    assert np.array_equal(jr.log1p_f32(x).view(np.int32), want.view(np.int32))


# -- training ---------------------------------------------------------------------


def _scribbles():
    """``tests/test_inference.py::test_pixel_classification_end_to_end``'s
    two-texture volume and 1% scribbles (its ``rng`` fixture, seed 0)."""
    rng = np.random.default_rng(0)
    shape = (24, 48, 48)
    gt = np.zeros(shape, np.uint8)
    gt[:, 24:, :] = 1
    raw = (np.where(gt == 1, 0.8, 0.2) + rng.normal(0, 0.05, shape)).astype(np.float32)
    labels = np.zeros(shape, np.uint8)
    scribble = rng.random(shape) < 0.01
    labels[scribble] = gt[scribble] + 1
    return raw, labels, gt


@pytest.fixture(scope="module")
def trained():
    raw, labels, gt = _scribbles()
    feats = np.asarray(jil.feature_bank(jnp.asarray(raw), jil.DEFAULT_SIGMAS))
    X = feats[labels > 0].astype(np.float32)
    y = labels[labels > 0].astype(np.int32) - 1
    return dict(raw=raw, labels=labels, gt=gt, feats=feats, X=X, y=y,
                jfit=jil.fit_linear_classifier(X, y, n_steps=300),
                jtrain=jil.train_pixel_classifier(raw, labels, n_steps=200))


def _close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert np.abs(g - w).max() <= TRAIN_RTOL * np.abs(w).max(), np.abs(g - w).max() / np.abs(w).max()


def _classes(feats, W, b):
    return (feats.reshape(-1, W.shape[0]) @ W + b).argmax(1)


def test_fit_linear_classifier_matches_the_reference(trained):
    got = pil.fit_linear_classifier(trained["X"], trained["y"], n_steps=300, device="cpu")
    _close(got, trained["jfit"])
    np.testing.assert_array_equal(_classes(trained["feats"], *got), _classes(trained["feats"], *trained["jfit"]))


def test_train_pixel_classifier_matches_the_reference(trained):
    W, b = pil.train_pixel_classifier(trained["raw"], trained["labels"], n_steps=200, device="cpu")
    _close((W, b), trained["jtrain"])
    pred = _classes(trained["feats"], W, b)
    np.testing.assert_array_equal(pred, _classes(trained["feats"], *trained["jtrain"]))
    assert (pred == trained["gt"].ravel()).mean() > 0.95


def test_training_defaults_to_the_card(monkeypatch, trained):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pil.fit_linear_classifier(trained["X"], trained["y"], n_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pil.train_pixel_classifier(trained["raw"], trained["labels"], n_steps=1)


# -- .ilp projects --------------------------------------------------------------------

from tests.test_inference import _write_minimal_ilp, _write_vigra_forests  # noqa: E402

IDS = ["GaussianSmoothing", "GaussianGradientMagnitude", "LaplacianOfGaussian", "DifferenceOfGaussians"]


def _annotated_project(root):
    """``tests/test_inference.py::test_ilp_project_ingestion``'s project:
    two annotation blocks and five feature selections."""
    rng = np.random.default_rng(0)
    shape = (24, 48, 48)
    gt = np.zeros(shape, np.uint8)
    gt[:, 24:, :] = 1
    raw = (np.where(gt == 1, 0.8, 0.2) + rng.normal(0, 0.05, shape)).astype(np.float32)
    blk1 = (slice(4, 12), slice(2, 20), slice(2, 40))
    blk2 = (slice(4, 12), slice(28, 46), slice(2, 40))
    lb1 = np.zeros((8, 18, 38), np.uint8)
    lb1[rng.random(lb1.shape) < 0.2] = 1
    lb2 = np.zeros((8, 18, 38), np.uint8)
    lb2[rng.random(lb2.shape) < 0.2] = 2
    matrix = np.zeros((4, 3), bool)
    matrix[0] = [True, True, True]
    matrix[1, 1] = True
    matrix[3, 2] = True
    ilp = os.path.join(root, "project.ilp")
    _write_minimal_ilp(ilp, [(blk1, lb1), (blk2, lb2)], IDS, [0.7, 1.6, 3.5], matrix)
    return ilp, raw


T0 = {"col": 0, "thr": 0.5, "left": {"probs": [3, 1]}, "right": {"probs": [0, 4]}}
T1 = {"col": 1, "thr": 0.3, "left": {"probs": [2, 0]},
      "right": {"col": 0, "thr": 0.7, "left": {"probs": [1, 1]}, "right": {"probs": [0, 2]}}}
T2 = {"probs": [1, 3]}


def _forest_project(root, forests=((T0, T1), (T2,)), ids=("GaussianSmoothing", "GaussianGradientMagnitude"),
                    name="trained.ilp"):
    import h5py

    ilp = os.path.join(root, name)
    with h5py.File(ilp, "w") as f:
        fs = f.create_group("FeatureSelections")
        fs.create_dataset("FeatureIds", data=np.array([s.encode() for s in ids]))
        fs.create_dataset("Scales", data=np.asarray([0.7, 1.6], np.float64))
        m = np.zeros((len(ids), 2), bool)
        m[0, 0] = m[-1, 1] = True
        fs.create_dataset("SelectionMatrix", data=m)
        _write_vigra_forests(f, [list(t) for t in forests], 2, 2)
    return ilp


def test_load_ilp_project_and_forest_are_exact(tmp_path):
    ilp, _ = _annotated_project(str(tmp_path))
    (ps, pb), (js, jb) = pil.load_ilp_project(ilp), jil.load_ilp_project(ilp)
    assert ps == js and len(ps) == 5 and len(pb) == len(jb) == 2
    for (psl, pdata), (jsl, jdata) in zip(pb, jb):
        assert psl == jsl and pdata.dtype == jdata.dtype and np.array_equal(pdata, jdata)
    assert pil._parse_block_slice("[1:4,0:10,5:9,0:1]") == jil._parse_block_slice("[1:4,0:10,5:9,0:1]")
    fl = _forest_project(str(tmp_path))
    got, want = pil.load_ilp_forest(fl), jil.load_ilp_forest(fl)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])) and \
            np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert got["depth"] == 2 and got["feature"].shape[0] == 3


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_import_ilp_forest_checkpoint_equals_the_reference(tmp_path):
    fl = _forest_project(str(tmp_path), forests=((T0, T1),))
    pc, jc = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    assert pil.import_ilp(fl, pc) == jil.import_ilp(fl, jc) == 2
    got, want = _npz(pc), _npz(jc)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    # the port's prediction reads it: the forest and the selections
    clf = pil.load_classifier(pc, torch.device("cpu"))
    assert clf["selections"] == (("GaussianSmoothing", 0.7), ("GaussianGradientMagnitude", 1.6))
    assert clf["forest"]["depth"] == 2 and clf["n_classes"] == 2


def test_train_from_ilp_matches_the_reference(tmp_path):
    ilp, raw = _annotated_project(str(tmp_path))
    pc, jc = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    assert pil.train_from_ilp(ilp, raw, pc, n_steps=100, device="cpu") == \
        jil.train_from_ilp(ilp, raw, jc, n_steps=100) == 2
    got, want = _npz(pc), _npz(jc)
    assert sorted(got) == sorted(want)
    _close((got["W"], got["b"]), (want["W"], want["b"]))
    assert np.array_equal(got["ilp_features"], want["ilp_features"]) and got["sigmas"].shape == (0,)
    # import_ilp of a project without a forest retrains the same way
    pc2 = str(tmp_path / "p2.npz")
    assert pil.import_ilp(ilp, pc2, raw=raw, n_steps=100, device="cpu") == 2
    again = _npz(pc2)
    assert all(np.array_equal(again[k], got[k]) for k in got)


def _error(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the error is the result compared
        return type(e).__name__, str(e)
    return None


def test_malformed_projects_raise_as_the_reference(tmp_path):
    """``tests/test_inference.py:264-283``'s projects (an unsupported
    feature id, no annotations) and the forest faults: the same error type
    and message from both packages."""
    import h5py

    root = str(tmp_path)
    m = np.ones((1, 1), bool)
    lb = np.zeros((4, 4, 4), np.uint8)
    lb[0, 0, 0] = 1
    bad = os.path.join(root, "bad.ilp")
    _write_minimal_ilp(bad, [((slice(0, 4), slice(0, 4), slice(0, 4)), lb)], ["Vesselness"], [1.0], m)
    empty = os.path.join(root, "empty.ilp")
    _write_minimal_ilp(empty, [], ["GaussianSmoothing"], [1.0], m)
    no_ext = os.path.join(root, "no_ext.ilp")
    with h5py.File(no_ext, "w") as f:
        f.create_group("PixelClassification/ClassifierForests/Forest0000")
    mismatch = _forest_project(root, ids=("GaussianSmoothing", "HessianOfGaussianEigenvalues"), name="mm.ilp")
    cases = [
        ("load_ilp_project", (bad,), {}),
        ("load_ilp_project", (empty,), {}),
        ("load_ilp_forest", (no_ext,), {}),
        ("import_ilp", (empty, os.path.join(root, "x.npz")), {}),
        ("import_ilp", (mismatch, os.path.join(root, "y.npz")), {}),
    ]
    for name, args, kw in cases:
        want = _error(getattr(jil, name), *args, **kw)
        got = _error(getattr(pil, name), *args, **kw)
        assert want is not None and got == want, (name, got, want)
    assert _error(pil.load_ilp_project, bad)[1].startswith("ilastik feature 'Vesselness' is not supported")
    assert "no label annotations" in _error(pil.load_ilp_project, empty)[1]


def test_without_h5py_the_readers_raise_naming_it(tmp_path, monkeypatch):
    ilp, raw = _annotated_project(str(tmp_path))
    monkeypatch.setitem(sys.modules, "h5py", None)
    for fn, args in ((pil.load_ilp_project, (ilp,)), (pil.load_ilp_forest, (ilp,)),
                     (pil.train_from_ilp, (ilp, raw, str(tmp_path / "a.npz"))),
                     (pil.import_ilp, (ilp, str(tmp_path / "b.npz")))):
        with pytest.raises(ImportError, match="h5py"):
            fn(*args, device="cpu") if fn is pil.train_from_ilp else fn(*args)


# -- the msgpack reader -----------------------------------------------------------------


def _tree():
    rng = np.random.default_rng(3)
    return {
        "params": {
            "Conv_0": {"kernel": rng.random((3, 3, 3, 1, 4)).astype(np.float32),
                       "bias": np.zeros(4, np.float32)},
            "Dense": {"w": rng.integers(-5, 5, (2, 3)).astype(np.int64),
                      "half": jnp.asarray(rng.random(5), jnp.bfloat16),
                      "u8": np.arange(300, dtype=np.uint16).astype(np.uint8),
                      "f64": rng.random((2, 2))},
            "big": rng.random((64, 17)).astype(np.float32),
        },
        "meta": {"name": "unet" * 20, "long": "x" * 300, "step": 123456789012, "neg": -7, "small": -100000,
                 "u16": 60000, "f": 0.5, "flag": True, "off": False, "none": None, "blob": b"\x00\x01" * 200,
                 "z": 1.5 + 2.0j, "scalar": np.float32(2.5), "i32": np.int32(-3),
                 "items": [1, "a", [2.0, None]], "empty": {}},
    }


def _same(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), path
        for k in b:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}/{i}")
    elif isinstance(b, np.ndarray) and b.dtype.name == "bfloat16":
        assert a.dtype == np.float32 and np.array_equal(a, b.astype(np.float32)), path
    elif isinstance(b, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype and np.array_equal(a, b), path
        assert np.shape(a) == np.shape(b), path
    else:
        assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize("chunk", [None, 256])
def test_msgpack_reader_matches_flax(chunk, monkeypatch):
    """Every type of ``_tree`` through ``flax.serialization.to_bytes`` and
    back through both readers; ``chunk`` lowers flax's chunk size so the
    large leaves are written chunked."""
    if chunk is not None:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
    data = flax.serialization.to_bytes(_tree())
    if chunk is not None:
        assert b"__msgpack_chunked_array__" in data
    want = flax.serialization.msgpack_restore(data)
    got = flax_msgpack.restore(data)
    _same(got, want)
    flat = flax_msgpack.flatten(got)
    # flax stores a list as a map keyed by position
    assert flat["params/Conv_0/kernel"].shape == (3, 3, 3, 1, 4) and flat["meta/items/2/0"] == 2.0


def test_msgpack_reader_refuses_malformed_documents():
    data = flax.serialization.to_bytes({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore(data[:-2])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.restore(data + b"\x00")
    with pytest.raises(ValueError, match="type byte 0xc1"):
        flax_msgpack.restore(b"\xc1")
    with pytest.raises(ValueError, match="extension type 9"):
        flax_msgpack.restore(b"\xd4\x09\x00")
    assert flax_msgpack.restore(json.dumps(1).encode()) == 0x31
