"""``tasks/morphology.py``, ``tasks/node_labels.py`` and
``tasks/evaluation.py`` against the JAX package's ``local`` runs with zero
tolerance.

The four cases of the reference's ``tests/test_morphology_eval.py`` run on
both packages on the same seeded numpy input.  The morphology table, the
node-label table and the evaluation report are equal bit for bit: the
float64 centres of mass and the VI / Rand metrics are summed in the
reference's order, so they are exact, not close.  Each case keeps the
reference's own oracle check (scipy and dense-entropy oracles, at its
tolerances).  The JAX runs are shared through a module-scoped fixture.
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


def _dataset(side, root, name, data):
    path = os.path.join(root, f"{name}.zarr")
    _reader(side)(path).require_dataset(name, shape=data.shape, chunks=(16, 16, 16), dtype=str(data.dtype))[...] = data
    return path


def _workflow(side, root, module, cls_name, **params):
    config_dir = os.path.join(root, "config")
    os.makedirs(config_dir, exist_ok=True)
    with open(os.path.join(config_dir, "global.config"), "w") as f:
        json.dump({"block_shape": [16, 16, 16]}, f)
    tmp_folder = os.path.join(root, "tmp")
    wf = getattr(_mod(side, f"tasks.{module}"), cls_name)(tmp_folder=tmp_folder, config_dir=config_dir, max_jobs=4,
                                                          target="local", block_shape=[16, 16, 16], **params)
    assert _mod(side, "runtime.task").build([wf])
    return tmp_folder


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _blob_labels():
    labels, _ = ndi.label(random_blobs(np.random.default_rng(11), (32, 48, 32), p=0.3))
    return labels.astype(np.uint64)


def _morphology(side, root):
    path = _dataset(side, root, "seg", _blob_labels())
    tmp = _workflow(side, root, "morphology", "MorphologyWorkflow", input_path=path, input_key="seg")
    return _npz(_mod(side, "tasks.morphology").morphology_path(tmp))


def _node_label_inputs():
    rng = np.random.default_rng(12)
    return rng.integers(1, 8, (32, 32, 32)).astype(np.uint64), rng.integers(0, 5, (32, 32, 32)).astype(np.uint64)


def _node_labels(side, root):
    seg, overlap = _node_label_inputs()
    p1, p2 = _dataset(side, root, "seg", seg), _dataset(side, root, "ovl", overlap)
    tmp = _workflow(side, root, "node_labels", "NodeLabelWorkflow", input_path=p1, input_key="seg", labels_path=p2,
                    labels_key="ovl")
    return _npz(_mod(side, "tasks.node_labels").node_labels_path(tmp))


def _evaluation(side, root):
    gt, _ = ndi.label(random_blobs(np.random.default_rng(13), (32, 32, 32), p=0.4))
    gt = gt.astype(np.uint64)
    # a second segmentation: the ground truth with its largest object split
    seg = gt.copy()
    big = np.bincount(gt.ravel().astype(np.int64))[1:].argmax() + 1
    seg[(gt == big) & (np.arange(32)[None, None, :] >= 16)] = gt.max() + 1
    p_gt = _dataset(side, root, "gt", gt)
    out = {}
    for name, data in (("seg", gt), ("split", seg)):
        p = _dataset(side, root, name, data)
        tmp = _workflow(side, os.path.join(root, name), "evaluation", "EvaluationWorkflow", input_path=p,
                        input_key=name, labels_path=p_gt, labels_key="gt")
        with open(os.path.join(tmp, "evaluation.json")) as f:
            out.update({f"{name}/{k}": np.asarray(v) for k, v in json.load(f).items()})
    m2 = _mod(side, "tasks.evaluation").contingency_metrics(np.array([[1, 1], [2, 1]], np.uint64),
                                                            np.array([50, 50], np.int64))
    out.update({f"split2x2/{k}": np.asarray(v) for k, v in m2.items()})
    return out


def _oracle_inputs():
    rng = np.random.default_rng(14)
    return rng.integers(1, 6, (24, 24, 24)).astype(np.uint64), rng.integers(1, 4, (24, 24, 24)).astype(np.uint64)


def _contingency(side, root):
    seg, gt = _oracle_inputs()
    pairs, counts = _mod(side, "tasks.node_labels").overlap_votes(seg, gt)
    m = _mod(side, "tasks.evaluation").contingency_metrics(pairs, counts)
    return {"pairs": pairs, "counts": counts, **{k: np.asarray(v) for k, v in m.items()}}


CASES = {"morphology": _morphology, "node_labels": _node_labels, "evaluation": _evaluation,
         "contingency": _contingency}


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


def test_morphology_workflow_vs_scipy(tmp_path, jax_run):
    m = _both("morphology", tmp_path, jax_run)
    labels = _blob_labels()
    n = int(labels.max())
    ids = m["ids"]
    np.testing.assert_array_equal(ids, np.arange(1, n + 1))
    np.testing.assert_array_equal(m["sizes"], ndi.sum_labels(np.ones_like(labels), labels, ids).astype(int))
    want_com = np.array(ndi.center_of_mass(np.ones_like(labels), labels, ids))
    np.testing.assert_allclose(m["com"], want_com, atol=1e-9)
    for i, sl in enumerate(ndi.find_objects(labels.astype(np.int64))):
        np.testing.assert_array_equal(m["bb_min"][i], [s.start for s in sl])
        np.testing.assert_array_equal(m["bb_max"][i], [s.stop for s in sl])


def test_node_labels_max_overlap(tmp_path, jax_run):
    t = _both("node_labels", tmp_path, jax_run)
    seg, overlap = _node_label_inputs()
    for s in np.unique(seg):
        vals, cnts = np.unique(overlap[(seg == s) & (overlap != 0)], return_counts=True)
        got = t["values"][np.searchsorted(t["keys"], s)]
        # ties break to the smaller label: the first of the tied maxima
        assert got == vals[cnts == cnts.max()][0], (s, got)


def test_evaluation_metrics_identity_and_split(tmp_path, jax_run):
    m = _both("evaluation", tmp_path, jax_run)
    # identical segmentations: all distances 0, Rand 1
    assert m["seg/vi_split"] == pytest.approx(0.0, abs=1e-9)
    assert m["seg/vi_merge"] == pytest.approx(0.0, abs=1e-9)
    assert m["seg/adapted_rand_error"] == pytest.approx(0.0, abs=1e-9)
    # the split segmentation over-segments: vi_split > 0, vi_merge 0
    assert m["split/vi_split"] > 0.01 and m["split/vi_merge"] == pytest.approx(0.0, abs=1e-9)
    # one gt object split in half by seg: vi_split = ln 2, vi_merge = 0;
    # precision 1 (every seg-co-clustered pair is gt-co-clustered), recall 0.5
    assert m["split2x2/vi_split"] == pytest.approx(np.log(2), rel=1e-9)
    assert m["split2x2/vi_merge"] == pytest.approx(0.0, abs=1e-9)
    assert m["split2x2/rand_precision"] == pytest.approx(1.0, rel=1e-9)
    assert m["split2x2/rand_recall"] == pytest.approx(0.5, rel=1e-9)


def test_evaluation_vs_sklearn_style_oracle(tmp_path, jax_run):
    """VI from the blockwise table == VI computed on the whole volume."""
    m = _both("contingency", tmp_path, jax_run)
    seg, gt = _oracle_inputs()
    cont = np.zeros((6, 4))
    np.add.at(cont, (seg.ravel().astype(np.int64) - 1, gt.ravel().astype(np.int64) - 1), 1)
    p = cont / cont.sum()
    ps, pg = p.sum(1), p.sum(0)

    def h(x):
        return -np.sum(x[x > 0] * np.log(x[x > 0]))

    np.testing.assert_allclose(m["vi_split"], h(p) - h(pg), rtol=1e-9)
    np.testing.assert_allclose(m["vi_merge"], h(p) - h(ps), rtol=1e-9)
