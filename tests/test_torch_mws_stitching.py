"""The port's mutex-watershed blocks (``tasks/mutex_watershed.py``), its
stitching (``tasks/stitching.py``) and the synthetic-EM chain
(``utils/synthetic.py::synthetic_em_volume`` through
``MulticutSegmentationWorkflow`` and ``EvaluationWorkflow``) against the
JAX package's, on the CPU, with zero tolerance.

- ``tests/test_mws_stitching.py::test_mws_workflow_blockwise_with_stitching``
  on both packages, and the same blocks with ``stitch=False``: the written
  labels, the face statistics and the stitch assignment table are equal.
- ``test_stitching_workflow_multicut_mode`` with ``solver_shards`` 1 and 2,
  and the same fragments stitched with ``merge_mode`` ``less`` and
  ``greater``: the same arrays, and the solver manifests carry the same
  keys.
- ``tests/test_synthetic_em.py``'s generator test and its tier-1 2-D
  chain: the same volumes, labels and measures (VI, adapted RAND).  The
  fused variant keeps the reference's ``slow`` marker.

The MWS runs each package's host C++ rung; the stitching solves and the
synthetic-EM chain run both packages' Python paths (each one's
``native.force_python()``), with the watershed's modes pinned.
"""

import importlib
import json
import os
import shutil
import signal

import numpy as np
import pytest

import cluster_tools_tpu.native as jnative
import cluster_tools_tpu_torch.native as pnative
from cluster_tools_tpu.runtime import supervision as jsup
from cluster_tools_tpu.utils.synthetic import synthetic_em_volume as j_em
from cluster_tools_tpu_torch.runtime import supervision as psup
from cluster_tools_tpu_torch.tasks.mutex_watershed import DEFAULT_OFFSETS
from cluster_tools_tpu_torch.utils.synthetic import synthetic_em_volume as p_em

from .helpers import assert_labels_equivalent
from .test_mws_stitching import OFFSETS, make_affinities

PKG = {"jax": "cluster_tools_tpu", "port": "cluster_tools_tpu_torch"}
NATIVE = {"jax": jnative, "port": pnative}


@pytest.fixture(autouse=True, scope="module")
def _restore_drain_handlers():
    """Both packages' executors arm a SIGTERM/SIGUSR1 drain handler in the
    main thread and keep it: restore both signals, both packages' armed
    flags and their drain latches after this file (ROADMAP fact 19)."""
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGUSR1)}
    flags = [(mod, mod._drain_installed) for mod in (jsup, psup)]
    yield
    for sig, handler in saved.items():
        signal.signal(sig, handler)
    for mod, flag in flags:
        mod._drain_installed = flag
        mod.reset_drain()


@pytest.fixture(autouse=True, scope="module")
def _pin_modes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CT_TIER_MODE", "cond")
        mp.setenv("CT_FILL_MODE", "capacity")
        mp.setenv("CT_SEED_CCL", "tiled")
        yield


def _mod(side, name):
    return importlib.import_module(f"{PKG[side]}.{name}")


def _reader(side):
    return _mod(side, "utils.volume_utils").file_reader


def _workspace(root, block):
    config_dir = os.path.join(root, "config")
    os.makedirs(config_dir, exist_ok=True)
    with open(os.path.join(config_dir, "global.config"), "w") as f:
        json.dump({"block_shape": list(block)}, f)
    return os.path.join(root, "tmp"), config_dir


def _artifacts(tmp_folder, sub="stitch_faces"):
    """Every npz array under ``tmp_folder/sub``, and the ``solver`` blocks
    of the success manifests."""
    out = {}
    d = os.path.join(tmp_folder, sub)
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".npz"):
            with np.load(os.path.join(d, fn)) as z:
                out.update({f"{sub}/{fn}/{k}": z[k] for k in z.files})
    manifests = {}
    for fn in sorted(os.listdir(tmp_folder)):
        if fn.endswith(".success.json"):
            doc = json.load(open(os.path.join(tmp_folder, fn)))
            if "solver" in doc:
                manifests[fn.split(".")[0]] = doc["solver"]
    return out, manifests


# -- mutex watershed blocks and their stitching --------------------------------------------


def _mws_affinities():
    """The reference test's volume: four quadrant objects, affinities with
    noise 0.02 from ``default_rng(42)`` (its ``rng`` fixture)."""
    shape = (16, 32, 32)
    gt = np.ones(shape, np.uint64)
    gt[:, 16:, :] = 2
    gt[:, :, 16:] += 2
    return make_affinities(gt, OFFSETS, noise=0.02, rng=np.random.default_rng(42)), gt


def _mws(stitch, offsets=OFFSETS):
    def run(side, root):
        affs, _ = _mws_affinities() if offsets is OFFSETS else _default_offset_affinities()
        tmp_folder, config_dir = _workspace(root, (16, 16, 16))
        path = os.path.join(root, "affs.zarr")
        _reader(side)(path).require_dataset("affs", shape=affs.shape, chunks=(len(offsets), 16, 16, 16),
                                            dtype="float32")[...] = affs
        wf = _mod(side, "tasks.mutex_watershed").MwsWorkflow(
            tmp_folder=tmp_folder, config_dir=config_dir, max_jobs=4, target="local", input_path=path,
            input_key="affs", output_path=path, output_key="seg", offsets=offsets, halo=[2, 2, 2],
            stitch_threshold=0.5, block_shape=[16, 16, 16], **({} if stitch else {"stitch": False}))
        assert _mod(side, "runtime.task").build([wf])
        out = {"seg": np.asarray(_reader(side)(path, "r")["seg"][...])}
        if stitch:
            out.update(_artifacts(tmp_folder)[0])
        return out, {}

    return run


def _default_offset_affinities():
    """Affinities of a ``synthetic_em_volume`` ground truth with the
    default offsets (the card's MWS input, at a test's size)."""
    _, gt, _ = p_em(shape=(16, 48, 48), n_objects=6, seed=11, with_mask=False)
    return make_affinities(gt, DEFAULT_OFFSETS, noise=0.05, rng=np.random.default_rng(11)), gt


# -- stitching -------------------------------------------------------------------------------


def _fragments():
    """The reference's multicut-stitching case: object boundaries off the
    16^3 block grid, per-block fragment labels, a boundary map high next
    to every ground-truth transition."""
    shape = (16, 32, 32)
    gt = np.ones(shape, np.uint64)
    gt[:, 20:, :] = 2
    gt[:, :, 12:] += 2
    yy, zz = np.meshgrid(np.arange(shape[1]) // 16, np.arange(shape[2]) // 16, indexing="ij")
    block_of = (yy * 2 + zz)[None].astype(np.uint64)
    frag = gt * 4 + np.broadcast_to(block_of, shape) + 1
    bmap = np.full(shape, 0.1, np.float32)
    for ax in range(3):
        sl_a = tuple(slice(0, -1) if d == ax else slice(None) for d in range(3))
        sl_b = tuple(slice(1, None) if d == ax else slice(None) for d in range(3))
        edge = gt[sl_a] != gt[sl_b]
        bmap[sl_a][edge] = 0.9
        bmap[sl_b][edge] = 0.9
    return frag, bmap, gt


def _stitch(merge_mode, **extra):
    def run(side, root):
        frag, bmap, _ = _fragments()
        tmp_folder, config_dir = _workspace(root, (16, 16, 16))
        path = os.path.join(root, "stitch.zarr")
        for key, arr in (("seg", frag), ("bmap", bmap)):
            _reader(side)(path).require_dataset(key, shape=arr.shape, chunks=(16, 16, 16),
                                                dtype=arr.dtype.name)[...] = arr
        wf = _mod(side, "tasks.stitching").StitchingWorkflow(
            tmp_folder=tmp_folder, config_dir=config_dir, max_jobs=4, target="local", seg_path=path, seg_key="seg",
            input_path=path, input_key="bmap", merge_mode=merge_mode, block_shape=[16, 16, 16], **extra)
        with NATIVE[side].force_python():
            assert _mod(side, "runtime.task").build([wf])
        arrays, manifests = _artifacts(tmp_folder)
        arrays["seg"] = np.asarray(_reader(side)(path, "r")["seg"][...])
        return arrays, manifests

    return run


# -- synthetic EM ------------------------------------------------------------------------------


EM_BLOCK = (8, 32, 32)


def _em_data():
    return p_em(shape=(24, 96, 96), n_objects=5, sampling=(40.0, 4.0, 4.0), boundary_width=2.0, smooth=0.3,
                noise=0.03, seed=7)


def _evaluate(side, tmp_folder, config_dir, path):
    ev = _mod(side, "tasks.evaluation").EvaluationWorkflow(
        tmp_folder=os.path.join(tmp_folder, "eval"), config_dir=config_dir, max_jobs=2, target="local",
        input_path=path, input_key="seg", labels_path=path, labels_key="gt", block_shape=list(EM_BLOCK))
    assert _mod(side, "runtime.task").build([ev])
    with open(os.path.join(tmp_folder, "eval", "evaluation.json")) as fh:
        return json.load(fh)


def _em_chain(side, root, feed=None):
    """``tests/test_synthetic_em.py::_run_e2e`` with ``two_d=True``; with
    ``feed`` (the reference's root) the port takes the reference's
    supervoxels (``skip_ws``) and, once its chain has built them, its
    ``costs.npy``."""
    boundaries, gt, mask = _em_data()
    tmp_folder, config_dir = _workspace(root, EM_BLOCK)
    path = os.path.join(root, "em.zarr")
    f = _reader(side)(path)
    for key, arr, dtype in (("boundaries", boundaries, "float32"), ("gt", gt, "uint64"),
                            ("mask", mask.astype(np.uint8), "uint8")):
        f.create_dataset(key, shape=arr.shape, chunks=EM_BLOCK, dtype=dtype)[...] = arr
    if feed is not None:
        f.create_dataset("sv", shape=gt.shape, chunks=EM_BLOCK, dtype="uint64")[...] = \
            _reader("jax")(os.path.join(feed, "em.zarr"))["sv"][...]
    wf = _mod(side, "workflows").MulticutSegmentationWorkflow(
        tmp_folder=tmp_folder, config_dir=config_dir, max_jobs=2, target="local", input_path=path,
        input_key="boundaries", ws_path=path, ws_key="sv", output_path=path, output_key="seg", mask_path=path,
        mask_key="mask", block_shape=list(EM_BLOCK), halo=[2, 8, 8], threshold=0.5, sigma_seeds=1.0,
        min_seed_distance=2.0, sampling=[2.0, 1.0, 1.0], two_d=True, beta=0.5, n_scales=1,
        agglomerator="greedy-additive", skip_ws=feed is not None)
    build = _mod(side, "runtime.task").build
    with NATIVE[side].force_python():
        if feed is not None:
            costs = next(t for t in _walk(wf) if type(t).__name__ == "ProbsToCostsLocal")
            assert build([costs])
            shutil.copy(os.path.join(feed, "tmp", "graph", "costs.npy"),
                        os.path.join(tmp_folder, "graph", "costs.npy"))
        assert build([wf])
    measures = _evaluate(side, tmp_folder, config_dir, path)
    seg = np.asarray(_reader(side)(path, "r")["seg"][...])
    sv = np.asarray(_reader(side)(path, "r")["sv"][...])
    return {"seg": seg, "sv": sv}, measures


def _walk(task):
    yield task
    for dep in task.requires():
        yield from _walk(dep)


CASES = {
    "mws_stitched": _mws(stitch=True),
    "mws_blocks": _mws(stitch=False),
    "mws_default_offsets": _mws(stitch=True, offsets=DEFAULT_OFFSETS),
    "stitch_multicut_s1": _stitch("multicut", stitch_threshold=0.5, solver_shards=1),
    "stitch_multicut_s2": _stitch("multicut", stitch_threshold=0.5, solver_shards=2),
    "stitch_less": _stitch("less", stitch_threshold=0.5),
    "stitch_greater": _stitch("greater", stitch_threshold=0.5),
}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's run of a case, once per module: ``(root, arrays,
    manifests)``."""
    cache = {}

    def get(case):
        if case not in cache:
            root = str(tmp_path_factory.mktemp(f"jax-{case}"))
            if case == "em_2d":
                cache[case] = (root,) + _em_chain("jax", root)
            else:
                cache[case] = (root,) + CASES[case]("jax", root)
        return cache[case]

    return get


def _both(case, tmp_path, jax_run):
    _, want, want_manifests = jax_run(case)
    got, got_manifests = CASES[case]("port", str(tmp_path))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sorted(got_manifests) == sorted(want_manifests)
    for task in want_manifests:
        assert sorted(got_manifests[task]) == sorted(want_manifests[task]), task
    return got, got_manifests


def test_mws_workflow_blockwise_with_stitching(tmp_path, jax_run):
    got, _ = _both("mws_stitched", tmp_path, jax_run)
    assert (got["seg"] > 0).all()
    assert_labels_equivalent(got["seg"], _mws_affinities()[1])


def test_mws_workflow_blockwise_without_stitching(tmp_path, jax_run):
    """``stitch=False``: the independent blocks, labels encoded by block
    (``block_id * (n_outer + 1) + inner``)."""
    got, _ = _both("mws_blocks", tmp_path, jax_run)
    seg = got["seg"]
    n_outer = 20 ** 3
    assert (seg > 0).all()
    for bz, by, bx in np.ndindex(1, 2, 2):
        block = seg[bz * 16:(bz + 1) * 16, by * 16:(by + 1) * 16, bx * 16:(bx + 1) * 16]
        block_id = (bz * 2 + by) * 2 + bx
        assert ((block // np.uint64(n_outer + 1)) == block_id).all()
    # each quadrant object sits in one block: four blocks, four labels
    assert len(np.unique(seg)) == 4


def test_mws_workflow_on_default_offsets(tmp_path, jax_run):
    """The default offsets (the task's ``DEFAULT_OFFSETS``, the card's input)
    on a synthetic-EM ground truth's affinities, stitched."""
    got, _ = _both("mws_default_offsets", tmp_path, jax_run)
    assert (got["seg"] > 0).all() and len(np.unique(got["seg"])) >= 6


@pytest.mark.parametrize("solver_shards", [1, 2])
def test_stitching_workflow_multicut_mode(tmp_path, jax_run, solver_shards):
    """``merge_mode='multicut'``: the face pairs' signed costs solved by the
    parallel GAEC (``solver_shards=2``: over the reduce tree); fragments
    split by the block grid reunify, distinct objects stay apart, and the
    manifest carries the solver block."""
    got, manifests = _both(f"stitch_multicut_s{solver_shards}", tmp_path, jax_run)
    assert_labels_equivalent(got["seg"], _fragments()[2])
    assert manifests["merge_stitch_assignments"]["sharded"] is (solver_shards > 1)
    assert manifests["merge_stitch_assignments"]["energy"] is not None


@pytest.mark.parametrize("merge_mode", ["less", "greater"])
def test_stitching_workflow_threshold_modes(tmp_path, jax_run, merge_mode):
    """The face-consensus modes on the same fragments: ``less`` merges the
    low-boundary faces (the ground truth), ``greater`` merges only faces
    whose mean passes 0.5, of which there are none."""
    got, _ = _both(f"stitch_{merge_mode}", tmp_path, jax_run)
    frag, _, gt = _fragments()
    if merge_mode == "less":
        assert_labels_equivalent(got["seg"], gt)
    else:
        # every face mean lies below 0.5: no pair merges
        assert_labels_equivalent(got["seg"], frag)


# -- synthetic EM ------------------------------------------------------------------------------


def test_generator_is_deterministic_and_exact():
    b1, g1, m1 = p_em(shape=(16, 64, 64), n_objects=6, seed=3)
    b2, g2, m2 = p_em(shape=(16, 64, 64), n_objects=6, seed=3)
    for got, want in zip((b1, g1, m1), j_em(shape=(16, 64, 64), n_objects=6, seed=3)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(g1, g2)
    np.testing.assert_array_equal(b1, b2)
    np.testing.assert_array_equal(m1, m2)
    assert set(np.unique(g1[m1])) <= set(range(1, 7))
    assert (g1[~m1] == 0).all()
    from scipy import ndimage

    interfaces = np.zeros(g1.shape, bool)
    for axis in range(3):
        a = [slice(None)] * 3
        b = [slice(None)] * 3
        a[axis] = slice(0, -1)
        b[axis] = slice(1, None)
        diff = (g1[tuple(a)] != g1[tuple(b)]) & (g1[tuple(a)] > 0) & (g1[tuple(b)] > 0)
        interfaces[tuple(a)] |= diff
    inner = (ndimage.distance_transform_edt(~interfaces) > 3) & m1 & (g1 > 0)
    assert b1[interfaces].mean() > 0.55
    assert b1[interfaces].mean() > b1[inner].mean() + 0.15


def test_multicut_on_synthetic_em_2d_mode(tmp_path, jax_run):
    """The per-slice watershed chain on synthetic EM.  The port's whole
    chain meets the reference test's quality bounds; its seeds are smoothed
    by ``sigma_seeds``, where the packages differ by a few float32 ulps
    (ROADMAP fact 6), so its supervoxels are its own.  Fed the reference's
    supervoxels and costs, the port's labels and measures equal the
    reference's."""
    root, want, want_measures = jax_run("em_2d")
    for feed in (None, root):
        got, measures = _em_chain("port", str(tmp_path / ("fed" if feed else "own")), feed=feed)
        assert measures["vi_split"] + measures["vi_merge"] < 1.5, measures
        assert measures["adapted_rand_error"] < 0.25, measures
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert measures == want_measures


@pytest.mark.slow  # tier-2, as the reference's own fused variant; the 2-D chain above stays tier-1
def test_multicut_on_fused_fragments(tmp_path):
    """Stitched fused watershed fragments feed
    ``MulticutSegmentationWorkflow(skip_ws=True)`` on both packages, within
    the reference test's quality bounds; the port's multicut fed the
    reference's fragments and costs gives the reference's measures."""
    boundaries, gt, _ = _em_data()
    measures = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side)
        tmp_folder, config_dir = _workspace(root, EM_BLOCK)
        path = os.path.join(root, "emf.zarr")
        f = _reader(side)(path)
        f.create_dataset("boundaries", shape=gt.shape, chunks=EM_BLOCK, dtype="float32")[...] = boundaries
        f.create_dataset("gt", shape=gt.shape, chunks=EM_BLOCK, dtype="uint64")[...] = gt
        build = _mod(side, "runtime.task").build
        fused = _mod(side, "tasks.fused").FusedSegmentationLocal(
            tmp_folder=tmp_folder, config_dir=config_dir, max_jobs=2, input_path=path, input_key="boundaries",
            output_path=path, ws_key="sv", threshold=0.5, halo=2, min_seed_distance=2.0, stitch_ws_threshold=0.5,
            max_labels_per_shard=8192, block_shape=list(EM_BLOCK))
        wf = _mod(side, "workflows").MulticutSegmentationWorkflow(
            tmp_folder=tmp_folder, config_dir=config_dir, max_jobs=2, target="local", input_path=path,
            input_key="boundaries", ws_path=path, ws_key="sv", skip_ws=True, output_path=path, output_key="seg",
            block_shape=list(EM_BLOCK), beta=0.5, n_scales=1, agglomerator="greedy-additive")
        with NATIVE[side].force_python():
            assert build([fused])
            assert build([wf])
        measures[side] = _evaluate(side, tmp_folder, config_dir, path)
        assert measures[side]["vi_split"] + measures[side]["vi_merge"] < 1.5, measures
        assert measures[side]["adapted_rand_error"] < 0.25, measures
    # the port's chain on the reference's fragments and costs
    root = str(tmp_path / "fed")
    tmp_folder, config_dir = _workspace(root, EM_BLOCK)
    path = os.path.join(root, "emf.zarr")
    f = _reader("port")(path)
    src = _reader("jax")(str(tmp_path / "jax" / "emf.zarr"))
    for key, arr in (("boundaries", boundaries), ("gt", gt), ("sv", src["sv"][...])):
        f.create_dataset(key, shape=gt.shape, chunks=EM_BLOCK, dtype=str(arr.dtype))[...] = arr
    wf = _mod("port", "workflows").MulticutSegmentationWorkflow(
        tmp_folder=tmp_folder, config_dir=config_dir, max_jobs=2, target="local", input_path=path,
        input_key="boundaries", ws_path=path, ws_key="sv", skip_ws=True, output_path=path, output_key="seg",
        block_shape=list(EM_BLOCK), beta=0.5, n_scales=1, agglomerator="greedy-additive")
    build = _mod("port", "runtime.task").build
    with pnative.force_python():
        assert build([next(t for t in _walk(wf) if type(t).__name__ == "ProbsToCostsLocal")])
        shutil.copy(str(tmp_path / "jax" / "tmp" / "graph" / "costs.npy"), os.path.join(tmp_folder, "graph",
                                                                                     "costs.npy"))
        assert build([wf])
    np.testing.assert_array_equal(f["seg"][...], src["seg"][...])
    assert _evaluate("port", tmp_folder, config_dir, path) == measures["jax"]
