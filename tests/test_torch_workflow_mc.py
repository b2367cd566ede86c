"""The port's BASELINE config 4 workflows (``MulticutSegmentationWorkflow``,
``AgglomerativeClusteringWorkflow``) and the watershed's
``agglomerate_threshold`` against the JAX package's, on the CPU
(``target="local"``).

Cases: ``make_case`` of ``tests/test_multicut_workflow.py`` (16^3, given
supervoxels, blocks of 8, ``n_scales`` 1 and 2), and a seeded 32^3
boundary map through the watershed (blocks of 16, halo 4).  Each side
reads its own zarr (tensorstore for JAX, the port's numpy zarr).

- The graph artifacts equal the reference's exactly; features and costs
  are within the reference tests' tolerances.
- Fed the reference's ``graph/costs.npy`` (multicut) or
  ``graph/features.npy`` (agglomeration) -- the port's chain is built up to
  that artifact, the file is overwritten, and the whole workflow is built,
  skipping the finished tasks -- the assignments and the written
  segmentation equal the reference's bit for bit.
- Unfed, the segmentation equals the reference's up to a bijection.

Both packages run their Python solver paths (each one's
``native.force_python``), except in the default-workflow case, where both
run their host C++ rungs; the modes of its watershed are pinned.  The agglomerative ``impl`` is
pinned in both configs (``numpy`` in the reference, ``torch`` in the port).
"""

import json
import os
import shutil

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import cluster_tools_tpu.native as native
import cluster_tools_tpu_torch.native as pnative
from cluster_tools_tpu.runtime.task import build as j_build
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
from cluster_tools_tpu.workflows import AgglomerativeClusteringWorkflow as JAC
from cluster_tools_tpu.workflows import MulticutSegmentationWorkflow as JMC
from cluster_tools_tpu.tasks.watershed import WatershedWorkflow as JWS
from cluster_tools_tpu_torch import workflows as pwf
from cluster_tools_tpu_torch.runtime.task import build as p_build
from cluster_tools_tpu_torch.tasks import agglomerative_clustering as pac
from cluster_tools_tpu_torch.tasks import multicut as pmc
from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow as PWS
from cluster_tools_tpu_torch.utils.volume_utils import file_reader as p_reader

from .helpers import assert_labels_equivalent
from .test_multicut_workflow import make_case

torch.set_num_threads(1)

SIDES = {
    "jax": dict(mc=JMC, ac=JAC, ws=JWS, build=j_build, reader=j_reader),
    "port": dict(mc=pwf.MulticutSegmentationWorkflow, ac=pwf.AgglomerativeClusteringWorkflow, ws=PWS,
                 build=p_build, reader=p_reader),
}
AC_IMPL = {"jax": "numpy", "port": "torch"}


@pytest.fixture(scope="module", autouse=True)
def _pin_modes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CT_TIER_MODE", "cond")
        mp.setenv("CT_FILL_MODE", "capacity")
        mp.setenv("CT_SEED_CCL", "tiled")
        yield


def _boundaries32():
    x = ndi.gaussian_filter(np.random.default_rng(0).random((32, 32, 32)), 2.0)
    return ((x - x.min()) / (x.max() - x.min())).astype(np.float32)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mc"))
    _, sv, bmap16 = make_case()
    for side, s in SIDES.items():
        f = s["reader"](os.path.join(root, f"{side}.zarr"))
        for key, data, chunks in (("bmap16", bmap16, (8, 8, 8)), ("sv16", sv, (8, 8, 8)),
                                  ("bmap32", _boundaries32(), (16, 16, 16))):
            f.require_dataset(key, shape=data.shape, chunks=chunks, dtype=str(data.dtype))[...] = data
    return root


CASES = {
    # name: (boundary key, workflow params, block shape)
    "given_sv_n1": ("bmap16", dict(ws_key="sv16", skip_ws=True, n_scales=1), 8),
    "given_sv_n2": ("bmap16", dict(ws_key="sv16", skip_ws=True, n_scales=2), 8),
    "watershed32": ("bmap32", dict(ws_key="ws32", threshold=0.5, halo=[4, 4, 4]), 16),
    # a host solver for the subproblems: one solve a block
    "given_sv_greedy": ("bmap16", dict(ws_key="sv16", skip_ws=True, n_scales=2, agglomerator="greedy-additive"), 8),
}


def _find(task, cls_name):
    if type(task).__name__ == cls_name:
        return task
    for dep in task.requires():
        hit = _find(dep, cls_name)
        if hit is not None:
            return hit
    return None


def run(root, side, kind, case, feed=None, native_rung=False):
    """One workflow of ``kind`` ("mc" or "ac") on ``side``; with ``feed`` (a
    tmp_folder of the reference) the port first builds the chain up to the
    solver's input, overwrites that artifact with the reference's, then
    builds the whole workflow.  Each side runs its Python solver paths, or
    with ``native_rung`` its host C++ rung.  Returns the run's directory."""
    bkey, params, block = CASES[case]
    tag = f"{kind}-{case}-{side}" + ("-fed" if feed else "") + ("-native" if native_rung else "")
    d = os.path.join(root, tag)
    os.makedirs(os.path.join(d, "cfg"))
    with open(os.path.join(d, "cfg", "global.config"), "w") as f:
        json.dump({"block_shape": [block] * 3}, f)
    with open(os.path.join(d, "cfg", "agglomerative_clustering.config"), "w") as f:
        json.dump({"impl": AC_IMPL[side]}, f)
    s = SIDES[side]
    path = os.path.join(root, f"{side}.zarr")
    params = dict(params, ws_key=params["ws_key"] + ("" if params.get("skip_ws") else f"_{tag}"))
    wf = s[kind](tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=2, target="local",
                 input_path=path, input_key=bkey, ws_path=path, output_path=path, output_key=tag,
                 block_shape=[block] * 3, beta=0.5, **params)
    if feed is not None:
        artifact, producer = ("costs.npy", "ProbsToCostsLocal") if kind == "mc" else \
            ("features.npy", "EdgeFeaturesWorkflow")
        assert s["build"]([_find(wf, producer)])
        shutil.copy(os.path.join(feed, "tmp", "graph", artifact), os.path.join(d, "tmp", "graph", artifact))
    if native_rung:
        assert s["build"]([wf]), tag
    elif side == "jax":
        with native.force_python():
            assert s["build"]([wf]), tag
    else:
        with pnative.force_python():
            assert s["build"]([wf]), tag
    return d


def _seg(root, side, d):
    return np.asarray(SIDES[side]["reader"](os.path.join(root, f"{side}.zarr"))[os.path.basename(d)][:])


@pytest.fixture(scope="module")
def ref(root):
    """The reference's runs, shared: ``{(kind, case): run directory}``."""
    return {(kind, case): run(root, "jax", kind, case)
            for kind, case in (("mc", c) for c in CASES)} | {("ac", "watershed32"): run(root, "jax", "ac",
                                                                                         "watershed32")}


@pytest.fixture(scope="module")
def port(root):
    return {("mc", case): run(root, "port", "mc", case) for case in CASES} | {
        ("ac", "watershed32"): run(root, "port", "ac", "watershed32")}


def _graph_files(d):
    return sorted(f for f in os.listdir(os.path.join(d, "tmp", "graph"))
                  if f.startswith(("block_", "graph", "edge_ids_")))


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_features_costs_match_reference(root, ref, port, case):
    dj, dp = ref[("mc", case)], port[("mc", case)]
    assert _graph_files(dp) == _graph_files(dj)
    for name in _graph_files(dj):
        a, b = (np.load(os.path.join(d, "tmp", "graph", name)) for d in (dj, dp))
        keys = a.files if name.endswith(".npz") else [None]
        for k in keys:
            x, y = (a, b) if k is None else (a[k], b[k])
            assert x.dtype == y.dtype, (name, k)
            np.testing.assert_array_equal(y, x, err_msg=f"{name} {k}")
    fj, fp = (np.load(os.path.join(d, "tmp", "graph", "features.npy")) for d in (dj, dp))
    np.testing.assert_array_equal(fp[:, 1:4], fj[:, 1:4])
    np.testing.assert_allclose(fp[:, 0], fj[:, 0], rtol=1e-4)
    np.testing.assert_allclose(fp[:, 4], fj[:, 4], rtol=1e-2, atol=1e-6)
    cj, cp = (np.load(os.path.join(d, "tmp", "graph", "costs.npy")) for d in (dj, dp))
    assert cp.dtype == cj.dtype == np.float32
    np.testing.assert_allclose(cp, cj, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_multicut_fed_the_reference_costs_is_bit_equal(root, ref, case):
    dj = ref[("mc", case)]
    dp = run(root, "port", "mc", case, feed=dj)
    for name in ("keys", "values"):
        a, b = (np.load(os.path.join(d, "tmp", "multicut", "mc_assignments.npz"))[name] for d in (dj, dp))
        assert a.dtype == b.dtype == np.uint64
        np.testing.assert_array_equal(b, a)
    seg = _seg(root, "port", dp)
    np.testing.assert_array_equal(seg, _seg(root, "jax", dj))
    assert seg.dtype == np.uint64 and len(np.unique(seg)) > 1


def test_default_workflow_on_the_native_rungs_is_bit_equal(root):
    """The default workflow (its own watershed, ``gaec_parallel``
    subproblems, the Kernighan-Lin global solve) with both packages on their
    host C++ rungs, the port fed the reference's costs: equal assignments
    and segmentation."""
    dj = run(root, "jax", "mc", "watershed32", native_rung=True)
    pnative.reset_counts()
    dp = run(root, "port", "mc", "watershed32", feed=dj, native_rung=True)
    assert pnative.COUNTS["kernighan_lin"] >= 1 and pnative.COUNTS["parallel_contract"] >= 1, pnative.COUNTS
    assert pnative.COUNTS["merge_edge_features"] >= 1 and pnative.COUNTS["union_find"] >= 1, pnative.COUNTS
    for name in ("keys", "values"):
        a, b = (np.load(os.path.join(d, "tmp", "multicut", "mc_assignments.npz"))[name] for d in (dj, dp))
        np.testing.assert_array_equal(b, a)
    seg = _seg(root, "port", dp)
    np.testing.assert_array_equal(seg, _seg(root, "jax", dj))
    assert len(np.unique(seg)) > 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_multicut_segmentation_matches_reference(root, ref, port, case):
    seg = _seg(root, "port", port[("mc", case)])
    want = _seg(root, "jax", ref[("mc", case)])
    assert_labels_equivalent(seg, want)
    if case.startswith("given_sv"):
        assert_labels_equivalent(seg, make_case()[0])


def test_agglomerative_fed_the_reference_features_is_bit_equal(root, ref):
    dj = ref[("ac", "watershed32")]
    dp = run(root, "port", "ac", "watershed32", feed=dj)
    for name in ("keys", "values"):
        a, b = (np.load(os.path.join(d, "tmp", "agglomerative_assignments.npz"))[name] for d in (dj, dp))
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(_seg(root, "port", dp), _seg(root, "jax", dj))


def test_agglomerative_segmentation_matches_reference(root, ref, port):
    seg = _seg(root, "port", port[("ac", "watershed32")])
    assert_labels_equivalent(seg, _seg(root, "jax", ref[("ac", "watershed32")]))
    ws = _seg(root, "port", port[("mc", "watershed32")]).shape
    assert seg.shape == ws and len(np.unique(seg)) > 1


def test_agglomerate_threshold_watershed_is_bit_equal(root, port):
    out = {}
    for side, s in SIDES.items():
        d = os.path.join(root, f"agg-{side}")
        os.makedirs(os.path.join(d, "cfg"))
        with open(os.path.join(d, "cfg", "global.config"), "w") as f:
            json.dump({"block_shape": [16] * 3}, f)
        path = os.path.join(root, f"{side}.zarr")
        wf = s["ws"](tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=2,
                     target="local", input_path=path, input_key="bmap32", output_path=path, output_key="agg",
                     block_shape=[16] * 3, halo=[4, 4, 4], threshold=0.5, agglomerate_threshold=0.5)
        assert s["build"]([wf]), side
        out[side] = np.asarray(s["reader"](path)["agg"][:])
    np.testing.assert_array_equal(out["port"], out["jax"])
    # the same watershed without the agglomeration: the multicut case's
    plain = np.asarray(p_reader(os.path.join(root, "port.zarr"))["ws32_mc-watershed32-port"][:])
    assert 1 < len(np.unique(out["port"])) < len(np.unique(plain)), "the agglomeration merged nothing"


def _tasks(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "cfg"), exist_ok=True)
    return dict(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=1)


def test_sharded_solves_are_refused(tmp_path):
    """``solver_shards > 1`` is no longer refused (ROADMAP item 10b): the
    multicut workflow and the agglomerative task run the reduce tree on
    ``make_case``, and the multicut recovers the ground truth as the
    unsharded solve does.  ``tests/test_torch_reduce_tasks.py`` holds both
    against the JAX package bit for bit."""
    common = _tasks(tmp_path)
    with open(os.path.join(common["config_dir"], "global.config"), "w") as f:
        json.dump({"block_shape": [8] * 3}, f)
    gt, sv, bmap = make_case()
    path = os.path.join(str(tmp_path), "d.zarr")
    f = p_reader(path)
    for key, data in (("bmap", bmap), ("sv", sv)):
        f.require_dataset(key, shape=data.shape, chunks=(8, 8, 8), dtype=str(data.dtype))[...] = data
    wf = pwf.MulticutSegmentationWorkflow(**common, target="local", input_path=path, input_key="bmap", ws_path=path,
                                          ws_key="sv", output_path=path, output_key="seg", skip_ws=True, n_scales=0,
                                          beta=0.5, agglomerator="gaec_parallel", solver_shards=2)
    assert p_build([wf])
    assert_labels_equivalent(np.asarray(p_reader(path)["seg"][:]), gt)
    ac = pac.AgglomerativeClusteringLocal(**common, dependencies=[], solver_shards=2, threshold=0.5, impl="numpy")
    ac.run()
    for task in (pmc.SolveGlobalLocal(**common, input_path=path, input_key="sv", scale=0), ac):
        doc = json.load(open(os.path.join(common["tmp_folder"], [
            n for n in os.listdir(common["tmp_folder"])
            if n.split(".")[0] == task.task_name and n.endswith(".success.json")][0])))
        assert doc["solver"]["sharded"] is True and doc["solver"]["shards"] == 2, task.task_name


def test_lifted_workflow_is_refused(tmp_path):
    """The lifted workflow is ported: on ``make_case`` with its ground truth
    as the attribution it builds, runs the lifted tasks and recovers the
    ground truth (``tests/test_torch_lifted.py`` holds it against the
    reference)."""
    gt, sv, bmap = make_case()
    common = _tasks(tmp_path)
    with open(os.path.join(common["config_dir"], "global.config"), "w") as f:
        json.dump({"block_shape": [8, 8, 8]}, f)
    path = os.path.join(str(tmp_path), "data.zarr")
    f = p_reader(path)
    for key, data in (("bmap", bmap), ("sv", sv), ("gt", gt)):
        f.require_dataset(key, shape=data.shape, chunks=(8, 8, 8), dtype=str(data.dtype))[...] = data
    wf = pwf.LiftedMulticutSegmentationWorkflow(**common, target="local", input_path=path, input_key="bmap",
                                                ws_path=path, ws_key="sv", output_path=path, output_key="seg",
                                                labels_path=path, labels_key="gt", skip_ws=True, beta=0.5,
                                                block_shape=[8, 8, 8])
    assert p_build([wf])
    assert_labels_equivalent(np.asarray(p_reader(path)["seg"][:]), gt)
    done = {n.split(".")[0] for n in os.listdir(common["tmp_folder"]) if n.endswith(".success.json")}
    assert {"sparse_lifted_neighborhood", "costs_from_node_labels", "solve_lifted_subproblems",
            "reduce_lifted_problem", "solve_lifted_global", "write"} <= done


def test_workflow_get_config():
    cfg = pwf.MulticutSegmentationWorkflow.get_config()
    assert "global" in cfg and "watershed" in cfg and "solve_global" in cfg
    assert cfg["probs_to_costs"]["beta"] == 0.5
    assert cfg["solve_subproblems"]["agglomerator"] == "gaec_parallel"
    assert pwf.AgglomerativeClusteringWorkflow.get_config()["agglomerative_clustering"]["impl"] == "auto"


@pytest.mark.parametrize("beta,weighted", [(0.5, False), (0.3, True), (0.7, True)])
def test_compute_costs_matches_reference(beta, weighted):
    from cluster_tools_tpu.tasks.costs import compute_costs as j_costs
    from cluster_tools_tpu_torch.tasks.costs import compute_costs as p_costs

    rng = np.random.default_rng(int(beta * 10))
    probs = rng.random(500).astype(np.float32)
    probs[:3] = (0.0, 1.0, 0.5)
    sizes = rng.integers(1, 300, 500) if weighted else None
    got = p_costs(probs, beta=beta, edge_sizes=sizes, weighting_exponent=1.5, device="cpu")
    want = j_costs(probs, beta=beta, edge_sizes=sizes, weighting_exponent=1.5)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("channel", [None, 1, [0, 2]])
def test_read_boundary_map_channels_match_reference(channel):
    from cluster_tools_tpu.tasks.features import _read_boundary_map as j_read
    from cluster_tools_tpu_torch.tasks.features import _read_boundary_map as p_read

    data = np.random.default_rng(0).random((3, 6, 7, 8)).astype(np.float32)
    ds = data[0] if channel is None else data
    bb = (slice(1, 5), slice(0, 7), slice(2, 8))
    np.testing.assert_array_equal(p_read(ds, bb, channel), j_read(ds, bb, channel))
