"""The port's lifted multicut (``ops/multicut.py``'s lifted solvers,
``tasks/lifted_features.py``, ``tasks/lifted_multicut.py``, lifted edges
through ``parallel/reduce_tree.py`` and
``workflows.LiftedMulticutSegmentationWorkflow``) against the JAX
package's, on the CPU, with zero tolerance.

- The sparse lifted neighbourhood and the lifted GAEC and energy on the
  reference's chain cases and on ``grid_rag`` problems with seeded random
  lifted edges: the same arrays, labels and energies.
- The reduce tree carrying lifted edges: the port's packet plane and its
  2-process worker group give the reference's packet-plane labels; the
  collective plane refuses them with the reference's reason.
- Every case of ``tests/test_lifted_multicut.py`` on both packages, the
  workflow with ``solver_shards`` 1 and 2 and with ``n_scales=2``, and the
  workflow on its own watershed of a ``synthetic_em_volume`` with its
  ground truth as the attribution (the port fed the reference's
  ``costs.npy``: the edge features are float32 sums the two packages round
  apart, ROADMAP Queue A's config-4 notes): the written labels, every npz
  and npy under ``lifted/`` and ``lifted_multicut/`` and the graph
  artifacts are equal, and the solve manifests carry the same keys.

Both packages run their Python solver paths (each one's
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
from cluster_tools_tpu.ops import multicut as J
from cluster_tools_tpu.parallel import reduce_tree as jrt
from cluster_tools_tpu.runtime import supervision as jsup
from cluster_tools_tpu.tasks.lifted_features import sparse_lifted_neighborhood as j_nh
from cluster_tools_tpu_torch.ops import multicut as P
from cluster_tools_tpu_torch.parallel import reduce_tree as prt
from cluster_tools_tpu_torch.runtime import supervision as psup
from cluster_tools_tpu_torch.tasks.lifted_features import sparse_lifted_neighborhood as p_nh
from cluster_tools_tpu_torch.utils.synthetic import grid_rag, synthetic_em_volume

from .helpers import assert_labels_equivalent

PKG = {"jax": "cluster_tools_tpu", "port": "cluster_tools_tpu_torch"}
NATIVE = {"jax": jnative, "port": pnative}
COUNTERS = ("sharded_solves", "unsharded_fallbacks", "solve_shards", "solve_levels", "tree_rounds",
            "boundary_edges_in", "boundary_edges_out", "collective_hops", "packet_fallbacks",
            "contraction_dispatches")


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


@pytest.fixture
def python_paths():
    with jnative.force_python(), pnative.force_python():
        yield


def _mod(side, name):
    return importlib.import_module(f"{PKG[side]}.{name}")


# -- the lifted neighbourhood and solvers ---------------------------------------------


def test_sparse_lifted_neighborhood_chain():
    # path graph 0-1-2-3: distance-2 pairs (0,2), (1,3); distance-3 (0,3)
    edges = np.array([[0, 1], [1, 2], [2, 3]])
    for fn in (p_nh, j_nh):
        np.testing.assert_array_equal(fn(4, edges, 2), [[0, 2], [1, 3]])
        np.testing.assert_array_equal(fn(4, edges, 3), [[0, 2], [0, 3], [1, 3]])
        assert len(fn(4, np.zeros((0, 2), np.int64), 2)) == 0
    assert p_nh(4, edges, 1).dtype == j_nh(4, edges, 1).dtype == np.int64


@pytest.mark.parametrize("distance", [2, 3, 4])
def test_sparse_lifted_neighborhood_on_grid_rag(distance):
    n, edges, _ = grid_rag(g=7, seed=distance)
    # a graph with holes: drop a seeded third of the grid's edges
    edges = edges[np.random.default_rng(distance).random(len(edges)) > 0.33]
    got, want = p_nh(n, edges, distance), j_nh(n, edges, distance)
    assert got.dtype == want.dtype and len(got) > 0
    np.testing.assert_array_equal(got, want)


def test_lifted_solver_repulsion_splits_chain():
    """A uniformly attractive chain is split only by the lifted repulsion."""
    edges = np.array([[0, 1], [1, 2], [2, 3]])
    costs = np.array([1.0, 0.9, 1.0])
    lifted, lc = np.array([[0, 3]]), np.array([-5.0])
    labels = P.lifted_greedy_additive(4, edges, costs, lifted, lc)
    np.testing.assert_array_equal(labels, J.lifted_greedy_additive(4, edges, costs, lifted, lc))
    assert labels[0] != labels[3]
    e = P.lifted_multicut_energy(edges, costs, lifted, lc, labels)
    assert e == J.lifted_multicut_energy(edges, costs, lifted, lc, labels)
    assert e < P.lifted_multicut_energy(edges, costs, lifted, lc, np.zeros(4, np.int64))


def test_lifted_solver_attraction_bridges_weak_edge():
    """Lifted attraction pulls across a locally ambivalent edge."""
    edges = np.array([[0, 1], [1, 2]])
    costs = np.array([1.0, -0.1])
    lifted = np.array([[0, 2]])
    labels = P.lifted_greedy_additive(3, edges, costs, lifted, np.array([2.0]))
    np.testing.assert_array_equal(labels, J.lifted_greedy_additive(3, edges, costs, lifted, np.array([2.0])))
    assert labels[0] == labels[1] == labels[2]
    # without the lifted pull, 2 stays apart: the plain GAEC
    none = (np.zeros((0, 2), np.int64), np.zeros(0))
    labels2 = P.lifted_greedy_additive(3, edges, costs, *none)
    np.testing.assert_array_equal(labels2, J.lifted_greedy_additive(3, edges, costs, *none))
    assert labels2[2] != labels2[0]


@pytest.mark.parametrize("g,seed,per_node,native_rung", [(6, 0, 2, False), (9, 1, 3, False), (11, 2, 1, False),
                                                         (8, 3, 0, True), (10, 4, 4, True)])
def test_lifted_greedy_additive_on_grid_rag(g, seed, per_node, native_rung):
    """Seeded random lifted edges (self-pairs and repeats included) on a
    grid RAG: equal labels and energies; with no lifted edges the solve is
    the GAEC, here also on both host C++ rungs."""
    n, edges, costs = grid_rag(g=g, seed=seed)
    rng = np.random.default_rng(seed)
    le = rng.integers(0, n, (per_node * n, 2))
    lc = rng.normal(-0.1, 1.0, len(le))
    if native_rung:
        pnative.reset_counts()
        got, want = (M.lifted_greedy_additive(n, edges, costs, le, lc) for M in (P, J))
        assert pnative.COUNTS["greedy_additive"] == (1 if per_node == 0 else 0)
    else:
        with jnative.force_python(), pnative.force_python():
            got, want = (M.lifted_greedy_additive(n, edges, costs, le, lc) for M in (P, J))
    assert got.dtype == want.dtype == np.int64 and got.max() > 0
    np.testing.assert_array_equal(got, want)
    assert P.lifted_multicut_energy(edges, costs, le, lc, got) == J.lifted_multicut_energy(edges, costs, le, lc, want)
    if per_node == 0:
        np.testing.assert_array_equal(got, P.greedy_additive(n, edges, costs))


def test_lifted_frontier_capable():
    assert P.lifted_frontier_capable() is J.lifted_frontier_capable() is False


# -- lifted edges through the reduce tree ------------------------------------------------


def _lifted_grid(g=8, seed=0, shards=4):
    n, edges, costs = grid_rag(g=g, seed=seed)
    pos = np.stack(np.unravel_index(np.arange(n), (g, g, g)), axis=1)
    rng = np.random.default_rng(seed + 10)
    le = rng.integers(0, n, (2 * n, 2))
    le = le[le[:, 0] != le[:, 1]]
    return n, edges, costs, le, rng.normal(-0.2, 1.0, len(le)), jrt.morton_node_shards(pos, shards)


@pytest.mark.parametrize("fanout", [2, 4])
def test_sharded_solve_carries_lifted_edges(python_paths, fanout):
    """The packet plane with lifted edges at every tree node: the
    reference's labels and counters."""
    n, edges, costs, le, lc, node_shard = _lifted_grid(g=8, seed=fanout)
    js, ps = jrt.solve_snapshot(), prt.solve_snapshot()
    lj, ij = jrt.sharded_solve(n, edges, costs, node_shard, fanout=fanout, lifted_edges=le, lifted_payload=lc)
    jd = jrt.solve_delta(js)
    lp, ip = prt.sharded_solve(n, edges, costs, node_shard, fanout=fanout, lifted_edges=le, lifted_payload=lc,
                               device="cpu")
    pd = prt.solve_delta(ps)
    np.testing.assert_array_equal(lp, lj)
    assert {k: jd[k] for k in COUNTERS} == {k: pd[k] for k in COUNTERS}
    assert ip["reduce_plane"] == ij["reduce_plane"] == "host" and pd["sharded_solves"] == 1
    assert len(np.unique(lp)) > 1


def test_worker_group_solves_lifted_edges(python_paths, tmp_path):
    """Two worker processes on the packet plane (the problem's lifted edges
    read from the group's npz) give the reference's in-process labels."""
    n, edges, costs, le, lc, node_shard = _lifted_grid(g=8, seed=5, shards=4)
    want, _ = jrt.sharded_solve(n, edges, costs, node_shard, fanout=2, lifted_edges=le, lifted_payload=lc)
    snap = prt.solve_snapshot()
    got, info = prt.solve_with_reduce_tree(
        n, edges, costs, node_shard=node_shard, solver_shards=4, fanout=2,
        failures_path=str(tmp_path / "failures.json"), task_name="lifted_group",
        unsharded=lambda: pytest.fail("the group degraded"), lifted_edges=le, lifted_payload=lc, workers=2,
        scratch_dir=str(tmp_path / "rt"), reduce_plane="packet", device="cpu")
    np.testing.assert_array_equal(got, want)
    assert info["sharded"] is True and info.get("workers") == 2 and "degraded" not in info, info
    assert prt.solve_delta(snap)["unsharded_fallbacks"] == 0


def test_collective_plane_refuses_lifted_edges(python_paths, tmp_path, monkeypatch):
    """A demanded collective plane refuses lifted edges with the
    reference's reason: the solve runs on the packet plane, attributed."""
    n, edges, costs, le, lc, node_shard = _lifted_grid(g=6, seed=7, shards=2)
    want, _ = jrt.sharded_solve(n, edges, costs, node_shard, lifted_edges=le, lifted_payload=lc)
    docs = {}
    for tag, mod in (("jax", jrt), ("port", prt)):
        kw = {"device": "cpu"} if mod is prt else {}
        snap = mod.solve_snapshot()
        labels, info = mod.solve_with_reduce_tree(
            n, edges, costs, node_shard=node_shard, solver_shards=2, fanout=2,
            failures_path=str(tmp_path / f"{tag}.json"), task_name="lifted_collective",
            unsharded=lambda: pytest.fail("degraded to the unsharded solve"), lifted_edges=le, lifted_payload=lc,
            reduce_plane="collective", **kw)
        np.testing.assert_array_equal(labels, want)
        assert info["reduce_plane"] == "host" and mod.solve_delta(snap)["packet_fallbacks"] == 1
        recs = json.loads((tmp_path / f"{tag}.json").read_text())["records"]
        docs[tag] = [(r["task"], r["resolution"], r["sites"]) for r in recs]
        assert any("no lifted edges" in json.dumps(r) for r in recs), recs
    assert docs["port"] == docs["jax"]
    # the plane itself (two sibling shards on the CPU) refuses a group with
    # lifted edges, before any dispatch
    monkeypatch.setenv("CTT_MESH_SHARDS", "2")
    state = prt._TreeState(n, edges, prt._as_payload(costs, len(edges)), le, prt._as_payload(lc, len(le)),
                           node_shard)
    plane = prt.CollectiveReducePlane("max", 0.0, 1, device="cpu")
    with pytest.raises(prt.ShardedSolveError, match="no frontier formulation"):
        plane.solve_level(state, prt.reduce_tree_levels(2, 2)[0], level=0)


# -- the workflow ---------------------------------------------------------------------


def _slabs():
    """The reference's case: four supervoxel slabs along x with an
    ambiguous boundary (0.5) at every interface, two nuclei."""
    shape = (16, 16, 32)
    sv = np.zeros(shape, np.uint64)
    for i in range(4):
        sv[:, :, 8 * i: 8 * (i + 1)] = i + 1
    bmap = np.full(shape, 0.1, np.float32)
    for xb in (8, 16, 24):
        bmap[:, :, xb - 1: xb + 1] = 0.5
    nuclei = np.zeros(shape, np.uint64)
    nuclei[4:12, 4:12, 2:14] = 1
    nuclei[4:12, 4:12, 18:30] = 2
    return dict(bmap=bmap, sv=sv, nuclei=nuclei), np.where(sv <= 2, np.uint64(1), np.uint64(2))


def _em():
    b, gt, _ = synthetic_em_volume(shape=(16, 48, 48), n_objects=8, smooth=0.3, noise=0.03, seed=5)
    return dict(bmap=b, gt=gt), gt


SLAB = dict(ws_key="sv", labels_key="nuclei", skip_ws=True, beta=0.5, max_graph_distance=3, w_attractive=4.0,
            w_repulsive=4.0)
EM = dict(ws_key="ws", labels_key="gt", threshold=0.5, halo=[2, 8, 8], min_seed_distance=2.0,
          sampling=[2.0, 1.0, 1.0], beta=0.5, max_graph_distance=2)
CASES = {
    # name: (data, block shape, workflow params)
    "attribution_s1": (_slabs, [8, 8, 8], dict(SLAB, n_scales=1, solver_shards=1)),
    "attribution_s2": (_slabs, [8, 8, 8], dict(SLAB, n_scales=1, solver_shards=2)),
    "attribution_two_scales": (_slabs, [8, 8, 8], dict(SLAB, n_scales=2, solver_shards=1)),
    "em_watershed_s1": (_em, [8, 24, 24], dict(EM, n_scales=1, solver_shards=1)),
    "em_watershed_s2": (_em, [8, 24, 24], dict(EM, n_scales=2, solver_shards=2)),
}


def _find(task, cls_name):
    if type(task).__name__ == cls_name:
        return task
    for dep in task.requires():
        hit = _find(dep, cls_name)
        if hit is not None:
            return hit
    return None


def _run(side, root, case, feed=None):
    """The case's workflow on ``side`` in ``root``; with ``feed`` (the
    reference's run directory) the port builds the chain to its costs,
    takes the reference's ``costs.npy`` and builds the rest.  Returns every
    artifact of the run's ``graph``, ``lifted`` and ``lifted_multicut``
    folders, the written labels (``seg``) and the success manifests'
    ``solver`` blocks of the solve tasks."""
    make, block, params = CASES[case]
    data, _ = make()
    tmp_folder, cfg = os.path.join(root, "tmp"), os.path.join(root, "cfg")
    os.makedirs(cfg, exist_ok=True)
    with open(os.path.join(cfg, "global.config"), "w") as f:
        json.dump({"block_shape": block}, f)
    path = os.path.join(root, "data.zarr")
    reader = _mod(side, "utils.volume_utils").file_reader
    for name, arr in data.items():
        reader(path).require_dataset(name, shape=arr.shape, chunks=tuple(block), dtype=str(arr.dtype))[...] = arr
    wf = _mod(side, "workflows").LiftedMulticutSegmentationWorkflow(
        tmp_folder=tmp_folder, config_dir=cfg, max_jobs=4, target="local", input_path=path, input_key="bmap",
        ws_path=path, output_path=path, output_key="seg", labels_path=path, block_shape=block, **params)
    build = _mod(side, "runtime.task").build
    with NATIVE[side].force_python():
        if feed is not None:
            assert build([_find(wf, "ProbsToCostsLocal")])
            shutil.copy(os.path.join(feed, "tmp", "graph", "costs.npy"),
                        os.path.join(tmp_folder, "graph", "costs.npy"))
        assert build([wf]), case
    out = {k: np.asarray(reader(path, "r")[key][...]) for k, key in (("seg", "seg"), ("ws", params["ws_key"]))}
    for sub in ("graph", "lifted", "lifted_multicut"):
        for fn in sorted(os.listdir(os.path.join(tmp_folder, sub))):
            p = os.path.join(tmp_folder, sub, fn)
            if fn.endswith(".npz"):
                with np.load(p) as z:
                    out.update({f"{sub}/{fn}/{k}": z[k] for k in z.files})
            elif fn.endswith(".npy"):
                out[f"{sub}/{fn}"] = np.load(p)
    manifests = {}
    for fn in sorted(os.listdir(tmp_folder)):
        if fn.endswith(".success.json"):
            doc = json.load(open(os.path.join(tmp_folder, fn)))
            if "solver" in doc:
                manifests[fn.split(".")[0]] = doc["solver"]
    return out, manifests


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's run of a case, once per module: ``(root, artifacts,
    manifests)``."""
    cache = {}

    def get(case):
        if case not in cache:
            root = str(tmp_path_factory.mktemp(f"jax-{case}"))
            cache[case] = (root,) + _run("jax", root, case)
        return cache[case]

    return get


def _both(case, tmp_path, jax_run):
    root, want, want_manifests = jax_run(case)
    fed = case.startswith("em_")
    got, got_manifests = _run("port", str(tmp_path), case, feed=root if fed else None)
    assert sorted(got) == sorted(want)
    for k in want:
        if fed and (k.startswith("graph/features") or k == "graph/costs.npy"):
            continue  # float32 sums the packages round apart; the costs were fed
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sorted(got_manifests) == sorted(want_manifests) and got_manifests
    for task in want_manifests:
        assert sorted(got_manifests[task]) == sorted(want_manifests[task]), task
        assert got_manifests[task]["energy"] == want_manifests[task]["energy"], task
        assert got_manifests[task]["sharded"] is want_manifests[task]["sharded"], task
    return got, got_manifests


@pytest.mark.parametrize("solver_shards", [1, 2])
def test_lifted_multicut_workflow_uses_attribution(tmp_path, jax_run, solver_shards):
    """The reference's case: an ambiguous local boundary (0.5 on every
    interface) resolved by the nucleus attribution, unsharded and through
    the octant reduce tree with the lifted edges carried through every
    level."""
    got, manifests = _both(f"attribution_s{solver_shards}", tmp_path, jax_run)
    assert_labels_equivalent(got["seg"], _slabs()[1])
    assert manifests["solve_lifted_global"]["sharded"] is (solver_shards > 1)
    assert len(got["lifted/lifted_problem.npz/edges"]) > 0


def test_lifted_multicut_workflow_two_scales(tmp_path, jax_run):
    got, _ = _both("attribution_two_scales", tmp_path, jax_run)
    assert_labels_equivalent(got["seg"], _slabs()[1])
    assert "lifted_multicut/problem_s2.npz/lifted_edges" in got and "lifted_multicut/cut_edges_s1.npz/cut" in got


@pytest.mark.parametrize("case", ["em_watershed_s1", "em_watershed_s2"])
def test_lifted_multicut_workflow_on_its_own_watershed(tmp_path, jax_run, case):
    """The whole chain with its watershed on a synthetic EM volume, the
    ground truth as the attribution (two scales and two solver shards in
    the second case): hundreds of supervoxels, thousands of lifted edges,
    the watershed and everything after the costs equal."""
    got, manifests = _both(case, tmp_path, jax_run)
    assert len(got["graph/graph.npz/nodes"]) > 100 and len(got["lifted/lifted_problem.npz/edges"]) > 1000
    # the segmentation coarsens the supervoxels: one segment a supervoxel
    ws, seg = got["ws"], got["seg"]
    pairs = np.unique(np.stack([ws.ravel(), seg.ravel()], 1), axis=0)
    assert len(pairs) == len(np.unique(ws)) and 1 < len(np.unique(seg)) < len(pairs)
    assert manifests["solve_lifted_global"]["sharded"] is case.endswith("s2")
