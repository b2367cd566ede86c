"""The port's reduce tree (``cluster_tools_tpu_torch/parallel/reduce_tree.py``)
against the JAX package's, on the CPU: the scenarios of
``tests/test_reduce_tree.py`` (topology, Morton and contiguous partitions,
frontier contraction, the in-process sharded solve in max and min mode
across pool widths, the degenerate single shard, the degrade ladder through
a raising partition thunk, the counters, lifted edges carried through
the tree), each on the same numpy inputs
through both packages, with the contraction ``impl`` pinned to ``numpy`` on
both sides (each package under its ``native.force_python()``).  Labels and
integer counters are compared bit for bit; the only tolerance is the
reference's own 0.1% energy gap to the single-host solve."""

import json

import numpy as np
import pytest

import cluster_tools_tpu.native as native
import cluster_tools_tpu_torch.native as pnative
from cluster_tools_tpu.ops.contraction import gaec_parallel as j_gaec_parallel
from cluster_tools_tpu.parallel import reduce_tree as jrt
from cluster_tools_tpu.utils.synthetic import grid_rag
from cluster_tools_tpu_torch.ops.contraction import gaec_parallel
from cluster_tools_tpu_torch.ops.multicut import multicut_energy
from cluster_tools_tpu_torch.parallel import reduce_tree as prt

#: the counters both packages keep (the port adds ``host_syncs``)
COUNTERS = ("sharded_solves", "unsharded_fallbacks", "solve_shards", "solve_levels", "tree_rounds",
            "boundary_edges_in", "boundary_edges_out", "collective_hops", "packet_fallbacks",
            "contraction_dispatches")


@pytest.fixture(autouse=True)
def _python_reference():
    with native.force_python(), pnative.force_python():
        yield


def _grid_problem(g=10, seed=0, shards=4):
    n, edges, costs = grid_rag(g=g, seed=seed)
    pos = np.stack(np.unravel_index(np.arange(n), (g, g, g)), axis=1)
    return n, edges, costs, jrt.morton_node_shards(pos, shards)


def _both(fn_name, *args, **kw):
    """``(reference, port, reference counter delta, port counter delta)``
    of one reduce-tree function on the same inputs."""
    js, ps = jrt.solve_snapshot(), prt.solve_snapshot()
    j = getattr(jrt, fn_name)(*args, **kw)
    jd = jrt.solve_delta(js)
    p = getattr(prt, fn_name)(*args, device="cpu", **kw) if fn_name == "sharded_solve" else \
        getattr(prt, fn_name)(*args, **kw)
    pd = prt.solve_delta(ps)
    return j, p, jd, pd


def _same_counters(jd, pd):
    assert {k: jd[k] for k in COUNTERS} == {k: pd[k] for k in COUNTERS}


# -- topology ----------------------------------------------------------------------


@pytest.mark.parametrize("n_shards,fanout", [(8, 2), (5, 3), (1, 2), (7, 2), (16, 4)])
def test_tree_levels_equal_the_reference(n_shards, fanout):
    assert prt.reduce_tree_levels(n_shards, fanout) == jrt.reduce_tree_levels(n_shards, fanout)


def test_tree_levels_shapes_and_refusals():
    assert [len(level) for level in prt.reduce_tree_levels(8, 2)] == [8, 4, 2, 1]
    assert prt.reduce_tree_levels(5, 3)[1] == [(0, 1, 2), (3, 4)]
    assert prt.reduce_tree_levels(1, 2) == [[(0,)]]
    for bad in ((0, 2), (4, 1)):
        with pytest.raises(ValueError):
            prt.reduce_tree_levels(*bad)


# -- partitions --------------------------------------------------------------------


def test_morton_shards_are_octant_contiguous():
    g = 8
    pos = np.stack(np.unravel_index(np.arange(g ** 3), (g, g, g)), axis=1)
    shards = prt.morton_node_shards(pos, 8)
    np.testing.assert_array_equal(shards, jrt.morton_node_shards(pos, 8))
    np.testing.assert_array_equal(prt.morton_argsort(pos), jrt.morton_argsort(pos))
    assert (np.bincount(shards) == g ** 3 // 8).all()
    corner = (pos < 4).all(axis=1)
    assert len(set(shards[corner].tolist())) == 1


def test_morton_shards_on_a_ragged_grid():
    pos = np.random.default_rng(3).integers(0, 11, (300, 3))
    for k in (1, 3, 7):
        np.testing.assert_array_equal(prt.morton_node_shards(pos, k), jrt.morton_node_shards(pos, k))


@pytest.mark.parametrize("n,k", [(10, 3), (2, 8), (0, 4), (1000, 7)])
def test_contiguous_shards_equal_the_reference(n, k):
    s = prt.contiguous_node_shards(n, k)
    np.testing.assert_array_equal(s, jrt.contiguous_node_shards(n, k))
    assert (np.diff(s) >= 0).all()


# -- frontier contraction ----------------------------------------------------------


def test_frontier_contraction_defers_boundary_best_nodes():
    edges = np.array([[0, 1]], np.int64)
    payload = np.array([[1.0]])
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros((0, 1)))
    lab = prt.frontier_contraction(2, edges, payload, *empty)
    assert lab[0] == lab[1]
    lab = prt.frontier_contraction(2, edges, payload, np.array([1]), np.array([7]), np.array([[5.0]]))
    assert lab[0] != lab[1]


@pytest.mark.parametrize("mode,thr,k", [("max", 0.0, 1), ("min", 0.4, 2)])
def test_frontier_contraction_equals_the_reference(mode, thr, k):
    rng = np.random.default_rng(11)
    n = 60
    edges = rng.integers(0, n, (400, 2))
    payload = rng.normal(size=(400, 1)) if k == 1 else np.stack([rng.random(400), np.ones(400)], 1)
    f_node, f_ghost = rng.integers(0, n, 90), rng.integers(0, 30, 90)
    f_pay = rng.normal(size=(90, 1)) if k == 1 else np.stack([rng.random(90), np.ones(90)], 1)
    args = (n, edges, payload, f_node, f_ghost, f_pay)
    j, p, jd, pd = _both("frontier_contraction", *args, mode=mode, threshold=thr)
    np.testing.assert_array_equal(p, j)
    assert pd["tree_rounds"] == jd["tree_rounds"] > 0


# -- the in-process sharded solve ---------------------------------------------------


def test_sharded_solve_matches_single_host_energy_within_0p1pct():
    n, edges, costs, node_shard = _grid_problem(g=12, shards=4)
    (lj, ij), (lp, ip), jd, pd = _both("sharded_solve", n, edges, costs, node_shard, fanout=2)
    np.testing.assert_array_equal(lp, lj)
    _same_counters(jd, pd)
    lab_single = gaec_parallel(n, edges, costs, impl="numpy")
    np.testing.assert_array_equal(lab_single, j_gaec_parallel(n, edges, costs, impl="numpy"))
    e_single, e_tree = multicut_energy(edges, costs, lab_single), multicut_energy(edges, costs, lp)
    assert abs(e_tree - e_single) / abs(e_single) <= 1e-3
    assert ip["sharded"] and ip["shards"] == 4 and ip["reduce_plane"] == "host"
    strip = ("solve_s", "merge_s")
    assert [{k: v for k, v in lv.items() if k not in strip} for lv in ip["levels"]] == \
        [{k: v for k, v in lv.items() if k not in strip} for lv in ij["levels"]]
    assert ip["boundary_edges_root"] == ij["boundary_edges_root"]


@pytest.mark.parametrize("max_workers", [1, 4])
def test_sharded_solve_deterministic_across_pool_widths(max_workers):
    n, edges, costs, node_shard = _grid_problem(g=10, shards=4)
    (lj, _), (lp, _), _, _ = _both("sharded_solve", n, edges, costs, node_shard, max_workers=max_workers)
    np.testing.assert_array_equal(lp, lj)
    again, _ = prt.sharded_solve(n, edges, costs, node_shard, max_workers=1, device="cpu")
    np.testing.assert_array_equal(again, lp)


@pytest.mark.parametrize("fanout", [2, 3])
def test_sharded_solve_average_linkage_mode(fanout):
    rng = np.random.default_rng(3)
    n, edges, _ = grid_rag(g=8, seed=3)
    probs, sizes = rng.random(len(edges)), rng.integers(1, 9, len(edges)).astype(np.float64)
    payload = np.stack([probs * sizes, sizes], axis=1)
    node_shard = prt.contiguous_node_shards(n, 5)
    (lj, _), (lp, _), jd, pd = _both("sharded_solve", n, edges, payload, node_shard, mode="min", threshold=0.3,
                                     fanout=fanout)
    np.testing.assert_array_equal(lp, lj)
    _same_counters(jd, pd)


def test_sharded_solve_refuses_lifted_edges():
    """Lifted edges ride the tree (none is refused any more): a strong
    lifted repulsion between the grid's far corners, solved on the packet
    plane, gives the reference's labels and counters and cuts the pair."""
    n, edges, costs, node_shard = _grid_problem(g=6, shards=2)
    lifted = dict(lifted_edges=np.array([[0, n - 1]]), lifted_payload=np.array([-1e4]))
    (lj, _), (lp, info), jd, pd = _both("sharded_solve", n, edges, costs, node_shard, **lifted)
    np.testing.assert_array_equal(lp, lj)
    _same_counters(jd, pd)
    assert info["reduce_plane"] == "host" and lp[0] != lp[n - 1]


def test_tree_rounds_counted_for_frontier_solves():
    n, edges, costs, node_shard = _grid_problem(g=10, shards=4)
    _, _, jd, pd = _both("sharded_solve", n, edges, costs, node_shard)
    _same_counters(jd, pd)
    assert pd["tree_rounds"] > 0 and pd["sharded_solves"] == 1 and pd["solve_shards"] == 4
    assert pd["boundary_edges_in"] == len(edges) and 0 < pd["boundary_edges_out"] < len(edges)


# -- the attributed entry point ------------------------------------------------------


def _entry(mod, tmp_path, tag, **over):
    kw = dict(solver_shards=4, fanout=2, failures_path=str(tmp_path / f"{tag}.json"), task_name="unit_solve")
    if mod is prt:
        kw["device"] = "cpu"
    kw.update(over)
    return kw


def test_solve_entry_degenerate_single_shard_is_exact():
    n, edges, costs, node_shard = _grid_problem(g=6, shards=2)
    expect = gaec_parallel(n, edges, costs, impl="numpy")
    labels, info = prt.solve_with_reduce_tree(n, edges, costs, node_shard=node_shard, solver_shards=1, fanout=2,
                                              failures_path="/nonexistent/failures.json", task_name="unit",
                                              unsharded=lambda: expect, device="cpu")
    assert info == {"sharded": False, "shards": 1}
    assert labels is expect


def test_solve_entry_resolves_partition_thunk_inside_ladder(tmp_path):
    n, edges, costs, node_shard = _grid_problem(g=6, shards=2)
    expect = gaec_parallel(n, edges, costs, impl="numpy")

    def boom():
        raise OSError("ws store unreachable at solve time")

    docs = {}
    for tag, mod in (("jax", jrt), ("port", prt)):
        snap = mod.solve_snapshot()
        labels, info = mod.solve_with_reduce_tree(n, edges, costs, node_shard=boom,
                                                  **_entry(mod, tmp_path, tag, unsharded=lambda: expect))
        np.testing.assert_array_equal(labels, expect)
        assert info["degraded"] == "unsharded_solve"
        assert mod.solve_delta(snap)["unsharded_fallbacks"] == 1
        recs = json.loads((tmp_path / f"{tag}.json").read_text())["records"]
        docs[tag] = [(r["task"], r["resolution"], r["resolved"], r["sites"]) for r in recs]
    assert docs["port"] == docs["jax"] == [("unit_solve", "degraded:unsharded_solve", True, {"solve": 1})]
    # a thunk resolving to None is not a failure: no record, no fallback
    snap = prt.solve_snapshot()
    labels, info = prt.solve_with_reduce_tree(n, edges, costs, node_shard=lambda: None,
                                              **_entry(prt, tmp_path, "none", unsharded=lambda: expect))
    assert info == {"sharded": False, "shards": 1} and labels is expect
    assert prt.solve_delta(snap)["unsharded_fallbacks"] == 0
    assert not (tmp_path / "none.json").exists()
    # a working thunk runs the sharded path, equal to the reference's
    got = {}
    for tag, mod in (("jax", jrt), ("port", prt)):
        labels, info = mod.solve_with_reduce_tree(n, edges, costs, node_shard=lambda: node_shard,
                                                  **_entry(mod, tmp_path, tag, unsharded=lambda: expect,
                                                           solver_shards=2))
        assert info["sharded"] is True and info["shards"] == 2
        got[tag] = labels
    np.testing.assert_array_equal(got["port"], got["jax"])


def test_solve_entry_degrades_when_worker_group_cannot_form(tmp_path):
    n, edges, costs, node_shard = _grid_problem(g=6, shards=2)
    expect = gaec_parallel(n, edges, costs, impl="numpy")
    labels, info = prt.solve_with_reduce_tree(n, edges, costs, node_shard=node_shard,
                                              **_entry(prt, tmp_path, "w", unsharded=lambda: expect, workers=2,
                                                       scratch_dir=None))
    np.testing.assert_array_equal(labels, expect)
    assert info["degraded"] == "unsharded_solve"


def test_solve_entry_degrades_lifted_edges_to_the_unsharded_solve(tmp_path):
    """The attributed entry point with lifted edges no longer degrades: it
    solves sharded on the packet plane, with the reference's labels, and
    records nothing."""
    n, edges, costs, node_shard = _grid_problem(g=6, shards=2)
    expect = gaec_parallel(n, edges, costs, impl="numpy")
    got = {}
    for tag, mod in (("jax", jrt), ("port", prt)):
        labels, info = mod.solve_with_reduce_tree(n, edges, costs, node_shard=node_shard,
                                                  lifted_edges=np.array([[0, n - 1]]),
                                                  lifted_payload=np.array([-1e4]),
                                                  **_entry(mod, tmp_path, tag, unsharded=lambda: expect))
        assert info["sharded"] is True and "degraded" not in info, info
        assert not (tmp_path / f"{tag}.json").exists()
        got[tag] = labels
    np.testing.assert_array_equal(got["port"], got["jax"])
    assert got["port"][0] != got["port"][n - 1]
