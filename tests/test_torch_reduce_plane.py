"""The port's collective reduce plane (``CollectiveReducePlane`` and
``ops/contraction.py::lane_frontier_rounds``) and worker-group driver on the
CPU, against the JAX package.

- The collective plane on 4 and 8 CPU sibling shards (``CTT_MESH_SHARDS``)
  equals the reference's packet plane bit for bit, across shard counts,
  modes and thresholds, the k=2 (average-linkage) payload, and ragged and
  zero-edge shards.  The reference's own collective plane cannot run on
  this jax (ROADMAP Queue C fact 3), so the packet plane is the reference.
- ``lane_frontier_rounds`` equals the reference's under
  ``jax.enable_x64(True)``, lane by lane, on random padded lanes.
- The counters (one dispatch and one hop a level), the degrade ladder
  (collectives disabled, the hop deadline, fewer than two shards), the
  auto floor and the env override, the warm re-solve's zero h2d bytes.
- ``_wait_npz``'s three cases, and the two worker-group cases (two
  processes over gloo on the CPU), equal to the reference's packet plane.

The contraction ``impl`` is pinned to ``numpy`` on both sides (each
package's ``native.force_python()``)."""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cluster_tools_tpu.native as native
import cluster_tools_tpu_torch.native as pnative
from cluster_tools_tpu.ops.contraction import lane_frontier_rounds as j_lane
from cluster_tools_tpu.parallel import reduce_tree as jrt
from cluster_tools_tpu.utils.synthetic import grid_rag
from cluster_tools_tpu_torch.ops import contraction as pcon
from cluster_tools_tpu_torch.parallel import device_pool
from cluster_tools_tpu_torch.parallel import reduce_tree as prt

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _python_reference():
    with native.force_python(), pnative.force_python():
        yield


@pytest.fixture
def shards(monkeypatch):
    def set_shards(n):
        monkeypatch.setenv("CTT_MESH_SHARDS", str(n))

    set_shards(8)
    return set_shards


def _grid_problem(g=8, seed=0, shards=4):
    n, edges, costs = grid_rag(g=g, seed=seed)
    pos = np.stack(np.unravel_index(np.arange(n), (g, g, g)), axis=1)
    return n, edges, costs, jrt.morton_node_shards(pos, shards)


def _reference(n, edges, payload, node_shard, **kw):
    labels, _ = jrt.sharded_solve(n, edges, payload, node_shard, fanout=kw.pop("fanout", 2), reduce_plane="packet",
                                  **kw)
    return labels


def _port(plane, n, edges, payload, node_shard, tmp_path=None, **kw):
    kw.setdefault("fanout", 2)
    if tmp_path is not None:
        kw.update(failures_path=str(tmp_path / "failures.json"), task_name="plane_solve")
    return prt.sharded_solve(n, edges, payload, node_shard, reduce_plane=plane, device="cpu", **kw)


# -- the collective plane against the reference's packet plane ----------------------


@pytest.mark.parametrize("mesh_shards", [4, 8])
@pytest.mark.parametrize("tree_shards,mode,threshold", [(2, "max", 0.0), (4, "max", 0.0), (8, "max", 0.0),
                                                        (4, "min", 0.5), (8, "max", 0.3)])
def test_collective_equals_the_reference_packet_plane(shards, mesh_shards, tree_shards, mode, threshold):
    shards(mesh_shards)
    n, edges, costs, node_shard = _grid_problem(g=8, seed=tree_shards, shards=tree_shards)
    if mode == "min":
        costs = np.abs(costs)
    want = _reference(n, edges, costs, node_shard, mode=mode, threshold=threshold)
    snap = prt.solve_snapshot()
    got, info = _port("collective", n, edges, costs, node_shard, mode=mode, threshold=threshold)
    np.testing.assert_array_equal(got, want)
    assert info["reduce_plane"] == "collective"
    assert all(lv["plane"] == "collective" for lv in info["levels"])
    d = prt.solve_delta(snap)
    assert d["collective_hops"] == len(info["levels"]) and d["packet_fallbacks"] == 0
    assert d["bytes_over_interconnect"] > 0


@pytest.mark.parametrize("mesh_shards", [4, 8])
@pytest.mark.parametrize("fanout", [2, 4])
def test_collective_equals_the_reference_average_linkage_payload(shards, mesh_shards, fanout):
    """k=2 payload ((w * size, size), the agglomerative task's contract)."""
    shards(mesh_shards)
    n, edges, costs, node_shard = _grid_problem(g=8, seed=3, shards=8)
    sizes = np.random.default_rng(5).integers(1, 20, len(edges)).astype(np.float64)
    payload = np.stack([np.abs(costs) * sizes, sizes], axis=1)
    want = _reference(n, edges, payload, node_shard, mode="min", threshold=0.5, fanout=fanout)
    got, info = _port("collective", n, edges, payload, node_shard, mode="min", threshold=0.5, fanout=fanout)
    np.testing.assert_array_equal(got, want)
    assert info["reduce_plane"] == "collective"


@pytest.mark.parametrize("mesh_shards", [4, 8])
def test_collective_equals_the_reference_ragged_and_zero_edge_shards(shards, mesh_shards):
    """One fat shard, skinny siblings and a shard with no edge at all."""
    shards(mesh_shards)
    n = 40
    rs = np.random.default_rng(7)
    u = np.arange(0, 29)
    extra_u, extra_v = rs.integers(0, 10, size=25), rs.integers(10, 20, size=25)
    edges = np.stack([np.concatenate([u, extra_u]), np.concatenate([u + 1, extra_v])], axis=1).astype(np.int64)
    edges = edges[edges[:, 0] != edges[:, 1]]
    costs = rs.random(len(edges))
    node_shard = prt.contiguous_node_shards(n, 4)
    want = _reference(n, edges, costs, node_shard)
    got, info = _port("collective", n, edges, costs, node_shard)
    np.testing.assert_array_equal(got, want)
    assert info["reduce_plane"] == "collective"
    assert len(set(got[30:40].tolist())) == 10


# -- the lane program against the reference's ----------------------------------------


def _random_lane(rng, n_pad, we, wf, k):
    n_mem = int(rng.integers(2, n_pad))
    m, fm = int(rng.integers(0, we)), int(rng.integers(0, wf))
    u, v = np.full(we, n_pad, np.int64), np.full(we, n_pad, np.int64)
    pay, fn, fg, fp = np.zeros((we, k)), np.full(wf, n_pad, np.int64), np.zeros(wf, np.int64), np.zeros((wf, k))
    u[:m], v[:m] = rng.integers(0, n_mem, m), rng.integers(0, n_mem, m)
    fn[:fm], fg[:fm] = rng.integers(0, n_mem, fm), rng.integers(0, 3 * n_mem, fm)
    for p, c in ((pay, m), (fp, fm)):
        if k == 1:
            p[:c, 0] = rng.normal(0.2, 1.0, c)
        else:
            p[:c, 1] = rng.integers(1, 6, c)
            p[:c, 0] = rng.random(c) * p[:c, 1]
    return u, v, pay, fn, fg, fp


@pytest.mark.parametrize("k,mode,threshold", [(1, "max", 0.0), (1, "max", 0.4), (2, "min", 0.5)])
def test_lane_frontier_rounds_equals_the_reference_under_x64(k, mode, threshold):
    rng = np.random.default_rng(k + int(10 * threshold))
    progs = {}
    # the last shape's lanes outgrow their first rounds: the capacities are
    # cut down as the live rows shrink
    shapes = ((64, 128, 128), (128, 256, 128), (128, 1024, 512))
    for trial in range(9):
        n_pad, we, wf = shapes[trial % 3]
        args = _random_lane(rng, n_pad, we, wf, k)
        with jax.enable_x64(True):
            if n_pad not in progs:
                progs[n_pad] = jax.jit(lambda *a, _n=n_pad: j_lane(*a, threshold, n_pad=_n, mode=mode, k=k))
            jl, jr = progs[n_pad](*[jnp.asarray(a) for a in args])
            jl, jr = np.asarray(jl), int(jr)
        pl, pr = pcon.lane_frontier_rounds(*[torch.from_numpy(a) for a in args], threshold, n_pad=n_pad, mode=mode,
                                           k=k)
        np.testing.assert_array_equal(pl.numpy(), jl, err_msg=f"trial {trial}")
        assert pr == jr, trial


def test_lane_frontier_rounds_stops_at_a_round_boundary():
    args = _random_lane(np.random.default_rng(0), 64, 128, 128, 1)
    with pytest.raises(RuntimeError, match="round boundary"):
        pcon.lane_frontier_rounds(*[torch.from_numpy(a) for a in args], 0.0, n_pad=64, mode="max", k=1,
                                  stop=lambda: True)


# -- the counters ----------------------------------------------------------------------


def test_collective_counters_one_dispatch_per_level(shards):
    n, edges, costs, node_shard = _grid_problem(g=8, seed=0, shards=8)
    snap = prt.solve_snapshot()
    lab_h, _ = _port("packet", n, edges, costs, node_shard)
    host = prt.solve_delta(snap)
    snap = prt.solve_snapshot()
    lab_c, info = _port("collective", n, edges, costs, node_shard)
    coll = prt.solve_delta(snap)
    np.testing.assert_array_equal(lab_c, lab_h)
    levels = len(info["levels"])
    assert coll["contraction_dispatches"] == levels and coll["collective_hops"] == levels
    assert host["collective_hops"] == 0 and host["contraction_dispatches"] >= 2 * levels
    # a lane of r rounds reads the host r + 1 times, plus one read a level
    assert coll["host_syncs"] > coll["tree_rounds"] >= host["tree_rounds"] - host["contraction_dispatches"]


def test_collective_warm_resolve_sends_no_bytes(shards):
    device_pool.reset()
    n, edges, costs, node_shard = _grid_problem(g=8, seed=1, shards=8)
    snap = device_pool.snapshot()
    cold, _ = _port("collective", n, edges, costs, node_shard)
    d_cold = device_pool.delta(snap)
    snap = device_pool.snapshot()
    warm, _ = _port("collective", n, edges, costs, node_shard)
    d_warm = device_pool.delta(snap)
    np.testing.assert_array_equal(warm, cold)
    assert d_cold["h2d_bytes"] > 0 and d_warm["h2d_bytes"] == 0 and d_warm["device_pool_hits"] > 0
    device_pool.reset()


# -- the degrade ladder ----------------------------------------------------------------


def _records(tmp_path):
    return json.loads((tmp_path / "failures.json").read_text())["records"]


def test_collectives_disabled_env_is_the_fallback_arm(shards, tmp_path, monkeypatch):
    n, edges, costs, node_shard = _grid_problem(g=6, shards=2)
    expect = _reference(n, edges, costs, node_shard)
    monkeypatch.setenv("CT_COLLECTIVES_DISABLED", "1")
    snap = prt.solve_snapshot()
    labels, info = _port("collective", n, edges, costs, node_shard, tmp_path=tmp_path)
    np.testing.assert_array_equal(labels, expect)
    assert info["reduce_plane"] == "host"
    d = prt.solve_delta(snap)
    assert d["packet_fallbacks"] == 1 and d["collective_hops"] == 0
    recs = [r for r in _records(tmp_path) if r["task"] == "plane_solve"]
    assert [(r["resolution"], r["resolved"], r["sites"]) for r in recs] == [("degraded:packet_plane", True,
                                                                             {"hop": 1})]


def test_one_sibling_shard_is_an_init_refusal(tmp_path, monkeypatch):
    monkeypatch.delenv("CTT_MESH_SHARDS", raising=False)
    n, edges, costs, node_shard = _grid_problem(g=6, shards=4)
    labels, info = _port("collective", n, edges, costs, node_shard, tmp_path=tmp_path)
    np.testing.assert_array_equal(labels, _reference(n, edges, costs, node_shard))
    assert info["reduce_plane"] == "host"
    assert any(r["resolution"] == "degraded:packet_plane" for r in _records(tmp_path))


def test_hop_deadline_degrades_mid_solve(shards, tmp_path, monkeypatch):
    """A level program that outlives the hop deadline: the level and every
    later one re-solve on the host; the stranded program stops at its next
    round boundary, and the plane works again after it."""
    n, edges, costs, node_shard = _grid_problem(g=6, shards=4)
    expect = _reference(n, edges, costs, node_shard)
    real = pcon.lane_frontier_rounds

    def slow(*a, **kw):
        time.sleep(0.5)
        return real(*a, **kw)

    monkeypatch.setattr(pcon, "lane_frontier_rounds", slow)
    snap = prt.solve_snapshot()
    labels, info = _port("collective", n, edges, costs, node_shard, tmp_path=tmp_path, hop_deadline_s=0.2)
    np.testing.assert_array_equal(labels, expect)
    assert info["reduce_plane"] == "host" and "hop deadline" in info["degraded_plane"]
    assert all(lv["plane"] == "host" for lv in info["levels"])
    assert prt.solve_delta(snap)["packet_fallbacks"] == 1
    assert any(r["resolution"] == "degraded:packet_plane" for r in _records(tmp_path))
    monkeypatch.setattr(pcon, "lane_frontier_rounds", real)
    time.sleep(1.0)  # the stranded level program ends and frees the pool
    labels, info = _port("collective", n, edges, costs, node_shard)
    np.testing.assert_array_equal(labels, expect)
    assert info["reduce_plane"] == "collective"


def test_auto_plane_floor_and_override(shards, tmp_path, monkeypatch):
    n, edges, costs, node_shard = _grid_problem(g=6, shards=4)
    snap = prt.solve_snapshot()
    labels_h, info = _port("auto", n, edges, costs, node_shard, tmp_path=tmp_path)
    assert info["reduce_plane"] == "host"
    d = prt.solve_delta(snap)
    assert d["packet_fallbacks"] == 0 and d["collective_hops"] == 0
    assert not (tmp_path / "failures.json").exists()
    monkeypatch.setenv("CT_REDUCE_PLANE_MIN_EDGES", "1")
    snap = prt.solve_snapshot()
    labels_c, info = _port("auto", n, edges, costs, node_shard, tmp_path=tmp_path)
    assert info["reduce_plane"] == "collective"
    assert prt.solve_delta(snap)["collective_hops"] == len(info["levels"])
    np.testing.assert_array_equal(labels_h, labels_c)
    np.testing.assert_array_equal(labels_c, _reference(n, edges, costs, node_shard))


def test_env_plane_override_wins(shards, monkeypatch):
    n, edges, costs, node_shard = _grid_problem(g=6, shards=2)
    monkeypatch.setenv("CT_REDUCE_PLANE", "packet")
    snap = prt.solve_snapshot()
    _, info = _port("collective", n, edges, costs, node_shard)
    assert info["reduce_plane"] == "host"
    assert prt.solve_delta(snap)["packet_fallbacks"] == 0
    monkeypatch.setenv("CT_REDUCE_PLANE", "bogus")
    with pytest.raises(ValueError):
        _port("auto", n, edges, costs, node_shard)


# -- the packet plane's fast paths (_wait_npz) -------------------------------------------


def test_wait_npz_dead_publisher_fails_in_a_quarter_second(tmp_path):
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    pid_path = tmp_path / "worker_0.json"
    pid_path.write_text(json.dumps({"os_pid": proc.pid}))
    t0 = time.monotonic()
    with pytest.raises(prt.ShardedSolveError, match=f"{proc.pid}.*is dead"):
        prt._wait_npz(str(tmp_path / "packet_l0_g0.npz"), 30.0, owner_pid_path=str(pid_path))
    assert time.monotonic() - t0 < 5.0


def test_wait_npz_level_deadline_caps_total_wait(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(prt.ShardedSolveError, match="level deadline"):
        prt._wait_npz(str(tmp_path / "packet_l0_g0.npz"), 30.0, deadline=time.monotonic() + 0.3)
    assert time.monotonic() - t0 < 5.0


def test_wait_npz_live_unprobeable_pid_keeps_waiting(tmp_path):
    pid_path = tmp_path / "worker_0.json"
    pid_path.write_text(json.dumps({"os_pid": 1}))  # init: alive, EPERM
    with pytest.raises(prt.ShardedSolveError, match="did not arrive"):
        prt._wait_npz(str(tmp_path / "packet_l0_g0.npz"), 0.6, owner_pid_path=str(pid_path))


# -- the worker group (two processes, gloo on the CPU) -----------------------------------


def _worker_problem(seed):
    g, n_shards = 10, 4
    n, edges, costs = grid_rag(g=g, seed=seed)
    pos = np.stack(np.unravel_index(np.arange(n), (g, g, g)), axis=1)
    return n, edges, costs, jrt.morton_node_shards(pos, n_shards)


@pytest.mark.parametrize("plane", ["packet", "auto"])
def test_worker_group_equals_the_reference(tmp_path, plane):
    """Two workers: on the packet plane they exchange npz packets; under
    ``auto`` each probes the group's collectives once (gloo runs them) and
    the group solves each level as one program over the pod's sibling
    mesh.  Labels equal the reference's packet plane either way."""
    n, edges, costs, node_shard = _worker_problem(1)
    want = _reference(n, edges, costs, node_shard)
    labels, info = prt.solve_over_workers(n, edges, costs, node_shard, fanout=2, n_workers=2,
                                          scratch_dir=str(tmp_path / "hops"), timeout=240, reduce_plane=plane,
                                          device="cpu")
    np.testing.assert_array_equal(labels, want)
    assert info["reduce_plane"] == ("packet" if plane == "packet" else "collective"), info["plane_reason"]
    assert info["workers"] == 2 and info["boundary_edges_root"] > 0


def test_worker_group_demanded_collective_rides_the_ladder(tmp_path, monkeypatch):
    """Demanded collective through the task entry point with a worker group
    whose collectives are switched off: the group degrades to the packet
    plane once, driver-side, with a ``degraded:packet_plane`` record, and
    the labels equal the reference's."""
    n, edges, costs, node_shard = _worker_problem(2)
    want = _reference(n, edges, costs, node_shard)
    monkeypatch.setenv("CT_COLLECTIVES_DISABLED", "1")
    labels, info = prt.solve_with_reduce_tree(n, edges, costs, node_shard=node_shard, solver_shards=4, fanout=2,
                                              reduce_plane="collective", failures_path=str(tmp_path / "f.json"),
                                              task_name="worker_ladder", unsharded=lambda: want, workers=2,
                                              scratch_dir=str(tmp_path / "hops"), worker_timeout=240, device="cpu")
    np.testing.assert_array_equal(labels, want)
    assert info["reduce_plane"] == "packet" and "force-disabled" in info["plane_reason"]
    recs = json.loads((tmp_path / "f.json").read_text())["records"]
    assert [r["resolution"] for r in recs if r["task"] == "worker_ladder"] == ["degraded:packet_plane"]
    assert "degraded" not in info
