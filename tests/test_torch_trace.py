"""The port's tracer (``runtime/trace.py``) against the JAX package's, and
the spans, instants and fault sites of the reduce tree.

- The tracer: the reference's unit cases (clock-offset merge, torn shards,
  tracer off as a true no-op, the env pin, the ring buffer, percentiles,
  the critical path and overlap) on the port.  Shards written by either
  package merge and summarize identically under the other's ``merge`` and
  ``summarize``.
- A traced build writes ``trace.json`` and ``trace_summary.json``, and
  ``scripts/failures_report.py --json`` and ``scripts/progress.py`` render
  the port's ``tmp_folder``.
- The per-block watershed sweep (32^3, blocks of 16^3) traced through both
  packages gives the same span and instant names with the same count per
  name.  Two names are held out because their count is a matter of timing,
  in both packages: ``executor.batch_wait`` (recorded only when the
  dispatch loop waited over 100 us) and ``chunk_cache.wait`` (only when a
  read found another reader's load of its chunk in flight).  The port's
  own steps inside a phase (``executor.load.read`` / ``.pad``,
  ``executor.store.encode`` / ``.write`` / ``.verify``) and its
  ``executor.lock_wait`` have no counterpart in the reference: they are
  held out of the comparison and counted on the port alone, one a block
  (or a call to the card) each.  The port
  compiles no programs, and the reference emits no compile span either, so
  that is no difference.  The port's ``executor.dispatch`` span carries the
  device time and its ``executor.d2h`` the copy alone (see
  ``runtime/executor.py``): the same names and counts, another split of the
  time.
- The reduce tree: a ``solve`` fault at the task entry degrades to the
  unsharded solve and a ``hop`` fault to the packet plane, each with its
  record and trace instant; the labels equal the reference's packet plane.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import cluster_tools_tpu.native as native
import cluster_tools_tpu_torch.native as pnative
from cluster_tools_tpu.parallel import reduce_tree as jrt
from cluster_tools_tpu.runtime import trace as jtrace
from cluster_tools_tpu.runtime.task import build as j_build
from cluster_tools_tpu.tasks.watershed import WatershedWorkflow as JWS
from cluster_tools_tpu.utils.synthetic import grid_rag
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
from cluster_tools_tpu_torch.ops.contraction import gaec_parallel
from cluster_tools_tpu_torch.parallel import reduce_tree as prt
from cluster_tools_tpu_torch.runtime import faults, trace
from cluster_tools_tpu_torch.runtime.executor import BlockwiseExecutor
from cluster_tools_tpu_torch.runtime.supervision import write_heartbeat
from cluster_tools_tpu_torch.runtime.task import BaseTask, build
from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow as PWS
from cluster_tools_tpu_torch.utils import function_utils as fu
from cluster_tools_tpu_torch.utils.volume_utils import Blocking, file_reader

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("CTT_TRACE", raising=False)
    for t in (trace, jtrace):
        t.reset()
    faults.reset()
    yield
    for t in (trace, jtrace):
        t.reset()
    faults.reset()


def _shard(d, hostname, pid, wall0, mono0, events, dropped=0):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"shard_{hostname}_{pid}.json"), "w") as f:
        json.dump({"version": 1, "pid": pid, "hostname": hostname, "wall0": wall0, "mono0": mono0,
                   "dropped": dropped, "events": events}, f)


def _span(name, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


# -- the tracer ---------------------------------------------------------------------


def test_merge_orders_two_processes_by_their_wall_anchors(tmp_path):
    d = str(tmp_path / "trace")
    _shard(d, "h1", 1, 1000.0, 50000.0, [_span("executor.load", 50000.5, 0.1, block=1)])
    _shard(d, "h2", 2, 1000.2, 7.0, [_span("executor.load", 7.1, 0.1, block=2)])
    doc = trace.merge(d)
    loads = [e for e in doc["traceEvents"] if e.get("name") == "executor.load"]
    assert [e["args"]["block"] for e in loads] == [2, 1]
    assert doc == jtrace.merge(d)


def test_merge_skips_a_torn_shard(tmp_path):
    d = str(tmp_path / "trace")
    _shard(d, "h", 1, 0.0, 0.0, [_span("task.run", 0.0, 1.0, task="t.1", deps=[])])
    with open(os.path.join(d, "shard_h_2.json"), "w") as f:
        f.write('{"version": 1, "events": [')
    assert [e["name"] for e in trace.merge(d)["traceEvents"] if e.get("ph") == "X"] == ["task.run"]


def test_tracer_off_is_a_true_noop(tmp_path):
    assert not trace.enabled()
    s1, s2 = trace.span("executor.load", block=1), trace.span("executor.store", block=2)
    assert s1 is s2
    with s1:
        pass
    trace.instant("fault:load", block=1)
    assert trace.begin("executor.sweep").end() >= 0.0
    assert trace.flush() is None and trace.write_timeline(str(tmp_path)) is None
    assert trace.stats() == {"spans": 0, "instants": 0, "dropped": 0, "flushes": 0}
    assert not os.path.exists(str(tmp_path / "trace.json"))


def test_env_pin_wins_and_a_new_run_repoints(tmp_path, monkeypatch):
    monkeypatch.setenv("CTT_TRACE", str(tmp_path / "pinned"))
    trace.reset()
    trace.set_trace_dir(str(tmp_path / "elsewhere"))
    assert trace.trace_dir() == str(tmp_path / "pinned")
    monkeypatch.setenv("CTT_TRACE", "1")
    trace.reset()
    dir_a, dir_b = str(tmp_path / "a" / "trace"), str(tmp_path / "b" / "trace")
    trace.set_trace_dir(dir_a)
    with trace.span("task.run", task="run_a"):
        pass
    trace.set_trace_dir(dir_b)
    with trace.span("task.run", task="run_b"):
        pass
    trace.flush()
    for d, want in ((dir_a, {"run_a"}), (dir_b, {"run_b"})):
        assert {e["args"]["task"] for e in trace.merge(d)["traceEvents"] if e.get("ph") == "X"} == want


def test_ring_buffer_drops_the_oldest(tmp_path):
    trace.configure(enabled=True, trace_dir=str(tmp_path / "t"), buffer=10)
    for i in range(25):
        with trace.span("s", i=i):
            pass
    assert trace.stats()["spans"] == 10 and trace.stats()["dropped"] == 15
    trace.flush()
    assert trace.merge(str(tmp_path / "t"))["otherData"]["dropped"] == 15


def test_summarize_percentiles_critical_path_and_overlap(tmp_path):
    d = str(tmp_path / "trace")
    events = [_span("executor.load", float(i), 0.010 + 0.001 * i, block=i) for i in range(100)]
    events += [_span("task.run", 200.0, 10.0, task="a.1", deps=[]),
               _span("task.run", 211.0, 5.0, task="b.1", deps=["a.1"]),
               _span("task.run", 211.0, 20.0, task="side.1", deps=[]),
               _span("task.run", 232.0, 2.0, task="c.1", deps=["b.1", "side.1"]),
               _span("executor.sweep", 300.0, 10.0), _span("executor.batch_wait", 301.0, 2.0),
               {"ph": "i", "name": "degraded:unsharded", "ts": 305.0, "dur": 0.0, "tid": 1, "args": {"block": 3}}]
    _shard(d, "h", 1, 1000.0, 0.0, events)
    summary = trace.summarize(trace.merge(d))
    assert summary == jtrace.summarize(jtrace.merge(d))
    site = summary["sites"]["executor.load"]
    assert site["count"] == 100 and site["p50_ms"] == pytest.approx(60.0, abs=2.0)
    assert summary["critical_path"]["tasks"] == ["side.1", "c.1"]
    assert summary["instants"] == {"degraded:unsharded": 1}


def test_walltime_tracks_the_clock():
    import time

    assert abs(trace.walltime() - time.time()) < 1.0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shards_cross_read_between_the_packages(tmp_path, writer):
    """A shard flushed by one package's tracer (real events, task context,
    instants) merges and summarizes the same under both packages."""
    mod = trace if writer == "port" else jtrace
    d = str(tmp_path / "trace")
    mod.configure(enabled=True, trace_dir=d)
    with mod.task_context("ws.1"):
        with mod.span("task.run", task="ws.1", deps=[]):
            for b in range(3):
                with mod.span("executor.load", block=b):
                    pass
            mod.instant("fault:load", block=1)
    mod.flush()
    merged = {m: m.merge(d) for m in (trace, jtrace)}
    assert merged[trace] == merged[jtrace]
    assert trace.summarize(merged[trace]) == jtrace.summarize(merged[jtrace])
    names = [e["name"] for e in merged[trace]["traceEvents"] if e.get("ph") in ("X", "i")]
    # task_context brackets its own task.run span
    assert sorted(names) == ["executor.load"] * 3 + ["fault:load", "task.run", "task.run"]


def test_executor_sweep_emits_its_spans(tmp_path):
    trace.configure(enabled=True, trace_dir=str(tmp_path / "trace"))
    blocks = [Blocking([16, 16, 16], [8, 8, 8]).get_block(i) for i in range(8)]
    store = {}
    with trace.task_context("trace_sweep"):
        BlockwiseExecutor(target="local", io_threads=2, max_retries=1).map_blocks(
            lambda x: x + 1, blocks, lambda b: (np.zeros((8, 8, 8), np.float32),),
            lambda b, out: store.__setitem__(int(b.block_id), out), task_name="trace_sweep", sweep_mode="auto")
    trace.flush()
    sites = trace.write_timeline(str(tmp_path))["sites"]
    assert sites["executor.load"]["count"] == 8 == sites["executor.store"]["count"]
    assert sites["executor.dispatch"]["count"] >= 1 and sites["executor.sweep"]["count"] == 1
    doc = json.load(open(tmp_path / "trace.json"))
    assert all(e["args"]["task"] == "trace_sweep" for e in doc["traceEvents"]
               if e.get("name") in ("executor.load", "executor.store"))


# -- traced builds and the scripts ----------------------------------------------------------


class _Sweep(BaseTask):
    task_name = "traced"

    def run_impl(self):
        blocks = [Blocking([16, 16], [8, 8]).get_block(i) for i in range(4)]
        out = {}
        BlockwiseExecutor(target="local").map_blocks(lambda x: x * 2, blocks, lambda b: (np.ones((8, 8)),),
                                                     lambda b, o: out.__setitem__(int(b.block_id), o),
                                                     failures_path=self.failures_path, task_name=self.uid,
                                                     on_block_done=lambda b: self.log_block_success(b.block_id))
        return {"n": len(out)}


def test_traced_build_writes_the_timeline_and_the_report_renders_it(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("CTT_TRACE", "1")
    trace.reset()
    tmp = str(tmp_path / "tmp")
    faults.configure({"faults": [{"site": "load", "kind": "error", "blocks": [2], "fail_attempts": 1}]})
    assert build([_Sweep(tmp, "")])
    assert os.path.exists(os.path.join(tmp, "trace.json")) and os.path.exists(os.path.join(tmp, "trace_summary.json"))
    summary = json.load(open(os.path.join(tmp, "trace_summary.json")))
    assert summary["sites"]["task.run"]["count"] == 1 and summary["sites"]["task.build"]["count"] == 1
    assert summary["sites"]["executor.load"]["count"] == 4
    sys.path.insert(0, SCRIPTS)
    import failures_report

    rc = failures_report.main(["failures_report.py", "--json", tmp, "--no-lint"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["failures"]["n_records"] == 1
    assert doc["trace"]["sites"]["executor.load"]["count"] == 4
    assert failures_report.main(["failures_report.py", "--trace", tmp]) == 0
    assert "executor.load" in capsys.readouterr().out


def test_progress_script_reads_the_ports_tmp_folder(tmp_path, capsys):
    sys.path.insert(0, SCRIPTS)
    import progress

    d = str(tmp_path)
    fu.log_block_success(d, "a.1", 0)
    fu.atomic_write_json(os.path.join(d, "a.1.success.json"), {"runtime_s": 1.5})
    fu.log_block_success(d, "b.1", 0)
    write_heartbeat(d, "b.1")
    fu.record_failures(os.path.join(d, "failures.json"), "c.1",
                       [{"block_id": 7, "sites": {"store": 3}, "error": "x", "quarantined": True,
                         "resolved": False}])
    states = {t["task"]: t["state"] for t in progress.collect_progress(d, stale_after_s=60.0)["tasks"]}
    assert states == {"a.1": "done", "b.1": "in-flight", "c.1": "failed"}
    assert progress.main(["progress.py", d]) == 1


# -- the watershed sweep's span names against the reference -----------------------------------------

TIMING_DEPENDENT = ("executor.batch_wait", "chunk_cache.wait")
# the port's steps inside a phase and its lock waits, with the phase whose
# count each equals
PORT_ONLY = {"executor.load.read": "executor.load", "executor.load.pad": "executor.load",
             "executor.store.encode": "executor.store", "executor.store.write": "executor.store",
             "executor.store.verify": "executor.store", "executor.lock_wait": "executor.dispatch"}


def _traced_ws(root, side):
    """Span and instant counts per name of a traced per-block watershed
    build, and its labels."""
    wf_cls, build_fn, reader, mod = {"jax": (JWS, j_build, j_reader, jtrace), "port": (PWS, build, file_reader,
                                                                                       trace)}[side]
    d = os.path.join(root, side)
    os.makedirs(os.path.join(d, "cfg"), exist_ok=True)
    with open(os.path.join(d, "cfg", "global.config"), "w") as f:
        json.dump({"block_shape": [16, 16, 16], "sweep_mode": "per_block"}, f)
    path = os.path.join(root, f"{side}.zarr")
    x = ndi.gaussian_filter(np.random.default_rng(0).random((32, 32, 32)), 2.0)
    reader(path).require_dataset("b", shape=(32, 32, 32), chunks=(16, 16, 16), dtype="float32")[...] = \
        ((x - x.min()) / (x.max() - x.min())).astype(np.float32)
    mod.configure(enabled=True)
    wf = wf_cls(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=1, target="local",
                input_path=path, input_key="b", output_path=path, output_key="ws", block_shape=[16, 16, 16],
                halo=[4, 4, 4], threshold=0.5)
    assert build_fn([wf])
    doc = json.load(open(os.path.join(d, "tmp", "trace.json")))
    counts = {}
    for e in doc["traceEvents"]:
        if e.get("ph") in ("X", "i") and e["name"] not in TIMING_DEPENDENT:
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts, np.asarray(reader(path)["ws"][...])


_JAX_SIDE = """
import json, sys
import numpy as np
sys.path.insert(0, {tests!r})
import test_torch_trace as t
counts, labels = t._traced_ws({root!r}, "jax")
np.save({root!r} + "/jax_labels.npy", labels)
print(json.dumps(counts))
"""


def test_watershed_sweep_span_names_and_counts_equal_the_reference(tmp_path, monkeypatch):
    """The reference runs in a process of its own on one JAX device, as the
    port runs on one: its per-block sweep then dispatches once a block."""
    for k, v in (("CT_TIER_MODE", "cond"), ("CT_FILL_MODE", "capacity"), ("CT_SEED_CCL", "tiled")):
        monkeypatch.setenv(k, v)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=REPO)
    env.pop("CTT_TRACE", None)
    code = _JAX_SIDE.format(tests=os.path.join(REPO, "tests"), root=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got, labels = _traced_ws(str(tmp_path), "port")
    np.testing.assert_array_equal(labels, np.load(tmp_path / "jax_labels.npy"))
    own = {name: got.pop(name, 0) for name in PORT_ONLY}
    assert got == want
    assert got["executor.load"] == 8 == got["executor.dispatch"] and got["task.run"] >= 2
    assert own == {name: got[of] for name, of in PORT_ONLY.items()}


# -- the reduce tree's fault sites and trace events ----------------------------------------------------


@pytest.fixture
def python_reference():
    with native.force_python(), pnative.force_python():
        yield


def _problem(g=6, shards=4):
    n, edges, costs = grid_rag(g=g, seed=0)
    pos = np.stack(np.unravel_index(np.arange(n), (g, g, g)), axis=1)
    return n, edges, costs, jrt.morton_node_shards(pos, shards)


def test_solve_fault_degrades_to_the_unsharded_solve(tmp_path, python_reference):
    n, edges, costs, node_shard = _problem()
    expect = gaec_parallel(n, edges, costs, impl="numpy")
    trace.configure(enabled=True, trace_dir=str(tmp_path / "trace"))
    faults.configure({"faults": [{"site": "solve", "kind": "error"}]})
    labels, info = prt.solve_with_reduce_tree(n, edges, costs, node_shard=node_shard, solver_shards=4, fanout=2,
                                              failures_path=str(tmp_path / "failures.json"), task_name="unit_solve",
                                              unsharded=lambda: expect, device="cpu")
    np.testing.assert_array_equal(labels, expect)
    assert info["degraded"] == "unsharded_solve" and "injected solve fault" in info["error"]
    recs = json.load(open(tmp_path / "failures.json"))["records"]
    assert [(r["resolution"], r["sites"]) for r in recs] == [("degraded:unsharded_solve", {"solve": 1})]
    trace.flush()
    assert trace.summarize(trace.merge(str(tmp_path / "trace")))["instants"] == {"degraded:unsharded_solve": 1}


@pytest.mark.parametrize("kind", ["init", "level_error", "level_hang"])
def test_hop_fault_degrades_to_the_packet_plane(tmp_path, python_reference, monkeypatch, kind):
    monkeypatch.setenv("CTT_MESH_SHARDS", "4")
    n, edges, costs, node_shard = _problem(shards=4)
    want, _ = jrt.sharded_solve(n, edges, costs, node_shard, fanout=2, reduce_plane="packet")
    spec = {"init": {"site": "hop", "kind": "error"},
            "level_error": {"site": "hop", "kind": "error", "blocks": [1]},
            "level_hang": {"site": "hop", "kind": "hang", "blocks": [0], "seconds": 1.5}}[kind]
    trace.configure(enabled=True, trace_dir=str(tmp_path / "trace"))
    faults.configure({"faults": [spec]})
    labels, info = prt.sharded_solve(n, edges, costs, node_shard, fanout=2, reduce_plane="collective",
                                     hop_deadline_s=0.5, failures_path=str(tmp_path / "failures.json"),
                                     task_name="plane_solve", device="cpu")
    np.testing.assert_array_equal(labels, want)
    assert info["reduce_plane"] == "host"
    recs = json.load(open(tmp_path / "failures.json"))["records"]
    assert [(r["resolution"], r["sites"]) for r in recs] == [("degraded:packet_plane", {"hop": 1})]
    trace.flush()
    summary = trace.summarize(trace.merge(str(tmp_path / "trace")))
    assert summary["instants"] == {"degraded:packet_plane": 1}
    assert summary["sites"]["solve.level_solve"]["count"] == len(info["levels"])
    assert summary["sites"]["solve.level_merge"]["count"] == len(info["levels"])
    if kind != "init":
        assert summary["sites"]["solve.collective_level"]["count"] >= 1
    # a level program stranded by the deadline finishes on its own thread:
    # let it end before the process may
    for t in threading.enumerate():
        if t.name.startswith("collective-hop-"):
            t.join(timeout=30)
            assert not t.is_alive()
