"""The port's tracer joined to ``torch.profiler`` (``runtime/trace.py``), on
the CPU: what is mirrored into a running profile and under which name, the
executor's worker threads recording into it, the thread CPU of the phase
spans, and the ring keeping every run of a window.

- Tracing off: ``span`` and ``phase`` are the shared null object, nothing
  reaches the profiler, the counters stay zero.
- Under a CPU ``torch.profiler``: an executor phase span opens a
  function-scope record (not a user annotation) under its phase's name, a
  step inside a phase under the phase's name; plain spans (``task.run``,
  ``task.build``, ``executor.sweep``) are not mirrored.
- A task of the executor's pools records its phases and torch ops into the
  profile under its own thread id, where the thread-state helper is built,
  and one captured state serves many threads at once; these skip with the
  helper's reason where it is not built.
- Three traced runs of the workflow cell's ``tiny`` configuration leave
  every run's spans in the ring and each run's alone in its shard.
"""

import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cluster_tools_tpu_torch.runtime import trace
from cluster_tools_tpu_torch.runtime.executor import BlockwiseExecutor
from cluster_tools_tpu_torch.utils.volume_utils import Blocking

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the profiler's scope of an aten op, and of a mirrored span
FUNCTION_SCOPE = int(torch._C._profiler.RecordScope.FUNCTION.value)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("CTT_TRACE", raising=False)
    trace.reset()
    yield
    trace.reset()


def _profiled(body):
    """``body()`` under a CPU ``torch.profiler``: ``[(name, scope, user
    annotation, thread)]`` of the host events it recorded."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        body()
    return [(e.name(), int(e.scope()), bool(e.is_user_annotation()), int(e.start_thread_id()))
            for e in prof.profiler.kineto_results.events()]


def test_tracer_off_is_the_null_span_and_reaches_no_profiler(monkeypatch):
    assert not trace.enabled()

    def no_record(name):
        raise AssertionError(f"a profiler record was opened for {name} with the tracer off")

    monkeypatch.setattr(trace, "_open_record", no_record)
    events = []

    def body():
        spans = [trace.span("executor.load", block=1), trace.phase("executor.store", block=2),
                 trace.phase("executor.store.write")]
        assert all(s is spans[0] for s in spans)
        for s in spans:
            with s:
                pass
        assert trace.begin("executor.batch_wait", phase=True).end() >= 0.0
        assert trace.capture_thread_state() is None
        with trace.thread_state(None):
            events.append(torch.ones(2).sum())

    names = {name for name, *_ in _profiled(body)}
    assert not {n for n in names if n.startswith("executor.")}
    assert trace.stats() == {"spans": 0, "instants": 0, "dropped": 0, "flushes": 0}


def test_phase_spans_are_mirrored_as_function_scope_under_their_phase(tmp_path):
    trace.configure(enabled=True, trace_dir=str(tmp_path / "t"))

    def body():
        with trace.phase("executor.load", block=1):
            with trace.phase("executor.load.read", block=1):
                torch.ones(4).add_(1)
        with trace.phase("executor.dispatch", n_blocks=1):
            pass
        with trace.span("executor.d2h", n_blocks=1):
            pass
        with trace.phase("executor.store.write", block=1):
            pass
        trace.begin("executor.batch_wait", phase=True, batch=0).end()
        trace.begin("executor.lock_wait", phase=True, lock="dispatch").end()

    events = _profiled(body)
    mirrored = [(n, scope, user) for n, scope, user, _ in events if n.startswith("executor.")]
    # a step inside a phase is mirrored under the phase's name
    assert sorted(n for n, *_ in mirrored) == ["executor.batch_wait", "executor.dispatch", "executor.load",
                                                "executor.load", "executor.lock_wait", "executor.store"]
    assert all(scope == FUNCTION_SCOPE and not user for _, scope, user in mirrored)
    # the tracer's own ring keeps the full names
    ring = sorted(e["name"] for e in trace._get().snapshot_events())
    assert ring == ["executor.batch_wait", "executor.d2h", "executor.dispatch", "executor.load",
                    "executor.load.read", "executor.lock_wait", "executor.store.write"]


def test_sweep_and_task_spans_are_not_mirrored(tmp_path):
    trace.configure(enabled=True, trace_dir=str(tmp_path / "t"))
    assert trace.mirror_name("executor.store.verify") == "executor.store"
    assert trace.mirror_name("executor.lock_wait") == "executor.lock_wait"

    def body():
        with trace.span("task.build"), trace.span("task.run", task="t.1"):
            sweep = trace.begin("executor.sweep", task="t.1")
            with trace.span("executor.sweep"), trace.phase("executor.h2d", nbytes=8):
                pass
            sweep.end()

    names = [n for n, *_ in _profiled(body)]
    assert names.count("executor.h2d") == 1
    assert not {"task.run", "task.build", "executor.sweep"} & set(names)
    assert sorted(e["name"] for e in trace._get().snapshot_events()) == [
        "executor.h2d", "executor.sweep", "executor.sweep", "task.build", "task.run"]


def test_phase_spans_carry_their_thread_cpu_and_the_summary_totals_it(tmp_path):
    d = str(tmp_path / "t")
    trace.configure(enabled=True, trace_dir=d)
    for _ in range(3):
        with trace.phase("executor.store", block=0):
            t_end = time.monotonic() + 0.03
            while time.monotonic() < t_end:
                pass
    with trace.span("executor.sweep"):
        pass
    trace.flush()
    evs = [e for e in trace._get().snapshot_events() if e["name"] == "executor.store"]
    assert len(evs) == 3
    for e in evs:
        cpu = e["args"]["cpu_user_ms"] + e["args"]["cpu_sys_ms"]
        assert 0.0 <= cpu <= e["dur"] * 1e3 + 5.0
    site = trace.summarize(trace.merge(d))["sites"]["executor.store"]
    assert site["cpu_user_ms"] == pytest.approx(sum(e["args"]["cpu_user_ms"] for e in evs), abs=0.01)
    assert site["cpu_user_ms"] + site["cpu_sys_ms"] > 30.0
    # a span that is no phase carries no CPU, and its site no totals
    assert "cpu_user_ms" not in trace.summarize(trace.merge(d))["sites"]["executor.sweep"]


def _helper():
    reason = trace.thread_state_missing()
    if reason is not None:
        pytest.skip(reason)


def test_a_thread_state_joins_the_profile_for_its_body_only():
    _helper()
    trace.configure(enabled=True)
    seen = {}

    def worker(state):
        seen["before"] = torch._C._autograd._profiler_enabled()
        with trace.thread_state(state):
            seen["inside"] = torch._C._autograd._profiler_enabled()
            torch.ones(3).mul_(2)
        seen["after"] = torch._C._autograd._profiler_enabled()

    def body():
        assert trace.capture_thread_state() is not None
        th = threading.Thread(target=worker, args=(trace.capture_thread_state(),))
        th.start()
        th.join()

    events = _profiled(body)
    assert seen == {"before": False, "inside": True, "after": False}
    assert {n for n, *_ in events} >= {"aten::mul_", "aten::ones"}
    assert len({tid for *_, tid in events}) == 1
    assert {n for n, *_ in events} == {n for n, *_ in events if n.startswith("aten::")}
    # with tracing on and no profiler recording nothing is captured
    assert trace.capture_thread_state() is None


def test_one_state_serves_many_threads_at_once():
    """Sixteen threads enter one captured state together, with a short
    switch interval: every thread's ops land in the profile, and each
    thread leaves with its own state back."""
    _helper()
    trace.configure(enabled=True)
    n_threads, n_iter = 16, 20
    after = []
    interval = sys.getswitchinterval()

    def worker(state):
        for _ in range(n_iter):
            with trace.thread_state(state):
                torch.ones(2).mul_(3)
        after.append(torch._C._autograd._profiler_enabled())

    def body():
        state = trace.capture_thread_state()
        threads = [threading.Thread(target=worker, args=(state,)) for _ in range(n_threads)]
        sys.setswitchinterval(1e-5)
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(th.is_alive() for th in threads)

    events = _profiled(body)
    muls = [tid for name, *_, tid in events if name == "aten::mul_"]
    assert len(muls) == n_threads * n_iter and len(set(muls)) == n_threads
    assert after == [False] * n_threads


def test_executor_workers_record_into_the_profile(tmp_path):
    _helper()
    trace.configure(enabled=True, trace_dir=str(tmp_path / "trace"))
    blocks = [Blocking([16, 16, 16], [8, 8, 8]).get_block(i) for i in range(8)]
    store = {}

    def load(b):
        with trace.phase("executor.load.read", block=int(b.block_id)):
            return (torch.full((8, 8, 8), float(b.block_id)).numpy(),)

    def run():
        with trace.task_context("mirror_sweep"):
            BlockwiseExecutor(target="local", io_threads=2, max_retries=1).map_blocks(
                lambda x: x + 1, blocks, load, lambda b, out: store.__setitem__(int(b.block_id), out),
                task_name="mirror_sweep", sweep_mode="per_block")

    events = _profiled(run)
    assert sorted(store) == list(range(8))
    by_name = {}
    for name, _, _, tid in events:
        by_name.setdefault(name, set()).add(tid)
    # loads and stores run on the pool's threads, the dispatch loop on this one
    assert {"executor.load", "executor.store", "executor.dispatch"} <= set(by_name)
    assert by_name["executor.load"] - by_name["executor.dispatch"]
    assert by_name["executor.store"] - by_name["executor.dispatch"]
    # the workers' torch ops are in the profile too
    assert by_name.get("aten::full", set()) - by_name["executor.dispatch"]


def test_the_ring_keeps_every_run_of_a_window_and_each_shard_its_own(tmp_path):
    """Three traced runs of the workflow cell's ``tiny`` configuration in one
    window: 27 blocks a run, so 81 ``executor.store`` spans in the ring and
    27 in each run's shard."""
    from cluster_tools_tpu_torch.io.containers import MemoryContainer, open_container
    from cluster_tools_tpu_torch.runtime.task import build
    from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow

    cfg = json.loads((ROOT / "port_bench" / "configs" / "ws_workflow_125x1250x1250.json").read_text())
    tiny = cfg["tiny"]
    shape, block = tiny["volume_shape"], tiny["block_shape"]
    params = dict(cfg["workflow"], **tiny["workflow"])
    n_blocks = int(np.prod([-(-s // b) for s, b in zip(shape, block)]))
    assert n_blocks == 27
    vol = np.random.default_rng(3).random(shape).astype(np.float32)
    inp = "memory://mirror/in"
    open_container(inp).require_dataset("b", shape=shape, chunks=block, dtype="float32")[...] = vol
    trace.configure(enabled=True)
    runs = []
    try:
        for r in range(3):
            d = tmp_path / f"run{r}"
            (d / "cfg").mkdir(parents=True)
            (d / "cfg" / "global.config").write_text(json.dumps({"block_shape": block}))
            wf = WatershedWorkflow(tmp_folder=str(d / "tmp"), config_dir=str(d / "cfg"), max_jobs=tiny["max_jobs"],
                                   block_shape=block, input_path=inp, input_key="b",
                                   output_path=f"memory://mirror/out{r}", output_key="ws", target="local", **params)
            assert build([wf])
            runs.append(str(d / "tmp" / trace.TRACE_DIRNAME))
        ring = [e for e in trace._get().snapshot_events() if e["ph"] == "X" and e["name"] == "executor.store"]
        assert len(ring) == 3 * n_blocks
        for d in runs:
            shard = [e for e in trace.merge(d)["traceEvents"] if e.get("name") == "executor.store"]
            assert len(shard) == n_blocks, d
        assert os.path.exists(os.path.join(os.path.dirname(runs[-1]), trace.SUMMARY_NAME))
    finally:
        for path in [inp] + [f"memory://mirror/out{r}" for r in range(3)]:
            MemoryContainer._registry.pop(path, None)


def test_a_missing_helper_is_said_once_while_a_profile_records(monkeypatch, capsys):
    """Without the thread-state helper a profiled sweep's workers record
    nothing: the first task submitted while a profile records prints why
    to stderr, once; no task outside a profile prints it."""
    trace.configure(enabled=True)
    monkeypatch.setattr(trace, "_tls_lib", None)
    monkeypatch.setattr(trace, "_tls_missing", "no compiler here")
    monkeypatch.setattr(trace, "_tls_said", False)
    assert trace.capture_thread_state() is None
    assert capsys.readouterr().err == ""

    def body():
        assert trace.capture_thread_state() is None
        assert trace.capture_thread_state() is None

    _profiled(body)
    err = capsys.readouterr().err
    assert err.count("no compiler here") == 1 and "worker threads record nothing" in err


def test_the_ring_bound_holds_over_the_runs_and_each_shard_counts_its_own_drops(tmp_path):
    """One ring of 10 over two runs of 8 and 15 spans: the ring keeps the
    last 10 (13 dropped since configure), run A's shard its 8 (none
    dropped), run B's shard its last 10 (5 dropped)."""
    trace.configure(enabled=True, buffer=10)
    dir_a, dir_b = str(tmp_path / "a"), str(tmp_path / "b")
    for d, run, n in ((dir_a, "run_a", 8), (dir_b, "run_b", 15)):
        trace.set_trace_dir(d)
        for i in range(n):
            with trace.span("s", task=run, i=i):
                pass
    trace.flush()
    assert trace.stats()["spans"] == 10 and trace.stats()["dropped"] == 13
    assert [e["args"]["i"] for e in trace._get().snapshot_events()] == list(range(5, 15))
    for d, run, kept, dropped in ((dir_a, "run_a", list(range(8)), 0), (dir_b, "run_b", list(range(5, 15)), 5)):
        doc = trace.merge(d)
        evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        assert [e["args"]["i"] for e in evs] == kept and {e["args"]["task"] for e in evs} == {run}
        assert doc["otherData"]["dropped"] == dropped
