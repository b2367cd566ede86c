"""Unified tracing plane: per-block spans from every process, one timeline.

Port (a copy) of ``cluster_tools_tpu/runtime/trace.py``: the same env
names (``CTT_TRACE``, ``CTT_TRACE_BUFFER``), shard and timeline formats and
file names, so either package's ``merge``/``summarize`` reads the other's
shards.  Differences in what the port *emits* (not in this module): it
compiles no programs, so it has no compile spans, and its executor's
dispatch spans end after the device sync (see ``runtime/executor.py``).
Differences in this module, none of which changes a shard's or a
summary's format:

- **the ring keeps the window**: a new run's directory seals the previous
  run's shard, and each shard holds only its own run's events, but the
  ring (:func:`stats`, ``snapshot_events``) keeps every event since
  :func:`configure` up to its bound, so a reader of several runs in one
  process sees them all;
- **executor phases** (:func:`phase`, ``begin(..., phase=True)``) also
  record their thread's user and system CPU as the span args
  ``cpu_user_ms`` / ``cpu_sys_ms``, which :func:`summarize` totals per
  site: wall minus CPU is what the phase spent waiting (GIL, locks, I/O);
- **the mirror into torch.profiler**: while a ``torch.profiler`` session
  records, an executor phase span, and a step inside one
  (``executor.store.write``), also opens a function-scope profiler record
  under the phase's name (``executor.store``), so the profiler stamps the
  executor's phases on the device trace's own clock and its idle gaps can
  be put down to them.  Plain spans (``executor.sweep``, ``task.*``)
  cover every gap and are not mirrored.  Function scope, not
  ``record_function``'s user scope: the profiler copies user annotations
  onto the device's timeline, where they would read as device time;
- **worker threads join a running profile**: the profiler's callbacks and
  state are thread-local to the thread that started it, so the executor
  submits each task with :func:`capture_thread_state` and runs it under
  :func:`thread_state` (PyTorch's ``at::ThreadLocalState``, through the
  small helper ``csrc/ct_thread_state.cpp``); the worker's torch ops and
  mirrored spans then land in the profile under the worker's own thread
  id.  Where the helper cannot be built, :func:`thread_state_missing`
  says why (printed to stderr once, at the first task submitted while a
  profile records) and only the profiling thread's spans are mirrored.

The runtime attributes every *failure* (``failures.json``, schema v2) and
counts every *byte and dispatch* (``io_metrics.json``), but neither answers
the question that gates the service mode's p50/p99 work (ROADMAP item 4):
**where does the wall-clock go — per block, per site, per process?**  This
module is that layer (docs/OBSERVABILITY.md):

- a **process-wide, low-overhead span tracer** — ring-buffered, monotonic-
  clock, thread-aware, and block/task-context aware the same way
  :mod:`.faults` is (events inherit the executor's thread-local block id
  and the process-level current task, so a span recorded three layers
  below ``map_blocks`` still lands attributed).  ``CTT_TRACE`` is the
  knob: unset/``0`` is a TRUE no-op (the hooks return a shared null
  context — no clock reads on the pure-timeline paths, no counters, no
  files), ``1`` enables tracing with the shard directory supplied by the
  runtime (``BaseTask.run`` points it at ``<tmp_folder>/trace/``), and a
  path value enables tracing *and* fixes the directory — which is how
  worker processes inherit the submitter's timeline through the
  environment.
- **per-process shard files** — every participating process (the
  submitter, cluster-runner workers, reduce-tree solver workers,
  multihost pod workers) flushes its buffered events into
  ``<trace_dir>/shard_<host>_<pid>.json`` (atomic rewrite, crash-safe);
  each shard carries a ``(wall0, mono0)`` clock anchor so the merger can
  place every process's monotonic timestamps on ONE wall-clock-corrected
  timeline even when the monotonic clocks are arbitrarily offset.
- a **merger + aggregator** — :func:`merge` stitches the shards into a
  Chrome-trace-event JSON (Perfetto-loadable ``trace.json``: ``ph="X"``
  complete spans per process/thread track, ``ph="i"`` instants for the
  degrade/fault/quarantine events of the attribution plane — a failure is
  visually adjacent to the latency it caused); :func:`summarize` computes
  per-site latency aggregates (count, total, p50/p95/p99/max), the
  critical path through the task DAG (``task.run`` spans carry their
  dependency uids), and per-process overlap/utilization figures, written
  next to ``io_metrics.json`` as ``trace_summary.json`` and rendered by
  ``scripts/failures_report.py --trace``.

Timing discipline (docs/ANALYSIS.md CT008): this module is the ONE place
``runtime/`` reads ``time.time`` / ``time.perf_counter`` — every other
runtime module measures durations through :func:`span` / :func:`begin`
(whose :meth:`Span.end` returns the elapsed seconds, so existing counters
like the executor's ``dispatch_wait_s`` keep working with the tracer off)
and stamps wall-clock timestamps through :func:`walltime`.  One clock
source means the timeline, the manifests, and the heartbeats agree.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import resource
import socket
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

ENV_VAR = "CTT_TRACE"
ENV_BUFFER = "CTT_TRACE_BUFFER"

#: ring-buffer bound on buffered events per process; oldest events drop
#: (counted) so a runaway sweep cannot let the tracer eat the host
DEFAULT_BUFFER = 200_000

#: shard directory name under a run's tmp_folder
TRACE_DIRNAME = "trace"
_SHARD_PREFIX = "shard_"

#: merged-output filenames (written next to failures.json / io_metrics.json)
TIMELINE_NAME = "trace.json"
SUMMARY_NAME = "trace_summary.json"

_OFF_VALUES = ("", "0", "false", "off")


def walltime() -> float:
    """The runtime's sanctioned wall-clock source (== ``time.time()``).

    Manifest/heartbeat timestamps read it so they share the tracer's
    wall anchor; docs/ANALYSIS.md CT008 bans direct ``time.time()`` in
    ``runtime/`` outside this module."""
    return time.time()


class _Tracer:
    """Process-wide event buffer + clock anchor (module singleton).

    Hot-path discipline: events are buffered as bare tuples
    ``(ph, name, ts, dur, tid, args)`` — dict/JSON shaping happens once,
    at flush, never per event — because the <5% bench-sweep overhead bar
    prices every per-event allocation (``bench.py --sweep`` measures it).
    """

    def __init__(self, enabled: Optional[bool] = None,
                 trace_dir: Optional[str] = None,
                 buffer: Optional[int] = None):
        env = os.environ.get(ENV_VAR, "").strip()
        if enabled is None:
            enabled = env.lower() not in _OFF_VALUES
        if trace_dir is None and env.lower() not in _OFF_VALUES \
                and env.lower() not in ("1", "on", "true"):
            trace_dir = env
        if buffer is None:
            try:
                buffer = int(os.environ.get(ENV_BUFFER, DEFAULT_BUFFER))
            except ValueError:
                buffer = DEFAULT_BUFFER
        self.enabled = bool(enabled)
        self.dir: Optional[str] = trace_dir
        # an explicitly-supplied dir (operator CTT_TRACE=<dir> pin or a
        # test/bench configure()) is never re-pointed; only task-derived
        # dirs set via set_trace_dir may roll over to a new run's dir
        self.pinned = trace_dir is not None
        self.max_events = max(1, int(buffer))
        # every run's events since configure(); the last ``n_run`` of them
        # are the current run's (what a flush writes)
        self._events: deque = deque(maxlen=self.max_events)
        self.n_run = 0
        # the per-process clock anchor: monotonic timestamps in the shard
        # map to wall time as wall0 + (ts - mono0), which is what lets the
        # merger put offset clocks on one timeline
        self.wall0 = time.time()
        self.mono0 = time.monotonic()
        self.dropped = 0
        self.flushes = 0

    def record(self, ph: str, name: str, ts: float, dur: float,
               args: Dict[str, Any]) -> None:
        # LOCK-FREE on purpose: deque.append is GIL-atomic in CPython, and
        # the drop check is advisory — per-event locking was the single
        # largest cost in the <5% bench-sweep overhead budget
        events = self._events
        if len(events) == self.max_events:
            self.dropped += 1
        events.append((ph, name, ts, dur, threading.get_ident(), args))
        self.n_run += 1

    def counts(self) -> Dict[str, int]:
        """Buffered span/instant counts + all-time dropped/flushes —
        computed lazily (never per event; see :meth:`record`)."""
        raw = list(self._events)
        spans = sum(1 for ev in raw if ev[0] == "X")
        return {
            "spans": spans,
            "instants": len(raw) - spans,
            "dropped": int(self.dropped),
            "flushes": int(self.flushes),
        }

    @staticmethod
    def _dicts(raw) -> List[Dict[str, Any]]:
        return [
            {"ph": ph, "name": name, "ts": ts, "dur": dur, "tid": tid,
             "args": args}
            for ph, name, ts, dur, tid, args in raw
        ]

    def snapshot_events(self) -> List[Dict[str, Any]]:
        """Every buffered event since configure(), every run's."""
        return self._dicts(list(self._events))

    def run_events(self) -> List[Dict[str, Any]]:
        """The current run's buffered events (its shard)."""
        raw = list(self._events)
        return self._dicts(raw[len(raw) - min(self.n_run, len(raw)):])

    def run_dropped(self) -> int:
        """The current run's events the ring's bound has dropped."""
        return max(0, int(self.n_run) - self.max_events)


_tracer: Optional[_Tracer] = None
_singleton_lock = threading.Lock()


def _get() -> _Tracer:
    global _tracer
    if _tracer is None:
        with _singleton_lock:
            if _tracer is None:
                _tracer = _Tracer()
    return _tracer


def configure(enabled: Optional[bool] = None,
              trace_dir: Optional[str] = None,
              buffer: Optional[int] = None) -> _Tracer:
    """Install a fresh tracer (tests / bench A-B runs): empties the buffer
    and zeroes the counters.  Arguments default to the environment knobs."""
    global _tracer
    with _singleton_lock:
        _tracer = _Tracer(enabled=enabled, trace_dir=trace_dir, buffer=buffer)
        _last_merge.clear()
    return _tracer


def reset() -> None:
    """Drop the installed tracer; the next hook re-reads the environment."""
    global _tracer
    with _singleton_lock:
        _tracer = None
        _last_merge.clear()


def enabled() -> bool:
    return _get().enabled


def stats() -> Dict[str, int]:
    """The tracer's counters: buffered spans/instants plus all-time
    dropped/flushes — the tracer-off no-op test asserts these stay zero.
    Computed lazily from the ring (never maintained per event: the record
    hot path is priced by the <5% bench-sweep overhead bar)."""
    return _get().counts()


def trace_dir() -> Optional[str]:
    return _get().dir


def set_trace_dir(path: str) -> None:
    """Point the tracer at a run's shard directory.  Within a run the first
    writer wins, and an operator-pinned ``CTT_TRACE=<dir>`` (or an explicit
    :func:`configure` dir) is never re-pointed.  A task-derived call with a
    DIFFERENT directory means a NEW run in the same long-lived process: the
    previous run's shard is sealed in its own directory and the next shard
    starts fresh, so two runs' timelines never cross-contaminate; the ring
    keeps the sealed run's events for :func:`stats` and its readers."""
    t = _get()
    if t.dir is None:
        t.dir = path
    elif path != t.dir and not t.pinned:
        flush()
        t.n_run = 0
        t.dir = path
        _last_merge.clear()


_faults_mod = None


def _faults():
    # lazily bound once (not per event): the import indirection breaks the
    # runtime's only would-be cycle (faults never imports trace)
    global _faults_mod
    if _faults_mod is None:
        from . import faults

        _faults_mod = faults
    return _faults_mod


def _context_args(args: Dict[str, Any]) -> Dict[str, Any]:
    """Enrich event args with the fault-targeting context (thread-local
    block id, process-level task uid) unless the caller pinned them."""
    if "block" not in args or "task" not in args:
        fm = _faults()
        if "block" not in args:
            bid = fm.current_block_id()
            if bid is not None:
                args["block"] = int(bid)
        if "task" not in args:
            task = fm.current_task()
            if task is not None:
                args["task"] = task
    return args


# -- the mirror into torch.profiler --------------------------------------------

_RecordFunctionFast = None


def _profiling() -> bool:
    """A ``torch.profiler`` session is recording in this process (the flag
    torch sets at a session's start and clears at its stop); False where
    torch is not loaded."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


def mirror_name(name: str) -> str:
    """The profiler name phase span ``name`` is mirrored under: the phase's
    own name for the phase and for a step inside it
    (``executor.store.write`` -> ``executor.store``), so the profiler sees
    a handful of names while ``trace.json`` keeps the full ones."""
    return ".".join(name.split(".")[:2])


def _open_record(name: str):
    """A function-scope profiler record named ``name``, entered on this
    thread (a no-op inside torch where this thread records nothing)."""
    global _RecordFunctionFast
    if _RecordFunctionFast is None:
        from torch._C._profiler import _RecordFunctionFast as rf

        _RecordFunctionFast = rf
    rec = _RecordFunctionFast(name)
    rec.__enter__()
    return rec


_RUSAGE_THREAD = getattr(resource, "RUSAGE_THREAD", None)


def _thread_cpu():
    return resource.getrusage(_RUSAGE_THREAD) if _RUSAGE_THREAD is not None else None


class Span:
    """One timed span: a context manager (``with span(...)``) or a manual
    ``begin()``/``end()`` pair.  ``end`` returns the elapsed seconds —
    always measured, so callers can feed duration counters whether or not
    the event was recorded — and records the event unless ``discard``.
    A phase span also reads its thread's CPU at both ends, and a mirrored
    one holds its profiler record from its start to its first ``end``.

    Hot-path discipline (the <5% bench-sweep overhead bar): the tracer
    reference is captured at construction (one singleton lookup per span,
    not two) and the timestamp reads are bound locally."""

    __slots__ = ("name", "args", "t0", "elapsed_s", "_recorded", "_tracer", "_record", "_cpu")

    def __init__(self, name: str, args: Dict[str, Any],
                 tracer: Optional["_Tracer"] = None, cpu: bool = False):
        self.name = name
        self.args = args
        self._tracer = tracer
        self._record = None
        self._cpu = _thread_cpu() if cpu else None
        self.t0 = time.monotonic()
        self.elapsed_s: Optional[float] = None
        self._recorded = False

    def end(self, discard: bool = False, **extra) -> float:
        t1 = time.monotonic()
        if self.elapsed_s is None:
            self.elapsed_s = t1 - self.t0
            if self._record is not None:
                self._record.__exit__(None, None, None)
                self._record = None
            if self._cpu is not None:
                ru = _thread_cpu()
                self._cpu = ((ru.ru_utime - self._cpu.ru_utime) * 1e3,
                             (ru.ru_stime - self._cpu.ru_stime) * 1e3)
        if self._recorded or discard:
            return self.elapsed_s
        self._recorded = True
        t = self._tracer or _get()
        if t.enabled:
            if extra:
                self.args.update(extra)
            if self._cpu is not None:
                self.args["cpu_user_ms"] = round(self._cpu[0], 3)
                self.args["cpu_sys_ms"] = round(self._cpu[1], 3)
            t.record(
                "X", self.name, self.t0, self.elapsed_s,
                _context_args(self.args),
            )
        return self.elapsed_s

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end(error=True) if exc_type is not None else self.end()
        return False


def _phase_span(name: str, args: Dict[str, Any], tracer: "_Tracer") -> Span:
    """A phase span of the enabled tracer: its thread's CPU, and the
    mirror while a profiler records."""
    sp = Span(name, args, tracer, cpu=True)
    if _profiling():
        sp._record = _open_record(mirror_name(name))
    return sp


class _NullSpan:
    """Shared no-op span for the tracer-off fast path: no clock reads, no
    allocation beyond the singleton."""

    __slots__ = ()
    elapsed_s = 0.0

    def end(self, discard: bool = False, **extra) -> float:
        return 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL = _NullSpan()


def span(name: str, **args):
    """A pure-timeline span: records ``name`` with its duration when
    tracing is on; the shared null context (zero cost) when off.  Use
    :func:`begin` instead when the caller needs the elapsed seconds for a
    metrics counter regardless of the knob."""
    t = _tracer
    if t is None:
        t = _get()
    if not t.enabled:
        return _NULL
    return Span(name, args, t)


def phase(name: str, **args):
    """An executor phase, or a step inside one (``executor.load.read``): a
    :func:`span` that also records its thread's user and system CPU
    (``cpu_user_ms``, ``cpu_sys_ms``) and, while a profiler records, is
    mirrored into it under :func:`mirror_name`; the shared null context
    when tracing is off.  Spans that cover every gap of a sweep
    (``executor.sweep``, ``task.*``) are no phases: they would name every
    idle gap and explain none."""
    t = _tracer
    if t is None:
        t = _get()
    if not t.enabled:
        return _NULL
    return _phase_span(name, args, t)


def begin(name: str, phase: bool = False, **args) -> Span:
    """A *timed* span: always measures (two monotonic reads), records only
    when tracing is on.  ``sp.end()`` returns the elapsed seconds;
    ``sp.end(discard=True)`` measures without recording (e.g. an admission
    gate that never actually waited).  With ``phase`` and tracing on it is
    an executor phase as :func:`phase` makes one (its CPU, the mirror)."""
    if not phase:
        return Span(name, args)
    t = _get()
    return _phase_span(name, args, t) if t.enabled else Span(name, args, t)


# -- executor threads join a running profile -------------------------------------

_tls_lib: Optional[ctypes.CDLL] = None
_tls_missing: Optional[str] = None
_tls_lock = threading.Lock()


def _thread_state_lib() -> Optional[ctypes.CDLL]:
    """The thread-state helper, built (:func:`..build.thread_state_library`)
    and loaded at the first call; None, with :data:`_tls_missing` saying
    why, where it cannot be."""
    global _tls_lib, _tls_missing
    if _tls_lib is None and _tls_missing is None:
        with _tls_lock:
            if _tls_lib is None and _tls_missing is None:
                try:
                    from .. import build

                    lib = ctypes.CDLL(str(build.thread_state_library()))
                    P = ctypes.c_void_p
                    for fn, argtypes, restype in (("ct_tls_capture", [], P), ("ct_tls_free", [P], None),
                                                  ("ct_tls_enter", [P], P), ("ct_tls_exit", [P], None)):
                        getattr(lib, fn).argtypes = argtypes
                        getattr(lib, fn).restype = restype
                    _tls_lib = lib
                except Exception as e:  # noqa: BLE001 - any failure means no helper, said once
                    lines = str(e).strip().splitlines() or [type(e).__name__]
                    _tls_missing = f"the thread-state helper is not available here: {lines[0][:300]}"
    return _tls_lib


def thread_state_missing() -> Optional[str]:
    """Why the executor's worker threads cannot join a running profile
    here (the helper ``csrc/ct_thread_state.cpp`` could not be built or
    loaded), or None when they can.  Builds the helper at the first call."""
    _thread_state_lib()
    return _tls_missing


class ThreadState:
    """A thread's captured PyTorch thread-local state (its profiler's
    callbacks and state among it), freed with the last task holding it."""

    __slots__ = ("_lib", "_ptr")

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._ptr = lib.ct_tls_capture()

    def __del__(self):
        self._lib.ct_tls_free(self._ptr)


@contextlib.contextmanager
def _installed(state: ThreadState):
    """``state`` installed on this thread for the body only: the thread's
    own state is restored at the exit, so nothing outlives the task."""
    guard = state._lib.ct_tls_enter(state._ptr)
    try:
        yield
    finally:
        state._lib.ct_tls_exit(guard)


def capture_thread_state() -> Optional[ThreadState]:
    """This thread's state for a task it submits to a worker thread, while
    tracing is on and a ``torch.profiler`` session records; None otherwise,
    and where the helper is missing.  With tracing on, the first call loads
    (or builds) the helper whether a profiler records or not, so no build
    falls inside a profile."""
    t = _tracer
    if t is None:
        t = _get()
    if not t.enabled:
        return None
    lib = _thread_state_lib()
    if not _profiling():
        return None
    if lib is None:
        _say_missing()
        return None
    return ThreadState(lib)


_tls_said = False


def _say_missing() -> None:
    """Print :func:`thread_state_missing`'s reason to stderr, once a
    process: a profile is recording without the workers' phases, so what
    it puts the idle card down to is the profiling thread's alone."""
    global _tls_said
    if not _tls_said:
        _tls_said = True
        print(f"ctt trace: the executor's worker threads record nothing into this profile: {_tls_missing}",
              file=sys.stderr, flush=True)


def thread_state(state: Optional[ThreadState]):
    """A context that runs its body under ``state`` (from
    :func:`capture_thread_state`) and restores the thread's own state
    after; the shared null context for None."""
    return _NULL if state is None else _installed(state)


def task_context(name: str, **args):
    """The task trace context for call sites OUTSIDE a task class (bench
    drivers, scripts): a ``task.run`` span carrying ``task=name``, the
    same shape ``BaseTask.run`` opens — docs/ANALYSIS.md CT008 requires
    every ``map_blocks`` / ``host_block_map`` / ``solve_with_reduce_tree``
    call site to run under one."""
    args.setdefault("task", name)
    if not _get().enabled:
        return _NULL
    return Span("task.run", args)


def instant(name: str, **args) -> None:
    """A zero-duration timeline marker (Chrome ``ph="i"``): the degrade /
    fault / quarantine events of the attribution plane land through this,
    so a failure sits on the same timeline as the latency it caused."""
    t = _get()
    if not t.enabled:
        return
    t.record("i", name, time.monotonic(), 0.0, _context_args(args))


def shard_path(trace_dir: str) -> str:
    host = socket.gethostname().replace(os.sep, "_")
    return os.path.join(
        trace_dir, f"{_SHARD_PREFIX}{host}_{os.getpid()}.json"
    )


def flush(trace_dir: Optional[str] = None) -> Optional[str]:
    """Write this process's buffered events as its shard (atomic rewrite —
    a kill mid-flush leaves the previous shard, never a torn one).  Safe
    to call repeatedly: each flush rewrites the current run's full buffer,
    so the last flush before a crash is what survives.  No-op (returns
    None) when tracing is off or no directory is known."""
    t = _get()
    if not t.enabled:
        return None
    d = trace_dir or t.dir
    if not d:
        return None
    os.makedirs(d, exist_ok=True)
    path = shard_path(d)
    doc = {
        "version": 1,
        "pid": os.getpid(),
        "hostname": socket.gethostname(),
        "wall0": t.wall0,
        "mono0": t.mono0,
        "dropped": t.run_dropped(),
        "events": t.run_events(),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    t.flushes += 1
    return path


# -- merger: shards -> one Perfetto-loadable timeline -------------------------


def _load_shards(trace_dir: str) -> List[Dict[str, Any]]:
    shards = []
    try:
        names = sorted(os.listdir(trace_dir))
    except OSError:
        return shards
    for fname in names:
        if not (fname.startswith(_SHARD_PREFIX) and fname.endswith(".json")):
            continue
        try:
            with open(os.path.join(trace_dir, fname)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue  # torn/unreadable shard: skip, never fail the merge
        if isinstance(doc, dict) and isinstance(doc.get("events"), list):
            shards.append(doc)
    return shards


def merge(trace_dir: str) -> Dict[str, Any]:
    """Stitch every process shard into one Chrome-trace-event document.

    Clock-offset correction: each shard's monotonic timestamps map to wall
    time through its own ``(wall0, mono0)`` anchor, so two processes whose
    monotonic clocks are offset by hours still interleave correctly; the
    merged timeline is then re-based at the earliest event (``ts`` starts
    at 0, microseconds — what Perfetto expects)."""
    shards = _load_shards(trace_dir)
    placed: List[Dict[str, Any]] = []
    meta: List[Dict[str, Any]] = []
    seen_pids: Dict[int, int] = {}
    for shard in shards:
        wall0 = float(shard.get("wall0", 0.0))
        mono0 = float(shard.get("mono0", 0.0))
        pid = int(shard.get("pid", 0))
        # two hosts can reuse a pid: give the collision a synthetic id so
        # the tracks stay separate (the real identity is in process_name)
        while pid in seen_pids:
            pid += 1_000_000
        seen_pids[pid] = 1
        host = str(shard.get("hostname", "?"))
        meta.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"{host}:{shard.get('pid', pid)}"},
        })
        tid_map: Dict[int, int] = {}
        for ev in shard["events"]:
            try:
                wall = wall0 + (float(ev["ts"]) - mono0)
                tid = int(ev.get("tid", 0))
                name = str(ev.get("name", "?"))
                placed.append({
                    "name": name,
                    # category derived HERE, not at record time: the hot
                    # path buffers bare tuples (see _Tracer)
                    "cat": name.split(":", 1)[0].split(".", 1)[0],
                    "ph": str(ev.get("ph", "X")),
                    "pid": pid,
                    "tid": tid_map.setdefault(tid, len(tid_map)),
                    "_wall": wall,
                    "dur": float(ev.get("dur", 0.0)),
                    "args": ev.get("args") or {},
                })
            except (TypeError, ValueError, KeyError):
                continue
    base = min((e["_wall"] for e in placed), default=0.0)
    placed.sort(key=lambda e: e["_wall"])
    events: List[Dict[str, Any]] = list(meta)
    for e in placed:
        out = {
            "name": e["name"], "cat": e["cat"], "ph": e["ph"],
            "pid": e["pid"], "tid": e["tid"],
            "ts": round((e["_wall"] - base) * 1e6, 3),
            "args": e["args"],
        }
        if e["ph"] == "X":
            out["dur"] = round(e["dur"] * 1e6, 3)
        else:
            out["s"] = "t"  # thread-scoped instant
        events.append(out)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "processes": len(shards),
            "dropped": sum(int(s.get("dropped", 0)) for s in shards),
        },
    }


# -- aggregator: latency percentiles, critical path, utilization --------------


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (no numpy: the
    report path must work in bare tooling environments)."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


def _critical_path(task_spans: List[Dict[str, Any]]) -> Optional[Dict]:
    """Longest-duration chain through the task DAG: ``task.run`` spans
    carry their task uid and dependency uids, so the chain that bounds the
    run's wall time falls out of the recorded spans alone."""
    dur: Dict[str, float] = {}
    deps: Dict[str, List[str]] = {}
    for ev in task_spans:
        uid = ev["args"].get("task")
        if not uid:
            continue
        # merged-timeline durations are microseconds (Chrome trace format)
        dur[uid] = dur.get(uid, 0.0) + float(ev.get("dur", 0.0)) / 1e6
        for d in ev["args"].get("deps") or []:
            if d not in deps.setdefault(uid, []):
                deps[uid].append(d)
    if not dur:
        return None
    memo: Dict[str, float] = {}

    def cp(uid: str, stack=()) -> float:
        if uid in memo:
            return memo[uid]
        if uid in stack:  # defensive: the DAG engine rejects cycles
            return 0.0
        best = 0.0
        for d in deps.get(uid, []):
            if d in dur:
                best = max(best, cp(d, stack + (uid,)))
        memo[uid] = dur[uid] + best
        return memo[uid]

    end = max(dur, key=lambda u: cp(u))
    chain, cur = [], end
    while cur is not None:
        chain.append(cur)
        nxt, best = None, 0.0
        for d in deps.get(cur, []):
            if d in dur and cp(d) >= best:
                nxt, best = d, cp(d)
        cur = nxt
    chain.reverse()
    return {
        "tasks": chain,
        "total_s": round(cp(end), 6),
        "task_s": {u: round(dur[u], 6) for u in chain},
    }


def summarize(chrome: Dict[str, Any]) -> Dict[str, Any]:
    """Run-level aggregates over a merged timeline: per-site latency
    percentiles (and, for the executor's phase spans, their thread CPU
    totals ``cpu_user_ms`` / ``cpu_sys_ms``), instant counts, the task-DAG
    critical path, and per-process utilization (busy seconds by category
    vs wall extent — >1.0 concurrency means the category genuinely
    overlapped)."""
    spans = [e for e in chrome.get("traceEvents", [])
             if e.get("ph") == "X"]
    instants = [e for e in chrome.get("traceEvents", [])
                if e.get("ph") == "i"]
    sites: Dict[str, List[float]] = {}
    # the thread CPU of the executor's phase spans, totalled per site
    cpu: Dict[str, List[float]] = {}
    for e in spans:
        sites.setdefault(e["name"], []).append(float(e.get("dur", 0.0)) / 1e6)
        args = e.get("args") or {}
        if "cpu_user_ms" in args:
            tot = cpu.setdefault(e["name"], [0.0, 0.0])
            tot[0] += float(args["cpu_user_ms"])
            tot[1] += float(args.get("cpu_sys_ms", 0.0))
    site_stats = {}
    for name, vals in sorted(sites.items()):
        vals.sort()
        site_stats[name] = {
            "count": len(vals),
            "total_s": round(sum(vals), 6),
            "p50_ms": round(_percentile(vals, 50) * 1e3, 3),
            "p95_ms": round(_percentile(vals, 95) * 1e3, 3),
            "p99_ms": round(_percentile(vals, 99) * 1e3, 3),
            "max_ms": round(vals[-1] * 1e3, 3),
        }
        if name in cpu:
            site_stats[name]["cpu_user_ms"] = round(cpu[name][0], 3)
            site_stats[name]["cpu_sys_ms"] = round(cpu[name][1], 3)
    instant_counts: Dict[str, int] = {}
    for e in instants:
        instant_counts[e["name"]] = instant_counts.get(e["name"], 0) + 1

    procs: Dict[int, Dict[str, Any]] = {}
    for e in spans:
        p = procs.setdefault(int(e.get("pid", 0)), {
            "start": float(e["ts"]), "end": 0.0, "busy": {}, "events": 0,
        })
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        p["start"] = min(p["start"], ts)
        p["end"] = max(p["end"], ts + dur)
        p["events"] += 1
        cat = str(e.get("cat", "runtime"))
        p["busy"][cat] = p["busy"].get(cat, 0.0) + dur / 1e6
    names = {
        int(e.get("pid", 0)): e.get("args", {}).get("name")
        for e in chrome.get("traceEvents", [])
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    processes = []
    for pid in sorted(procs):
        p = procs[pid]
        wall = max(0.0, (p["end"] - p["start"]) / 1e6)
        processes.append({
            "pid": pid,
            "process": names.get(pid) or str(pid),
            "events": p["events"],
            "wall_s": round(wall, 6),
            "busy_s_by_cat": {
                c: round(v, 6) for c, v in sorted(p["busy"].items())
            },
        })

    # executor overlap: the share of sweep wall NOT stalled on
    # un-overlapped loads (the same figure io_metrics derives, computed
    # here from the spans so the two planes cross-check each other)
    sweep = sum(sites.get("executor.sweep", []))
    wait = sum(sites.get("executor.batch_wait", []))
    overlap = None
    if sweep > 0:
        overlap = {
            "sweep_s": round(sweep, 6),
            "batch_wait_s": round(wait, 6),
            "overlap_efficiency": round(max(0.0, 1.0 - wait / sweep), 4),
        }

    return {
        "version": 1,
        "n_events": len(spans) + len(instants),
        "n_processes": len(processes),
        "dropped": int(chrome.get("otherData", {}).get("dropped", 0)),
        "sites": site_stats,
        "instants": instant_counts,
        "critical_path": _critical_path(
            [e for e in spans if e["name"] == "task.run"]
        ),
        "processes": processes,
        "overlap": overlap,
    }


# per-tmp_folder monotonic stamp of the last in-process re-merge: the
# per-task merge in BaseTask.run is throttled through this (a run with
# many short tasks would otherwise re-read every shard after every task,
# O(tasks x shards)); the build()-end merge passes min_interval_s=0 so
# the finished timeline is always current
MERGE_MIN_INTERVAL_S = 30.0
_last_merge: Dict[str, float] = {}


def write_timeline(tmp_folder: str,
                   trace_dir: Optional[str] = None,
                   min_interval_s: float = 0.0) -> Optional[Dict]:
    """Merge the run's shards into ``<tmp_folder>/trace.json`` (Perfetto-
    loadable) + ``<tmp_folder>/trace_summary.json`` (the latency
    aggregates, next to ``io_metrics.json``).  Returns the summary, or
    None when there is nothing to merge.  Atomic writes; best-effort by
    contract — callers must not fail a run over its observability.
    ``min_interval_s`` > 0 skips the merge (returning None) when this
    process already merged ``tmp_folder`` within that window — the
    shards themselves are always current, only the restitch is deferred."""
    if min_interval_s > 0.0:
        last = _last_merge.get(tmp_folder)
        if last is not None and (time.monotonic() - last) < min_interval_s:
            return None
    _last_merge[tmp_folder] = time.monotonic()
    d = trace_dir or _get().dir or os.path.join(tmp_folder, TRACE_DIRNAME)
    chrome = merge(d)
    if not any(e.get("ph") in ("X", "i") for e in chrome["traceEvents"]):
        return None
    summary = summarize(chrome)
    for fname, doc in ((TIMELINE_NAME, chrome), (SUMMARY_NAME, summary)):
        path = os.path.join(tmp_folder, fname)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    return summary


def summary_path(tmp_folder: str) -> str:
    return os.path.join(tmp_folder, SUMMARY_NAME)


def timeline_path(tmp_folder: str) -> str:
    return os.path.join(tmp_folder, TIMELINE_NAME)
