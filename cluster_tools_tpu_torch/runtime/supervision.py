"""Supervision primitives: heartbeats, deadlines, and duplicate commits.

Port (a copy) of ``cluster_tools_tpu/runtime/supervision.py``;
:func:`array_digest` gives the reference's CRC for the same numpy leaves.
The cluster supervisor that reads the heartbeats is
``runtime/cluster.py::supervise_job``.

The fault layer handles *loud* failures (exceptions, kills); this module
supplies the building blocks for the *silent* ones (docs/ROBUSTNESS.md
"Silent failures"):

- **Heartbeats** — cluster jobs write a small JSON liveness file under
  ``tmp_folder/heartbeats/`` every few seconds (:class:`HeartbeatWriter`);
  the submitting supervisor (``runtime/cluster.py``) reads it to declare a
  job lost when the scheduler still claims it runs but nothing is alive
  (stale heartbeat, dead pid) — the slurm/LSF "lost array task" failure
  mode that otherwise burns the whole ``submit_timeout_s``.
- :class:`Watchdog` — a daemon thread that scans registered in-flight work
  items against a wall-clock deadline and fires a callback once per overdue
  item.  The executor registers every per-block load/compute/store with it
  to detect hung blocks within ``block_deadline_s`` + one period.
- :class:`FirstWins` — the commit registry for speculative re-execution:
  when a hung block's duplicate and its original both finish, the first
  result wins and the second is checked for bit-identical agreement (a
  disagreement means a nondeterministic kernel or corrupted data, and is
  surfaced instead of silently picking one).
- **Drain latch** (docs/ROBUSTNESS.md "Graceful degradation") — the
  process-wide preemption protocol: :func:`install_drain_handler` arms
  SIGTERM/SIGUSR1 to flip a latch instead of dying; the executor, the task
  runner, and ``host_block_map`` poll :func:`drain_requested` at their block
  / task boundaries, finish in-flight work, flush markers + manifests, and
  raise :class:`DrainInterrupt` so the entry point can exit with
  :data:`REQUEUE_EXIT_CODE` — the scheduler-visible "requeue me" signal a
  preempted job sends instead of a crash.
- **Headroom probes** — :func:`host_mem_available_fraction` /
  :func:`disk_free_fraction`, the cheap measurements behind the executor's
  byte-budget admission control and resource-exhaustion backpressure.

A cluster job's first heartbeat is written by its *batch script* (a shell
one-liner, before the Python interpreter even starts), so the supervisor's
staleness clock is not confused by slow jax imports on the worker node.
"""

from __future__ import annotations

import os
import shutil
import signal
import socket
import threading
import time
import zlib
from typing import Any, Callable, Dict, Optional

from ..utils import function_utils as fu

HEARTBEAT_DIRNAME = "heartbeats"

#: Exit code a gracefully-drained (preempted) process exits with, telling
#: the submitting supervisor "requeue me, nothing is broken" — distinct from
#: both a crash (1) and an injected hard kill (``faults.KILL_EXIT_CODE``).
REQUEUE_EXIT_CODE = 114

#: Exit code a serve member exits with after discovering it was FENCED —
#: declared dead and adopted away while wedged (SIGSTOP, GC pause), then
#: woken.  Distinct from a drain (114): the supervisor must NOT requeue
#: it onto the same member dir — a survivor owns that journal now
#: (docs/SERVING.md "Gray failures").
FENCED_EXIT_CODE = 115


# -- preemption-aware draining ------------------------------------------------


class DrainInterrupt(BaseException):
    """Raised at a safe block/task boundary once a drain was requested
    (SIGTERM/SIGUSR1): in-flight work has been finished or checkpointed,
    markers and manifests are flushed, and the process should exit with
    :data:`REQUEUE_EXIT_CODE` so the supervisor requeues it.

    A ``BaseException`` on purpose: the task runtime's broad ``except
    Exception`` retry/continue paths must never swallow a preemption and
    burn failure retries on it.
    """

    def __init__(self, reason: str, remaining_ids=None):
        self.reason = reason
        self.remaining_ids = sorted(int(b) for b in (remaining_ids or []))
        msg = f"drain requested ({reason})"
        if self.remaining_ids:
            msg += f"; {len(self.remaining_ids)} block(s) left for the resume"
        super().__init__(msg)


_drain_event = threading.Event()
_drain_reason: Optional[str] = None
_drain_installed = False
_drain_lock = threading.Lock()


def request_drain(reason: str = "drain requested") -> None:
    """Flip the process-wide drain latch (idempotent; signal-safe)."""
    global _drain_reason
    if _drain_reason is None:
        _drain_reason = reason
    _drain_event.set()


def drain_requested() -> bool:
    return _drain_event.is_set()


def drain_reason() -> Optional[str]:
    return _drain_reason


def reset_drain() -> None:
    """Clear the latch (tests; a resumed run starts un-drained anyway
    because it is a fresh process)."""
    global _drain_reason
    _drain_event.clear()
    _drain_reason = None


def install_drain_handler(signals=(signal.SIGTERM, signal.SIGUSR1)) -> bool:
    """Arm SIGTERM/SIGUSR1 to flip the drain latch instead of killing the
    process.  Idempotent; only replaces *default* dispositions (an embedder
    who installed their own handler keeps it); a no-op off the main thread
    (Python restricts ``signal.signal`` to it).  Returns True when the
    latch is armed for at least one signal."""
    global _drain_installed
    with _drain_lock:
        if _drain_installed:
            return True
        armed = False
        for sig in signals:
            try:
                if signal.getsignal(sig) != signal.SIG_DFL:
                    continue

                def _handler(signum, frame, _name=signal.Signals(sig).name):
                    request_drain(f"received {_name}")

                signal.signal(sig, _handler)
                armed = True
            except (ValueError, OSError):  # non-main thread / exotic platform
                return False
        if armed:
            _drain_installed = True
        return armed


# -- resource headroom probes -------------------------------------------------


def host_mem_available_bytes() -> Optional[int]:
    """``MemAvailable`` from /proc/meminfo, or None where unavailable —
    callers treat None as "no admission control possible", never as 0."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def host_mem_available_fraction() -> Optional[float]:
    """MemAvailable / MemTotal, or None where /proc/meminfo is absent."""
    try:
        avail = total = None
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1])
        if avail is not None and total:
            return avail / total
    except (OSError, ValueError, IndexError):
        pass
    return None


def disk_free_fraction(path: str) -> Optional[float]:
    """Free/total of the filesystem holding ``path``, or None."""
    try:
        usage = shutil.disk_usage(path)
        if usage.total:
            return usage.free / usage.total
    except (OSError, ValueError):
        pass
    return None


# -- heartbeats ---------------------------------------------------------------


def heartbeat_dir(tmp_folder: str) -> str:
    d = os.path.join(tmp_folder, HEARTBEAT_DIRNAME)
    os.makedirs(d, exist_ok=True)
    return d


def heartbeat_path(tmp_folder: str, uid: str) -> str:
    return os.path.join(heartbeat_dir(tmp_folder), f"{uid}.json")


def write_heartbeat(tmp_folder: str, uid: str) -> None:
    """Atomically record ``{time, pid, host}`` — the shared-filesystem pulse
    the supervisor checks for staleness and pid-liveness.  Stamped through
    the tracer's wall-clock source (docs/ANALYSIS.md CT008), so heartbeat
    timestamps and the merged trace timeline share one anchor."""
    from . import trace as trace_mod

    fu.atomic_write_json(
        heartbeat_path(tmp_folder, uid),
        {"time": trace_mod.walltime(), "pid": os.getpid(),
         "host": socket.gethostname()},
    )


def read_heartbeat(tmp_folder: str, uid: str) -> Optional[Dict[str, Any]]:
    """The last heartbeat, or None (never written, or torn mid-kill)."""
    return fu.read_json_if_valid(heartbeat_path(tmp_folder, uid))


def pid_alive(pid) -> bool:
    """Best-effort liveness probe for a pid on THIS host.  Errs on the side
    of alive: only a definite ESRCH says dead (a false 'dead' would trigger
    a spurious resubmission racing a live job)."""
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError, ValueError, OverflowError):
        return True
    return True


class HeartbeatWriter:
    """Background thread writing a heartbeat every ``interval_s`` until
    stopped.  Writes once synchronously on :meth:`start`, so liveness is
    visible the moment the job begins work."""

    def __init__(self, tmp_folder: str, uid: str, interval_s: float = 5.0):
        self.tmp_folder = tmp_folder
        self.uid = uid
        self.interval_s = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatWriter":
        write_heartbeat(self.tmp_folder, self.uid)
        self._thread = threading.Thread(
            target=self._run, name=f"heartbeat-{self.uid}", daemon=True
        )
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                write_heartbeat(self.tmp_folder, self.uid)
            except OSError:
                # a full/unreachable filesystem must not crash the worker —
                # the supervisor sees staleness and handles it
                pass

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s + 1.0)


# -- per-block deadline watchdog ----------------------------------------------


class Watchdog:
    """Scan registered in-flight items against a wall-clock deadline.

    ``register(token, **info)`` marks work as started, ``clear(token)`` as
    finished; a daemon thread wakes every ``period_s`` and calls
    ``on_overdue(token, info, elapsed)`` exactly once per token whose age
    exceeds ``deadline_s``.  The overdue item stays registered (its thread
    is still stuck) but never fires twice.  Detection latency is bounded by
    ``deadline_s + period_s``.
    """

    def __init__(
        self,
        deadline_s: float,
        period_s: float,
        on_overdue: Callable[[Any, Dict[str, Any], float], None],
    ):
        self.deadline_s = float(deadline_s)
        self.period_s = max(0.01, float(period_s))
        self._on_overdue = on_overdue
        self._inflight: Dict[Any, tuple] = {}
        self._fired: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, token, **info) -> None:
        with self._lock:
            self._inflight[token] = (time.monotonic(), info)

    def clear(self, token) -> None:
        with self._lock:
            self._inflight.pop(token, None)
            self._fired.discard(token)

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(
            target=self._run, name="block-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.period_s):
            self._scan()

    def _scan(self):
        now = time.monotonic()
        with self._lock:
            overdue = [
                (tok, info, now - t0)
                for tok, (t0, info) in self._inflight.items()
                if now - t0 > self.deadline_s and tok not in self._fired
            ]
            for tok, _, _ in overdue:
                self._fired.add(tok)
        for tok, info, elapsed in overdue:
            try:
                self._on_overdue(tok, info, elapsed)
            except Exception:
                # the watchdog must outlive a buggy callback — the hung
                # block is already recorded as fired
                pass

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.period_s + 1.0)


# -- speculative-duplicate commits --------------------------------------------


class FirstWins:
    """First-result-wins registry with a determinism check.

    ``commit(key, digest)`` returns ``"win"`` for the first committer of a
    key (it proceeds to store), ``"agree"`` when a later duplicate matches
    the winner bit-for-bit (it skips the store), and ``"mismatch"`` when it
    does not — the caller must surface that instead of trusting either copy.
    """

    WIN, AGREE, MISMATCH = "win", "agree", "mismatch"

    def __init__(self):
        self._digests: Dict[Any, Any] = {}
        self._lock = threading.Lock()

    def commit(self, key, digest) -> str:
        with self._lock:
            if key not in self._digests:
                self._digests[key] = digest
                return self.WIN
            return self.AGREE if self._digests[key] == digest else self.MISMATCH

    def withdraw(self, key, digest) -> None:
        """Release a WIN claim whose store ultimately failed, so a later
        re-attempt (the quarantine recompute) can claim the key instead of
        being misread as a duplicate of a result that never landed."""
        with self._lock:
            if self._digests.get(key) == digest:
                del self._digests[key]


def array_digest(arrays) -> int:
    """Order-sensitive CRC32 over (dtype, shape, bytes) of array leaves —
    the bit-identity fingerprint used by the speculative agreement check."""
    import numpy as np

    h = 0
    for a in arrays:
        a = np.ascontiguousarray(a)
        h = zlib.crc32(a.tobytes(), zlib.crc32(
            f"{a.dtype.str}:{a.shape}".encode(), h))
    return h
