"""Remote entry point for cluster-target jobs (``python -m
cluster_tools_tpu_torch.runtime.cluster_runner <spec.json>``).

Port (a copy) of ``cluster_tools_tpu/runtime/cluster_runner.py``.
Reconstructs the LOCAL variant of a task from the spec written by
:mod:`.cluster`'s submitting wrapper and executes its ``run_impl`` on the
node, writing ``{ok, result|error}`` to the spec's ``result_path``
(atomic tmp+rename: the submitter polls for this file on the shared
filesystem).  Block markers and per-task logs land in the shared
``tmp_folder`` exactly as for a local run, so a preempted job resumes at
the block grain when resubmitted.

The reference pins JAX to its CPU platform here before any task import.
The port needs no pin: the Local variant's target names the CPU, and no
task touches a device it was not given, so the node process never
initialises CUDA.

Liveness: for specs carrying a ``uid``, a heartbeat thread writes
``tmp_folder/heartbeats/<uid>.json`` every ``heartbeat_interval_s`` for
the submitting supervisor's staleness/pid checks (the batch script wrote
the first beat before Python started — see ``runtime/cluster.py``).

Preemption: a SIGTERM/SIGUSR1 (scheduler eviction, injected ``preempt``
fault) flips the drain latch instead of killing the job; the
executor/task runtime finishes in-flight blocks, flushes markers, and
raises ``DrainInterrupt``, which this runner turns into a *requeue marker*
(``<uid>.requeue.json`` next to the result file) plus exit code
``REQUEUE_EXIT_CODE`` (114) — no result file is written, so the supervisor
sees the job leave the queue, finds the marker, and resubmits under its
preemption budget instead of burning failure retries.
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import sys
import traceback


def main(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)

    result_path = spec["result_path"]

    def emit(payload) -> None:
        # numpy-aware serialization (same as SuccessTarget manifests) so
        # manifest field types match target='local' exactly
        from ..utils.task_utils import _default

        tmp = f"{result_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=_default)
        os.replace(tmp, result_path)

    from .supervision import (
        REQUEUE_EXIT_CODE,
        DrainInterrupt,
        install_drain_handler,
        write_heartbeat,
    )

    # arm graceful preemption BEFORE any work: the scheduler's eviction
    # SIGTERM must flip the drain latch, not kill the interpreter mid-block
    install_drain_handler()

    heartbeat = None
    if spec.get("uid"):
        from .supervision import HeartbeatWriter

        heartbeat = HeartbeatWriter(
            spec["tmp_folder"], spec["uid"],
            float(spec.get("heartbeat_interval_s", 5.0)),
        ).start()

    # unified tracing plane: when the submitter's
    # batch script exported CTT_TRACE=<dir>, this process traces into the
    # same shard directory — the worker's spans interleave with the
    # submitter's on one clock-corrected timeline.  The lifetime span is
    # the "cluster-worker lifetime" track; the flush in the finally is
    # best-effort by contract (observability must never fail the job).
    from . import trace as trace_mod

    worker_span = trace_mod.begin(
        "cluster.worker", task=spec.get("uid"), spec=os.path.basename(spec_path)
    )

    def _flush_trace(error: bool = False) -> None:
        try:
            worker_span.end(error=True) if error else worker_span.end()
            trace_mod.flush()
        except Exception:
            pass

    try:
        from . import faults as faults_mod

        # fault specs with a "tasks" filter target this job's task uid
        faults_mod.set_current_task(spec.get("uid"))
        module = importlib.import_module(spec["module"])
        cls = getattr(module, spec["cls"])
        task = cls(
            tmp_folder=spec["tmp_folder"],
            config_dir=spec["config_dir"],
            max_jobs=int(spec["max_jobs"]),
            **spec["params"],
        )
        # the chunk IO happens HERE, in the cluster worker process — the
        # submitter only polls — so this process must record its own
        # io_metrics delta into the shared manifest (additive merge, same
        # discipline as BaseTask.run on the local target)
        from ..io import chunk_cache
        from ..utils import function_utils as fu

        io_snap = chunk_cache.snapshot()
        try:
            result = task.run_impl()
        finally:
            io_metrics = chunk_cache.delta(io_snap)
            if any(io_metrics.values()):
                try:
                    fu.record_io_metrics(
                        fu.io_metrics_path(spec["tmp_folder"]),
                        # the submitter-side uid (heartbeats, failure
                        # records, scheduler artifacts all key on it) —
                        # not the worker's re-derived local identity
                        spec.get("uid") or task.uid,
                        io_metrics,
                    )
                except OSError:
                    pass
        _flush_trace()
        emit({"ok": True, "result": result})
        return 0
    except DrainInterrupt as e:
        # drained for preemption: markers/manifests are flushed, so leave a
        # requeue marker (NOT a result — the work is unfinished) and exit
        # with the requeue code; the supervisor resubmits under its
        # preemption budget and the resumed job picks up at block grain
        requeue_path = spec.get("requeue_path")
        if requeue_path:
            tmp = f"{requeue_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump({
                    "preempted": True,
                    "reason": e.reason,
                    "remaining_blocks": len(e.remaining_ids),
                    "time": trace_mod.walltime(),
                    "host": socket.gethostname(),
                    "pid": os.getpid(),
                }, f)
            os.replace(tmp, requeue_path)
        _flush_trace()
        if spec.get("uid"):
            # one last beat so the supervisor's staleness clock sees the
            # drain, not dead air, while the marker propagates over NFS
            try:
                write_heartbeat(spec["tmp_folder"], spec["uid"])
            except OSError:
                pass
        return REQUEUE_EXIT_CODE
    except Exception as e:  # noqa: BLE001 - report ANY failure to the poller
        _flush_trace(error=True)
        emit({
            "ok": False,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc(),
        })
        return 1
    finally:
        if heartbeat is not None:
            heartbeat.stop()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
