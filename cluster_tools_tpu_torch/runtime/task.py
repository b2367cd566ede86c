"""Task runtime: a small DAG engine with idempotent, resumable tasks.

Port of ``cluster_tools_tpu/runtime/task.py``: the DAG of tasks with
``requires()`` and skip-if-done (:func:`build`, the reference's
``luigi.build``), a success manifest per task plus block markers inside a
task (the resume grains), the config system (``global.config`` +
``<task_name>.config`` over ``default_task_config()``), and the target
pattern: every op module exposes ``<Op>Local`` and ``<Op>GPU`` classes,
selected by :func:`get_task_cls`.

Targets: ``local`` runs on the CPU (the caller asks for it, as the tests
do); ``gpu`` runs on the card and is the default of :class:`WorkflowBase`,
so a workflow that names no target raises where there is no card.  The
cluster targets ``slurm`` and ``lsf`` are synthesized by
:func:`get_task_cls` as in the reference: the task's ``<Op>Local`` class
wrapped into a batch-submitting class (:func:`.cluster.make_cluster_task`)
whose job re-runs the Local variant on the node, so a cluster job runs on
the node's CPU.  That is the reference's behaviour (its cluster targets
serve the ingest side; compute runs on the device), not a gap of the port.

Faults, traces and drain, as in the reference: each task sets the fault
injector's current task and runs inside a ``task.run`` span; with
``CTT_TRACE`` on, the run's spans shard into ``<tmp_folder>/trace/`` and
:func:`build` (a ``task.build`` span) stitches ``trace.json`` and
``trace_summary.json`` at its end.  :meth:`BaseTask.host_block_map` takes
the hung-block deadline, the drain latch and post-store verification with
lineage registration.  A drain (SIGTERM/SIGUSR1, or
:func:`~.supervision.request_drain`) stops :func:`build` before its next
task with :class:`~.supervision.DrainInterrupt`.

Task-graph fusion (``memory_handoffs``, ``device_handoffs``; ROADMAP item
9b): outputs declared through :meth:`BaseTask.handoff_dataset`,
:meth:`BaseTask.save_handoff_arrays` and
:meth:`BaseTask.save_handoff_device_arrays` are :class:`MemoryTarget` targets,
kept in host or device memory by :mod:`.handoff` for the consumer tasks,
with storage as the fallback.  The success manifest records them, and
:meth:`BaseTask.complete` re-runs a producer whose memory-only output is
gone.  Each task's handoff and device-plane counter deltas go into its
manifest and into ``<tmp_folder>/io_metrics.json``.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

from ..utils import function_utils as fu
from ..utils import task_utils as tu
from . import trace as trace_mod
from .executor import target_device


class MemoryTarget:
    """A typed in-memory output target: the declaration that a task's
    output lives in memory under the identity of the dataset or artifact
    a storage consumer would have opened, with storage as the fallback.
    Declared through :meth:`BaseTask.handoff_dataset`,
    :meth:`BaseTask.save_handoff_arrays` or
    :meth:`BaseTask.save_handoff_device_arrays`; backed by the registry of
    :mod:`.handoff`."""

    def __init__(self, entry):
        self.entry = entry

    @property
    def identity(self) -> str:
        return self.entry.identity


class SuccessTarget:
    """A success manifest file, written atomically; a torn manifest counts
    as not done."""

    def __init__(self, tmp_folder: str, task_name: str):
        self.path = os.path.join(tmp_folder, f"{task_name}.success.json")

    def exists(self) -> bool:
        return fu.read_json_if_valid(self.path) is not None

    def write(self, payload: Optional[Dict[str, Any]] = None):
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        doc = {"time": time.time()}
        if payload:
            doc.update(payload)
        fu.atomic_write_json(self.path, doc, default=tu._default)

    def read(self) -> Dict[str, Any]:
        doc = fu.read_json_if_valid(self.path)
        if doc is None:
            raise FileNotFoundError(f"no valid success manifest at {self.path} (missing or torn)")
        return doc


class BaseTask:
    """Base of all tasks.  Subclasses set ``task_name`` and define
    ``run_impl()``; target subclasses (``<Op>Local`` / ``<Op>GPU``) only
    pin ``target``.  ``tmp_folder`` holds scratch and markers,
    ``config_dir`` the JSON configs, ``max_jobs`` the host IO workers."""

    task_name: str = "base"
    target: str = "local"

    def __init__(self, tmp_folder: str, config_dir: str, max_jobs: int = 1,
                 dependencies: Optional[Sequence["BaseTask"]] = None, **params: Any):
        self.tmp_folder = tmp_folder
        self.config_dir = config_dir
        self.max_jobs = int(max_jobs)
        self.dependencies = list(dependencies or [])
        self.params = params
        if self.target == "gpu":
            # a task for the card raises without one, whatever it runs on
            target_device("gpu")
        os.makedirs(tmp_folder, exist_ok=True)
        # identity includes a parameter hash: differently parameterized
        # instances of one task class get distinct targets and markers
        h = hashlib.sha256(
            json.dumps({"params": params, "target": self.target}, sort_keys=True, default=str).encode()
        ).hexdigest()[:8]
        self.uid = f"{self.task_name}.{h}"
        self.logger = fu.get_logger(self.uid, os.path.join(tmp_folder, f"{self.uid}.log"))
        # in-memory output targets declared during run_impl; run() writes
        # them into the success manifest
        self._memory_targets: List[MemoryTarget] = []

    # -- config ------------------------------------------------------------
    @staticmethod
    def default_task_config() -> Dict[str, Any]:
        return {"threads_per_job": 1, "device_batch": 1}

    @staticmethod
    def default_retry_config() -> Dict[str, Any]:
        """The reference's runtime knobs, with its defaults.  The port honours
        ``max_retries``/``retry_backoff_s`` (task re-runs in :func:`build`),
        ``io_retries``/``io_backoff_s``/``io_threads`` (the executor's
        per-block retries and IO pool), ``block_schedule``, ``sweep_mode``
        (``auto`` runs sharded once the sweep fills a batch, as in the
        reference; ``sharded`` and ``per_block`` force a path) with
        ``sharded_batch``, and ``device_pool`` / ``device_pool_bytes`` (the
        resident page pool of ragged sweeps).  A task config may also set
        ``ragged`` (``auto``/``on``/``off``), which the executor takes as
        the reference's ``map_blocks`` does.  ``inflight_byte_budget``
        (None: a quarter of MemAvailable less the live handoff bytes; 0:
        off) and ``degrade_wait_s`` go to the executor's admission gate;
        ``memory_handoffs`` and ``device_handoffs`` (default off) turn on
        task-graph fusion (:mod:`.handoff`).  ``solver_shards`` /
        ``reduce_fanout`` / ``solver_workers`` / ``reduce_plane`` /
        ``hop_deadline_s`` shard the global solves over the reduce tree
        (:mod:`..parallel.reduce_tree`).  ``block_deadline_s`` /
        ``watchdog_period_s`` arm the hung-block watchdog (the executor and
        :meth:`host_block_map`), and ``allow_block_split`` /
        ``min_block_shape`` the degrade-and-split of the tasks whose
        kernels are shape-local (inference, ilastik).  The heartbeat and
        resubmission knobs (``heartbeat_interval_s``,
        ``heartbeat_timeout_s``, ``max_resubmits``,
        ``max_preempt_resubmits``) drive the cluster targets' supervisor
        (:func:`.cluster.supervise_job`)."""
        return {
            "max_retries": 0,
            "retry_backoff_s": 1.0,
            "io_retries": 2,
            "io_backoff_s": 0.05,
            "io_threads": None,
            "block_schedule": "morton",
            "sweep_mode": "auto",
            "sharded_batch": None,
            "block_deadline_s": None,
            "watchdog_period_s": None,
            "heartbeat_interval_s": 5.0,
            "heartbeat_timeout_s": 0.0,
            "max_resubmits": 2,
            "max_preempt_resubmits": 3,
            "allow_block_split": False,
            "min_block_shape": None,
            "degrade_wait_s": 5.0,
            "inflight_byte_budget": None,
            "memory_handoffs": False,
            "device_pool": "auto",
            "device_pool_bytes": None,
            "device_handoffs": False,
            "solver_shards": 1,
            "reduce_fanout": 2,
            "solver_workers": 1,
            "reduce_plane": "auto",
            "hop_deadline_s": None,
        }

    @staticmethod
    def default_global_config() -> Dict[str, Any]:
        return {"block_shape": [64, 64, 64], "roi_begin": None, "roi_end": None, "halo": None}

    def get_config(self) -> Dict[str, Any]:
        defaults = dict(self.default_global_config())
        defaults.update(self.default_retry_config())
        defaults.update(self.default_task_config())
        config = tu.load_task_config(self.config_dir, self.task_name, defaults)
        config.update(self.params)
        return config

    @property
    def device(self):
        """The torch device of this task's target (raises for ``gpu``
        without a card)."""
        return target_device(self.target)

    # -- DAG protocol ------------------------------------------------------
    def requires(self) -> List["BaseTask"]:
        return self.dependencies

    def output(self) -> SuccessTarget:
        return SuccessTarget(self.tmp_folder, self.uid)

    def run_impl(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def run(self):
        from ..io import chunk_cache
        from ..ops import contraction as contraction_mod
        from ..parallel import device_pool as device_pool_mod
        from ..parallel import reduce_tree as reduce_tree_mod
        from . import faults as faults_mod
        from . import handoff as handoff_mod

        self.logger.info(f"start {self.task_name} (target={self.target})")
        # the run's spans shard into <tmp_folder>/trace/ (an operator's
        # CTT_TRACE=<dir> pin wins)
        if trace_mod.enabled():
            trace_mod.set_trace_dir(os.path.join(self.tmp_folder, trace_mod.TRACE_DIRNAME))
        # the task.run span is the runtime_s clock and carries the
        # dependency uids the summary's critical path walks
        run_span = trace_mod.begin("task.run", task=self.uid, task_name=self.task_name,
                                   deps=[d.uid for d in self.dependencies])
        # fault specs with a "tasks" filter target the running task's uid
        faults_mod.set_current_task(self.uid)
        io_snap = chunk_cache.snapshot()
        handoff_snap = handoff_mod.snapshot()
        device_snap = device_pool_mod.snapshot()
        solver_snap = contraction_mod.solver_snapshot()
        tree_snap = reduce_tree_mod.solve_snapshot()
        ok = False
        try:
            result = self.run_impl() or {}
            # inside the task context: forced spill faults filter on the
            # producing task's uid
            handoff_records = self._finalize_handoffs()
            ok = True
        finally:
            faults_mod.set_current_task(None)
            if not ok:
                # a failed task's spans reach the timeline too
                run_span.end(error=True)
                self._flush_trace()
        result["runtime_s"] = run_span.end()
        result["target"] = self.target
        if handoff_records:
            # the resume contract of complete(): a memory-only record whose
            # handle died with this process re-runs the task
            result["handoffs"] = handoff_records
        # the counters' movement during this task, in the manifest and
        # merged additively into the run's io_metrics.json
        io_metrics = {}
        for metrics in (chunk_cache.delta(io_snap), handoff_mod.delta(handoff_snap),
                        device_pool_mod.delta(device_snap), contraction_mod.solver_delta(solver_snap),
                        reduce_tree_mod.solve_delta(tree_snap)):
            if any(metrics.values()):
                io_metrics.update(metrics)
        if io_metrics:
            result["io_metrics"] = io_metrics
            try:
                fu.record_io_metrics(fu.io_metrics_path(self.tmp_folder), self.uid, io_metrics)
            except Exception:
                self.logger.warning(f"io_metrics recording failed:\n{traceback.format_exc()}")
        self.output().write(result)
        # flush this process's shard and restitch the timeline (throttled;
        # build() always merges at its end)
        self._flush_trace(merge=True)
        self.logger.info(f"done {self.task_name} in {result['runtime_s']:.2f}s")

    def _flush_trace(self, merge: bool = False) -> None:
        """Best-effort shard flush (and timeline merge): tracing never fails
        a run."""
        if not trace_mod.enabled():
            return
        try:
            trace_mod.flush()
            if merge:
                trace_mod.write_timeline(self.tmp_folder, min_interval_s=trace_mod.MERGE_MIN_INTERVAL_S)
        except Exception:
            self.logger.warning(f"trace flush failed:\n{traceback.format_exc()}")

    def complete(self) -> bool:
        """The success manifest exists and every memory-only output it
        records is still resolvable in this process's registry (live, or
        spilled since).  A memory-only manifest whose handle is gone (a new
        process) or that belongs to another request's namespace is removed
        with its block markers, so the DAG re-runs the producer."""
        doc = fu.read_json_if_valid(self.output().path)
        if doc is None:
            return False
        stale = [h for h in doc.get("handoffs", []) if not h.get("stored")]
        if stale:
            from . import handoff

            stale = [h for h in stale
                     if not (handoff.in_current_namespace(h.get("identity"))
                             and handoff.is_resolvable(h.get("identity")))]
        if not stale:
            return True
        self.logger.info(f"{self.task_name}: {len(stale)} memory-only handoff output(s) no longer live "
                         "(a new process?): re-running the task")
        try:
            os.remove(self.output().path)
        except OSError:
            pass
        fu.clear_block_markers(self.tmp_folder, self.uid)
        return False

    # -- block-level resume helpers ---------------------------------------
    def blocks_done(self) -> List[int]:
        # markers stamped by another process's in-memory run describe data
        # that died with it: cleared whatever this run's storage path
        from . import handoff

        if handoff.invalidate_stale_markers(self.tmp_folder, self.uid):
            self.logger.info(f"{self.task_name}: cleared block markers of another process's in-memory run "
                             "(its outputs no longer exist)")
        return fu.blocks_done(self.tmp_folder, self.uid)

    def log_block_success(self, block_id: int):
        fu.log_block_success(self.tmp_folder, self.uid, block_id)

    @property
    def failures_path(self) -> str:
        """The run's shared ``failures.json`` manifest."""
        return fu.failures_path(self.tmp_folder)

    def clean_up_for_retry(self):
        """Job-level markers go; valid block markers stay (a re-run resumes
        at block grain)."""
        fu.clean_up_for_retry(self.tmp_folder, self.uid)
        self.blocks_done()

    # -- in-memory handoff targets (task-graph fusion) --------------------
    def _handoffs_on(self) -> bool:
        """Fusion applies when the ``memory_handoffs`` knob is set, the
        process switch (``CTT_HANDOFF``) is on and the task crosses no host
        boundary (cluster targets: the job's memory dies with its node
        process)."""
        if self.target in _CLUSTER_TARGETS:
            return False
        from . import handoff

        if not handoff.handoff_enabled():
            return False
        try:
            cfg = self.get_config()
        except Exception:
            return False
        return bool(cfg.get("memory_handoffs", False))

    def declare_handoff_producer(self) -> bool:
        """Call at the top of a task that publishes artifact handoffs from
        block-grain work (per-block npz/npy under :meth:`host_block_map`):
        returns whether handoffs are on, and stamps this task's markers
        with the process token, so a later run in another process clears
        them before trusting them.  Dataset producers get the same guard
        from :meth:`handoff_dataset`."""
        if not self._handoffs_on():
            return False
        from . import handoff

        handoff.invalidate_stale_markers(self.tmp_folder, self.uid)
        handoff.mark_memory_producer(self.tmp_folder, self.uid)
        return True

    def handoff_dataset(self, path, key, shape, chunks, dtype, fill_value: int = 0):
        """Declare a chunked-volume output as a :class:`MemoryTarget` and
        return the dataset to write through.  Handoffs off (the default):
        ``file_reader(path).require_dataset(...)``, the storage path.  On:
        the in-memory :class:`~..io.containers.HandoffDataset`, unless the
        target spills at birth (the byte budget, or a spilled predecessor
        at the same identity), when it is the storage dataset."""
        from ..utils.volume_utils import file_reader
        from . import handoff

        if not self._handoffs_on():
            # an earlier run's live payload must not shadow the fresh
            # storage bytes this run is about to write
            handoff.discard(handoff.dataset_identity(path, key))
            return file_reader(path).require_dataset(key, shape=shape, chunks=chunks, dtype=dtype)
        # markers stamped by another process's in-memory run are stale on
        # every acquire path, spill at birth included
        handoff.invalidate_stale_markers(self.tmp_folder, self.uid)
        ds, entry = handoff.acquire_dataset(path, key, shape=shape, chunks=chunks, dtype=dtype, producer=self.uid,
                                            failures_path=self.failures_path, fill_value=fill_value)
        self._memory_targets.append(MemoryTarget(entry))
        if not entry.spilled:
            handoff.mark_memory_producer(self.tmp_folder, self.uid)
        return ds

    def save_handoff_arrays(self, path, **arrays):
        """Publish named arrays as the artifact a storage consumer would
        have loaded from ``path`` (npz): a plain ``np.savez`` with handoffs
        off, else read-only in host RAM unless the budget writes the file
        (and its CRC sidecar) through."""
        import numpy as np

        from . import handoff

        if not self._handoffs_on():
            # drop an earlier run's live payload and spill sidecar: the
            # plain file this run writes is the truth
            handoff.forget_artifact(path)
            np.savez(path, **arrays)
            return
        entry = handoff.publish_arrays(path, arrays, producer=self.uid, failures_path=self.failures_path)
        self._memory_targets.append(MemoryTarget(entry))

    def save_handoff_array(self, path, array):
        """Single-array (``.npy``) twin of :meth:`save_handoff_arrays`."""
        import numpy as np

        from . import handoff

        if not self._handoffs_on():
            handoff.forget_artifact(path)
            np.save(path, array)
            return
        entry = handoff.publish_arrays(path, {"data": array}, producer=self.uid, failures_path=self.failures_path)
        self._memory_targets.append(MemoryTarget(entry))

    def _device_handoffs_on(self) -> bool:
        """The device rung: the ``device_handoffs`` knob on top of
        :meth:`_handoffs_on`, and the ``CTT_DEVICE_POOL`` kill switch."""
        if not self._handoffs_on():
            return False
        from ..parallel import device_pool

        if not device_pool.device_pool_enabled():
            return False
        try:
            cfg = self.get_config()
        except Exception:
            return False
        return bool(cfg.get("device_handoffs", False))

    def save_handoff_device_arrays(self, path, **arrays):
        """Device-rung twin of :meth:`save_handoff_arrays`: with
        ``device_handoffs`` on, the named tensors (numpy arrays are uploaded
        to this task's device) stay in device memory under the artifact
        identity for :func:`~.handoff.resolve_device_arrays`; otherwise
        they land on the memory rung or in a plain npz, one device-to-host
        copy, as :meth:`save_handoff_arrays` takes them."""
        from . import handoff

        if not self._device_handoffs_on():
            return self.save_handoff_arrays(path, **{k: _host_array(v) for k, v in arrays.items()})
        entry = handoff.publish_device_arrays(path, arrays, producer=self.uid, failures_path=self.failures_path,
                                              device=self.device)
        self._memory_targets.append(MemoryTarget(entry))

    def save_handoff_device_array(self, path, array):
        """Single-array (``.npy``) twin of :meth:`save_handoff_device_arrays`."""
        from . import handoff

        if not self._device_handoffs_on():
            return self.save_handoff_array(path, _host_array(array))
        entry = handoff.publish_device_arrays(path, {"data": array}, producer=self.uid,
                                              failures_path=self.failures_path, device=self.device)
        self._memory_targets.append(MemoryTarget(entry))

    def _finalize_handoffs(self) -> List[Dict[str, Any]]:
        """Mark this run's declared targets complete; returns the manifest
        records :meth:`complete` validates on resume."""
        if not self._memory_targets:
            return []
        from . import handoff

        return handoff.finalize_task(self._memory_targets, self.uid)

    def host_block_map(self, block_ids: Sequence[int], process, store_verify_fn=None, blocking=None) -> int:
        """Run ``process(block_id)`` for every block without a success marker
        on a pool of ``max_jobs`` host threads, marking each success.

        From the task config, as in the reference: per-block retries
        (``io_retries`` / ``io_backoff_s``; a resource-classified failure,
        OOM or ENOSPC, is not retried at the same size), the hung-block
        deadline (``block_deadline_s`` / ``watchdog_period_s``: an overdue
        block is recorded ``hung``, resolved if it finishes) and the sweep
        order (``block_schedule``, Morton when ``blocking`` is given).  From
        the call site: ``store_verify_fn(block)``, a post-store integrity
        check (:func:`~.executor.region_verifier`; a corruption retries the
        block, whose re-run re-writes it) that also registers the block's
        lineage for repair, and ``blocking``.  A drain stops claiming
        blocks and raises :class:`~.supervision.DrainInterrupt` once the
        running ones are done.  Every failed block is recorded in
        ``failures.json`` and a RuntimeError names them all.  Returns the
        number of blocks run.
        """
        from . import admission as admission_mod
        from .executor import classify_resource_error, morton_order
        from .supervision import DrainInterrupt, Watchdog, drain_reason, drain_requested

        try:
            cfg = self.get_config()
        except Exception:
            cfg = {}
        io_retries = max(0, int(cfg.get("io_retries", 2) or 0))
        io_backoff = float(cfg.get("io_backoff_s", 0.05) or 0.0)
        deadline = float(cfg.get("block_deadline_s") or 0.0)
        period = cfg.get("watchdog_period_s")
        done = set(self.blocks_done())
        todo = [b for b in block_ids if b not in done]
        if blocking is not None and str(cfg.get("block_schedule") or "morton") == "morton":
            todo = [int(b.block_id) for b in morton_order([blocking.get_block(i) for i in todo])]
        errors: List[tuple] = []
        skipped_for_drain: List[int] = []
        hung: Dict[int, str] = {}
        completed: set = set()
        watchdog = None
        if deadline > 0:
            def _on_hung(token, info, elapsed):
                hung[int(info["block_id"])] = (f"block exceeded block_deadline_s={deadline:g}s on the host path "
                                               f"({elapsed:.2f}s elapsed)")

            watchdog = Watchdog(deadline, float(period) if period else max(0.02, deadline / 4.0), _on_hung).start()

        def register_lineage(block_id):
            """A verified host store registers its recompute (re-run
            ``process``, re-verify) for lineage repair; best effort."""
            ds = getattr(store_verify_fn, "dataset", None)
            if ds is None:
                return
            try:
                from . import repair as repair_mod

                bb_of = getattr(store_verify_fn, "bb_of", None) or (lambda b: b.bb)

                def recompute(b=block_id):
                    process(b)
                    store_verify_fn(blocking.get_block(b))

                repair_mod.register_producer(ds, bb_of(blocking.get_block(block_id)), recompute, task=self.uid,
                                             block_id=int(block_id), failures_path=self.failures_path)
            except Exception:
                pass

        # the service request's context is thread-local: each block
        # re-enters it on the pool's thread, so artifact handoffs that
        # ``process`` publishes keep the request's namespace
        req_ctx = admission_mod.current_request()

        def wrapped(block_id):
            if drain_requested():
                # stop claiming blocks; the finished ones keep their markers
                skipped_for_drain.append(block_id)
                return
            last_tb, attempts = None, 0
            # the span covers the whole retry ladder
            with admission_mod.request_scope(req_ctx), trace_mod.span("host.block", block=int(block_id),
                                                                       task=self.uid):
                for k in range(io_retries + 1):
                    attempts = k + 1
                    if watchdog is not None:
                        watchdog.register((block_id, k), block_id=int(block_id), stage="host")
                    try:
                        process(block_id)
                        if store_verify_fn is not None and blocking is not None:
                            store_verify_fn(blocking.get_block(block_id))
                    except Exception as e:
                        last_tb = fu.cap_traceback(traceback.format_exc())
                        if classify_resource_error(e) is not None:
                            break  # a same-size retry re-runs the failed allocation
                        if k < io_retries:
                            time.sleep(fu.backoff_delay(k, io_backoff, 5.0))
                    else:
                        completed.add(block_id)
                        self.log_block_success(block_id)
                        if store_verify_fn is not None and blocking is not None:
                            register_lineage(block_id)
                        return
                    finally:
                        if watchdog is not None:
                            watchdog.clear((block_id, k))
            trace_mod.instant("fault:host", block=int(block_id), task=self.uid)
            errors.append((block_id, last_tb, attempts))

        try:
            with ThreadPoolExecutor(max_workers=max(1, self.max_jobs)) as pool:
                list(pool.map(wrapped, todo))
        finally:
            if watchdog is not None:
                watchdog.stop()
        records = [{"block_id": int(b), "sites": {"host": int(n)}, "error": tb, "quarantined": False,
                    "resolved": False} for b, tb, n in sorted(errors)]
        failed_ids = {b for b, _, _ in errors}
        # a hung block that finished (and was marked) is resolved
        records += [{"block_id": int(b), "sites": {"hung": 1}, "error": msg, "quarantined": False,
                     "resolved": b in completed} for b, msg in sorted(hung.items()) if b not in failed_ids]
        if records:
            fu.record_failures(self.failures_path, self.uid, records)
        if skipped_for_drain:
            # a drain outranks block errors: the resumed run retries them
            raise DrainInterrupt(drain_reason() or "drain requested", skipped_for_drain + sorted(failed_ids))
        if errors:
            detail = "\n".join(f"-- block {b} --\n{tb}" for b, tb, _ in errors[:5])
            raise RuntimeError(
                f"{self.task_name}: {len(errors)}/{len(todo)} blocks failed (ids: {sorted(failed_ids)}); "
                f"see {self.failures_path}; first tracebacks:\n{detail}"
            )
        return len(todo)


def _host_array(a):
    """A tensor (or array) as a numpy array on the host; a copy off the
    card counts in the device plane's ``d2h_bytes``."""
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            from ..parallel import device_pool

            device_pool.record_d2h(a.nbytes)
        return a.detach().cpu().numpy()
    return np.asarray(a)


_TARGET_SUFFIX = {"local": "Local", "gpu": "GPU"}
_CLUSTER_TARGETS = ("slurm", "lsf")


def _check_target(target: str) -> None:
    if target not in _TARGET_SUFFIX and target not in _CLUSTER_TARGETS:
        raise ValueError(f"unknown target {target!r}, expected one of "
                         f"{sorted(_TARGET_SUFFIX) + list(_CLUSTER_TARGETS)}")


def get_task_cls(module, base_name: str, target: str):
    """Resolve ``<Op><Target>`` in an op module: ``local`` -> ``<Op>Local``,
    ``gpu`` -> ``<Op>GPU``.  ``slurm``/``lsf`` are synthesized on demand:
    the task's Local variant wrapped into a batch-submitting class
    (``runtime/cluster.py``), so every task gains the cluster backends
    without per-module boilerplate."""
    _check_target(target)
    if target in _CLUSTER_TARGETS:
        from .cluster import make_cluster_task

        return make_cluster_task(getattr(module, base_name + "Local"), target)
    return getattr(module, base_name + _TARGET_SUFFIX[target])


class WorkflowBase(BaseTask):
    """Base for workflow tasks: selects target classes by ``target``
    (default ``gpu``: the card, which must be there) and chains sub-tasks.
    A cluster target asks for no device here: its jobs run the Local
    variant on the node."""

    task_name = "workflow"

    def __init__(self, *args, target: str = "gpu", **kwargs):
        _check_target(target)
        if target not in _CLUSTER_TARGETS:
            target_device(target)
        # set before super().__init__ so the uid hash sees the real target
        self.target = target
        super().__init__(*args, **kwargs)

    def run_impl(self):
        return {}


def _run_with_retries(task: BaseTask) -> bool:
    """One task to completion: ``max_retries`` re-runs with capped
    exponential backoff, clearing job markers between attempts (block
    markers survive, so a retry resumes at block grain)."""
    try:
        cfg = task.get_config()
        max_retries = int(cfg.get("max_retries", 0) or 0)
        backoff = float(cfg.get("retry_backoff_s", 1.0) or 0.0)
    except Exception:
        max_retries, backoff = 0, 1.0
    for attempt in range(max_retries + 1):
        if attempt:
            delay = fu.backoff_delay(attempt - 1, backoff, 60.0)
            task.logger.warning(f"retry {attempt}/{max_retries} for {task.task_name} after {delay:.1f}s backoff")
            task.clean_up_for_retry()
            time.sleep(delay)
        try:
            task.run()
        except NotImplementedError:
            raise  # a refused option fails the same way on every attempt
        except Exception:
            task.logger.error(f"task {task.task_name} failed (attempt {attempt + 1}/{max_retries + 1}):\n"
                              f"{traceback.format_exc()}")
            continue
        if task.output().exists():
            return True
        task.logger.error(f"task {task.task_name} produced no target")
    return False


def build(tasks: Sequence[BaseTask], rerun: bool = False) -> bool:
    """Run a task DAG to completion (the reference's ``luigi.build``).

    Dependencies run first; a task whose success target exists is skipped
    (idempotent resume).  A failed task (after its retries) skips only its
    dependents.  Returns True only if every task succeeded.  A refused
    option (``NotImplementedError``) propagates; so does a drain
    (:class:`~.supervision.DrainInterrupt`, checked before each task).  The
    ``task_done`` kill point fires after each finished task, and with
    tracing on the run's timeline is written at the end.
    """
    from . import faults as faults_mod
    from .supervision import DrainInterrupt, drain_reason, drain_requested

    order: List[BaseTask] = []
    seen = set()
    deps_of: Dict[tuple, List[tuple]] = {}

    def _key(task: BaseTask) -> tuple:
        return (type(task).__name__, task.uid, task.tmp_folder)

    def visit(task: BaseTask, stack: tuple):
        key = _key(task)
        if key in stack:
            raise RuntimeError(f"dependency cycle at {key}")
        if key in seen:
            return
        deps = task.requires()
        deps_of[key] = [_key(dep) for dep in deps]
        for dep in deps:
            visit(dep, stack + (key,))
        seen.add(key)
        order.append(task)

    for t in tasks:
        visit(t, ())

    # brackets every task.run of this build: the timeline shows the gaps
    # between tasks too
    build_span = trace_mod.begin("task.build", n_tasks=len(order))
    failed: set = set()
    for task in order:
        key = _key(task)
        if task.complete() and not rerun:
            task.logger.info(f"skip {task.task_name}: target exists")
            continue
        blocked = [d for d in deps_of[key] if d in failed]
        if blocked:
            task.logger.error(f"skip {task.task_name}: upstream failed ({[d[0] for d in blocked]})")
            failed.add(key)
            continue
        if drain_requested():
            raise DrainInterrupt(drain_reason() or "drain requested")
        if _run_with_retries(task):
            faults_mod.get_injector().kill_point("task_done")
        else:
            failed.add(key)
    build_span.end(n_failed=len(failed))
    if trace_mod.enabled() and order:
        # the build span reaches the timeline through the last task's
        # tmp_folder, where the run's shard directory lives
        try:
            trace_mod.flush()
            trace_mod.write_timeline(order[-1].tmp_folder)
        except Exception:
            pass
    return not failed
