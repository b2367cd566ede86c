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
reference's cluster targets (``slurm``, ``lsf``) are ROADMAP Queue A item
11.

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
        (:mod:`..parallel.reduce_tree`).  The others select machinery that
        is not ported and are refused when turned on."""
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
        from . import handoff as handoff_mod

        self.logger.info(f"start {self.task_name} (target={self.target})")
        io_snap = chunk_cache.snapshot()
        handoff_snap = handoff_mod.snapshot()
        device_snap = device_pool_mod.snapshot()
        solver_snap = contraction_mod.solver_snapshot()
        tree_snap = reduce_tree_mod.solve_snapshot()
        t0 = time.perf_counter()
        result = self.run_impl() or {}
        handoff_records = self._finalize_handoffs()
        result["runtime_s"] = time.perf_counter() - t0
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
        self.logger.info(f"done {self.task_name} in {result['runtime_s']:.2f}s")

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
        boundary (cluster targets, which the port refuses anyway)."""
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

    def host_block_map(self, block_ids: Sequence[int], process, blocking=None) -> int:
        """Run ``process(block_id)`` for every block without a success marker
        on a pool of ``max_jobs`` host threads, marking each success.

        Per-block retries (``io_retries`` / ``io_backoff_s``) and the sweep
        order (``block_schedule``, Morton when ``blocking`` is given) come from
        the task config.  Every failed block is recorded in ``failures.json``
        and a RuntimeError names them all.  Returns the number of blocks run.
        """
        from .executor import morton_order

        cfg = self.get_config()
        if cfg.get("block_deadline_s"):
            raise NotImplementedError("block_deadline_s (the hung-block watchdog) is not ported: "
                                      "ROADMAP Queue A item 11")
        io_retries = max(0, int(cfg.get("io_retries", 2) or 0))
        io_backoff = float(cfg.get("io_backoff_s", 0.05) or 0.0)
        done = set(self.blocks_done())
        todo = [b for b in block_ids if b not in done]
        if blocking is not None and str(cfg.get("block_schedule") or "morton") == "morton":
            todo = [int(b.block_id) for b in morton_order([blocking.get_block(i) for i in todo])]
        errors: List[tuple] = []

        def wrapped(block_id):
            last_tb = None
            for k in range(io_retries + 1):
                try:
                    process(block_id)
                except Exception:
                    last_tb = fu.cap_traceback(traceback.format_exc())
                    if k < io_retries:
                        time.sleep(fu.backoff_delay(k, io_backoff, 5.0))
                else:
                    self.log_block_success(block_id)
                    return
            errors.append((block_id, last_tb, io_retries + 1))

        with ThreadPoolExecutor(max_workers=max(1, self.max_jobs)) as pool:
            list(pool.map(wrapped, todo))
        if errors:
            fu.record_failures(self.failures_path, self.uid, [
                {"block_id": int(b), "sites": {"host": int(n)}, "error": tb,
                 "quarantined": False, "resolved": False}
                for b, tb, n in sorted(errors)
            ])
            failed_ids = sorted(b for b, _, _ in errors)
            detail = "\n".join(f"-- block {b} --\n{tb}" for b, tb, _ in errors[:5])
            raise RuntimeError(
                f"{self.task_name}: {len(errors)}/{len(todo)} blocks failed (ids: {failed_ids}); "
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
    if target in _CLUSTER_TARGETS:
        raise NotImplementedError(
            f"target {target!r} (batch-cluster submission) is not ported: ROADMAP Queue A item 11"
        )
    if target not in _TARGET_SUFFIX:
        raise ValueError(f"unknown target {target!r}, expected one of {sorted(_TARGET_SUFFIX)}")


def get_task_cls(module, base_name: str, target: str):
    """Resolve ``<Op><Target>`` in an op module: ``local`` -> ``<Op>Local``,
    ``gpu`` -> ``<Op>GPU``."""
    _check_target(target)
    return getattr(module, base_name + _TARGET_SUFFIX[target])


class WorkflowBase(BaseTask):
    """Base for workflow tasks: selects target classes by ``target``
    (default ``gpu``: the card, which must be there) and chains sub-tasks."""

    task_name = "workflow"

    def __init__(self, *args, target: str = "gpu", **kwargs):
        _check_target(target)
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
    option (``NotImplementedError``) propagates.
    """
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
        if not _run_with_retries(task):
            failed.add(key)
    return not failed
