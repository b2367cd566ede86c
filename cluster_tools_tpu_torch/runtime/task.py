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
11.  Task-graph fusion (``memory_handoffs``, ``device_handoffs``) is not
ported (items 9 and 11): only the storage rung of the handoff methods is.
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

    # -- config ------------------------------------------------------------
    @staticmethod
    def default_task_config() -> Dict[str, Any]:
        return {"threads_per_job": 1, "device_batch": 1}

    @staticmethod
    def default_retry_config() -> Dict[str, Any]:
        """The reference's runtime knobs, with its defaults.  The port honours
        ``max_retries``/``retry_backoff_s`` (task re-runs in :func:`build`),
        ``io_retries``/``io_backoff_s``/``io_threads`` (the executor's
        per-block retries and IO pool), ``block_schedule`` and ``sweep_mode``
        (``auto`` and ``per_block`` both run per block); the others select
        machinery that is not ported and are refused when turned on."""
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
        self.logger.info(f"start {self.task_name} (target={self.target})")
        t0 = time.perf_counter()
        result = self.run_impl() or {}
        result["runtime_s"] = time.perf_counter() - t0
        result["target"] = self.target
        self.output().write(result)
        self.logger.info(f"done {self.task_name} in {result['runtime_s']:.2f}s")

    def complete(self) -> bool:
        return self.output().exists()

    # -- block-level resume helpers ---------------------------------------
    def blocks_done(self) -> List[int]:
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

    # -- handoff targets: the storage rung ---------------------------------
    def _check_handoffs_off(self) -> None:
        cfg = self.get_config()
        for knob in ("memory_handoffs", "device_handoffs"):
            if cfg.get(knob):
                raise NotImplementedError(
                    f"{knob}=True (task-graph fusion) is not ported: ROADMAP Queue A items 9 and 11"
                )

    def handoff_dataset(self, path, key, shape, chunks, dtype, fill_value: int = 0):
        """The output dataset: ``file_reader(path).require_dataset(...)``."""
        from ..utils.volume_utils import file_reader

        self._check_handoffs_off()
        return file_reader(path).require_dataset(key, shape=shape, chunks=chunks, dtype=dtype)

    def save_handoff_arrays(self, path, **arrays):
        """Publish named arrays as an ``.npz`` artifact."""
        import numpy as np

        self._check_handoffs_off()
        np.savez(path, **arrays)

    def save_handoff_array(self, path, array):
        """Publish one array as an ``.npy`` artifact."""
        import numpy as np

        self._check_handoffs_off()
        np.save(path, array)

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
