"""Logging, backoff, failure and IO-metrics manifests and block success
markers.

Port (a copy) of the parts of ``cluster_tools_tpu/utils/function_utils.py``
that the task runtime and the block executor call.  Completion is
coordinated through JSON markers: one per finished block (the resume
grain inside a task) and one success manifest per task.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import logging
import os
import random
import socket
import sys
import threading
import time
from typing import List, Optional

_LOGGERS = {}
_LOCK = threading.Lock()


def get_logger(name: str = "cluster_tools_tpu_torch", log_file: Optional[str] = None):
    with _LOCK:
        key = (name, log_file)
        if key in _LOGGERS:
            return _LOGGERS[key]
        logger = logging.getLogger(name if log_file is None else f"{name}:{log_file}")
        logger.setLevel(logging.INFO)
        logger.propagate = False
        handler = logging.FileHandler(log_file) if log_file else logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
        _LOGGERS[key] = logger
        return logger


def log(msg: str, log_file: Optional[str] = None):
    get_logger(log_file=log_file).info(msg)


def atomic_write_json(path: str, doc, default=None) -> None:
    """Write JSON via a temp file + ``os.replace``: readers never observe a
    torn document."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, default=default)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_json_if_valid(path: str):
    """Parse a JSON file; ``None`` for a missing or torn file."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def backoff_delay(attempt: int, base: float, cap: float) -> float:
    """Capped exponential backoff with full jitter (0.5x-1x)."""
    return min(cap, base * (2 ** attempt)) * (0.5 + 0.5 * random.random())


def cap_traceback(tb: str, max_chars: int = 2000) -> str:
    """Tail-capped traceback (the last lines carry the error)."""
    if len(tb) <= max_chars:
        return tb
    return "... [truncated] ...\n" + tb[-max_chars:]


def failures_path(tmp_folder: str) -> str:
    """The per-run structured failure manifest (shared by all tasks)."""
    return os.path.join(tmp_folder, "failures.json")


@contextlib.contextmanager
def file_lock(path: str, timeout_s: float = 30.0, stale_s: float = 60.0):
    """Advisory cross-process lock via an ``O_CREAT|O_EXCL`` lock file.  A
    lock older than ``stale_s`` is broken; after ``timeout_s`` it is stolen
    rather than raising (it guards best-effort bookkeeping)."""
    lock = path + ".lock"
    token = f"{socket.gethostname()}:{os.getpid()}:{threading.get_ident()}:{random.random()}"
    deadline = time.time() + float(timeout_s)
    while True:
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, token.encode())
            os.close(fd)
            break
        except FileExistsError:
            try:
                stale = time.time() - os.path.getmtime(lock) > float(stale_s)
            except OSError:
                continue  # released between the create and the stat
            if stale or time.time() > deadline:
                grave = f"{lock}.stolen.{os.getpid()}.{threading.get_ident()}"
                try:
                    os.rename(lock, grave)
                    os.unlink(grave)
                except OSError:
                    pass  # another waiter stole it first
                continue
            time.sleep(0.005 + 0.01 * random.random())
    try:
        yield
    finally:
        try:
            with open(lock) as f:
                if f.read() == token:
                    os.unlink(lock)
        except OSError:
            pass


FAILURES_SCHEMA_VERSION = 2


def record_failures(path: str, task_name: str, records) -> None:
    """Merge block-failure records into ``failures.json`` (atomic, under a
    lock file).  Records are keyed by ``(task, block_id)``; each is stamped
    with the recording host and pid.  Same schema as the reference's."""
    host, pid = socket.gethostname(), os.getpid()
    with file_lock(path):
        doc = read_json_if_valid(path) or {}
        existing = {(r.get("task"), r.get("block_id")): r for r in doc.get("records", [])}
        for rec in records:
            rec = dict(rec)
            rec["task"] = task_name
            rec.setdefault("schema_version", FAILURES_SCHEMA_VERSION)
            rec.setdefault("hostname", host)
            rec.setdefault("pid", pid)
            existing[(task_name, rec.get("block_id"))] = rec
        merged = sorted(existing.values(), key=lambda r: (str(r.get("task")), r.get("block_id") or 0))
        atomic_write_json(path, {"version": FAILURES_SCHEMA_VERSION, "records": merged})


def io_metrics_path(tmp_folder: str) -> str:
    """The per-run IO metrics manifest, next to ``failures.json``."""
    return os.path.join(tmp_folder, "io_metrics.json")


def record_io_metrics(path: str, task_name: str, metrics) -> None:
    """Merge one task's counter deltas into ``io_metrics.json`` (the
    reference's layout: ``{"version": 2, "tasks": {uid: {counter: total}},
    "provenance": {uid: {"host:pid": {"host", "pid", "last_updated",
    "merges", "counters"}}}}``).  Counters merge additively per task uid,
    so a resumed run's second pass accumulates into one total; each merge
    stamps the writing process's provenance entry.  Same file lock as
    :func:`record_failures`."""
    with file_lock(path):
        doc = read_json_if_valid(path) or {}
        doc["version"] = max(2, int(doc.get("version") or 1))
        tasks = doc.setdefault("tasks", {})
        cur = dict(tasks.get(task_name) or {})
        moved = []
        for k, v in dict(metrics).items():
            if isinstance(v, (int, float)) and isinstance(cur.get(k), (int, float)):
                cur[k] = cur[k] + v
            else:
                cur[k] = v
            if not isinstance(v, (int, float)) or v:
                moved.append(str(k))
        tasks[task_name] = cur
        host, pid = socket.gethostname(), os.getpid()
        prov = doc.setdefault("provenance", {}).setdefault(task_name, {})
        entry = dict(prov.get(f"{host}:{pid}") or {})
        entry.update({
            "host": host,
            "pid": pid,
            "last_updated": datetime.datetime.now().isoformat(),
            "merges": int(entry.get("merges", 0)) + 1,
            "counters": sorted(set(entry.get("counters") or []) | set(moved)),
        })
        prov[f"{host}:{pid}"] = entry
        atomic_write_json(path, doc)


def _marker_dir(tmp_folder: str, task_name: str) -> str:
    d = os.path.join(tmp_folder, "markers", task_name)
    os.makedirs(d, exist_ok=True)
    return d


def log_block_success(tmp_folder: str, task_name: str, block_id: int):
    """Record that one block of a task finished (atomic marker)."""
    path = os.path.join(_marker_dir(tmp_folder, task_name), f"block_{block_id}.json")
    atomic_write_json(path, {"block_id": block_id, "time": datetime.datetime.now().isoformat()})


def blocks_done(tmp_folder: str, task_name: str) -> List[int]:
    """Block ids with a valid success marker; torn markers are pruned."""
    d = _marker_dir(tmp_folder, task_name)
    out = []
    for fname in os.listdir(d):
        if fname.startswith("block_") and fname.endswith(".json"):
            if read_json_if_valid(os.path.join(d, fname)) is None:
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(d, fname))
                continue
            out.append(int(fname[len("block_"):-len(".json")]))
    return sorted(out)


def clean_up_for_retry(tmp_folder: str, task_name: str):
    """Drop job-level markers so a failed task re-checks its blocks."""
    d = _marker_dir(tmp_folder, task_name)
    for fname in os.listdir(d):
        if fname.startswith("job_"):
            os.remove(os.path.join(d, fname))


def clear_block_markers(tmp_folder: str, task_name: str):
    """Drop all of a task's markers, block grain included."""
    d = _marker_dir(tmp_folder, task_name)
    for fname in os.listdir(d):
        if fname.startswith(("block_", "job_")):
            with contextlib.suppress(OSError):
                os.remove(os.path.join(d, fname))


def python_executable() -> str:
    """Interpreter for re-executing the port's entry points in batch jobs."""
    return sys.executable
