"""The resident scrubber: background verify-at-rest for stored block
products, with lineage repair on mismatch (docs/SERVING.md
"Self-healing").

Port (a copy) of ``cluster_tools_tpu/runtime/scrub.py``; it reads, verifies
and repairs through the port's containers, ``io/verified.py`` and
``runtime/repair.py``, and writes the same ``scrub_state.json``.

The verifying reader only checks bytes somebody reads; cold data rots
unobserved.  :class:`Scrubber` is the server-resident loop that walks
digest-sidecar manifests, re-reads a *budgeted* number of bytes per
interval straight from storage (``verify_region`` bypasses the chunk
cache on purpose — the scrub must see the disk), and hands every mismatch
to :mod:`.repair`.  Rate limiting is two knobs:
``interval_s`` between scan slices and ``bytes_per_interval`` of region
data verified per slice — the scrub tax on a loaded server stays small
and constant (the <5 % bar of docs/SERVING.md) while still bounding the
time-to-detection for any given corpus size.

Work discovery is two planes, deduplicated by dataset label:

- the **live registry** (:func:`register_target`): every storage-backed
  product store that registers lineage (``repair.register_producer``)
  becomes a scrub target in the same process — these are the datasets the
  scrubber can both find *and* heal;
- **root walking**: directories handed to the scrubber (the server's
  ``base_dir`` plus configured roots) are searched for ``.ctt_checksums``
  sidecar dirs, so at-rest products from *previous* incarnations are
  still verified after a restart (found-but-unrepairable rot is
  attributed, not hidden).

The scrubber pauses while a drain is requested (a SIGTERM'd server spends
its grace period finishing requests, not scrubbing) and reports through
``scrub_state.json`` (next to ``failures.json``), the ``/healthz`` and
``/status`` scrub blocks, and ``make progress``
(docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import function_utils as fu
from . import repair as repair_mod
from . import trace as trace_mod
from .supervision import drain_requested

STATE_FILENAME = "scrub_state.json"

_DEFAULT_INTERVAL_S = 5.0
_DEFAULT_BYTES_PER_INTERVAL = 16 << 20
_TARGET_MAX = 256
_WALK_DIR_CAP = 2000

_reg_lock = threading.Lock()
#: label -> dataset; storage-backed product stores registered by the
#: repair engine (bounded LRU — a resident server must not accrete
#: handles for every dataset it ever touched)
_targets: "OrderedDict[str, Any]" = OrderedDict()


def register_target(dataset) -> bool:
    """Enlist a dataset for background scrubbing.  Only storage-backed
    sidecar indexes qualify (in-memory handoffs die with their request;
    their spilled copies re-register through the spill's store path)."""
    checks = getattr(dataset, "_checksums", None)
    label = getattr(dataset, "_label", None)
    if checks is None or label is None or getattr(checks, "_dir", None) is None:
        return False
    with _reg_lock:
        _targets[str(label)] = dataset
        _targets.move_to_end(str(label))
        while len(_targets) > _TARGET_MAX:
            _targets.popitem(last=False)
    return True


def registered_targets() -> List[Tuple[str, Any]]:
    with _reg_lock:
        return list(_targets.items())


def reset_targets() -> None:
    """Drop the registry (tests)."""
    with _reg_lock:
        _targets.clear()


def _container_of(sidecar_dir: str) -> Optional[Tuple[str, str]]:
    """Map ``<container>/<key...>/.ctt_checksums`` to (container, key)."""
    from ..io.containers import _ZARR_EXTS

    ds_dir = os.path.dirname(os.path.abspath(sidecar_dir))
    probe = ds_dir
    while True:
        parent = os.path.dirname(probe)
        if probe.lower().endswith(_ZARR_EXTS):
            key = os.path.relpath(ds_dir, probe)
            return (probe, key) if key not in (".", "") else None
        if parent == probe:
            return None
        probe = parent


def discover_targets(roots) -> List[Tuple[str, str]]:
    """(container, key) pairs found by walking ``roots`` for sidecar
    dirs — the at-rest plane that survives process restarts.  The walk is
    capped (``_WALK_DIR_CAP`` dirs) so a pathological tree cannot wedge a
    scrub slice."""
    found: List[Tuple[str, str]] = []
    seen = set()
    budget = _WALK_DIR_CAP
    for root in roots or ():
        if not root or not os.path.isdir(root):
            continue
        for dirpath, dirnames, _files in os.walk(root):
            budget -= 1
            if budget <= 0:
                return found
            if os.path.basename(dirpath) != ".ctt_checksums":
                continue
            dirnames[:] = []
            pair = _container_of(dirpath)
            if pair is not None and pair not in seen:
                seen.add(pair)
                found.append(pair)
    return found


class Scrubber:
    """The server-resident background verifier (see module docstring).

    Thread-owned state only; ``stats()`` snapshots under the lock for the
    health surfaces.  ``scan_once()`` is also the synchronous entry point
    the smoke test and an operator REPL can drive without the thread."""

    def __init__(
        self,
        base_dir: Optional[str] = None,
        interval_s: float = _DEFAULT_INTERVAL_S,
        bytes_per_interval: int = _DEFAULT_BYTES_PER_INTERVAL,
        roots: Optional[List[str]] = None,
        enabled: bool = True,
    ):
        self.base_dir = os.path.abspath(base_dir) if base_dir else None
        self.interval_s = max(0.05, float(interval_s))
        self.bytes_per_interval = max(1, int(bytes_per_interval))
        self.roots = [os.path.abspath(r) for r in (roots or []) if r]
        if self.base_dir and self.base_dir not in self.roots:
            self.roots.append(self.base_dir)
        self.enabled = bool(enabled)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._open_cache: "OrderedDict[Tuple[str, str], Any]" = OrderedDict()
        self._offset = 0
        self._scanned_in_pass = 0
        self._worklist_len = 0
        self._position: Optional[Dict[str, Any]] = None
        self._last_corrupt: Optional[Dict[str, Any]] = None
        self._counts = {
            "passes": 0, "scanned_regions": 0, "scanned_bytes": 0,
            "found_corrupt": 0, "repaired": 0, "unrepairable": 0,
            "errors": 0,
        }

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Scrubber":
        if not self.enabled or self._thread is not None:
            return self
        # the state file exists from boot: report consumers can tell "a
        # scrubber is on, nothing scanned yet" from "no scrubber at all"
        self._write_state()
        self._thread = threading.Thread(
            target=self._loop, name="scrubber", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            if drain_requested():
                continue  # the grace period belongs to in-flight requests
            try:
                self.scan_once()
            except Exception:
                with self._lock:
                    self._counts["errors"] += 1

    # -- one budgeted slice ------------------------------------------------
    def _open_dataset(self, container: str, key: str):
        from ..io.containers import open_container

        ck = (container, key)
        ds = self._open_cache.get(ck)
        if ds is None:
            ds = open_container(container, "a")[key]
            self._open_cache[ck] = ds
            while len(self._open_cache) > _TARGET_MAX:
                self._open_cache.popitem(last=False)
        return ds

    def _worklist(self) -> List[Tuple[str, Any, tuple]]:
        """(label, dataset, region) triples across both discovery planes,
        label-deduplicated, in a stable order so the cursor is
        meaningful."""
        by_label: "OrderedDict[str, Any]" = OrderedDict()
        for label, ds in registered_targets():
            by_label[label] = ds
        for container, key in discover_targets(self.roots):
            label = f"{container}:{key}"
            if label in by_label:
                continue
            try:
                by_label[label] = self._open_dataset(container, key)
            except Exception:
                with self._lock:
                    self._counts["errors"] += 1
        work: List[Tuple[str, Any, tuple]] = []
        for label in sorted(by_label):
            ds = by_label[label]
            try:
                regions = sorted(ds.checksum_regions())
            except Exception:
                with self._lock:
                    self._counts["errors"] += 1
                continue
            work.extend((label, ds, tuple(r)) for r in regions)
        return work

    @staticmethod
    def _region_nbytes(ds, bb) -> int:
        entry = None
        probe = getattr(ds, "checksum_entry", None)
        if probe is not None:
            try:
                entry = probe(bb)
            except Exception:
                entry = None
        if not entry:
            return 0
        try:
            return int(
                np.prod(entry.get("shape") or [0], dtype=np.int64)
                * np.dtype(entry.get("dtype") or "u1").itemsize
            )
        except Exception:
            return 0

    def _verify_one(self, label: str, ds, region) -> int:
        from ..io.containers import ChunkCorruptionError

        bb = tuple(slice(a, b) for a, b in region)
        nbytes = self._region_nbytes(ds, bb)
        try:
            ds.verify_region(bb)
        except ChunkCorruptionError:
            try:
                # double-check before crying rot: a live writer can land
                # region bytes a beat before its fresh sidecar (write,
                # then record) — the re-verify re-reads BOTH, so only
                # damage that holds still twice counts as corruption
                ds.verify_region(bb)
                return nbytes
            except ChunkCorruptionError:
                pass
            trace_mod.instant("scrub.corrupt", dataset=label)
            healed = repair_mod.attempt_repair(ds, region, "scrub")
            with self._lock:
                self._counts["found_corrupt"] += 1
                self._counts["repaired" if healed else "unrepairable"] += 1
                self._last_corrupt = {
                    "dataset": label,
                    "region": [list(r) for r in region],
                    "repaired": bool(healed),
                }
        except Exception:
            with self._lock:
                self._counts["errors"] += 1
        return nbytes

    def scan_once(self, budget_bytes: Optional[int] = None) -> int:
        """Verify up to ``budget_bytes`` of recorded regions, resuming at
        the cursor; returns regions scanned.  Wrapping the worklist
        completes a pass (full-corpus coverage)."""
        budget = int(budget_bytes or self.bytes_per_interval)
        work = self._worklist()
        n = len(work)
        with self._lock:
            self._worklist_len = n
            if n == 0:
                self._offset = 0
                self._scanned_in_pass = 0
                self._position = None
        if n == 0:
            self._write_state()
            return 0
        scanned = 0
        with trace_mod.span("scrub.slice", regions=n):
            while budget > 0 and scanned < n and not self._stop.is_set():
                idx = self._offset % n
                label, ds, region = work[idx]
                nbytes = self._verify_one(label, ds, region)
                budget -= max(1, nbytes)
                scanned += 1
                with self._lock:
                    self._counts["scanned_regions"] += 1
                    self._counts["scanned_bytes"] += nbytes
                    self._scanned_in_pass += 1
                    self._offset = idx + 1
                    if self._offset >= n:
                        self._offset = 0
                        self._counts["passes"] += 1
                        self._scanned_in_pass = 0
                    self._position = {
                        "dataset": label,
                        "index": self._offset,
                        "of": n,
                    }
        self._write_state()
        return scanned

    # -- reporting ---------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """The scrub block of ``/healthz`` / ``/status`` /
        ``scrub_state.json``: counters, cursor position, and pass
        coverage, plus the verifying-reader and repair-engine counters it
        cross-checks (docs/OBSERVABILITY.md)."""
        from ..io import verified as verified_mod

        with self._lock:
            doc: Dict[str, Any] = dict(self._counts)
            n = self._worklist_len
            doc.update({
                "enabled": self.enabled,
                "interval_s": self.interval_s,
                "bytes_per_interval": self.bytes_per_interval,
                "targets": len(_targets),
                "known_regions": n,
                "position": dict(self._position) if self._position else None,
                "last_corrupt": (
                    dict(self._last_corrupt) if self._last_corrupt else None
                ),
                "coverage": (
                    round(self._scanned_in_pass / n, 4) if n else None
                ),
            })
        doc["reader"] = verified_mod.stats()
        doc["repair"] = repair_mod.stats()
        return doc

    def _write_state(self) -> None:
        if not self.base_dir:
            return
        doc = {"version": 1, "time": trace_mod.walltime()}
        doc.update(self.stats())
        try:
            fu.atomic_write_json(
                os.path.join(self.base_dir, STATE_FILENAME), doc
            )
        except OSError:
            pass  # best-effort: the scrubber outlives a full disk
