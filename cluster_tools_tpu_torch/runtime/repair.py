"""Lineage-driven block repair: recompute a corrupt product block from its
producing task's inputs (docs/SERVING.md "Self-healing").

Port (a copy) of ``cluster_tools_tpu/runtime/repair.py``, with the same
env names (``CTT_REPAIR_BUDGET``, ``CTT_REPAIR_REGISTRY_MAX``) and records.

Detection without repair only converts silent corruption into loud
corruption.  The task DAG already knows each block's lineage — the
executor's store path holds the exact triple (``load_fn``, kernel,
``store_fn``) that produced every verified block, and the host scaffold
(``host_block_map``) holds the equivalent ``process(block_id)`` — so after
each verified store those layers register a **producer**: a recompute
closure keyed by ``(dataset label, region)``.  When the verifying reader
(:mod:`..io.verified`) or the resident scrubber
(:mod:`.scrub`) detects a digest mismatch, the
repair engine re-runs that closure — re-loading the producing task's
inputs at block grain, re-executing the kernel, re-publishing through the
ordinary store path (fresh digest sidecar recorded atomically with the
region write, cache coherence included) — then re-verifies the stored
bytes against the new sidecar.

Degrade ladder: a repair whose recompute fails (the producing task's own
inputs are damaged, the kernel faults, or the re-stored bytes *still*
mismatch) burns one unit of the region's **repair budget**
(``CTT_REPAIR_BUDGET``, default 2).  An exhausted budget quarantines the
region — ``quarantined:unrepairable`` in ``failures.json`` (unresolved:
the data is damaged beyond the lineage's reach and an operator must act)
— and further reads fail fast with the typed ``corrupt:<site>`` instead
of looping.  Corrupt *inputs* read during a recompute recurse into their
own producers (lineage repair cascades up the DAG); a region already
being repaired on this thread is never re-entered.

The registry is process-resident and bounded (``CTT_REPAIR_REGISTRY_MAX``
entries, LRU): closures pin their task's captured state, so under a
resident server old requests' producers age out instead of accreting.  A
restarted process has an empty registry — at-rest corruption found after
a restart is unrepairable until the producing task re-runs, which is the
recompute-from-markers story, not this module's.

Every outcome is attributed: ``repaired:lineage`` (resolved) /
``quarantined:unrepairable`` records in the producing task's
``failures.json``, matching trace instants on the unified timeline, and
:func:`stats` counters for ``/healthz`` and ``failures_report.py --json``.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from ..utils import function_utils as fu
from . import trace as trace_mod

#: failures.json resolution strings (docs/ROBUSTNESS.md)
REPAIRED_LINEAGE = "repaired:lineage"
QUARANTINE_UNREPAIRABLE = "quarantined:unrepairable"

_DEFAULT_BUDGET = 2
_DEFAULT_REGISTRY_MAX = 4096

_lock = threading.Lock()
_producers: "OrderedDict[Tuple[str, tuple], Dict[str, Any]]" = OrderedDict()
_failed_attempts: Dict[Tuple[str, tuple], int] = {}
_quarantined: set = set()
_counters: Dict[str, int] = {
    "registered": 0,
    "attempted": 0,
    "repaired": 0,
    "failed": 0,
    "no_lineage": 0,
    "unrepairable": 0,
}
_tls = threading.local()


def repair_budget() -> int:
    """Failed recomputes a region may burn before it is quarantined as
    unrepairable (``CTT_REPAIR_BUDGET``)."""
    try:
        return max(1, int(os.environ.get("CTT_REPAIR_BUDGET", "") or
                          _DEFAULT_BUDGET))
    except ValueError:
        return _DEFAULT_BUDGET


def registry_max() -> int:
    try:
        return max(1, int(os.environ.get("CTT_REPAIR_REGISTRY_MAX", "") or
                          _DEFAULT_REGISTRY_MAX))
    except ValueError:
        return _DEFAULT_REGISTRY_MAX


def _region_of(dataset, bb) -> Optional[tuple]:
    from ..io import containers as _c

    return _c._norm_region(bb, dataset.shape)


def _key_of(dataset, region) -> Optional[Tuple[str, tuple]]:
    label = getattr(dataset, "_label", None)
    if label is None or region is None:
        return None
    return (str(label), tuple(tuple(r) for r in region))


def register_producer(
    dataset,
    bb,
    recompute,
    task: str = "",
    block_id: Optional[int] = None,
    failures_path: Optional[str] = None,
) -> bool:
    """Record block lineage after a verified store: ``recompute()`` must
    re-load the producing task's inputs for this block, re-run its kernel,
    and re-store through the ordinary (sidecar-recording) write path.
    Called by the executor / host scaffold — tasks never wire it.  Returns
    False when the dataset has no stable identity to key on."""
    region = _region_of(dataset, bb)
    key = _key_of(dataset, region)
    if key is None or recompute is None:
        return False
    ent = {
        "recompute": recompute,
        "task": str(task or "unknown"),
        "block_id": block_id,
        "failures_path": failures_path,
    }
    with _lock:
        _producers[key] = ent
        _producers.move_to_end(key)
        while len(_producers) > registry_max():
            _producers.popitem(last=False)
        _counters["registered"] += 1
        # a fresh (re)store is new truth: damage history of the OLD bytes
        # must not pre-quarantine it
        _failed_attempts.pop(key, None)
        _quarantined.discard(key)
    # storage-backed product stores become scrub targets the moment they
    # have lineage: the scrubber can both find and heal their rot
    from . import scrub as scrub_mod

    scrub_mod.register_target(dataset)
    return True


def rehome(src, dataset) -> int:
    """Move the lineage registered under ``src``'s label (an in-memory
    handoff dataset) to ``dataset``, its stored copy after a spill, which
    becomes a scrub target.  The recompute closures still write through
    ``src``, which delegates to the stored copy once spilled.  Returns the
    number of regions moved.  (The reference keeps the lineage under the
    handoff's label, so the scrubber cannot heal a flushed request output;
    the port moves it.)"""
    old, new = getattr(src, "_label", None), getattr(dataset, "_label", None)
    if old is None or new is None or str(old) == str(new):
        return 0
    with _lock:
        keys = [k for k in _producers if k[0] == str(old)]
        for k in keys:
            _producers[(str(new), k[1])] = _producers.pop(k)
    if keys:
        from . import scrub as scrub_mod

        scrub_mod.register_target(dataset)
    return len(keys)


def _attribute(ent: Dict[str, Any], site: str, resolution: str,
               error: Optional[str], resolved: bool,
               quarantined: bool) -> None:
    path = ent.get("failures_path")
    if not path:
        return
    try:
        fu.record_failures(
            path,
            ent.get("task") or "repair",
            [{
                "block_id": ent.get("block_id"),
                "sites": {site: 1},
                "error": error,
                "quarantined": bool(quarantined),
                "resolved": bool(resolved),
                "resolution": resolution,
            }],
        )
    except Exception:
        pass  # attribution is best-effort; the repair outcome stands


def attempt_repair(dataset, region, site: str) -> bool:
    """Recompute one corrupt region from lineage; True when the stored
    bytes verify again.  Never raises — the caller (verifying reader /
    scrubber) owns the typed failure."""
    region = tuple(tuple(r) for r in region)
    key = _key_of(dataset, region)
    if key is None:
        return False
    in_flight = getattr(_tls, "keys", None)
    if in_flight is None:
        in_flight = _tls.keys = set()
    if key in in_flight:
        return False  # recursion guard: this thread is already inside it
    with _lock:
        ent = _producers.get(key)
        if ent is not None:
            _producers.move_to_end(key)
        already_dead = key in _quarantined
        used = _failed_attempts.get(key, 0)
        _counters["attempted"] += 1
        if ent is None:
            _counters["no_lineage"] += 1
    if ent is None or already_dead or used >= repair_budget():
        return False
    bb = tuple(slice(a, b) for a, b in region)
    in_flight.add(key)
    # the recompute IS the producing task's work: fault targeting must see
    # it as such (a task-gated fault armed for the READING task would
    # otherwise fire inside the healing path and rot the producer's
    # inputs), and its attribution belongs to the producer
    from . import faults as faults_mod

    prev_task = faults_mod.current_task()
    try:
        faults_mod.set_current_task(ent.get("task") or None)
        with trace_mod.span(
            "repair.lineage", site=site, task=ent.get("task") or "",
            block=int(ent["block_id"]) if ent.get("block_id") is not None
            else -1,
        ):
            ent["recompute"]()
            verify = getattr(dataset, "verify_region", None)
            if verify is not None:
                verify(bb)
    except Exception as e:
        with _lock:
            used = _failed_attempts.get(key, 0) + 1
            _failed_attempts[key] = used
            _counters["failed"] += 1
            exhausted = used >= repair_budget() and key not in _quarantined
            if exhausted:
                _quarantined.add(key)
                _counters["unrepairable"] += 1
        if exhausted:
            _attribute(
                ent, site, QUARANTINE_UNREPAIRABLE,
                f"repair budget ({repair_budget()}) exhausted for "
                f"{key[0]} region {region}: last error: {e!r}",
                resolved=False, quarantined=True,
            )
            trace_mod.instant(
                QUARANTINE_UNREPAIRABLE, site=site,
                task=ent.get("task") or "",
            )
        return False
    finally:
        faults_mod.set_current_task(prev_task)
        in_flight.discard(key)
    with _lock:
        _failed_attempts.pop(key, None)
        _counters["repaired"] += 1
    _attribute(ent, site, REPAIRED_LINEAGE, None, resolved=True,
               quarantined=False)
    trace_mod.instant(
        REPAIRED_LINEAGE, site=site, task=ent.get("task") or "",
    )
    return True


def stats() -> Dict[str, int]:
    """Repair-engine counters (docs/OBSERVABILITY.md): registered
    producers, repair attempts/successes/failures, corrupt regions with
    no lineage, and regions quarantined as unrepairable."""
    with _lock:
        doc = dict(_counters)
        doc["producers"] = len(_producers)
        return doc


def reset() -> None:
    """Drop all lineage state (tests)."""
    with _lock:
        _producers.clear()
        _failed_attempts.clear()
        _quarantined.clear()
        for k in _counters:
            _counters[k] = 0
