"""Typed in-memory targets: task-graph fusion without a storage round trip.

Port of ``cluster_tools_tpu/runtime/handoff.py``.  Every producer ->
consumer hop of a workflow otherwise pays a store and a load through
chunked storage: the watershed stores its labels so the graph tasks can
read them back, the graph tasks store npz artifacts so the costs can load
them, and so on.  This module is the registry behind the task runtime's
:class:`~..runtime.task.MemoryTarget` layer: a producer task declares an
output as in-memory and publishes it here under the *identity* of the
dataset or artifact a consumer would have opened from storage, and the
consumer resolves the identity to the live host-RAM handle instead.

Three rungs, each falling to the one below:

- **device** (``kind="device_arrays"``, :func:`publish_device_arrays` /
  :func:`resolve_device_arrays`): a dict of torch tensors on the task's
  device (on the card, ``cuda`` tensors on the default stream; no pinned
  memory), served to a fused consumer with no host byte.  Gated by the
  task's ``device_handoffs`` knob and ``CTT_DEVICE_POOL=0``.  Device-budget
  pressure (the ``device_pool_bytes`` / ``CTT_DEVICE_POOL_BYTES`` envelope
  shared with the page pool) demotes the oldest entries to the memory rung
  (one device-to-host copy, counted ``d2h_bytes``; the CRC32 of the host
  copy is stamped then), so does a host-side consumer, and a
  ``torch.OutOfMemoryError`` while publishing lands the payload on the
  memory rung, attributed ``degraded:host_staged``.  Demotion frees into
  torch's caching allocator, so the reserved device memory need not fall.
- **memory** (``kind="dataset"``, an in-memory
  :class:`~..io.containers.HandoffDataset`; ``kind="arrays"``, a dict of
  read-only numpy arrays): gated by the ``memory_handoffs`` knob and
  ``CTT_HANDOFF=0``.
- **storage**: the universal fallback.  A handoff whose bytes exceed the
  process budget (``CTT_HANDOFF_BYTES``, default ``min(2 GiB,
  MemAvailable/4)``) is written through to its storage path from birth;
  the executor's admission gate calls :func:`spill_for_headroom` when host
  memory runs low, flushing completed handoffs oldest first.  A spilled
  dataset is read back against its in-memory CRC32 digests; a spilled
  artifact gets a ``.crc.json`` sidecar that every later load verifies.
  Every spill is attributed in ``failures.json`` as
  ``resolution="degraded:spilled"``.

A consumer that finds no live handle (a new process, a spill) falls back
to the stored copy; a producer whose success manifest records a
memory-only output that is no longer live is not done and re-runs
(:meth:`~..runtime.task.BaseTask.complete`).  Counters
(:data:`STAT_KEYS`) follow the snapshot/delta pattern; the task runtime
merges each task's delta into ``io_metrics.json``.

Faults and traces, as in the reference: a ``spill`` fault at site
``publish`` forces the write-through of a target at birth (spill reason
``fault``); an error or OOM at ``publish`` on the device rung falls the
payload back to the host memory rung (``degraded:host_staged``); every
publish and resolve is a trace instant (``handoff.publish``,
``handoff.resolve``), every spill and demotion a span (``handoff.spill``,
``handoff.demote``).  A spilled dataset is stored with digest sidecars
and verified back.  Handoff identities are namespaced by the running
service request (``admission.current_request``), so two concurrent requests
over the same paths never resolve each other's intermediates; outside a
request (batch mode) the namespace is None.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import function_utils as fu

#: identity of this process for the marker-epoch sentinel: block markers
#: written beside a live in-memory output are only trustworthy inside the
#: process that holds the memory (a pid alone can be reused)
_PROCESS_TOKEN = f"{os.getpid()}.{uuid.uuid4().hex[:12]}"

#: counter names, the reference's, fixed so snapshots and deltas keep one schema
STAT_KEYS = (
    "handoffs_published",
    "handoffs_served",
    "handoffs_spilled",
    "handoff_fallbacks",
    "bytes_not_stored",
    "bytes_spilled",
    "device_handoffs_published",
    "device_handoffs_served",
    "device_handoffs_demoted",
)


def handoff_enabled() -> bool:
    """The process switch of in-memory handoffs (on unless
    ``CTT_HANDOFF=0``); tasks also gate on their ``memory_handoffs``
    knob, which defaults to off."""
    return os.environ.get("CTT_HANDOFF", "1").lower() not in ("0", "false", "off")


def handoff_budget() -> int:
    """Byte budget of live in-memory handoffs: ``CTT_HANDOFF_BYTES``, else
    ``min(2 GiB, MemAvailable/4)``, else 512 MiB where MemAvailable cannot
    be read."""
    env = os.environ.get("CTT_HANDOFF_BYTES")
    if env:
        return max(0, int(env))
    from .supervision import host_mem_available_bytes

    avail = host_mem_available_bytes()
    if avail:
        return int(min(2 << 30, avail // 4))
    return 512 << 20


def _request_namespace() -> Optional[str]:
    """The running service request's id, or None in batch mode."""
    from . import admission

    ctx = admission.current_request()
    return None if ctx is None else ctx.request_id


def _namespaced(base: str) -> str:
    ns = _request_namespace()
    return f"req:{ns}::{base}" if ns else base


def identity_namespace(identity: str) -> Optional[str]:
    """The request id an identity was namespaced under (``req:<id>::``), or None."""
    identity = str(identity)
    if identity.startswith("req:") and "::" in identity:
        return identity[len("req:"):identity.index("::")]
    return None


def in_current_namespace(identity) -> bool:
    """Whether ``identity`` belongs to this thread's request namespace
    (both None outside a service request)."""
    return identity_namespace(str(identity)) == _request_namespace()


def dataset_identity(path: str, key: str) -> str:
    """Identity of a chunked-dataset handoff: the ``(container path, key)``
    a storage consumer would open."""
    return _namespaced(f"{os.path.abspath(path)}:{key}")


def artifact_identity(path: str) -> str:
    """Identity of an array-artifact handoff (an npz/npy path)."""
    return _namespaced(os.path.abspath(path))


def _tensor_nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * int(t.element_size())


class _Entry:
    """One live or spilled handoff.  ``obj`` is the payload (a
    HandoffDataset, a dict of read-only arrays, or a dict of tensors) and
    is dropped on spill: after a spill, storage is the single source of
    truth."""

    __slots__ = (
        "kind", "identity", "path", "key", "obj", "nbytes", "complete",
        "spilled", "spilling", "spill_reason", "producer", "failures_path",
        "recorded", "device_crcs",
    )

    def __init__(self, kind, identity, path, key, obj, nbytes, producer, failures_path):
        self.kind = kind                # "dataset" | "arrays" | "device_arrays"
        self.identity = identity
        self.path = path
        self.key = key
        self.obj = obj
        self.nbytes = int(nbytes)
        self.complete = False
        self.spilled = False
        self.spilling = False           # claimed by an in-progress spill
        self.spill_reason: Optional[str] = None
        self.producer = producer
        self.failures_path = failures_path
        self.recorded = False           # degraded:spilled written once
        # per-array CRC32s stamped when a device entry's bytes first reach
        # host memory (demotion); verified at the storage spill
        self.device_crcs: Optional[Dict[str, int]] = None


class HandoffRegistry:
    """Process-wide registry of in-memory handoff targets."""

    def __init__(self):
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._lock = threading.Lock()
        self._stats: Dict[str, float] = {k: 0 for k in STAT_KEYS}

    def bump(self, key: str, n: float = 1) -> None:
        with self._lock:
            self._stats[key] += n

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._stats)

    def live_bytes(self) -> int:
        """Bytes of payloads resident in host RAM.  Device-rung entries hold
        device memory and count in :meth:`device_live_bytes` instead
        (demoting one under host pressure would add host bytes)."""
        with self._lock:
            return sum(e.nbytes for e in self._entries.values() if not e.spilled and e.kind != "device_arrays")

    def device_live_bytes(self) -> int:
        """Tensor bytes of the device-rung payloads still live."""
        with self._lock:
            return sum(e.nbytes for e in self._entries.values()
                       if e.kind == "device_arrays" and not e.spilled and e.obj is not None)

    def claim_spill(self, entry: _Entry) -> bool:
        """Atomically claim ``entry`` for spilling (or demotion).  Exactly
        one caller wins; ``spilled`` must never be observable before the
        storage copy is complete.  An incomplete entry (a producer is still
        writing it) is never claimed: its copy would be torn."""
        with self._lock:
            if entry.spilled or entry.spilling or entry.obj is None or not entry.complete:
                return False
            entry.spilling = True
            return True

    def finish_spill(self, entry: _Entry, ok: bool, reason: str) -> None:
        """Release a claim: on success the entry flips to spilled (payload
        dropped); on failure it stays live, the memory copy being the only
        copy."""
        with self._lock:
            entry.spilling = False
            if ok:
                entry.spilled = True
                entry.spill_reason = reason
                entry.obj = None

    def is_live(self, identity: str) -> bool:
        with self._lock:
            e = self._entries.get(identity)
            return e is not None and e.complete and not e.spilled

    def get(self, identity: str) -> Optional[_Entry]:
        with self._lock:
            return self._entries.get(identity)

    def put(self, entry: _Entry) -> None:
        with self._lock:
            self._entries[entry.identity] = entry
            self._entries.move_to_end(entry.identity)
        # every published target is an instant on the timeline, between
        # the producer's and the consumer's task.run spans
        from . import trace as trace_mod

        trace_mod.instant("handoff.publish", identity=entry.identity, nbytes=int(entry.nbytes),
                          spilled=bool(entry.spilled), kind=entry.kind)

    def spill_candidates(self) -> List[_Entry]:
        """Complete, resident, unclaimed host entries, oldest first."""
        with self._lock:
            return [e for e in self._entries.values()
                    if e.complete and not e.spilled and not e.spilling and e.kind != "device_arrays"]

    def demotion_candidates(self) -> List[_Entry]:
        """Live device-rung entries, oldest first."""
        with self._lock:
            return [e for e in self._entries.values()
                    if e.kind == "device_arrays" and e.complete and not e.spilled and not e.spilling
                    and e.obj is not None]


_registry: Optional[HandoffRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> HandoffRegistry:
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = HandoffRegistry()
    return _registry


def reset() -> None:
    """Drop every handoff (as a new process would see it)."""
    global _registry
    with _registry_lock:
        _registry = HandoffRegistry()


def snapshot() -> Dict[str, float]:
    """Process-wide handoff counters (monotonic; diff with :func:`delta`)."""
    return get_registry().snapshot()


def delta(snap: Dict[str, float]) -> Dict[str, float]:
    cur = snapshot()
    return {k: cur[k] - snap.get(k, 0) for k in cur}


def live_bytes() -> int:
    return get_registry().live_bytes()


def device_live_bytes() -> int:
    """Device bytes held by live device-rung handoffs."""
    return get_registry().device_live_bytes()


def live_entries() -> int:
    """Number of registry entries (any state): the resident server
    publishes it in ``server_state.json``, so a terminal request can be
    seen to have released its namespace."""
    reg = get_registry()
    with reg._lock:
        return len(reg._entries)


# -- marker-epoch sentinel ------------------------------------------------------
# A producer whose output lives in this process's memory stamps its marker
# directory with the process token; a later run in another process (whatever
# path it takes) clears the block markers before trusting them: they
# describe data that died with that process.


def _sentinel_path(tmp_folder: str, uid: str) -> str:
    return os.path.join(tmp_folder, "markers", uid, ".memory_outputs.json")


def mark_memory_producer(tmp_folder: str, uid: str) -> None:
    """Stamp ``uid``'s markers as backed by this process's memory.  Call
    after :func:`invalidate_stale_markers`."""
    path = _sentinel_path(tmp_folder, uid)
    doc = fu.read_json_if_valid(path)
    if doc and doc.get("token") == _PROCESS_TOKEN:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fu.atomic_write_json(path, {"token": _PROCESS_TOKEN})


def invalidate_stale_markers(tmp_folder: str, uid: str) -> bool:
    """Clear ``uid``'s block markers if another process's in-memory run
    stamped them (the sentinel goes too).  Returns whether they were
    cleared; a no-op without a sentinel."""
    path = _sentinel_path(tmp_folder, uid)
    doc = fu.read_json_if_valid(path)
    if doc is None:
        if os.path.exists(path):
            doc = {}  # torn sentinel: provenance unknown, treat as stale
        else:
            return False
    if doc.get("token") == _PROCESS_TOKEN:
        return False
    fu.clear_block_markers(tmp_folder, uid)
    try:
        os.remove(path)
    except OSError:
        pass
    return True


def is_live(identity: str) -> bool:
    return get_registry().is_live(identity)


def discard(identity: str) -> None:
    """Drop an entry outright: a producer about to rewrite the identity
    through storage (handoffs off for this run) must not leave an earlier
    run's live payload shadowing the fresh bytes."""
    reg = get_registry()
    with reg._lock:
        reg._entries.pop(identity, None)


def is_resolvable(identity: str) -> bool:
    """Whether a consumer can resolve ``identity`` in this process: a
    complete entry, live or spilled.  Only a missing or incomplete entry
    (a new process) means the data is gone."""
    entry = get_registry().get(identity)
    return entry is not None and entry.complete


def _file_reader(path: str, mode: str = "a"):
    from ..io.containers import open_container

    return open_container(path, mode=mode)


def _mem_headroom_ok(nbytes: int) -> bool:
    """A handoff larger than half of what the host has available cannot
    responsibly live in RAM."""
    from .supervision import host_mem_available_bytes

    avail = host_mem_available_bytes()
    return avail is None or nbytes <= avail // 2


def _force_spill() -> bool:
    """The fault injector's ``spill`` fault at site ``publish``."""
    from . import faults as faults_mod

    return faults_mod.get_injector().force_spill()


def _admit(nbytes: int) -> Optional[str]:
    """None when ``nbytes`` may live in memory, else the spill reason.
    Flushes completed elders first to make room."""
    budget = handoff_budget()
    if budget <= 0 or nbytes > budget:
        return "admission:budget"
    if not _mem_headroom_ok(nbytes):
        return "admission:headroom"
    if live_bytes() + nbytes > budget:
        spill_for_headroom(need_bytes=nbytes)
        if live_bytes() + nbytes > budget:
            return "admission:budget"
    return None


# -- dataset handoffs -------------------------------------------------------------


def acquire_dataset(path: str, key: str, shape, chunks, dtype, producer: str,
                    failures_path: Optional[str] = None, fill_value: int = 0) -> Tuple[Any, _Entry]:
    """Producer-side acquire of a dataset handoff.  Returns ``(dataset,
    entry)``: an in-memory :class:`~..io.containers.HandoffDataset`, or the
    real storage dataset when the target spills at birth (admission, or a
    spilled predecessor at the same identity), and the registry entry."""
    from ..io.containers import HandoffDataset, _check_existing

    reg = get_registry()
    identity = dataset_identity(path, key)
    entry = reg.get(identity)
    if entry is not None and entry.kind == "dataset":
        # an in-flight headroom spill owns the payload: wait it out instead
        # of handing out a memory handle whose copied regions would lose writes
        while entry.spilling:
            time.sleep(0.01)
        if not entry.spilled and entry.obj is not None:
            ds = entry.obj
            _check_existing(key, ds.shape, ds.dtype, shape, dtype, have_chunks=ds.chunks, want_chunks=chunks)
            entry.producer = producer
            entry.complete = False  # a new producer is writing again
            if failures_path:
                entry.failures_path = failures_path
            return ds, entry
        # spilled predecessor: storage is the truth now, the new producer
        # writes through (pass one spilled, so pass two must too)
        store = _file_reader(path).require_dataset(key, shape=shape, chunks=chunks, dtype=dtype)
        entry.producer = producer
        if failures_path:
            entry.failures_path = failures_path
        return store, entry

    nbytes = int(np.prod([int(s) for s in shape], dtype=np.int64)) * np.dtype(dtype).itemsize
    reason = "fault" if _force_spill() else _admit(nbytes)
    if reason is not None:
        # spill at birth: every block lands on storage; block-grain resume stays valid
        store = _file_reader(path).require_dataset(key, shape=shape, chunks=chunks, dtype=dtype)
        entry = _Entry("dataset", identity, path, key, None, nbytes, producer, failures_path)
        entry.spilled = True
        entry.spill_reason = reason
        reg.put(entry)
        reg.bump("handoffs_published")
        reg.bump("handoffs_spilled")
        reg.bump("bytes_spilled", nbytes)
        return store, entry

    def _store_factory():
        return _file_reader(path).require_dataset(key, shape=shape, chunks=chunks, dtype=dtype)

    ds = HandoffDataset(shape=shape, chunks=chunks, dtype=dtype, store_factory=_store_factory,
                        label=f"handoff://{identity}", fill_value=fill_value)
    entry = _Entry("dataset", identity, path, key, ds, nbytes, producer, failures_path)
    reg.put(entry)
    reg.bump("handoffs_published")
    return ds, entry


def resolve_dataset(path: str, key: str):
    """Consumer-side resolve: the live in-memory handle of a handoff at
    ``(path, key)`` (counted ``handoffs_served``), the stored copy when it
    spilled (``handoff_fallbacks``), else the plain storage dataset."""
    from . import trace as trace_mod

    reg = get_registry()
    identity = dataset_identity(path, key)
    entry = reg.get(identity)
    if entry is not None and entry.kind == "dataset":
        obj = entry.obj
        if not entry.spilled and obj is not None:
            reg.bump("handoffs_served")
            trace_mod.instant("handoff.resolve", identity=identity, served="memory")
            return obj
        reg.bump("handoff_fallbacks")
        trace_mod.instant("handoff.resolve", identity=identity, served="fallback")
    return _file_reader(path)[key]


# -- array-artifact handoffs ------------------------------------------------------


def _freeze(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a).copy()
        a.setflags(write=False)
        out[name] = a
    return out


def _views(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    # views of read-only arrays stay read-only: consumers cannot mutate a
    # producer's published payload in place
    return {name: a.view() for name, a in arrays.items()}


def _crc_sidecar_path(path: str) -> str:
    return path + ".crc.json"


def _is_npy(path: str) -> bool:
    return path.endswith(".npy")


def _write_artifact(path: str, arrays: Dict[str, np.ndarray], expected_crcs: Optional[Dict[str, int]] = None) -> None:
    """Spill one artifact: an atomic npz/npy write and a CRC32 sidecar.
    ``expected_crcs`` (demoted device entries) are the digests stamped when
    the payload first reached host memory; a mismatch fails the spill
    loudly (the memory copy stays the only copy)."""
    from ..io.containers import ChunkCorruptionError

    crcs = {name: zlib.crc32(np.ascontiguousarray(a).tobytes()) for name, a in arrays.items()}
    for name, want in (expected_crcs or {}).items():
        if name in crcs and crcs[name] != want:
            raise ChunkCorruptionError(f"{path}[{name}]", (), want, crcs[name])
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        if _is_npy(path):
            (arr,) = arrays.values()
            np.save(f, arr)
        else:
            np.savez(f, **arrays)
    os.replace(tmp, path)
    fu.atomic_write_json(_crc_sidecar_path(path), {"algo": "crc32", "arrays": crcs})


def _verify_artifact(path: str, arrays: Dict[str, np.ndarray]) -> bool:
    """CRC-check ``arrays`` against the spill sidecar; True when a sidecar
    exists (the file is a spilled handoff), False for a plain file."""
    from ..io.containers import ChunkCorruptionError

    doc = fu.read_json_if_valid(_crc_sidecar_path(path))
    if not doc:
        return False
    want = doc.get("arrays") or {}
    for name, a in arrays.items():
        if name not in want:
            continue
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes())
        if crc != want[name]:
            raise ChunkCorruptionError(f"{path}[{name}]", (), want[name], crc)
    return True


def publish_arrays(path: str, arrays: Dict[str, np.ndarray], producer: str,
                   failures_path: Optional[str] = None) -> _Entry:
    """Producer-side publish of named arrays under an artifact path (the
    npz/npy a storage consumer would have loaded).  The arrays are copied
    read-only; an admission rejection writes the file (and its CRC
    sidecar) instead.  Complete at once: artifacts have no block grain."""
    reg = get_registry()
    identity = artifact_identity(path)
    frozen = _freeze(arrays)
    nbytes = sum(a.nbytes for a in frozen.values())
    reason = "fault" if _force_spill() else _admit(nbytes)
    entry = _Entry("arrays", identity, path, None, None, nbytes, producer, failures_path)
    entry.complete = True
    if reason is not None:
        _write_artifact(path, frozen)
        entry.spilled = True
        entry.spill_reason = reason
        reg.put(entry)
        reg.bump("handoffs_published")
        reg.bump("handoffs_spilled")
        reg.bump("bytes_spilled", nbytes)
        return entry
    entry.obj = frozen
    reg.put(entry)
    reg.bump("handoffs_published")
    reg.bump("bytes_not_stored", nbytes)
    return entry


# -- the device rung ----------------------------------------------------------------


def _record_host_staged(producer, failures_path, identity, reason, err=None) -> None:
    """One ``degraded:host_staged`` record per device publish that fell to
    the memory rung, under the ``<producer>.device_handoff`` task key."""
    if not failures_path:
        return
    try:
        fu.record_failures(failures_path, f"{producer}.device_handoff", [{
            "block_id": None, "sites": {"publish": 1},
            "error": None if err is None else fu.cap_traceback(str(err)),
            "quarantined": False, "resolved": True, "resolution": "degraded:host_staged",
            "handoff": identity, "reason": reason,
        }])
    except Exception:
        pass  # attribution is best effort; the fallback itself landed


def publish_device_arrays(path: str, arrays: Dict[str, Any], producer: str, failures_path: Optional[str] = None,
                          device=None) -> _Entry:
    """Producer-side publish on the device rung: ``arrays`` (tensors stay
    where they are; numpy arrays are uploaded to ``device``, counted
    ``h2d_bytes``) stay live under the artifact identity, so a fused
    consumer's :func:`resolve_device_arrays` serves them with no host byte.
    The tensors are shared, not copied: neither side may write them in
    place afterwards.

    The ladder down: ``CTT_DEVICE_POOL=0`` -> the memory rung verbatim; a
    resource failure (``torch.OutOfMemoryError`` while uploading, the
    fault injector's OOM at site ``publish``, or the device byte budget
    rejecting the payload after demoting elder entries) -> one
    device-to-host copy and the memory rung, attributed
    ``degraded:host_staged``; another injected ``publish`` error raises."""
    from ..parallel import device_pool as device_pool_mod
    from . import faults as faults_mod
    from .executor import classify_resource_error

    def _host(reason, err=None):
        host = {}
        for name, a in arrays.items():
            if isinstance(a, torch.Tensor):
                h = a.detach().cpu().numpy()
                device_pool_mod.record_d2h(h.nbytes)
            else:
                h = np.asarray(a)
            host[name] = h
        entry = publish_arrays(path, host, producer, failures_path)
        if reason is not None:
            device_pool_mod.bump("host_staged_fallbacks")
            _record_host_staged(producer, failures_path, entry.identity, reason, err=err)
        return entry

    if not device_pool_mod.device_pool_enabled():
        return _host(None)

    reg = get_registry()
    identity = artifact_identity(path)
    try:
        faults_mod.get_injector().maybe_fail("publish", None)
        held: Dict[str, torch.Tensor] = {}
        nbytes = 0
        for name, a in arrays.items():
            if not isinstance(a, torch.Tensor):
                from ..device import resolve_device

                a = np.ascontiguousarray(a)
                device_pool_mod.record_h2d(a.nbytes)
                a = torch.from_numpy(a).to(resolve_device(device))
            held[name] = a
            nbytes += _tensor_nbytes(a)
        # the device envelope shared with the page pool: demote the oldest
        # device entries first, then ride the resource ladder
        budget = device_pool_mod.device_pool_budget()
        if device_live_bytes() + nbytes > budget:
            demote_for_device_headroom(need_bytes=nbytes)
        if device_live_bytes() + nbytes > budget:
            raise MemoryError(f"device handoff budget exhausted: {nbytes} B payload over the {budget} B envelope")
    except Exception as e:
        if classify_resource_error(e) is None:
            raise
        return _host("oom", err=e)
    entry = _Entry("device_arrays", identity, path, None, held, nbytes, producer, failures_path)
    entry.complete = True
    reg.put(entry)
    reg.bump("handoffs_published")
    reg.bump("device_handoffs_published")
    reg.bump("bytes_not_stored", nbytes)
    return entry


def resolve_device_arrays(path: str) -> Dict[str, Any]:
    """Consumer-side resolve on the device rung: the live tensors when the
    device entry is live (counted ``device_handoffs_served`` and, in the
    device-plane counters, ``bytes_not_staged``), else the memory and
    storage rungs through :func:`load_arrays` (numpy arrays)."""
    from ..parallel import device_pool as device_pool_mod
    from . import trace as trace_mod

    reg = get_registry()
    entry = reg.get(artifact_identity(path))
    if entry is not None and entry.kind == "device_arrays" and not entry.spilled and entry.obj is not None:
        reg.bump("handoffs_served")
        reg.bump("device_handoffs_served")
        device_pool_mod.bump("device_handoffs_served")
        device_pool_mod.bump("bytes_not_staged", entry.nbytes)
        trace_mod.instant("handoff.resolve", identity=entry.identity, served="device")
        return dict(entry.obj)
    return load_arrays(path)


def _demote_device_entry(entry: _Entry, reason: str) -> int:
    """Demote one device-rung entry to the memory rung: one device-to-host
    copy (``d2h_bytes``), frozen read-only, CRC32s stamped at this first
    point the bytes exist on the host.  Returns the device bytes released
    (0 when another thread holds the claim).  The entry stays resolvable
    throughout."""
    from ..parallel import device_pool as device_pool_mod
    from . import trace as trace_mod

    reg = get_registry()
    if not reg.claim_spill(entry):
        return 0
    ok = False
    try:
        with trace_mod.span("handoff.demote", identity=entry.identity, reason=reason, nbytes=int(entry.nbytes)):
            host = {}
            for name, a in entry.obj.items():
                h = a.detach().cpu().numpy()
                device_pool_mod.record_d2h(h.nbytes)
                host[name] = h
            frozen = _freeze(host)
            crcs = {name: zlib.crc32(np.ascontiguousarray(a).tobytes()) for name, a in frozen.items()}
        with reg._lock:
            entry.obj = frozen
            entry.device_crcs = crcs
            entry.kind = "arrays"
        ok = True
    finally:
        # release the claim without flipping spilled: the entry is now an
        # ordinary memory-rung artifact, which may spill as any other
        reg.finish_spill(entry, False, reason)
    if not ok:
        return 0
    reg.bump("device_handoffs_demoted")
    return entry.nbytes


def demote_for_device_headroom(need_bytes: Optional[int] = None) -> int:
    """Demote live device-rung entries to the memory rung, oldest first,
    until ``need_bytes`` fits the device budget (None: all of them).
    Returns the device bytes released."""
    from ..parallel import device_pool as device_pool_mod

    budget = device_pool_mod.device_pool_budget()
    freed = 0
    for entry in get_registry().demotion_candidates():
        if need_bytes is not None and device_live_bytes() + need_bytes <= budget:
            break
        freed += _demote_device_entry(entry, "device_budget")
    return freed


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    """Consumer-side load of an array artifact: the live payload when one
    exists (``handoffs_served``; a device entry is demoted first, the one
    device-to-host copy), else the file, verified against its CRC sidecar
    when it was spilled (``handoff_fallbacks``).  Plain files load as they
    are."""
    from . import trace as trace_mod

    reg = get_registry()
    entry = reg.get(artifact_identity(path))
    if entry is not None and entry.kind == "device_arrays":
        _demote_device_entry(entry, "host_consumer")
    if entry is not None and entry.kind == "arrays":
        obj = entry.obj
        if not entry.spilled and obj is not None:
            reg.bump("handoffs_served")
            trace_mod.instant("handoff.resolve", identity=entry.identity, served="memory")
            return _views(obj)
        reg.bump("handoff_fallbacks")
        trace_mod.instant("handoff.resolve", identity=entry.identity, served="fallback")
    if _is_npy(path):
        out = {"data": np.load(path)}
    else:
        with np.load(path) as f:
            out = {name: f[name] for name in f.files}
    # verify unconditionally: a new process has an empty registry, and the
    # sidecar exists for exactly that case (its fallback reads count too)
    was_spilled = _verify_artifact(path, out)
    if entry is None and was_spilled:
        reg.bump("handoff_fallbacks")
    return out


def load_array(path: str) -> np.ndarray:
    """The single array of an ``.npy`` artifact (:func:`load_arrays`)."""
    (arr,) = load_arrays(path).values()
    return arr


def forget_artifact(path: str) -> None:
    """A producer is about to write ``path`` as a plain file: drop any
    earlier run's live payload and the spill sidecar (a stale CRC would
    flag the fresh bytes as corruption)."""
    discard(artifact_identity(path))
    try:
        os.remove(_crc_sidecar_path(path))
    except OSError:
        pass


def array_exists(path: str) -> bool:
    """Whether the artifact is resolvable: live in memory or on disk."""
    entry = get_registry().get(artifact_identity(path))
    if entry is not None and entry.kind in ("arrays", "device_arrays") and not entry.spilled \
            and entry.obj is not None:
        return True
    return os.path.exists(path)


# -- spills ---------------------------------------------------------------------------


def _spill_entry(entry: _Entry, reason: str) -> int:
    """Flush one live entry to its storage path and release its RAM.
    Returns the bytes freed (0 when another thread owns the entry, or the
    spill failed: the memory copy, still the only copy, stays).  The flags
    flip under the registry lock only after the copy landed."""
    from . import trace as trace_mod

    reg = get_registry()
    if not reg.claim_spill(entry):
        return 0
    obj = entry.obj
    freed = 0
    ok = False
    try:
        # a spill is storage IO mid-pipeline: a span, so the timeline shows
        # the stall it caused
        with trace_mod.span("handoff.spill", identity=entry.identity, reason=reason, nbytes=int(entry.nbytes)):
            if entry.kind == "dataset":
                freed = obj.spill()
            else:
                # demoted device entries carry the CRCs stamped at their
                # first host copy: the spill verifies them
                _write_artifact(entry.path, obj, expected_crcs=entry.device_crcs)
                freed = entry.nbytes
        ok = True
    except Exception:
        ok = False
    finally:
        reg.finish_spill(entry, ok, reason)
    if not ok:
        return 0
    reg.bump("handoffs_spilled")
    reg.bump("bytes_spilled", freed)
    # these bytes did reach storage after all: reconcile "never stored"
    not_stored = int(getattr(obj, "not_stored_bytes", 0)) if entry.kind == "dataset" else entry.nbytes
    if not_stored:
        reg.bump("bytes_not_stored", -not_stored)
    if entry.kind == "dataset":
        # the block lineage follows the bytes to storage, where the
        # verifying reader and the scrubber can use it
        from . import repair as repair_mod

        repair_mod.rehome(obj, getattr(obj, "_spilled_ds", None))
    _record_spill(entry)
    return freed


def _record_spill(entry: _Entry) -> None:
    """One ``degraded:spilled`` record per spilled target."""
    if entry.recorded or not entry.failures_path:
        return
    entry.recorded = True
    try:
        fu.record_failures(entry.failures_path, f"{entry.producer}.handoff", [{
            "block_id": None, "sites": {"spill": 1}, "error": None, "quarantined": False,
            "resolved": True, "resolution": "degraded:spilled", "handoff": entry.identity,
            "reason": entry.spill_reason,
        }])
    except Exception:
        pass  # attribution is best effort; the spill itself landed


def spill_for_headroom(need_bytes: Optional[int] = None) -> int:
    """Flush completed in-memory handoffs to storage, oldest first: all of
    them (no ``need_bytes``: the executor's gate under real memory
    pressure), or only until ``need_bytes`` fits the budget (:func:`_admit`
    making room for one new target).  Returns the bytes freed."""
    budget = handoff_budget()
    freed = 0
    for entry in get_registry().spill_candidates():
        if need_bytes is not None and live_bytes() + need_bytes <= budget:
            break
        freed += _spill_entry(entry, "headroom")
    return freed


def _namespace_entries(request_id: str) -> List[_Entry]:
    prefix = f"req:{request_id}::"
    reg = get_registry()
    with reg._lock:
        return [e for e in reg._entries.values() if e.identity.startswith(prefix)]


def flush_namespace(request_id: str, datasets_only: bool = True) -> int:
    """Write a finished service request's live dataset handoffs to their
    storage paths (a planned completion step, not attributed as a degrade);
    artifacts die with the namespace.  Returns the bytes flushed."""
    flushed = 0
    for entry in _namespace_entries(request_id):
        if datasets_only and entry.kind != "dataset":
            continue
        if entry.spilled or entry.obj is None or not entry.complete:
            continue
        entry.recorded = True  # suppress the degrade attribution
        flushed += _spill_entry(entry, "service:finalize")
    return flushed


def release_request(request_id: str) -> int:
    """Drop every entry of a request's namespace; returns how many."""
    prefix = f"req:{request_id}::"
    reg = get_registry()
    with reg._lock:
        doomed = [k for k in reg._entries if k.startswith(prefix)]
        for k in doomed:
            reg._entries.pop(k, None)
    return len(doomed)


def finalize_task(targets, uid: str) -> List[Dict[str, Any]]:
    """Producer-task completion: mark this task's targets complete and
    return the success-manifest records that
    :meth:`~..runtime.task.BaseTask.complete` validates on resume; spilled
    targets get their ``degraded:spilled`` record here if not yet written."""
    records = []
    seen = set()
    for target in targets:
        entry = target.entry
        if entry.identity in seen:
            continue
        seen.add(entry.identity)
        entry.complete = True
        if entry.spilled:
            _record_spill(entry)
        records.append({
            "identity": entry.identity, "path": entry.path, "key": entry.key, "kind": entry.kind,
            "stored": bool(entry.spilled), "bytes": int(entry.nbytes),
        })
    return records
