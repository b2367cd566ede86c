"""Device-resident page pool: upload pages once, re-address them per batch.

Port of ``cluster_tools_tpu/parallel/device_pool.py``.  The ragged paged
pool (:mod:`.block_pool`) packs a batch into host page pools that would be
copied to the device every batch, even when consecutive batches (or a
warm re-sweep of the same data) carry identical bytes.  This module keeps
a **persistent device allocation** per ``(page_shape, dtype)`` class, with
pages addressed by *content*:

- a :class:`_DeviceArena` is one resident ``[capacity, *page_shape]``
  tensor on the executor's device, its slots assigned to page contents
  (crc32 of the bytes) under an LRU.  The fill page, every repeated page
  and every page of a warm re-sweep hit a resident slot and cost no
  host-to-device bytes;
- :meth:`DevicePagePool.stage` rewrites a packed
  :class:`~.block_pool.RaggedBatch`'s page tables against the arena slots
  and uploads only the missing pages: one host-to-device copy plus one
  ``index_copy_`` per batch, the miss count rounded up to a power of two;
- arena capacities are powers of two under a byte budget (the task's
  ``device_pool_bytes``, else ``CTT_DEVICE_POOL_BYTES``; kill switch
  ``CTT_DEVICE_POOL=0``).  ``torch.OutOfMemoryError`` while uploading
  takes the reference's ladder: evict everything, retry once, then raise
  :class:`DevicePoolExhausted`; the executor then stages that batch from
  the host, attributed ``degraded:host_staged`` in ``failures.json``.

Each card holds its own arena set under its own byte budget (the
reference replicates one arena set over its mesh): the shards of one
card share that card's arenas, and a batch split over several cards is
staged once on each.  Arenas are updated in place, so a staged batch must
be consumed (its lanes gathered from the pool, by every shard of the card
that maps it) before the arena stages again (the arguments of one batch
that share a page class share an arena, sized for all of them, and
staging one never evicts a page another maps; the pinned set spans every
lane of the batch, so no shard's miss evicts a page another shard of the
batch maps): hold :meth:`DevicePagePool.lock_for` of the card from
:meth:`DevicePagePool.stage` until the lanes are gathered, as the executor
does.  On one CUDA stream the gather is ordered before any later
``index_copy_``.  The degrade ladder's eviction empties the arenas of the
card that failed only.

Counters follow the reference's snapshot/delta pattern (``h2d_bytes``,
``d2h_bytes``, ``device_pool_hits``/``misses``/``evictions``,
``bytes_not_staged``, ``device_handoffs_served``,
``host_staged_fallbacks``); the task runtime merges each task's delta
into ``io_metrics.json``.  ``d2h_bytes``, ``device_handoffs_served`` and
``bytes_not_staged`` are recorded here but bumped by the executor's
device-to-host copies, the handoff registry's device rung
(:mod:`..runtime.handoff`: its demotions, served payloads and the
``host_staged_fallbacks`` of a publish that fell to the memory rung) and
the slab sweep's device feed.  One counter plane for the whole
device-resident data path; the registry keeps its own
``device_handoffs_published``/``_served``/``_demoted``.
:func:`device_pool_enabled` (``CTT_DEVICE_POOL=0``) switches off the
page pool and the device rung of the handoffs alike, and the rung's
payloads share :func:`device_pool_budget`'s envelope.
"""

from __future__ import annotations

import os
import threading
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import card_key
from .block_pool import RaggedArgSpec, RaggedBatch, _quantize_pages

#: default resident-pool byte budget per process when neither the task
#: knob nor ``CTT_DEVICE_POOL_BYTES`` says otherwise
DEFAULT_POOL_BYTES = 256 << 20

#: counter names, fixed so snapshots/deltas stay schema-stable
STAT_KEYS = (
    "h2d_bytes",
    "d2h_bytes",
    "device_pool_hits",
    "device_pool_misses",
    "device_pool_evictions",
    "device_batches_staged",
    "host_staged_fallbacks",
    "bytes_not_staged",
    "device_handoffs_served",
)

_METRICS_LOCK = threading.Lock()
_COUNTERS: Dict[str, float] = {k: 0 for k in STAT_KEYS}


def snapshot() -> Dict[str, float]:
    """Current process-wide device-plane counters (monotonic; diff two
    snapshots with :func:`delta` to attribute a sweep's share)."""
    with _METRICS_LOCK:
        return dict(_COUNTERS)


def delta(snap: Dict[str, float]) -> Dict[str, float]:
    cur = snapshot()
    return {k: cur[k] - snap.get(k, 0) for k in cur}


def bump(key: str, n: float = 1) -> None:
    with _METRICS_LOCK:
        _COUNTERS[key] += n


def record_h2d(nbytes: int) -> None:
    """Attribute ``nbytes`` of host-to-device traffic."""
    bump("h2d_bytes", int(nbytes))


def record_d2h(nbytes: int) -> None:
    """Attribute ``nbytes`` of device-to-host traffic."""
    bump("d2h_bytes", int(nbytes))


def device_pool_enabled() -> bool:
    """Process-level kill switch of the whole device-resident data plane,
    the resident page pool and the device handoffs: ``CTT_DEVICE_POOL=0``.
    Tasks also gate on their ``device_pool`` / ``device_handoffs`` knobs."""
    return os.environ.get("CTT_DEVICE_POOL", "1").lower() not in ("0", "false", "off")


def device_pool_budget(explicit: Optional[int] = None) -> int:
    """Byte budget of the resident allocations: ``explicit`` (the task's
    ``device_pool_bytes``), else ``CTT_DEVICE_POOL_BYTES``, else
    :data:`DEFAULT_POOL_BYTES`."""
    if explicit is not None:
        return max(0, int(explicit))
    env = os.environ.get("CTT_DEVICE_POOL_BYTES")
    if env:
        return max(0, int(env))
    return DEFAULT_POOL_BYTES


class DevicePoolExhausted(Exception):
    """The resident pool cannot hold a batch even after evicting
    everything.  Deliberately not a MemoryError: the executor catches it
    as the typed "stage from the host" signal and never quarantines blocks
    over it."""


def _content_key(page: np.ndarray) -> int:
    # content addressing: identical bytes share one resident slot.  crc32
    # collisions would alias two pages; at chunk-scale page counts the
    # 2^-32 rate is accepted, as in the reference
    return zlib.crc32(np.ascontiguousarray(page).tobytes())


def _quantize_count(n: int) -> int:
    """Round an upload width up to a power of two (>= 1)."""
    cap = 1
    while cap < n:
        cap *= 2
    return cap


class StagedBatch:
    """A ragged batch staged against the resident arenas: the descriptor
    surface of :class:`~.block_pool.RaggedBatch`, with ``pools`` the live
    device tensors and the tables rewritten to arena slots."""

    def __init__(self, specs, pools, tables, valids, width):
        self.specs: Tuple[RaggedArgSpec, ...] = tuple(specs)
        self.pools: List[torch.Tensor] = pools
        self.tables: List[np.ndarray] = tables
        self.valids: List[np.ndarray] = valids
        self.width = int(width)


class _DeviceArena:
    """One persistent ``[capacity, *page_shape]`` tensor for one
    ``(page_shape, dtype)`` class, slots assigned to page contents under
    an LRU.  Staging is serialized per arena: the slot table and the
    resident bytes advance together."""

    def __init__(self, page_shape, dtype, capacity, device: torch.device):
        self.page_shape = tuple(int(p) for p in page_shape)
        self.dtype = np.dtype(dtype)
        self.capacity = int(capacity)
        self.device = device
        self.page_nbytes = int(np.prod(self.page_shape, dtype=np.int64)) * self.dtype.itemsize
        self.pool = torch.zeros((self.capacity,) + self.page_shape,
                                dtype=torch.from_numpy(np.zeros(0, self.dtype)).dtype, device=device)
        self._lock = threading.Lock()
        # content crc -> slot, in LRU order (oldest first)
        self.slots: "OrderedDict[int, int]" = OrderedDict()
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))

    @property
    def nbytes(self) -> int:
        return self.capacity * self.page_nbytes

    def _take_slot(self, pinned) -> int:
        if self._free:
            return self._free.pop()
        # LRU eviction: the oldest content not in use by the batch being
        # staged loses its slot; its bytes are overwritten by this upload
        for key, slot in self.slots.items():
            if slot not in pinned:
                del self.slots[key]
                bump("device_pool_evictions")
                return slot
        raise DevicePoolExhausted(f"every slot of the {self.page_shape} arena is in use by the batch")

    def stage_pages(self, host_pool: np.ndarray, n_used: int, pinned=None) -> np.ndarray:
        """Map host slots ``[0, n_used)`` to resident slots, uploading only
        contents the arena does not hold; returns the mapping array.
        ``pinned`` (a set, updated here) holds the slots the batch being
        staged already maps: the arena is updated in place, so they may not
        be evicted until its lanes are read."""
        pinned = set() if pinned is None else pinned
        with self._lock:
            mapping = np.zeros(n_used, np.int32)
            miss_slots: List[int] = []
            miss_pages: List[np.ndarray] = []
            for s in range(n_used):
                key = _content_key(host_pool[s])
                slot = self.slots.get(key)
                if slot is not None:
                    self.slots.move_to_end(key)
                    bump("device_pool_hits")
                    bump("bytes_not_staged", self.page_nbytes)
                else:
                    slot = self._take_slot(pinned)
                    self.slots[key] = slot
                    bump("device_pool_misses")
                    miss_slots.append(slot)
                    miss_pages.append(host_pool[s])
                mapping[s] = slot
                pinned.add(slot)
            if miss_slots:
                # the pad repeats the last (slot, page) pair: same slot,
                # same bytes, a benign duplicate write
                width = _quantize_count(len(miss_slots))
                while len(miss_slots) < width:
                    miss_slots.append(miss_slots[-1])
                    miss_pages.append(miss_pages[-1])
                stacked = np.stack(miss_pages)
                record_h2d(stacked.nbytes)
                try:
                    staged = torch.from_numpy(stacked).to(self.device)
                    idx = torch.from_numpy(np.asarray(miss_slots, np.int64)).to(self.device)
                    self.pool.index_copy_(0, idx, staged)
                except BaseException:
                    # the slots were registered before the upload landed:
                    # forget them, or a retry would take them as hits
                    missed = set(miss_slots)
                    for key in [k for k, v in self.slots.items() if v in missed]:
                        del self.slots[key]
                    self._free.extend(missed)
                    raise
            return mapping


class DevicePagePool:
    """Process-wide manager of the resident arenas: one arena set per card,
    an arena per ``(page_shape, dtype)`` class, each card's set under its
    own byte budget and its own staging lock."""

    def __init__(self, budget: Optional[int] = None):
        self._lock = threading.Lock()
        self._card_locks: Dict[str, threading.RLock] = {}
        self._arenas: "OrderedDict[tuple, _DeviceArena]" = OrderedDict()
        self._budget = device_pool_budget(budget)

    def lock_for(self, device) -> threading.RLock:
        """The lock of ``device``'s arenas: held from :meth:`stage` until
        the staged lanes are gathered."""
        key = card_key(device)
        with self._lock:
            return self._card_locks.setdefault(key, threading.RLock())

    def _card_arenas(self, device) -> List[tuple]:
        key = None if device is None else card_key(device)
        return [k for k in self._arenas if key is None or k[0] == key]

    def evict_all(self, device=None) -> None:
        """Drop every arena of ``device`` (``None``: of every card): the
        degrade ladder's evict rung, and tests."""
        with self._lock:
            for k in self._card_arenas(device):
                del self._arenas[k]

    def resident_bytes(self, device=None) -> int:
        """Resident bytes of ``device``'s arenas (``None``: every card's)."""
        with self._lock:
            return sum(self._arenas[k].nbytes for k in self._card_arenas(device))

    def _arena_for(self, spec: RaggedArgSpec, need_pages: int, device: torch.device) -> _DeviceArena:
        akey = (card_key(device), spec.page_shape, spec.dtype)
        page_nbytes = int(np.prod(spec.page_shape, dtype=np.int64)) * np.dtype(spec.dtype).itemsize
        cap_budget = self._budget // max(1, page_nbytes)
        if need_pages > cap_budget:
            raise DevicePoolExhausted(
                f"batch needs {need_pages} pages of {page_nbytes} B but the device pool budget "
                f"({self._budget} B) holds at most {cap_budget}"
            )
        with self._lock:
            arena = self._arenas.get(akey)
            if arena is not None and arena.capacity >= need_pages:
                self._arenas.move_to_end(akey)
                return arena
            # grow: a fresh arena at the next power-of-two capacity; the
            # old mappings die with the old arena
            capacity = min(_quantize_pages(need_pages), cap_budget)
            arena = _DeviceArena(spec.page_shape, spec.dtype, capacity, device)
            self._arenas[akey] = arena
            self._arenas.move_to_end(akey)
            # the card's budget across its arenas: evict its oldest whole
            # arenas until its resident total fits (never the one just built)
            card = [k for k in self._card_arenas(device) if k != akey]
            while card and sum(self._arenas[k].nbytes for k in card) + arena.nbytes > self._budget:
                del self._arenas[card.pop(0)]
                bump("device_pool_evictions")
            return arena

    def _stage(self, rb: RaggedBatch, device: torch.device) -> StagedBatch:
        specs: List[RaggedArgSpec] = []
        pools: List[torch.Tensor] = []
        tables: List[np.ndarray] = []
        # arguments of one page class share an arena, updated in place: size
        # it for all of them and pin the batch's slots until it is staged
        need: Dict[tuple, int] = {}
        for spec, table in zip(rb.specs, rb.tables):
            cls = (spec.page_shape, spec.dtype)
            need[cls] = need.get(cls, 0) + int(table.max()) + 1
        pinned: Dict[int, set] = {}
        for spec, pool, table in zip(rb.specs, rb.pools, rb.tables):
            n_used = int(table.max()) + 1
            arena = self._arena_for(spec, need[(spec.page_shape, spec.dtype)], device)
            mapping = arena.stage_pages(pool, n_used, pinned.setdefault(id(arena), set()))
            specs.append(spec._replace(pool_pages=arena.capacity))
            pools.append(arena.pool)
            tables.append(mapping[table])
        bump("device_batches_staged")
        return StagedBatch(specs, pools, tables, list(rb.valids), rb.width)

    def stage(self, rb: RaggedBatch, device, block_id: Optional[int] = None) -> StagedBatch:
        """Stage ``rb`` against the resident arenas on ``device``.  On a
        resource error (``torch.OutOfMemoryError``, or the fault injector's
        ``h2d`` OOM for ``block_id``): evict every arena of ``device``,
        retry once, then raise :class:`DevicePoolExhausted`."""
        from ..runtime import faults as faults_mod
        from ..runtime.executor import classify_resource_error

        device = torch.device(device)
        injector = faults_mod.get_injector()
        for attempt in (0, 1):
            try:
                # an injected OOM at page upload: the resident allocation
                # does not fit
                injector.maybe_fail("h2d", block_id, voxels=rb.nbytes)
                return self._stage(rb, device)
            except DevicePoolExhausted:
                raise
            except Exception as e:
                if classify_resource_error(e) is None:
                    raise
                self.evict_all(device)
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                if attempt:
                    raise DevicePoolExhausted(
                        f"device pool out of memory after evicting all resident arenas: {e}"
                    ) from e
        raise AssertionError("unreachable")


_pool: Optional[DevicePagePool] = None
_pool_lock = threading.Lock()


def get_device_pool(budget: Optional[int] = None) -> DevicePagePool:
    """The process-wide resident pool (created on first use).  An explicit
    ``budget`` re-scopes the budget for later staging; the arenas
    persist."""
    global _pool
    if _pool is None:
        with _pool_lock:
            if _pool is None:
                _pool = DevicePagePool(budget)
    if budget is not None:
        _pool._budget = device_pool_budget(budget)
    return _pool


def reset() -> None:
    """Drop the resident pool and its arenas (tests)."""
    global _pool
    with _pool_lock:
        _pool = None
