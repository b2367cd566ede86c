"""Process-wide cache of decompressed chunks, with single-flight loads.

Port of ``cluster_tools_tpu/io/chunk_cache.py`` (standard library and
numpy).  Halo'd block reads overlap their neighbours' chunks: at block
128^3, halo 32 and chunks 128^3 an interior outer read of 192^3 touches
3^3 = 27 chunks, and one sweep of a 512^3 volume decompresses
10^3 = 1,000 chunk files for its 64 distinct chunks.  This module is the
fix: a byte-bounded LRU of *decompressed* chunks keyed by ``(dataset,
chunk index)``, from which :mod:`.containers` assembles region reads, so
only the chunks that miss are read and decompressed.

- **Single flight**: concurrent loads of one chunk share one storage read.
  The first caller becomes its *owner* and reads it; later callers *wait*
  on the owner's token (counted as ``coalesced``).  A waiter that outlives
  ``CTT_CHUNK_CACHE_WAIT_S`` (default 30 s) reads the chunk itself
  (:class:`ChunkWaitTimeout`, counted as ``stall_fallbacks``), so one
  wedged read cannot serialise every consumer of a chunk.
- **Coherence**: writes evict every chunk they overlap and doom the
  in-flight loads of those chunks.  A doomed load still serves the waiters
  it already has, but it is never cached, and a reader that comes after
  the write starts a fresh load instead of joining it.  A load that fails
  caches nothing; only a value within the budget is kept.

``CTT_CHUNK_CACHE=0`` is the kill switch: reads go straight to storage
(counted as ``direct_reads``) exactly as without this layer.
``CTT_CHUNK_CACHE_BYTES`` sets the budget; the default is ``min(1 GiB,
MemAvailable/8)``, else 256 MiB.  The executor's automatic in-flight byte
budget subtracts it.

The counters (:data:`STAT_KEYS`) are process-wide; the task runtime
snapshots them around each task and merges the delta into
``io_metrics.json``; a stall fallback is also a ``chunk_cache.stall_fallback``
trace instant.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, Iterable, Optional

import numpy as np

#: counter names, fixed so snapshots and deltas keep one schema
STAT_KEYS = (
    "hits",
    "misses",
    "coalesced",
    "evictions",
    "invalidations",
    "bytes_from_storage",
    "bytes_served",
    "direct_reads",
    "stall_fallbacks",
)


class ChunkWaitTimeout(Exception):
    """A coalesced waiter outlived its patience (:func:`stall_wait_s`) for a
    shared in-flight load; the caller reads the chunk itself."""


def cache_enabled() -> bool:
    """Chunk caching of region reads (default on); ``CTT_CHUNK_CACHE=0``
    (or ``false``/``off``) switches it off."""
    return os.environ.get("CTT_CHUNK_CACHE", "1").lower() not in ("0", "false", "off")


def stall_wait_s() -> float:
    """Patience of a coalesced wait before an independent read
    (``CTT_CHUNK_CACHE_WAIT_S``, default 30 s)."""
    try:
        return float(os.environ.get("CTT_CHUNK_CACHE_WAIT_S", "30"))
    except ValueError:
        return 30.0


def _default_budget() -> int:
    env = os.environ.get("CTT_CHUNK_CACHE_BYTES")
    if env:
        return max(0, int(env))
    from ..runtime.supervision import host_mem_available_bytes

    avail = host_mem_available_bytes()
    if avail:
        return int(min(1 << 30, avail // 8))
    return 256 << 20


class _InFlight:
    """One in-flight chunk load, shared by its owner and its waiters."""

    __slots__ = ("event", "value", "exc", "doomed")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.exc: Optional[BaseException] = None
        # a write raced this load: serve the waiters, cache nothing
        self.doomed = False


class ChunkCache:
    """Byte-bounded LRU of decompressed chunk arrays with single-flight loads.

    :meth:`get_or_begin` returns ``(HIT, array)``, ``(OWNER, token)`` (the
    caller reads the chunk and settles the token with :meth:`complete` or
    :meth:`fail`) or ``(WAIT, token)`` (another owner's load, to
    :meth:`wait` on).  Cached arrays are shared: callers copy out of them
    and never write to them.
    """

    HIT, OWNER, WAIT = "hit", "owner", "wait"

    def __init__(self, max_bytes: Optional[int] = None):
        self.max_bytes = int(_default_budget() if max_bytes is None else max_bytes)
        self._lock = threading.Lock()
        self._data: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self._inflight: Dict[tuple, _InFlight] = {}
        self.stats: Dict[str, int] = {k: 0 for k in STAT_KEYS}

    # -- single flight -----------------------------------------------------
    def get_or_begin(self, key: tuple):
        """``(HIT, array)``, ``(OWNER, token)`` or ``(WAIT, token)``."""
        with self._lock:
            arr = self._data.get(key)
            if arr is not None:
                self._data.move_to_end(key)
                self.stats["hits"] += 1
                return self.HIT, arr
            inf = self._inflight.get(key)
            if inf is not None:
                self.stats["coalesced"] += 1
                return self.WAIT, inf
            inf = _InFlight()
            self._inflight[key] = inf
            self.stats["misses"] += 1
            return self.OWNER, inf

    def _retire(self, key: tuple, token: _InFlight) -> None:
        # a write may have retired this token already and a fresh load of
        # the same key begun since: leave that one in place
        if self._inflight.get(key) is token:
            del self._inflight[key]

    def complete(self, key: tuple, token: _InFlight, value: np.ndarray) -> None:
        """The owner's read landed: serve the waiters, and cache the value
        unless a write doomed the load or it exceeds the budget."""
        value = np.asarray(value)
        with self._lock:
            self.stats["bytes_from_storage"] += int(value.nbytes)
            if not token.doomed and 0 < value.nbytes <= self.max_bytes:
                old = self._data.pop(key, None)
                if old is not None:
                    self._bytes -= int(old.nbytes)
                self._data[key] = value
                self._bytes += int(value.nbytes)
                while self._bytes > self.max_bytes and self._data:
                    _, evicted = self._data.popitem(last=False)
                    self._bytes -= int(evicted.nbytes)
                    self.stats["evictions"] += 1
            self._retire(key, token)
            token.value = value
        token.event.set()

    def fail(self, key: tuple, token: _InFlight, exc: BaseException) -> None:
        """The owner's read failed: raise it in the waiters, cache nothing."""
        with self._lock:
            self._retire(key, token)
            token.exc = exc
        token.event.set()

    @staticmethod
    def wait(token: _InFlight, timeout: Optional[float] = None) -> np.ndarray:
        """The shared load's value; raises the owner's error, or
        :class:`ChunkWaitTimeout` after ``timeout`` seconds."""
        if not token.event.wait(timeout):
            raise ChunkWaitTimeout()
        if token.exc is not None:
            raise token.exc
        return token.value

    # -- coherence ---------------------------------------------------------
    def _doom(self, key: tuple) -> None:
        inf = self._inflight.pop(key, None)
        if inf is not None:
            inf.doomed = True

    def invalidate(self, keys: Iterable[tuple]) -> None:
        """Evict ``keys`` and doom their in-flight loads."""
        with self._lock:
            for key in keys:
                arr = self._data.pop(key, None)
                if arr is not None:
                    self._bytes -= int(arr.nbytes)
                    self.stats["invalidations"] += 1
                self._doom(key)

    def invalidate_dataset(self, dataset_id) -> None:
        """Evict every chunk of one dataset and doom its in-flight loads."""
        with self._lock:
            for key in [k for k in self._data if k[0] == dataset_id]:
                self._bytes -= int(self._data.pop(key).nbytes)
                self.stats["invalidations"] += 1
            for key in [k for k in self._inflight if k[0] == dataset_id]:
                self._doom(key)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._bytes = 0

    # -- accounting --------------------------------------------------------
    def record_served(self, nbytes: int) -> None:
        with self._lock:
            self.stats["bytes_served"] += int(nbytes)

    def record_direct(self, nbytes: int) -> None:
        """A region read past the cache (kill switch, zero budget, a region
        over half the budget): its bytes from storage are its bytes served."""
        with self._lock:
            self.stats["direct_reads"] += 1
            self.stats["bytes_from_storage"] += int(nbytes)
            self.stats["bytes_served"] += int(nbytes)

    def record_stall_fallback(self, nbytes: int) -> None:
        """A waiter timed out on a stalled shared load and read the chunk
        itself."""
        with self._lock:
            self.stats["stall_fallbacks"] += 1
            self.stats["bytes_from_storage"] += int(nbytes)
        # the wedged storage read shows on the timeline next to the block
        # whose patience it burned
        from ..runtime import trace as trace_mod

        trace_mod.instant("chunk_cache.stall_fallback", nbytes=int(nbytes))

    @property
    def cached_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)


_cache: Optional[ChunkCache] = None
_singleton_lock = threading.Lock()


def get_chunk_cache() -> ChunkCache:
    """The process-wide cache (its budget read at first use)."""
    global _cache
    if _cache is None:
        with _singleton_lock:
            if _cache is None:
                _cache = ChunkCache()
    return _cache


def configure(max_bytes: Optional[int] = None) -> ChunkCache:
    """Install a fresh cache: empty, counters at zero, budget ``max_bytes``
    (None: the default)."""
    global _cache
    with _singleton_lock:
        _cache = ChunkCache(max_bytes)
    return _cache


def snapshot() -> Dict[str, int]:
    """A copy of the counters; pair with :func:`delta`."""
    cache = get_chunk_cache()
    with cache._lock:
        return dict(cache.stats)


def delta(snap: Dict[str, int]) -> Dict[str, int]:
    """The counters' movement since ``snap`` (non-negative: a
    :func:`configure` in between clamps to the new totals)."""
    cache = get_chunk_cache()
    with cache._lock:
        cur = dict(cache.stats)
    return {k: max(0, cur.get(k, 0) - snap.get(k, 0)) for k in STAT_KEYS}
