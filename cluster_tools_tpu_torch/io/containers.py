"""Chunked containers: zarr v2 and N5 in numpy and ``zlib``, HDF5 through
``h5py``, and ``memory://``.

Port of ``cluster_tools_tpu/io/containers.py``.  The reference's
``ZarrContainer`` goes through ``tensorstore`` and its ``H5Container``
through ``h5py``; the machine that runs the port on the card has neither,
so the port reads and writes zarr v2 and N5 itself:

- zarr: ``.zgroup`` and ``.zarray`` JSON, chunk files ``i.j.k`` (or nested
  with ``dimension_separator`` ``/``), C order, ``fill_value`` for chunks
  that were never written, full-size edge chunks; compressors ``zlib``
  (the reference writes ``{"id": "zlib", "level": 1}`` for
  ``compression="gzip"``) and ``null``;
- N5 (``.n5``, in the same container class): the group's
  ``attributes.json`` holds ``{"n5": "2.0.0"}``; a dataset's holds
  ``dimensions`` and ``blockSize`` fastest axis first, ``dataType`` and
  ``compression`` (``gzip``, gzip- or zlib-framed, or ``raw``) beside the
  user attributes; block files ``<key>/<i_x>/<i_y>/<i_z>``, each a
  big-endian header (mode 0, the number of axes, the block's extent along
  each axis, fastest first) and the big-endian payload.  Edge blocks are
  written truncated to the volume, as the N5 specification has them; a
  block written at full size (tensorstore writes them so) reads as well.
  A missing block reads as 0: N5 has no fill value;
- region reads and writes spanning any number of chunks; every chunk file
  is written to a temporary name and moved into place with ``os.replace``,
  so concurrent readers see a whole chunk, old or new.

Files written by either package read back bit for bit in the other.

Reads are assembled from the process-wide cache of decompressed chunks
(:mod:`.chunk_cache`): only the chunks that miss are read from disk and
decompressed, once however many concurrent readers want them.  Writes
evict every chunk they overlap (the partial-chunk read-modify-write reads
the disk, never the cache); a fresh dataset evicts whatever was cached
under its path.  ``CTT_CHUNK_CACHE=0`` reads past the cache, as before it
existed.  ``read_async`` and ``write_async`` return
``concurrent.futures.Future`` objects from a module-level I/O pool.

HDF5 (``.h5``, ``.hdf5``, ``.hdf``) goes through ``h5py``, imported when a
file is opened; it bypasses the chunk cache, as in the reference, and its
async calls return futures already resolved.  Without ``h5py`` (the card's
machine has none) opening such a file raises ``ImportError``.
``memory://`` datasets live in a process-wide registry, as in the
reference.  The reference's fault-injection and checksum hooks and its
verify-on-read are ROADMAP Queue A item 11a.

:class:`HandoffDataset` is the in-memory twin of a chunked dataset that
the task-graph fusion layer (:mod:`..runtime.handoff`) hands from a
producer task to its consumers.  The port's stores carry no digest
sidecars (the reference's ``.ctt_checksums/`` and ``io/verified.py`` are
item 11a), so a handoff's integrity rests on in-memory CRC32 region
digests: every region write records one, ``verify_region`` checks it, and
:meth:`HandoffDataset.spill` reads every chunk it wrote back from the
store and holds it against the CRC32 of the in-memory bytes before it
releases them.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import struct
import threading
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from . import chunk_cache as _chunk_cache

_ZARR_EXTS = (".zarr", ".zr")
_N5_EXTS = (".n5",)
_H5_EXTS = (".h5", ".hdf5", ".hdf")
# the data types N5 knows, by the numpy names it uses
_N5_DTYPES = ("uint8", "uint16", "uint32", "uint64", "int8", "int16", "int32", "int64", "float32", "float64")
# the keys of an N5 dataset's attributes.json that are its metadata
_N5_META_KEYS = ("dimensions", "blockSize", "dataType", "compression")


def _clamp_chunks(chunks, shape):
    """Chunks capped at the dataset shape."""
    return tuple(int(min(c, s)) for c, s in zip(chunks, shape))


def _check_existing(key, have_shape, have_dtype, want_shape, want_dtype, have_chunks=None, want_chunks=None):
    if tuple(have_shape) != tuple(int(s) for s in want_shape) or np.dtype(have_dtype) != np.dtype(want_dtype):
        raise ValueError(
            f"dataset {key!r} exists with shape {tuple(have_shape)} / dtype {np.dtype(have_dtype)}, "
            f"requested {tuple(want_shape)} / {np.dtype(want_dtype)}"
        )
    if have_chunks is None or want_chunks is None:
        return
    have_chunks = tuple(int(c) for c in have_chunks)
    want_chunks = tuple(int(c) for c in want_chunks)
    # parallel block writes are conflict-free only when every written block
    # tiles whole chunks
    if len(have_chunks) != len(want_chunks) or any(w % h for w, h in zip(want_chunks, have_chunks)):
        raise ValueError(
            f"dataset {key!r} exists with chunks {have_chunks}, requested {want_chunks} — blocks must "
            "tile whole chunks (per-axis integer multiples) for chunk-aligned parallel writes; use a "
            "matching block_shape or a fresh dataset"
        )


def _region(bb, shape) -> Tuple[Tuple[Tuple[int, int], ...], Tuple[int, ...]]:
    """``(((start, stop), ...), squeezed_axes)`` of a numpy basic index
    (ints, unit-step slices, one Ellipsis) into an array of ``shape``."""
    if not isinstance(bb, tuple):
        bb = (bb,)
    if any(b is Ellipsis for b in bb):
        i = next(k for k, b in enumerate(bb) if b is Ellipsis)
        bb = bb[:i] + (slice(None),) * (len(shape) - len(bb) + 1) + bb[i + 1:]
    if len(bb) > len(shape):
        raise IndexError(f"too many indices ({len(bb)}) for a {len(shape)}-d dataset")
    bb = bb + (slice(None),) * (len(shape) - len(bb))
    region, squeeze = [], []
    for ax, (b, n) in enumerate(zip(bb, shape)):
        if isinstance(b, slice):
            start, stop, step = b.indices(n)
            if step != 1:
                raise IndexError("only unit-step slices are supported")
            region.append((start, max(start, stop)))
        else:
            i = int(b)
            if i < 0:
                i += n
            if not 0 <= i < n:
                raise IndexError(f"index {int(b)} out of range for axis {ax} of size {n}")
            region.append((i, i + 1))
            squeeze.append(ax)
    return tuple(region), tuple(squeeze)


def _fill_json(fill_value, dtype):
    """``fill_value`` as zarr v2 JSON for ``dtype``."""
    dt = np.dtype(dtype)
    if fill_value is None:
        return None
    if dt.kind == "b":
        return bool(fill_value)
    if dt.kind == "f":
        v = float(fill_value)
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        return v
    return int(fill_value)


def _fill_from_json(value, dtype):
    if value is None:
        return np.zeros((), dtype)[()]
    if isinstance(value, str):
        value = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[value]
    return np.asarray(value).astype(dtype)[()]


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not json-serializable: {type(o)}")


def _read_file(path: str) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        return None


_io_pool: Optional[ThreadPoolExecutor] = None
_io_pool_lock = threading.Lock()


def _submit(fn, *args) -> Future:
    """``fn(*args)`` on the module's I/O pool.  The call runs whether or not
    anyone resolves its future, so a dropped future strands nothing."""
    global _io_pool
    with _io_pool_lock:
        if _io_pool is None:
            _io_pool = ThreadPoolExecutor(max_workers=min(32, (os.cpu_count() or 1) + 4),
                                          thread_name_prefix="ctt-io")
    return _io_pool.submit(fn, *args)


def _resolved(value) -> Future:
    fut: Future = Future()
    fut.set_result(value)
    return fut


class _CachedReadPlan:
    """A cache-assembled read begun: its region and one ``(cache key, chunk
    box, HIT/OWNER/WAIT, array or token)`` step a chunk of its cover."""

    __slots__ = ("region", "steps")

    def __init__(self, region, steps):
        self.region = region
        self.steps = steps


class _ChunkedDataset:
    """A chunked array on the local filesystem with numpy ``__getitem__`` /
    ``__setitem__`` over basic indices, reads assembled through the chunk
    cache.  Subclasses read and write one chunk, clipped to the volume
    (:meth:`_load_chunk`, :meth:`_store_chunk`)."""

    def __init__(self, path: str, shape, chunks, dtype, fill_value, attrs_path: str):
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self.chunks = tuple(int(c) for c in chunks)
        self.dtype = np.dtype(dtype)
        self.fill_value = fill_value
        self._attrs_path = attrs_path
        # the cache identity: the dataset's path, shared by every handle on it
        # in this process (handles on one store share and evict each other's
        # entries)
        self._cache_id = os.path.normpath(os.path.abspath(path))
        # partial-chunk writes read, modify and write a chunk; attribute
        # updates read, modify and write their file
        self._rmw_lock = threading.Lock()
        self._attrs_lock = threading.Lock()

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _load_chunk(self, idx) -> Optional[np.ndarray]:  # pragma: no cover - abstract
        """The stored chunk ``idx`` clipped to the volume, or None."""
        raise NotImplementedError

    def _store_chunk(self, idx, a: np.ndarray) -> None:  # pragma: no cover - abstract
        """Write chunk ``idx`` from ``a``, its part inside the volume."""
        raise NotImplementedError

    def _valid(self, idx) -> Tuple[int, ...]:
        """The extent of chunk ``idx`` inside the volume."""
        return tuple(min(c, s - i * c) for i, c, s in zip(idx, self.chunks, self.shape))

    def _chunk_or_fill(self, idx) -> np.ndarray:
        """Chunk ``idx`` clipped to the volume; a missing one as a read-only
        broadcast of the fill value."""
        a = self._load_chunk(idx)
        if a is None:
            a = np.broadcast_to(np.asarray(self.fill_value, self.dtype), self._valid(idx))
        return a

    def _cover(self, region):
        """``(chunk index, slice in the chunk, slice in the region)`` of every
        chunk that ``region`` touches."""
        ranges = [range(lo // c, (hi - 1) // c + 1) if hi > lo else range(0)
                  for (lo, hi), c in zip(region, self.chunks)]
        for idx in itertools.product(*ranges):
            in_chunk, in_region = [], []
            for i, (lo, hi), c in zip(idx, region, self.chunks):
                a, b = max(lo, i * c), min(hi, (i + 1) * c)
                in_chunk.append(slice(a - i * c, b - i * c))
                in_region.append(slice(a - lo, b - lo))
            yield idx, tuple(in_chunk), tuple(in_region)

    def _chunk_cover(self, region):
        """``[(cache key, chunk box), ...]`` of the chunks ``region`` touches,
        each box clipped to the volume."""
        return [((self._cache_id, idx), tuple((i * c, min((i + 1) * c, s))
                                              for i, c, s in zip(idx, self.chunks, self.shape)))
                for idx, _, _ in self._cover(region)]

    # -- reads -------------------------------------------------------------
    def _read_direct(self, region) -> np.ndarray:
        """``region`` from storage, every chunk decompressed here."""
        out = np.full(tuple(hi - lo for lo, hi in region), self.fill_value, dtype=self.dtype)
        for idx, in_chunk, in_region in self._cover(region):
            chunk = self._load_chunk(idx)
            if chunk is not None:
                out[in_region] = chunk[in_chunk]
        return out

    def _begin_cached_read(self, bb) -> Optional[_CachedReadPlan]:
        """Take a HIT, OWNER or WAIT ticket for every chunk of ``bb``'s
        cover; None where the read goes past the cache (kill switch, zero
        budget, or a region over half the budget, which would flush the
        working set the cache keeps).  The caller must pass the plan to
        :meth:`_finish_cached_read`, which settles every owned ticket."""
        if not _chunk_cache.cache_enabled():
            return None
        cache = _chunk_cache.get_chunk_cache()
        if cache.max_bytes <= 0:
            return None
        region, _ = _region(bb, self.shape)
        nbytes = int(np.prod([hi - lo for lo, hi in region], dtype=np.int64)) * self.dtype.itemsize
        if nbytes > cache.max_bytes // 2:
            return None
        steps = []
        for key, box in self._chunk_cover(region):
            kind, handle = cache.get_or_begin(key)
            steps.append((key, box, kind, handle))
        return _CachedReadPlan(region, steps)

    def _finish_cached_read(self, plan: _CachedReadPlan) -> np.ndarray:
        """Read and settle every owned chunk first (so an owner never blocks
        with a ticket unsettled), then assemble the region into a fresh
        array from hits, owned chunks and the waits.  A wait that outlives
        :func:`~.chunk_cache.stall_wait_s` reads its chunk from storage
        itself.  After the first failed chunk the remaining waits are
        skipped and that error is raised."""
        cache = _chunk_cache.get_chunk_cache()
        for key, _box, kind, token in plan.steps:
            if kind == cache.OWNER:
                try:
                    value = self._chunk_or_fill(key[1])
                except BaseException as e:
                    cache.fail(key, token, e)
                else:
                    cache.complete(key, token, value)
        patience = _chunk_cache.stall_wait_s()
        region = plan.region
        out = np.empty(tuple(hi - lo for lo, hi in region), self.dtype)
        for key, box, kind, handle in plan.steps:
            if kind == cache.HIT:
                chunk = handle
            else:
                try:
                    chunk = cache.wait(handle, timeout=patience)
                except _chunk_cache.ChunkWaitTimeout:
                    chunk = self._chunk_or_fill(key[1])
                    cache.record_stall_fallback(chunk.nbytes)
            src, dst = [], []
            for (ra, rb), (ca, cb) in zip(region, box):
                lo, hi = max(ra, ca), min(rb, cb)
                src.append(slice(lo - ca, hi - ca))
                dst.append(slice(lo - ra, hi - ra))
            out[tuple(dst)] = chunk[tuple(src)]
        cache.record_served(out.nbytes)
        return out

    def _invalidate_cached_region(self, region) -> None:
        """Evict every cached chunk ``region`` overlaps and doom their
        in-flight loads, even with the kill switch on: entries cached while
        it was off must not outlive a write."""
        _chunk_cache.get_chunk_cache().invalidate([key for key, _box in self._chunk_cover(region)])

    def __getitem__(self, bb) -> np.ndarray:
        region, squeeze = _region(bb, self.shape)
        plan = self._begin_cached_read(bb)
        if plan is None:
            out = self._read_direct(region)
            _chunk_cache.get_chunk_cache().record_direct(out.nbytes)
        else:
            out = self._finish_cached_read(plan)
        return out.squeeze(axis=squeeze) if squeeze else out

    def read_async(self, bb) -> Future:
        """A future of ``self[bb]``, read on the I/O pool."""
        return _submit(self.__getitem__, bb)

    # -- writes ------------------------------------------------------------
    def __setitem__(self, bb, value) -> None:
        region, squeeze = _region(bb, self.shape)
        shape = tuple(hi - lo for lo, hi in region)
        kept = tuple(s for ax, s in enumerate(shape) if ax not in squeeze)
        value = np.broadcast_to(np.asarray(value, dtype=self.dtype), kept).reshape(shape)
        try:
            for idx, in_chunk, in_region in self._cover(region):
                valid = self._valid(idx)
                if all(sl.start == 0 and sl.stop == v for sl, v in zip(in_chunk, valid)):
                    self._store_chunk(idx, value[in_region])
                    continue
                with self._rmw_lock:
                    old = self._load_chunk(idx)
                    chunk = np.full(valid, self.fill_value, dtype=self.dtype) if old is None else old.copy()
                    chunk[in_chunk] = value[in_region]
                    self._store_chunk(idx, chunk)
        finally:
            # after the write, and also when it raised: some chunks may have
            # landed before the error
            self._invalidate_cached_region(region)

    def write_async(self, bb, value) -> Future:
        """A future of ``self[bb] = value``, written on the I/O pool from a
        copy of ``value``."""
        return _submit(self.__setitem__, bb, np.array(value, dtype=self.dtype))

    # -- attributes --------------------------------------------------------
    @property
    def attrs(self) -> Dict:
        raw = _read_file(self._attrs_path)
        return {} if raw is None else json.loads(raw)

    def update_attrs(self, **kwargs) -> None:
        """Merge ``kwargs`` into the attributes file, atomically."""
        with self._attrs_lock:
            attrs = self.attrs
            attrs.update(kwargs)
            _atomic_write(self._attrs_path, json.dumps(attrs, indent=2, default=_json_default).encode())


class ZarrDataset(_ChunkedDataset):
    """One zarr v2 array on the local filesystem."""

    def __init__(self, path: str, meta: dict):
        disk_dtype = np.dtype(meta["dtype"])
        dtype = disk_dtype.newbyteorder("=")
        super().__init__(path, meta["shape"], meta["chunks"], dtype, _fill_from_json(meta.get("fill_value"), dtype),
                         os.path.join(path, ".zattrs"))
        self._disk_dtype = disk_dtype
        self._order = meta.get("order", "C")
        if self._order not in ("C", "F"):
            raise ValueError(f"{path}: unknown order {self._order!r}")
        if meta.get("filters"):
            raise NotImplementedError(f"{path}: zarr filters {meta['filters']} are not supported")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zlib":
            raise NotImplementedError(f"{path}: compressor {comp.get('id')!r} (only zlib and null are supported)")
        self._level = None if comp is None else int(comp.get("level", 1))
        self._sep = meta.get("dimension_separator", ".")

    def _chunk_path(self, idx) -> str:
        return os.path.join(self.path, self._sep.join(str(i) for i in idx))

    def _load_chunk(self, idx) -> Optional[np.ndarray]:
        raw = _read_file(self._chunk_path(idx))
        if raw is None:
            return None
        if self._level is not None:
            raw = zlib.decompress(raw)
        n = int(np.prod(self.chunks))
        if len(raw) != n * self._disk_dtype.itemsize:
            raise ValueError(f"{self._chunk_path(idx)}: {len(raw)} bytes, expected {n * self._disk_dtype.itemsize}")
        a = np.frombuffer(raw, dtype=self._disk_dtype).reshape(self.chunks, order=self._order)
        valid = self._valid(idx)
        if valid != self.chunks:
            # an edge chunk is stored at full size: keep its part in the volume
            return np.ascontiguousarray(a[tuple(slice(0, v) for v in valid)], dtype=self.dtype)
        return a.astype(self.dtype, copy=False)

    def _store_chunk(self, idx, a: np.ndarray) -> None:
        if a.shape != self.chunks:
            full = np.full(self.chunks, self.fill_value, dtype=self.dtype)
            full[tuple(slice(0, s) for s in a.shape)] = a
            a = full
        raw = np.asarray(a, dtype=self._disk_dtype).tobytes(order=self._order)
        if self._level is not None:
            raw = zlib.compress(raw, self._level)
        path = self._chunk_path(idx)
        if self._sep == "/":
            os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_write(path, raw)


class N5Dataset(_ChunkedDataset):
    """One N5 dataset on the local filesystem, presented in C order (the
    stored axis order reversed)."""

    def __init__(self, path: str, attrs: dict):
        if attrs.get("dataType") not in _N5_DTYPES:
            raise NotImplementedError(f"{path}: N5 dataType {attrs.get('dataType')!r}")
        dtype = np.dtype(attrs["dataType"])
        super().__init__(path, attrs["dimensions"][::-1], attrs["blockSize"][::-1], dtype, dtype.type(0),
                         os.path.join(path, "attributes.json"))
        self._disk_dtype = dtype.newbyteorder(">")
        comp = attrs.get("compression") or {"type": "raw"}
        kind = comp.get("type")
        if kind == "gzip":
            # gzip framing, or a bare zlib stream with useZlib
            self._wbits = 15 if comp.get("useZlib") else 31
            self._level = int(comp.get("level", -1))
        elif kind == "raw":
            self._wbits = None
        else:
            raise NotImplementedError(f"{path}: N5 compression {kind!r} (only gzip and raw are supported)")

    def _chunk_path(self, idx) -> str:
        return os.path.join(self.path, *(str(i) for i in reversed(idx)))

    def _load_chunk(self, idx) -> Optional[np.ndarray]:
        path = self._chunk_path(idx)
        raw = _read_file(path)
        if raw is None:
            return None
        mode, nd = struct.unpack(">HH", raw[:4])
        if mode != 0 or nd != self.ndim:
            raise NotImplementedError(f"{path}: N5 block mode {mode} with {nd} axes (only mode 0, "
                                      f"{self.ndim} axes)")
        dims = struct.unpack(f">{nd}I", raw[4:4 + 4 * nd])[::-1]
        payload = raw[4 + 4 * nd:]
        if self._wbits is not None:
            payload = zlib.decompress(payload, self._wbits)
        n = int(np.prod(dims))
        if len(payload) != n * self.dtype.itemsize:
            raise ValueError(f"{path}: {len(payload)} bytes, expected {n * self.dtype.itemsize} for block {dims}")
        valid = self._valid(idx)
        if any(d < v for d, v in zip(dims, valid)):
            raise ValueError(f"{path}: block {dims} smaller than its part of the volume {valid}")
        a = np.frombuffer(payload, dtype=self._disk_dtype).reshape(dims)
        # truncated to the volume (the specification) or stored at full size
        return a[tuple(slice(0, v) for v in valid)].astype(self.dtype)

    def _store_chunk(self, idx, a: np.ndarray) -> None:
        header = struct.pack(f">HH{a.ndim}I", 0, a.ndim, *reversed(a.shape))
        payload = np.ascontiguousarray(a, dtype=self._disk_dtype).tobytes()
        if self._wbits is not None:
            c = zlib.compressobj(self._level, zlib.DEFLATED, self._wbits)
            payload = c.compress(payload) + c.flush()
        path = self._chunk_path(idx)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_write(path, header + payload)

    def update_attrs(self, **kwargs) -> None:
        """Merge user attributes into ``attributes.json``, which also holds
        the dataset's metadata; those keys cannot be set this way."""
        clash = sorted(set(kwargs) & set(_N5_META_KEYS))
        if clash:
            raise ValueError(f"{self.path}: {clash} are the N5 dataset's metadata, not user attributes")
        super().update_attrs(**kwargs)


class ZarrContainer:
    """A zarr v2 group, or an N5 container for a path ending in ``.n5``, on
    the local filesystem (numpy + ``zlib``)."""

    def __init__(self, path: str, mode: str = "a"):
        self.path = os.path.abspath(path)
        self.mode = mode
        self.is_n5 = self.path.lower().endswith(_N5_EXTS)
        self._cache: Dict[str, _ChunkedDataset] = {}
        self._lock = threading.Lock()
        if mode != "r":
            os.makedirs(self.path, exist_ok=True)
            marker = os.path.join(self.path, "attributes.json" if self.is_n5 else ".zgroup")
            if not os.path.exists(marker):
                _atomic_write(marker, json.dumps({"n5": "2.0.0"} if self.is_n5 else {"zarr_format": 2}).encode())

    def _meta_path(self, key: str) -> str:
        return os.path.join(self.path, key, "attributes.json" if self.is_n5 else ".zarray")

    def _open(self, key: str, meta: dict) -> _ChunkedDataset:
        path = os.path.join(self.path, key)
        return N5Dataset(path, meta) if self.is_n5 else ZarrDataset(path, meta)

    def create_dataset(self, key: str, shape: Sequence[int], chunks: Sequence[int], dtype,
                       compression: Optional[str] = "gzip", exist_ok: bool = True,
                       fill_value=0) -> _ChunkedDataset:
        """A new dataset (N5 ignores ``fill_value``: it reads missing blocks
        as 0), or with ``exist_ok`` the existing one after checking its
        shape, dtype and chunks against the request."""
        if self.mode == "r":
            raise PermissionError(f"container {self.path} opened read-only")
        shape = [int(s) for s in shape]
        chunks = list(_clamp_chunks(chunks, shape))
        if key in self:
            if not exist_ok:
                raise ValueError(f"dataset {key} exists")
            ds = self[key]
            _check_existing(key, ds.shape, ds.dtype, shape, dtype, have_chunks=ds.chunks, want_chunks=chunks)
            return ds
        if self.is_n5:
            if np.dtype(dtype).name not in _N5_DTYPES:
                raise ValueError(f"N5 has no data type {np.dtype(dtype).name!r} (one of {_N5_DTYPES})")
            if compression not in ("gzip", "raw", None):
                raise NotImplementedError(f"N5 compression {compression!r} (only gzip and raw are supported)")
            # the keys, sorted, that tensorstore writes for the same request
            meta = {
                "blockSize": chunks[::-1],
                "compression": {"level": -1, "type": "gzip", "useZlib": False} if compression == "gzip"
                else {"type": "raw"},
                "dataType": np.dtype(dtype).name,
                "dimensions": shape[::-1],
            }
            text = json.dumps(meta, separators=(",", ":"))
        else:
            meta = {
                "chunks": chunks,
                # the reference's mapping: "gzip" is zlib at level 1, anything else none
                "compressor": {"id": "zlib", "level": 1} if compression == "gzip" else None,
                "dimension_separator": ".",
                "dtype": np.dtype(dtype).newbyteorder("<").str,
                "fill_value": _fill_json(fill_value, dtype),
                "filters": None,
                "order": "C",
                "shape": shape,
                "zarr_format": 2,
            }
            text = json.dumps(meta)
        os.makedirs(os.path.join(self.path, key), exist_ok=True)
        _atomic_write(self._meta_path(key), text.encode())
        ds = self._open(key, meta)
        # a fresh dataset lives at this path now: chunks cached under it
        # belong to a deleted predecessor
        _chunk_cache.get_chunk_cache().invalidate_dataset(ds._cache_id)
        with self._lock:
            self._cache[key] = ds
        return ds

    def require_dataset(self, key: str, **kwargs) -> _ChunkedDataset:
        return self.create_dataset(key, exist_ok=True, **kwargs)

    def __getitem__(self, key: str) -> _ChunkedDataset:
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        raw = _read_file(self._meta_path(key))
        if raw is None:
            raise KeyError(f"no dataset {key!r} in {self.path}")
        meta = json.loads(raw)
        if self.is_n5:
            if "dimensions" not in meta:
                raise KeyError(f"{key!r} in {self.path} is an N5 group, not a dataset")
        elif meta.get("zarr_format") != 2:
            raise NotImplementedError(f"{self.path}/{key}: zarr_format {meta.get('zarr_format')} (only 2)")
        ds = self._open(key, meta)
        with self._lock:
            self._cache[key] = ds
        return ds

    def __contains__(self, key: str) -> bool:
        return os.path.exists(self._meta_path(key))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self):
        pass


class _H5Dataset:
    """An ``h5py`` dataset behind the surface of the chunked datasets; no
    chunk cache (as in the reference)."""

    def __init__(self, ds):
        self._ds = ds

    shape = property(lambda self: tuple(self._ds.shape))
    dtype = property(lambda self: self._ds.dtype)
    ndim = property(lambda self: self._ds.ndim)

    @property
    def chunks(self):
        return tuple(self._ds.chunks) if self._ds.chunks else tuple(self._ds.shape)

    def __getitem__(self, bb):
        return self._ds[bb]

    def __setitem__(self, bb, value):
        self._ds[bb] = value

    def read_async(self, bb) -> Future:
        return _resolved(self._ds[bb])

    def write_async(self, bb, value) -> Future:
        self._ds[bb] = value
        return _resolved(None)

    @property
    def attrs(self):
        return dict(self._ds.attrs)

    def update_attrs(self, **kwargs):
        self._ds.attrs.update(kwargs)


class H5Container:
    """An HDF5 file through ``h5py``, imported here: the port itself imports
    without it."""

    def __init__(self, path: str, mode: str = "a"):
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"{path!r}: HDF5 containers need the h5py package, which cannot be imported "
                              "here") from e
        self.path = path
        self._f = h5py.File(path, mode)

    def create_dataset(self, key, shape, chunks, dtype, compression="gzip", exist_ok=True, fill_value=0):
        if key in self._f:
            if not exist_ok:
                raise ValueError(f"dataset {key} exists")
            ds = self._f[key]
            _check_existing(key, ds.shape, ds.dtype, shape, dtype, have_chunks=ds.chunks,
                            want_chunks=_clamp_chunks(chunks, shape))
            return _H5Dataset(ds)
        ds = self._f.create_dataset(key, shape=tuple(shape), chunks=_clamp_chunks(chunks, shape), dtype=dtype,
                                    compression=compression, fillvalue=fill_value)
        return _H5Dataset(ds)

    def require_dataset(self, key, **kwargs):
        return self.create_dataset(key, exist_ok=True, **kwargs)

    def __getitem__(self, key):
        return _H5Dataset(self._f[key])

    def __contains__(self, key):
        return key in self._f

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()
        return False

    def close(self):
        self._f.close()


class MemoryDataset:
    """A ``memory://`` dataset: a numpy array behind the dataset surface."""

    def __init__(self, arr: np.ndarray, chunks: Tuple[int, ...]):
        self._arr = arr
        self.chunks = chunks

    shape = property(lambda self: self._arr.shape)
    dtype = property(lambda self: self._arr.dtype)
    ndim = property(lambda self: self._arr.ndim)

    def __getitem__(self, bb):
        return self._arr[bb].copy()

    def __setitem__(self, bb, value):
        self._arr[bb] = np.asarray(value, dtype=self._arr.dtype)


class MemoryContainer:
    """In-memory container; one instance per path in a process-wide registry."""

    _registry: Dict[str, "MemoryContainer"] = {}
    _registry_lock = threading.Lock()

    def __init__(self, path: str = "", mode: str = "a"):
        self.path = path
        self._data: Dict[str, MemoryDataset] = {}
        self._lock = threading.Lock()

    @classmethod
    def open(cls, path: str, mode: str = "a") -> "MemoryContainer":
        with cls._registry_lock:
            if path not in cls._registry:
                cls._registry[path] = cls(path)
            return cls._registry[path]

    def create_dataset(self, key, shape, chunks, dtype, compression=None, exist_ok=True, fill_value=0):
        with self._lock:
            if key in self._data:
                if not exist_ok:
                    raise ValueError(f"dataset {key} exists")
                ds = self._data[key]
                _check_existing(key, ds.shape, ds.dtype, shape, dtype, have_chunks=ds.chunks, want_chunks=chunks)
                return ds
            ds = MemoryDataset(np.full(tuple(shape), fill_value, dtype=dtype), tuple(chunks))
            self._data[key] = ds
            return ds

    def require_dataset(self, key, **kwargs):
        return self.create_dataset(key, exist_ok=True, **kwargs)

    def __getitem__(self, key):
        return self._data[key]

    def __contains__(self, key):
        return key in self._data

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self):
        pass


class ChunkCorruptionError(RuntimeError):
    """A region's bytes no longer match the CRC32 digest taken when they
    were written (or, for a spill, when they left memory)."""

    def __init__(self, label: str, region, expected, actual):
        self.label = label
        self.region = tuple(region)
        self.expected = expected
        self.actual = actual
        super().__init__(
            f"chunk corruption in {label} region " + "x".join(f"[{a}:{b}]" for a, b in self.region)
            + f": stored digest {expected}, read digest {actual}"
        )


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _regions_overlap(r1, r2) -> bool:
    return len(r1) == len(r2) and all(a1 < b2 and a2 < b1 for (a1, b1), (a2, b2) in zip(r1, r2))


class HandoffDataset:
    """A ``memory://``-backed handoff twin of a chunked storage dataset.

    Producer tasks write blocks into host RAM through the port's dataset
    surface (``shape``, ``dtype``, ``ndim``, ``chunks``, ``__getitem__``
    returning a copy, ``__setitem__``), and consumers resolve the live
    handle through :mod:`..runtime.handoff` instead of opening the store.

    - **Integrity**: each write of a whole box records the CRC32 of the
      written bytes for that region (a partial overwrite drops the digests
      it overlaps); :meth:`verify_region` re-reads a region and checks it.
    - **Spill**: :meth:`spill` writes the array chunk by chunk through the
      real dataset's write path (``store_factory()``), reads every chunk
      back against the CRC32 of its in-memory bytes, then sends every later
      access to the stored copy and releases the RAM.  After a spill,
      storage is the single source of truth.
    """

    def __init__(self, shape, chunks, dtype, store_factory, label: str, fill_value: int = 0):
        shape = tuple(int(s) for s in shape)
        self._arr: Optional[np.ndarray] = np.full(shape, fill_value, dtype=np.dtype(dtype))
        self.chunks = _clamp_chunks(chunks, shape)
        self._digests: Dict[tuple, int] = {}
        self._lock = threading.Lock()
        self._label = label
        self._store_factory = store_factory
        self._spilled_ds = None
        self._spill_started = False
        # bytes counted into the registry's bytes_not_stored; a spill
        # reconciles them (they did reach storage)
        self.not_stored_bytes = 0

    # every accessor snapshots self._arr before branching: a concurrent
    # spill publishes the storage delegate and then drops the array, so a
    # reader holds its own reference instead of re-reading the attribute

    @property
    def shape(self):
        arr = self._arr
        return tuple(arr.shape) if arr is not None else tuple(self._spilled_ds.shape)

    @property
    def dtype(self):
        arr = self._arr
        return arr.dtype if arr is not None else self._spilled_ds.dtype

    ndim = property(lambda self: len(self.shape))

    def __getitem__(self, bb):
        arr = self._arr
        if arr is None:
            return self._spilled_ds[bb]
        return arr[bb].copy()

    def __setitem__(self, bb, value):
        arr = self._arr
        if arr is None:
            self._spilled_ds[bb] = value
            return
        value = np.asarray(value, dtype=arr.dtype)
        arr[bb] = value
        region, squeeze = _region(bb, arr.shape)
        whole = not squeeze and value.shape == tuple(b - a for a, b in region)
        with self._lock:
            for r in [r for r in self._digests if _regions_overlap(r, region)]:
                del self._digests[r]
            if whole:
                self._digests[region] = _crc(value)
            self.not_stored_bytes += int(value.nbytes)
        from ..runtime import handoff as _handoff

        _handoff.get_registry().bump("bytes_not_stored", int(value.nbytes))

    def verify_region(self, bb) -> None:
        """Check a written region against its digest; raises
        :class:`ChunkCorruptionError` on a mismatch, no-op where no digest
        was recorded (or after a spill, whose read-back already checked the
        stored bytes)."""
        arr = self._arr
        if arr is None:
            return
        region, _ = _region(bb, arr.shape)
        with self._lock:
            want = self._digests.get(region)
        if want is None:
            return
        got = _crc(arr[tuple(slice(a, b) for a, b in region)])
        if got != want:
            raise ChunkCorruptionError(self._label, region, want, got)

    def spill(self) -> int:
        """Flush to the storage spill path and delegate from now on.  Every
        chunk goes through the real dataset's write path and is read back
        against the CRC32 of its in-memory bytes before the RAM is released.
        Returns the bytes freed (0 when already spilled or spilling)."""
        with self._lock:
            if self._spill_started:
                return 0
            self._spill_started = True
        try:
            arr = self._arr
            ds = self._store_factory()
            for begin in itertools.product(*[range(0, s, c) for s, c in zip(arr.shape, self.chunks)]):
                bb = tuple(slice(b, min(b + c, s)) for b, c, s in zip(begin, self.chunks, arr.shape))
                want = _crc(arr[bb])
                ds[bb] = arr[bb]
                got = _crc(np.asarray(ds[bb], dtype=arr.dtype))
                if got != want:
                    raise ChunkCorruptionError(f"{self._label} (spill)", [(s.start, s.stop) for s in bb], want, got)
        except BaseException:
            # a half-written flush stays retriable: the next attempt
            # re-writes every region
            with self._lock:
                self._spill_started = False
            raise
        freed = int(arr.nbytes)
        # publish the delegate before dropping the array: concurrent readers
        # hold either the array (still valid bytes) or see the stored copy
        self._spilled_ds = ds
        self._arr = None
        return freed


def open_container(path: str, mode: str = "a"):
    """Open a container by extension (the reference's ``vu.file_reader``):
    zarr (``.zarr``, ``.zr``), N5 (``.n5``), HDF5 (``.h5``, ``.hdf5``,
    ``.hdf``; raises ``ImportError`` without ``h5py``) or ``memory://``."""
    if path.startswith("memory://"):
        return MemoryContainer.open(path, mode)
    lower = path.lower()
    if lower.endswith(_ZARR_EXTS + _N5_EXTS):
        return ZarrContainer(path, mode)
    if lower.endswith(_H5_EXTS):
        return H5Container(path, mode)
    raise ValueError(
        f"cannot infer container format from {path!r} (expected one of {_ZARR_EXTS + _N5_EXTS + _H5_EXTS} or "
        "memory://)"
    )
