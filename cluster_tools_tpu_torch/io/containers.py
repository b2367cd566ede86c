"""Chunked containers: zarr v2 in numpy and ``zlib``, and ``memory://``.

Port of ``cluster_tools_tpu/io/containers.py``.  The reference's
``ZarrContainer`` goes through ``tensorstore`` and its ``H5Container``
through ``h5py``; the machine that runs the port on the card has neither,
so the port reads and writes zarr v2 itself:

- ``.zgroup`` and ``.zarray`` JSON, chunk files ``i.j.k`` (or nested with
  ``dimension_separator`` ``/``), C order, ``fill_value`` for chunks that
  were never written, full-size edge chunks;
- compressors ``zlib`` (the reference writes ``{"id": "zlib", "level":
  1}`` for ``compression="gzip"``) and ``null``;
- region reads and writes spanning any number of chunks; every chunk file
  is written to a temporary name and moved into place with ``os.replace``,
  so concurrent readers see a whole chunk, old or new.

Files written by either package read back bit for bit in the other.
``memory://`` datasets live in a process-wide registry, as in the
reference (without its fault-injection and checksum hooks).  N5 and HDF5
are refused (ROADMAP Queue A item 6, still open).

:class:`HandoffDataset` is the in-memory twin of a chunked dataset that
the task-graph fusion layer (:mod:`..runtime.handoff`) hands from a
producer task to its consumers.  The port's stores carry no digest
sidecars (the reference's ``.ctt_checksums/`` and ``io/verified.py`` are
ROADMAP Queue A item 11), so a handoff's integrity rests on in-memory
CRC32 region digests: every region write records one, ``verify_region``
checks it, and :meth:`HandoffDataset.spill` reads every chunk it wrote back
from the store and holds it against the CRC32 of the in-memory bytes
before it releases them.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import threading
import zlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_ZARR_EXTS = (".zarr", ".zr")
_N5_EXTS = (".n5",)
_H5_EXTS = (".h5", ".hdf5", ".hdf")


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


class ZarrDataset:
    """One zarr v2 array on the local filesystem (numpy ``__getitem__`` /
    ``__setitem__`` over basic indices)."""

    def __init__(self, path: str, meta: dict):
        self.path = path
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"])
        self._disk_dtype = np.dtype(meta["dtype"])
        self.dtype = self._disk_dtype.newbyteorder("=")
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
        self.fill_value = _fill_from_json(meta.get("fill_value"), self.dtype)
        # partial-chunk writes read, modify and write a chunk
        self._rmw_lock = threading.Lock()

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _chunk_path(self, idx) -> str:
        return os.path.join(self.path, self._sep.join(str(i) for i in idx))

    def _read_chunk(self, idx) -> Optional[np.ndarray]:
        try:
            with open(self._chunk_path(idx), "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        if self._level is not None:
            raw = zlib.decompress(raw)
        n = int(np.prod(self.chunks))
        if len(raw) != n * self._disk_dtype.itemsize:
            raise ValueError(f"{self._chunk_path(idx)}: {len(raw)} bytes, expected {n * self._disk_dtype.itemsize}")
        a = np.frombuffer(raw, dtype=self._disk_dtype).reshape(self.chunks, order=self._order)
        return a.astype(self.dtype, copy=False)

    def _write_chunk(self, idx, a: np.ndarray) -> None:
        raw = np.asarray(a, dtype=self._disk_dtype).tobytes(order=self._order)
        if self._level is not None:
            raw = zlib.compress(raw, self._level)
        path = self._chunk_path(idx)
        if self._sep == "/":
            os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_write(path, raw)

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

    def __getitem__(self, bb) -> np.ndarray:
        region, squeeze = _region(bb, self.shape)
        out = np.full(tuple(hi - lo for lo, hi in region), self.fill_value, dtype=self.dtype)
        for idx, in_chunk, in_region in self._cover(region):
            chunk = self._read_chunk(idx)
            if chunk is not None:
                out[in_region] = chunk[in_chunk]
        return out.squeeze(axis=squeeze) if squeeze else out

    def __setitem__(self, bb, value) -> None:
        region, squeeze = _region(bb, self.shape)
        shape = tuple(hi - lo for lo, hi in region)
        kept = tuple(s for ax, s in enumerate(shape) if ax not in squeeze)
        value = np.broadcast_to(np.asarray(value, dtype=self.dtype), kept).reshape(shape)
        for idx, in_chunk, in_region in self._cover(region):
            # the chunk's part inside the volume (edge chunks are stored full size)
            valid = tuple(min(c, s - i * c) for i, c, s in zip(idx, self.chunks, self.shape))
            whole = all(sl.start == 0 and sl.stop == v for sl, v in zip(in_chunk, valid))
            if whole:
                chunk = np.full(self.chunks, self.fill_value, dtype=self.dtype)
                chunk[in_chunk] = value[in_region]
                self._write_chunk(idx, chunk)
                continue
            with self._rmw_lock:
                old = self._read_chunk(idx)
                chunk = np.full(self.chunks, self.fill_value, dtype=self.dtype) if old is None else old.copy()
                chunk[in_chunk] = value[in_region]
                self._write_chunk(idx, chunk)


class ZarrContainer:
    """A zarr v2 group on the local filesystem (numpy + ``zlib``)."""

    def __init__(self, path: str, mode: str = "a"):
        self.path = os.path.abspath(path)
        self.mode = mode
        self._cache: Dict[str, ZarrDataset] = {}
        self._lock = threading.Lock()
        if mode != "r":
            os.makedirs(self.path, exist_ok=True)
            marker = os.path.join(self.path, ".zgroup")
            if not os.path.exists(marker):
                _atomic_write(marker, json.dumps({"zarr_format": 2}).encode())

    def _meta_path(self, key: str) -> str:
        return os.path.join(self.path, key, ".zarray")

    def create_dataset(self, key: str, shape: Sequence[int], chunks: Sequence[int], dtype,
                       compression: Optional[str] = "gzip", exist_ok: bool = True,
                       fill_value=0) -> ZarrDataset:
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
        os.makedirs(os.path.join(self.path, key), exist_ok=True)
        _atomic_write(self._meta_path(key), json.dumps(meta).encode())
        ds = ZarrDataset(os.path.join(self.path, key), meta)
        with self._lock:
            self._cache[key] = ds
        return ds

    def require_dataset(self, key: str, **kwargs) -> ZarrDataset:
        return self.create_dataset(key, exist_ok=True, **kwargs)

    def __getitem__(self, key: str) -> ZarrDataset:
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        try:
            with open(self._meta_path(key)) as f:
                meta = json.load(f)
        except FileNotFoundError:
            raise KeyError(f"no dataset {key!r} in {self.path}") from None
        if meta.get("zarr_format") != 2:
            raise NotImplementedError(f"{self.path}/{key}: zarr_format {meta.get('zarr_format')} (only 2)")
        ds = ZarrDataset(os.path.join(self.path, key), meta)
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
    """Open a container by extension (the reference's ``vu.file_reader``)."""
    if path.startswith("memory://"):
        return MemoryContainer.open(path, mode)
    lower = path.lower()
    if lower.endswith(_ZARR_EXTS):
        return ZarrContainer(path, mode)
    if lower.endswith(_N5_EXTS) or lower.endswith(_H5_EXTS):
        raise NotImplementedError(
            f"{path!r}: N5 and HDF5 containers are not ported yet (ROADMAP Queue A item 6, "
            "still open: N5 raw/gzip, and HDF5, which needs h5py)"
        )
    raise ValueError(
        f"cannot infer container format from {path!r} (expected one of {_ZARR_EXTS} or memory://)"
    )
