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
reference.

Data integrity, as in the reference: every stored region gets a CRC32
digest *sidecar*, one JSON file a region under ``<dataset>/.ctt_checksums/``
for zarr and N5 (the reference's bytes, so either package verifies the
other's stores) and in memory for ``memory://`` and handoffs, written
after the data lands; a write that overlaps a recorded region drops its
stale digest.  Every read goes through the verifying reader
(:func:`..io.verified.postread`): a region with a digest is checked, a
mismatch evicts the cached chunks and asks lineage repair
(:mod:`..runtime.repair`) to recompute the block, and a product store
without a sidecar falls under the missing-sidecar policy.  The fault
injector's ``io_read``/``io_write`` sites (errors, hangs, bit flips and
sidecar loss) sit in every read and write, the async ones included: they
fire at issue, and ``read_async``/``write_async`` verify and record on
``.result()``.  ``CTT_CHECKSUMS=0`` turns the sidecars off.  HDF5 has no
sidecars (one shared file has no place for them) and no ``verify_region``.
The label of a ``memory://`` dataset is ``memory://<path>:<key>`` where
the reference's is ``memory://`` for all of them, so lineage repair keys
two memory stores apart.

:class:`HandoffDataset` is the in-memory twin of a chunked dataset that
the task-graph fusion layer (:mod:`..runtime.handoff`) hands from a
producer task to its consumers, with in-memory digests (read site
``handoff``); its spill writes through the real dataset, which records a
sidecar a region and is verified back (read site ``spill``).
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
# async completion hooks (verify, record the digest) map the futures
from .prefetch import _MappedFuture as _WrappedFuture

_ZARR_EXTS = (".zarr", ".zr")
_N5_EXTS = (".n5",)
_H5_EXTS = (".h5", ".hdf5", ".hdf")
# the data types N5 knows, by the numpy names it uses
_N5_DTYPES = ("uint8", "uint16", "uint32", "uint64", "int8", "int16", "int32", "int64", "float32", "float64")
# the keys of an N5 dataset's attributes.json that are its metadata
_N5_META_KEYS = ("dimensions", "blockSize", "dataType", "compression")


_faults_mod = None


def _faults():
    global _faults_mod
    if _faults_mod is None:
        from ..runtime import faults as _fm

        _faults_mod = _fm
    return _faults_mod


def _inject(site: str, voxels: Optional[int] = None) -> Optional[int]:
    """The fault injector's ``io_read``/``io_write`` hook: a no-op unless an
    injector is configured.  The block id comes from the executor's
    thread-local :func:`~..runtime.faults.block_context` and is returned so
    an async completion reuses it; ``voxels`` (the write's element count)
    feeds the ``min_voxels`` gate of resource faults."""
    fm = _faults()
    block_id = fm.current_block_id()
    fm.get_injector().maybe_fail(site, block_id, voxels=voxels)
    return block_id


def _hang(site: str, block_id: Optional[int]) -> None:
    _faults().get_injector().maybe_hang(site, block_id)


def checksums_enabled() -> bool:
    """Digest sidecars on stored regions (default on); ``CTT_CHECKSUMS=0``
    turns them off."""
    return os.environ.get("CTT_CHECKSUMS", "1").lower() not in ("0", "false", "off")


class ChunkCorruptionError(RuntimeError):
    """A stored region's bytes no longer match its digest sidecar."""

    def __init__(self, label: str, region, expected, actual):
        self.label = label
        self.region = tuple(region)
        self.expected = expected
        self.actual = actual
        super().__init__(
            f"chunk corruption in {label} region " + "x".join(f"[{a}:{b}]" for a, b in self.region)
            + f": stored digest {expected}, read digest {actual}"
        )


def _norm_region(bb, shape) -> Optional[Tuple[Tuple[int, int], ...]]:
    """``((start, stop), ...)`` of a box of step-1 slices (an Ellipsis
    allowed), or None for any other index: an integer or fancy index has no
    region identity to checksum."""
    if bb is Ellipsis:
        return tuple((0, int(s)) for s in shape)
    if isinstance(bb, slice):
        bb = (bb,)
    if not isinstance(bb, tuple):
        return None
    if any(b is Ellipsis for b in bb):
        i = next(j for j, b in enumerate(bb) if b is Ellipsis)
        bb = bb[:i] + (slice(None),) * (len(shape) - len(bb) + 1) + bb[i + 1:]
    if len(bb) < len(shape):
        bb = bb + (slice(None),) * (len(shape) - len(bb))
    if len(bb) != len(shape):
        return None
    out = []
    for sl, n in zip(bb, shape):
        if not isinstance(sl, slice) or sl.step not in (None, 1):
            return None
        start, stop, _ = sl.indices(int(n))
        out.append((int(start), max(int(start), int(stop))))
    return tuple(out)


def _region_shape(region) -> Tuple[int, ...]:
    return tuple(b - a for a, b in region)


def _regions_overlap(r1, r2) -> bool:
    return len(r1) == len(r2) and all(a1 < b2 and a2 < b1 for (a1, b1), (a2, b2) in zip(r1, r2))


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


class _ChecksumIndex:
    """Digest sidecars: one JSON file a region under ``<dataset>/.ctt_checksums/``
    (``r_<a>-<b>_...json``, holding ``algo``, ``crc``, ``dtype`` and ``shape``)
    or a dict in memory (``dirpath`` None).  The set of on-disk regions is
    seeded by one ``listdir`` at the first write and kept up to date after,
    so the overlap scan of a write walks a set, not the directory."""

    def __init__(self, dirpath: Optional[str] = None):
        self._dir = dirpath
        self._mem: Optional[Dict] = {} if dirpath is None else None
        self._fs_keys: Optional[set] = None
        self._lock = threading.Lock()

    def _known_regions(self) -> set:
        """The regions with an on-disk sidecar (call under ``_lock``)."""
        if self._fs_keys is None:
            keys = set()
            if self._dir is not None and os.path.isdir(self._dir):
                for fname in os.listdir(self._dir):
                    r = self._parse(fname)
                    if r is not None:
                        keys.add(r)
            self._fs_keys = keys
        return self._fs_keys

    @staticmethod
    def _key(region) -> str:
        return "r_" + "_".join(f"{a}-{b}" for a, b in region)

    @staticmethod
    def _parse(name: str):
        if not (name.startswith("r_") and name.endswith(".json")):
            return None
        try:
            return tuple((int(p.split("-")[0]), int(p.split("-")[1])) for p in name[2:-len(".json")].split("_"))
        except (ValueError, IndexError):
            return None

    def record(self, region, value: np.ndarray) -> None:
        entry = {"algo": "crc32", "crc": _crc(value), "dtype": value.dtype.str, "shape": list(value.shape)}
        self.invalidate_overlaps(region)
        if self._mem is not None:
            with self._lock:
                self._mem[region] = entry
            return
        os.makedirs(self._dir, exist_ok=True)
        path = os.path.join(self._dir, self._key(region) + ".json")
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(entry, f)
        os.replace(tmp, path)
        with self._lock:
            self._known_regions().add(region)

    def lookup(self, region) -> Optional[Dict]:
        if self._mem is not None:
            with self._lock:
                return self._mem.get(region)
        try:
            with open(os.path.join(self._dir, self._key(region) + ".json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def invalidate_overlaps(self, region) -> None:
        """Drop the digests of regions that ``region`` overlaps: a partial
        overwrite makes them stale."""
        if self._mem is not None:
            with self._lock:
                for r in [r for r in self._mem if _regions_overlap(r, region)]:
                    del self._mem[r]
            return
        with self._lock:
            known = self._known_regions()
            hits = [r for r in known if _regions_overlap(r, region)]
            for r in hits:
                known.discard(r)
        for r in hits:
            try:
                os.unlink(os.path.join(self._dir, self._key(r) + ".json"))
            except OSError:
                pass

    def drop(self, region) -> None:
        """Delete one region's sidecar (the injected sidecar loss)."""
        if self._mem is not None:
            with self._lock:
                self._mem.pop(region, None)
            return
        with self._lock:
            self._known_regions().discard(region)
        try:
            os.unlink(os.path.join(self._dir, self._key(region) + ".json"))
        except OSError:
            pass

    def regions(self) -> list:
        """Every region with a sidecar; on disk, from the directory, so
        sidecars other handles wrote count."""
        if self._mem is not None:
            with self._lock:
                return list(self._mem)
        out = []
        if self._dir is not None and os.path.isdir(self._dir):
            for fname in os.listdir(self._dir):
                r = self._parse(fname)
                if r is not None:
                    out.append(r)
        return out


def _flip_first_byte(value) -> np.ndarray:
    bad = np.ascontiguousarray(value).copy()
    if bad.size and bad.dtype.itemsize:
        bad.reshape(-1).view(np.uint8)[0] ^= 0x01
    return bad


class _ChecksumOps:
    """The digest behaviour of a dataset: subclasses give ``_read_back(bb)``
    (a raw read past cache and hooks), ``_write_raw(bb, value)`` (a raw
    write, no sidecar), ``shape``, ``_checksums`` and ``_label``."""

    #: the read site of typed ``corrupt:<site>`` errors (io/verified.py):
    #: "storage", "memory", "handoff", or "spill" for a handoff's spilled copy
    _read_site = "storage"

    def _after_write(self, bb, value: np.ndarray, block_id) -> None:
        """Record the region's digest, then any injected silent corruption:
        a flipped stored byte, or (``mode='sidecar'``) the fresh sidecar
        deleted."""
        region = _norm_region(bb, self.shape)
        if region is not None and checksums_enabled():
            if value.shape == _region_shape(region):
                self._checksums.record(region, value)
            else:
                # a broadcast fill has no digest, but any earlier one is stale
                self._checksums.invalidate_overlaps(region)
        elif region is None:
            # an integer or fancy index records no digest either; the
            # digests its box overlaps (all of them, for a fancy index) are
            # stale.  The reference keeps them; the port drops them, so a
            # later whole-region read does not raise a false corruption
            try:
                box, _ = _region(bb, self.shape)
            except (IndexError, TypeError, ValueError):
                box = tuple((0, int(n)) for n in self.shape)
            self._checksums.invalidate_overlaps(box)
        mode = _faults().get_injector().chunk_corrupt("io_write", block_id)
        if mode == "sidecar":
            if region is not None:
                self._checksums.drop(region)
        elif mode:
            self._write_raw(bb, _flip_first_byte(value))

    def _apply_read_rot(self, bb, block_id) -> None:
        """Injected at-rest damage at the read site: one stored byte of the
        region flipped (sidecar untouched), or its sidecar deleted."""
        mode = _faults().get_injector().chunk_corrupt("io_read", block_id)
        if not mode:
            return
        region = _norm_region(bb, self.shape)
        if region is None:
            return
        if mode == "sidecar":
            self._checksums.drop(region)
            return
        raw = np.asarray(self._read_back(bb))
        if raw.size and raw.dtype.itemsize:
            # _write_raw evicts the cached chunks: the rot lives on storage
            self._write_raw(bb, _flip_first_byte(raw))

    def _postread(self, bb, arr: np.ndarray, evict=None) -> np.ndarray:
        """The verifying reader's tail of every read (:func:`..io.verified.postread`)."""
        from . import verified as _verified

        return _verified.postread(self, bb, arr, evict=evict)

    def _verify_read(self, bb, arr: np.ndarray) -> None:
        if not checksums_enabled():
            return
        region = _norm_region(bb, self.shape)
        if region is None:
            return
        entry = self._checksums.lookup(region)
        if entry is None:
            return
        if list(entry.get("shape", [])) != list(arr.shape) or entry.get("dtype") != arr.dtype.str:
            return  # a stale sidecar (shape or dtype drifted) verifies nothing
        actual = _crc(arr)
        if actual != entry.get("crc"):
            raise ChunkCorruptionError(self._label, region, entry.get("crc"), actual)

    def verify_region(self, bb) -> None:
        """Read a stored region back past the cache and check it against its
        sidecar; raises :class:`ChunkCorruptionError` on a mismatch, no-op
        without a sidecar."""
        if not checksums_enabled():
            return
        region = _norm_region(bb, self.shape)
        if region is None or self._checksums.lookup(region) is None:
            return
        self._verify_read(bb, np.asarray(self._read_back(bb)))

    def checksum_regions(self) -> list:
        """Every region with a digest sidecar."""
        return self._checksums.regions()

    def checksum_entry(self, bb) -> Optional[Dict]:
        """The sidecar entry of ``bb``'s exact region, or None."""
        region = _norm_region(bb, self.shape)
        return None if region is None else self._checksums.lookup(region)


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

#: threads of a handoff dataset's spill: a request's flush writes 1 GiB of
#: labels through zlib and the digest's verify read, both off the GIL
SPILL_THREADS = 8
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


class _ChunkedDataset(_ChecksumOps):
    """A chunked array on the local filesystem with numpy ``__getitem__`` /
    ``__setitem__`` over basic indices, reads assembled through the chunk
    cache, digest sidecars under ``<path>/.ctt_checksums/``.  Subclasses
    read and write one chunk, clipped to the volume (:meth:`_load_chunk`,
    :meth:`_store_chunk`)."""

    def __init__(self, path: str, shape, chunks, dtype, fill_value, attrs_path: str, label: str = ""):
        self.path = path
        self._checksums = _ChecksumIndex(os.path.join(path, ".ctt_checksums"))
        self._label = label or path
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
        skipped and that error is raised.  One ``chunk_cache.assemble`` span
        a read (its hit/miss/wait composition in the args while tracing),
        a ``chunk_cache.wait`` span around each wait on another reader."""
        from ..runtime import trace as trace_mod

        cache = _chunk_cache.get_chunk_cache()
        if trace_mod.enabled():
            n_hits = sum(1 for step in plan.steps if step[2] == cache.HIT)
            n_waits = sum(1 for step in plan.steps if step[2] == cache.WAIT)
            assemble_span = trace_mod.span("chunk_cache.assemble", n_chunks=len(plan.steps), hits=n_hits,
                                           misses=len(plan.steps) - n_hits - n_waits, waits=n_waits)
        else:
            assemble_span = trace_mod.span("chunk_cache.assemble")
        with assemble_span:
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
                        if kind == cache.WAIT:
                            with trace_mod.span("chunk_cache.wait"):
                                chunk = cache.wait(handle, timeout=patience)
                        else:
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

    def _evict_plan(self, plan: _CachedReadPlan) -> None:
        _chunk_cache.get_chunk_cache().invalidate([key for key, _b, _k, _h in plan.steps])

    def _invalidate_cached_region(self, region) -> None:
        """Evict every cached chunk ``region`` overlaps and doom their
        in-flight loads, even with the kill switch on: entries cached while
        it was off must not outlive a write."""
        _chunk_cache.get_chunk_cache().invalidate([key for key, _box in self._chunk_cover(region)])

    def _read_back(self, bb) -> np.ndarray:
        """``bb`` from storage past the cache: what ``verify_region`` and
        lineage repair must check."""
        region, squeeze = _region(bb, self.shape)
        out = self._read_direct(region)
        return out.squeeze(axis=squeeze) if squeeze else out

    def _read(self, bb):
        """``(array, cache plan or None)`` of ``bb``, no hooks."""
        region, squeeze = _region(bb, self.shape)
        plan = self._begin_cached_read(bb)
        if plan is None:
            out = self._read_direct(region)
            _chunk_cache.get_chunk_cache().record_direct(out.nbytes)
        else:
            out = self._finish_cached_read(plan)
        return (out.squeeze(axis=squeeze) if squeeze else out), plan

    def _verified(self, bb, read) -> np.ndarray:
        out, plan = read
        # a failed digest check must not leave the bad chunks resident
        return self._postread(bb, out, evict=None if plan is None else (lambda: self._evict_plan(plan)))

    def __getitem__(self, bb) -> np.ndarray:
        bid = _inject("io_read")
        _hang("io_read", bid)
        self._apply_read_rot(bb, bid)
        return self._verified(bb, self._read(bb))

    def read_async(self, bb):
        """A future of ``self[bb]``: the fault hooks fire here, the read runs
        on the I/O pool, and ``.result()`` verifies it."""
        bid = _inject("io_read")
        self._apply_read_rot(bb, bid)

        def finish(read):
            _hang("io_read", bid)
            return self._verified(bb, read)

        return _WrappedFuture(_submit(self._read, bb), finish)

    # -- writes ------------------------------------------------------------
    def _write_raw(self, bb, value) -> None:
        """Write ``value`` to the chunks of ``bb``: no hooks, no sidecar."""
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

    def __setitem__(self, bb, value) -> None:
        bid = _inject("io_write", voxels=getattr(value, "size", None))
        _hang("io_write", bid)
        value = np.asarray(value, dtype=self.dtype)
        self._write_raw(bb, value)
        self._after_write(bb, value, bid)

    def write_async(self, bb, value):
        """A future of ``self[bb] = value``: the fault hook fires here, the
        write runs on the I/O pool from a copy of ``value``, and
        ``.result()`` records the region's sidecar."""
        bid = _inject("io_write", voxels=getattr(value, "size", None))
        value = np.array(value, dtype=self.dtype)

        def finish(_):
            _hang("io_write", bid)
            self._after_write(bb, value, bid)

        return _WrappedFuture(_submit(self._write_raw, bb, value), finish)

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

    def __init__(self, path: str, meta: dict, label: str = ""):
        disk_dtype = np.dtype(meta["dtype"])
        dtype = disk_dtype.newbyteorder("=")
        super().__init__(path, meta["shape"], meta["chunks"], dtype, _fill_from_json(meta.get("fill_value"), dtype),
                         os.path.join(path, ".zattrs"), label)
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

    def __init__(self, path: str, attrs: dict, label: str = ""):
        if attrs.get("dataType") not in _N5_DTYPES:
            raise NotImplementedError(f"{path}: N5 dataType {attrs.get('dataType')!r}")
        dtype = np.dtype(attrs["dataType"])
        super().__init__(path, attrs["dimensions"][::-1], attrs["blockSize"][::-1], dtype, dtype.type(0),
                         os.path.join(path, "attributes.json"), label)
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
        # the reference's label: the container's path and the key
        path, label = os.path.join(self.path, key), f"{self.path}:{key}"
        return N5Dataset(path, meta, label) if self.is_n5 else ZarrDataset(path, meta, label)

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
    chunk cache and no digest sidecars, so no ``verify_region`` (as in the
    reference); the fault hooks fire as on every dataset."""

    def __init__(self, ds):
        self._ds = ds

    shape = property(lambda self: tuple(self._ds.shape))
    dtype = property(lambda self: self._ds.dtype)
    ndim = property(lambda self: self._ds.ndim)

    @property
    def chunks(self):
        return tuple(self._ds.chunks) if self._ds.chunks else tuple(self._ds.shape)

    def __getitem__(self, bb):
        bid = _inject("io_read")
        _hang("io_read", bid)
        return self._ds[bb]

    def __setitem__(self, bb, value):
        bid = _inject("io_write", voxels=getattr(value, "size", None))
        _hang("io_write", bid)
        self._ds[bb] = value

    def read_async(self, bb) -> Future:
        return _resolved(self[bb])

    def write_async(self, bb, value) -> Future:
        self[bb] = value
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


class MemoryDataset(_ChecksumOps):
    """A ``memory://`` dataset: a numpy array behind the dataset surface,
    its digests in memory (read site ``memory``)."""

    _read_site = "memory"

    def __init__(self, arr: np.ndarray, chunks: Tuple[int, ...], label: str = "memory://"):
        self._arr = arr
        self.chunks = chunks
        self._checksums = _ChecksumIndex(None)
        self._label = label
        self._attrs: Dict = {}

    shape = property(lambda self: self._arr.shape)
    dtype = property(lambda self: self._arr.dtype)
    ndim = property(lambda self: self._arr.ndim)

    def _read_back(self, bb):
        return self._arr[bb].copy()

    def _write_raw(self, bb, value):
        self._arr[bb] = value

    def __getitem__(self, bb):
        bid = _inject("io_read")
        _hang("io_read", bid)
        self._apply_read_rot(bb, bid)
        return self._postread(bb, self._arr[bb].copy())

    def __setitem__(self, bb, value):
        bid = _inject("io_write", voxels=getattr(value, "size", None))
        _hang("io_write", bid)
        value = np.asarray(value, dtype=self._arr.dtype)
        self._arr[bb] = value
        self._after_write(bb, value, bid)

    def read_async(self, bb) -> Future:
        return _resolved(self[bb])

    def write_async(self, bb, value) -> Future:
        self[bb] = value
        return _resolved(None)

    @property
    def attrs(self) -> Dict:
        return dict(self._attrs)

    def update_attrs(self, **kwargs) -> None:
        self._attrs.update(kwargs)


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
            ds = MemoryDataset(np.full(tuple(shape), fill_value, dtype=dtype), tuple(chunks), f"{self.path}:{key}")
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


class HandoffDataset(_ChecksumOps):
    """A ``memory://``-backed handoff twin of a chunked storage dataset.

    Producer tasks write blocks into host RAM through the port's dataset
    surface (``shape``, ``dtype``, ``ndim``, ``chunks``, ``__getitem__``
    returning a copy, ``__setitem__``), and consumers resolve the live
    handle through :mod:`..runtime.handoff` instead of opening the store.

    - **Fault hooks**: every read and write carries the ``io_read`` /
      ``io_write`` injection and hang hooks, as on storage.
    - **Integrity**: writes record in-memory CRC32 region digests (read site
      ``handoff``); :meth:`verify_region` and the executor's
      ``region_verifier`` check them, injected corruption included.
    - **Spill**: :meth:`spill` writes the array chunk by chunk through the
      real dataset's write path (``store_factory()``; a sidecar a region),
      verifies every region back, then sends every later access to the
      stored copy (read site ``spill``) and releases the RAM.  After a
      spill, storage is the single source of truth.
    """

    _read_site = "handoff"

    def __init__(self, shape, chunks, dtype, store_factory, label: str, fill_value: int = 0):
        shape = tuple(int(s) for s in shape)
        self._arr: Optional[np.ndarray] = np.full(shape, fill_value, dtype=np.dtype(dtype))
        self.chunks = _clamp_chunks(chunks, shape)
        self._checksums = _ChecksumIndex(None)
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

    def _read_back(self, bb):
        arr = self._arr
        return self._spilled_ds._read_back(bb) if arr is None else arr[bb].copy()

    def _write_raw(self, bb, value):
        arr = self._arr
        if arr is None:
            self._spilled_ds._write_raw(bb, value)
        else:
            arr[bb] = value

    def __getitem__(self, bb):
        arr = self._arr
        if arr is None:
            return self._spilled_ds[bb]
        bid = _inject("io_read")
        _hang("io_read", bid)
        self._apply_read_rot(bb, bid)
        return self._postread(bb, arr[bb].copy())

    def __setitem__(self, bb, value):
        arr = self._arr
        if arr is None:
            self._spilled_ds[bb] = value
            return
        bid = _inject("io_write", voxels=getattr(value, "size", None))
        _hang("io_write", bid)
        value = np.asarray(value, dtype=arr.dtype)
        arr[bb] = value
        self._after_write(bb, value, bid)
        with self._lock:
            self.not_stored_bytes += int(value.nbytes)
        from ..runtime import handoff as _handoff

        _handoff.get_registry().bump("bytes_not_stored", int(value.nbytes))

    def read_async(self, bb) -> Future:
        arr = self._arr
        if arr is None:
            return self._spilled_ds.read_async(bb)
        return _resolved(self[bb])

    def write_async(self, bb, value) -> Future:
        arr = self._arr
        if arr is None:
            return self._spilled_ds.write_async(bb, value)
        self[bb] = value
        return _resolved(None)

    def verify_region(self, bb) -> None:
        if self._arr is None:
            verify = getattr(self._spilled_ds, "verify_region", None)
            if verify is not None:
                verify(bb)
            return
        super().verify_region(bb)

    def spill(self) -> int:
        """Flush to the storage spill path and delegate from now on.  Every
        chunk goes through the real dataset's write path (a digest sidecar a
        region) and is verified back before the RAM is released.  The
        regions are independent chunks, written and verified on up to
        ``SPILL_THREADS`` threads (the reference writes them one by one).
        Returns the bytes freed (0 when already spilled or spilling)."""
        with self._lock:
            if self._spill_started:
                return 0
            self._spill_started = True
        try:
            arr = self._arr
            ds = self._store_factory()
            verify = getattr(ds, "verify_region", None)
            regions = [tuple(slice(b, min(b + c, s)) for b, c, s in zip(begin, self.chunks, arr.shape))
                       for begin in itertools.product(*[range(0, s, c) for s, c in zip(arr.shape, self.chunks)])]

            def put(bb):
                ds[bb] = arr[bb]
                if verify is not None:
                    verify(bb)

            with ThreadPoolExecutor(max_workers=max(1, min(SPILL_THREADS, len(regions)))) as pool:
                list(pool.map(put, regions))
        except BaseException:
            # a half-written flush stays retriable: the next attempt
            # re-writes every region
            with self._lock:
                self._spill_started = False
            raise
        freed = int(arr.nbytes)
        # the spilled copy keeps the handoff's product identity: its reads
        # carry the "spill" site, and the producer's sidecar policy travels
        ds._read_site = "spill"
        pol = getattr(self, "_product_policy", None)
        if pol is not None:
            ds._product_policy = pol
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
