"""Ragged paged block pool: mixed-shape block batches as one sweep call.

Port of ``cluster_tools_tpu/parallel/block_pool.py`` (numpy only, so the
code is the reference's).  A batch of blocks whose shapes differ, or a
partial final batch, packs into fixed-shape **pages**:

- the **pool** is one ``[n_pages, *page_shape]`` buffer per kernel
  argument; page 0 is the shared *fill page* (a constant), so table slots
  that no real data backs cost nothing;
- each **lane** (one block of the batch) owns a *page table* row (the
  indices of its pages in grid-row-major order) and a *valid extent* (its
  true shape).  Synthetic *padding lanes* reference only the fill page and
  are discarded after the call;
- :func:`~cluster_tools_tpu_torch.parallel.batch_shard.ragged_sweep`
  gathers each lane's pages back into a dense page-aligned tensor on the
  device, masks everything beyond the valid extent with the fill value,
  and runs the kernel over the lanes.

Uniform-shape batches that are merely *partial* (the ragged tail) use the
lane shape itself as the page, so every real lane sees exactly the bytes
per-block execution would have seen and any kernel stays bit-identical.
Mixed-shape lanes run at the batch's page-aligned shape, which is only
guaranteed bit-identical on each lane's stored region for shape-local
kernels.

Host buffers are pooled per ``(page_shape, dtype)`` and reused across
batches (checkout at :meth:`PagedBlockPool.pack`, checkin at
:meth:`RaggedBatch.release` once the bytes are on the device).  A reused
buffer can carry an earlier batch's bytes in unused slots; the device-side
valid-extent mask, not the host fill, is what makes stale pages harmless.
"""

from __future__ import annotations

import threading
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

#: default per-axis page extent — a chunk-scale tile.  Small enough that a
#: degrade-split sub-block (half a block per axis) occupies a fraction of
#: a full lane's pages, big enough that page tables stay tiny.
DEFAULT_PAGE_EXTENT = 8

#: pool capacities are rounded up to a power of two so the host buffer
#: classes (and the device arenas built from the specs) stay few: without
#: quantization every batch's page count would be a class of its own.
_MIN_POOL_PAGES = 16

#: free-list bound per (page_shape, dtype) buffer class — a sweep has at
#: most prefetch-depth batches packing concurrently.
_MAX_FREE_BUFFERS = 4


class RaggedArgSpec(NamedTuple):
    """Static description of one ragged kernel argument."""

    grid: Tuple[int, ...]        # pages per axis of the padded lane
    page_shape: Tuple[int, ...]  # fixed page tile shape
    dtype: str                   # numpy dtype name (hashable on purpose)
    fill: Any                    # mask fill value (python scalar)
    pool_pages: int              # quantized pool capacity (leading dim)

    @property
    def padded_shape(self) -> Tuple[int, ...]:
        """The dense per-lane shape the kernel runs at: grid * page."""
        return tuple(g * p for g, p in zip(self.grid, self.page_shape))

    @property
    def pages_per_lane(self) -> int:
        return int(np.prod(self.grid))


def default_page_shape(
    max_shape: Sequence[int], uniform: bool
) -> Tuple[int, ...]:
    """Page policy: uniform-shape lanes use the lane shape itself as the
    page (every real lane reconstructs to exactly its own bytes — ANY
    kernel stays bit-identical, the padding lanes being pure fill), while
    mixed-shape lanes use the chunk-scale ``DEFAULT_PAGE_EXTENT`` tile so
    small lanes occupy few pages and different batches' page grids
    coincide."""
    if uniform:
        return tuple(int(s) for s in max_shape)
    return tuple(min(int(s), DEFAULT_PAGE_EXTENT) for s in max_shape)


def _quantize_pages(n: int) -> int:
    cap = _MIN_POOL_PAGES
    while cap < n:
        cap *= 2
    return cap


class RaggedBatch:
    """One packed mixed-shape batch: per-arg pools + page tables + valid
    extents, plus the lane -> block attribution the executor carries
    through d2h cropping and the dispatch counters."""

    def __init__(self, specs, pools, tables, valids, n_lanes, width,
                 pages_in_use, owner=None, buffers=None):
        self.specs: Tuple[RaggedArgSpec, ...] = tuple(specs)
        self.pools: List[np.ndarray] = pools
        self.tables: List[np.ndarray] = tables
        self.valids: List[np.ndarray] = valids
        self.n_lanes = int(n_lanes)          # real lanes; the rest is padding
        self.width = int(width)
        self.pages_in_use = int(pages_in_use)  # real pages, fill page excluded
        self._owner = owner
        self._buffers = buffers or []

    @property
    def lanes_padded(self) -> int:
        return self.width - self.n_lanes

    @property
    def nbytes(self) -> int:
        return int(
            sum(p.nbytes for p in self.pools)
            + sum(t.nbytes for t in self.tables)
            + sum(v.nbytes for v in self.valids)
        )

    def key(self) -> tuple:
        """Everything that shapes the sweep call: width and per-arg specs."""
        return (self.width, self.specs)

    def lane_valid_shape(self, lane: int) -> Tuple[int, ...]:
        return tuple(int(v) for v in self.valids[0][lane])

    def crop(self, lane: int, leaf: np.ndarray) -> np.ndarray:
        """Crop one output leaf of ``lane`` back to the lane's valid shape.
        A leaf matching an arg's padded spatial shape is cropped to that
        arg's valid extent (arg 0 wins ties — the canonical spatial shape
        of the block); other leaves (scalars, reductions) pass through."""
        leaf = np.asarray(leaf)
        for spec, valid in zip(self.specs, self.valids):
            if tuple(leaf.shape) == spec.padded_shape:
                return leaf[
                    tuple(slice(0, int(v)) for v in valid[lane])
                ]
        return leaf

    def release(self) -> None:
        """Return the pool buffers to the owning :class:`PagedBlockPool`
        for reuse — call once the bytes are on device.  Safe to skip (the
        buffers are then simply garbage-collected with this batch)."""
        if self._owner is not None and self._buffers:
            self._owner._checkin(self._buffers)
        self._buffers = []
        self._owner = None


class PagedBlockPool:
    """Reusable host-side staging pool for ragged batches (one per sweep).

    Thread-safe: ``pack`` is called from the executor's prefetching IO
    threads, so buffer checkout/checkin is under a lock while the actual
    packing works on privately-owned buffers.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._free = {}  # (pages, page_shape, dtype) -> [ndarray, ...]
        self.packs = 0
        self.buffer_reuses = 0

    # -- buffer lifecycle --------------------------------------------------
    def _checkout(self, pages: int, page_shape: Tuple[int, ...],
                  dtype: np.dtype) -> np.ndarray:
        key = (pages, page_shape, str(dtype))
        with self._lock:
            free = self._free.get(key)
            if free:
                self.buffer_reuses += 1
                return free.pop()
        return np.empty((pages,) + page_shape, dtype)

    def _checkin(self, buffers: List[np.ndarray]) -> None:
        with self._lock:
            for buf in buffers:
                key = (buf.shape[0], tuple(buf.shape[1:]), str(buf.dtype))
                free = self._free.setdefault(key, [])
                if len(free) < _MAX_FREE_BUFFERS:
                    free.append(buf)

    # -- packing -----------------------------------------------------------
    def pack(
        self,
        lane_args: Sequence[Tuple[np.ndarray, ...]],
        width: int,
        page_shape: Optional[Sequence[int]] = None,
        fills: Optional[Sequence[Any]] = None,
    ) -> RaggedBatch:
        """Pack ``lane_args`` (one tuple of arrays per real lane; shapes
        may differ between lanes) into a ragged batch of ``width`` lanes.
        Lanes beyond ``len(lane_args)`` are synthetic padding lanes (all
        fill page, valid extent 0 — their outputs are discarded on d2h).

        Raises ValueError when the lanes cannot pack (mismatched arg
        count / rank / dtype across lanes) — the executor treats that as
        "fall back to per-block execution", never as a sweep failure.
        """
        if not lane_args:
            raise ValueError("cannot pack an empty batch")
        n_lanes = len(lane_args)
        width = int(width)
        if width < n_lanes:
            raise ValueError(f"width {width} < {n_lanes} lanes")
        n_args = len(lane_args[0])
        if any(len(la) != n_args for la in lane_args):
            raise ValueError("lanes disagree on the kernel arg count")
        lane_args = [
            tuple(np.asarray(x) for x in la) for la in lane_args
        ]
        if fills is None:
            fills = (0,) * n_args
        if len(fills) != n_args:
            raise ValueError(f"{len(fills)} fills for {n_args} args")

        specs: List[RaggedArgSpec] = []
        pools: List[np.ndarray] = []
        tables: List[np.ndarray] = []
        valids: List[np.ndarray] = []
        buffers: List[np.ndarray] = []
        pages_in_use = 0
        for a in range(n_args):
            arrs = [la[a] for la in lane_args]
            dtype = arrs[0].dtype
            if any(x.dtype != dtype for x in arrs):
                raise ValueError(
                    f"lanes disagree on the dtype of kernel arg {a}"
                )
            # rank consistency is per ARG: args may have different ranks
            # (a 3-d mask next to a 4-d affinity map) — each gets its own
            # page grid and valid-extent descriptor
            nd = arrs[0].ndim
            if any(x.ndim != nd for x in arrs):
                raise ValueError(
                    f"lanes disagree on the rank of kernel arg {a}"
                )
            shapes = [tuple(int(s) for s in x.shape) for x in arrs]
            max_shape = tuple(int(m) for m in np.max(shapes, axis=0))
            uniform = len(set(shapes)) == 1
            # uniform lanes ALWAYS use the lane shape as the page — the
            # any-kernel bit-identity guarantee for partial uniform
            # batches must hold even when the caller tuned ``page_shape``
            # for its mixed-shape batches (chunk alignment only matters
            # there); a caller page tile also only fits same-rank args
            arg_page = page_shape if (
                not uniform
                and page_shape is not None and len(page_shape) == nd
            ) else None
            page = tuple(
                int(p) for p in (arg_page or
                                 default_page_shape(max_shape, uniform))
            )
            if any(p <= 0 for p in page):
                raise ValueError(f"bad page shape {page} for rank {nd}")
            grid = tuple(
                max(1, -(-m // p)) for m, p in zip(max_shape, page)
            )
            # real pages: the tiles each lane's valid extent overlaps
            n_real = sum(
                int(np.prod([-(-s // p) for s, p in zip(shape, page)]))
                for shape in shapes
            )
            cap = _quantize_pages(1 + n_real)
            spec = RaggedArgSpec(grid, page, dtype.name, fills[a], cap)
            pool = self._checkout(cap, page, dtype)
            pool[0] = fills[a]  # the shared fill page (slot 0)
            table = np.zeros((width, spec.pages_per_lane), np.int32)
            valid = np.zeros((width, nd), np.int32)
            slot = 1
            for lane, x in enumerate(arrs):
                shape = shapes[lane]
                valid[lane] = shape
                lane_grid = [-(-s // p) for s, p in zip(shape, page)]
                for coord in np.ndindex(*lane_grid):
                    lo = tuple(c * p for c, p in zip(coord, page))
                    hi = tuple(
                        min(c + p, s) for c, p, s in zip(lo, page, shape)
                    )
                    sub = x[tuple(slice(b, e) for b, e in zip(lo, hi))]
                    if sub.shape == page:
                        pool[slot] = sub
                    else:
                        # partial page: host fill beyond the valid extent
                        # (the device mask re-asserts this — see module
                        # docstring on buffer reuse)
                        pool[slot] = fills[a]
                        pool[slot][
                            tuple(slice(0, e - b) for b, e in zip(lo, hi))
                        ] = sub
                    flat = 0
                    for c, g in zip(coord, grid):
                        flat = flat * g + c
                    table[lane, flat] = slot
                    slot += 1
            pages_in_use += slot - 1
            specs.append(spec)
            pools.append(pool)
            tables.append(table)
            valids.append(valid)
            buffers.append(pool)
        with self._lock:
            self.packs += 1
        return RaggedBatch(
            specs, pools, tables, valids, n_lanes, width,
            pages_in_use, owner=self, buffers=buffers,
        )
