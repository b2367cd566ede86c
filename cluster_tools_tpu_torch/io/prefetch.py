"""Bounded-window read pipelines over futures.

Port of ``cluster_tools_tpu/io/prefetch.py``.  The reference's reads are
tensorstore futures; the port's are ``concurrent.futures.Future`` objects
from the containers' I/O pool (``read_async``), so a batch's chunk reads
are in flight together instead of one block after another.

Use :class:`BlockPrefetcher` to iterate items with a bounded window of
reads in flight, or :func:`async_loader` to build a future-returning
``load_fn`` for ``BlockwiseExecutor.map_blocks``, which issues every read
of a batch before it resolves any.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterator, Sequence, Tuple

import numpy as np


class _Resolved:
    """A future-like wrapper of a value that is already there."""

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


def as_future(value):
    """``value`` if it has ``.result()``, else a wrapper that returns it."""
    return value if hasattr(value, "result") else _Resolved(value)


class _FailedFuture:
    """A read whose submission raised: the error surfaces at that item's
    turn, so one bad item cannot take down the reads in flight behind it."""

    def __init__(self, exc: BaseException):
        self._exc = exc

    def result(self):
        raise self._exc


class BlockPrefetcher:
    """Iterate ``(item, array)`` with at most ``depth * batch_size`` reads in
    flight, in submission order.

    ``read_fn(item)`` returns an array or a future-like object with
    ``.result()`` (``read_async``).  A consumer that drains whole batches
    sets ``batch_size`` so the window holds ``depth`` batches; when its
    batch size changes mid-sweep, :meth:`set_batch_size` re-bounds the
    window at once (reads in flight drain, and no new read is submitted
    until the window is back under the new bound).

    A read that raises, at submission or at resolution, raises from
    ``__next__`` for its item only: the iterator is an object, not a
    generator (which the raise would close), so a consumer that catches the
    error goes on receiving the remaining items within the same bound.
    ``None`` is an item like any other.
    """

    def __init__(self, read_fn: Callable, items: Sequence, depth: int = 2, batch_size: int = 1):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        if batch_size < 1:
            raise ValueError("prefetch batch_size must be >= 1")
        self._read_fn = read_fn
        self._items = list(items)
        self._depth = depth
        self._batch_size = int(batch_size)

    def set_batch_size(self, batch_size: int) -> None:
        """Re-bound the window of this and every live iterator to ``depth *
        batch_size``."""
        if batch_size < 1:
            raise ValueError("prefetch batch_size must be >= 1")
        self._batch_size = int(batch_size)

    @property
    def window_bound(self) -> int:
        return self._depth * self._batch_size

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[Tuple[object, np.ndarray]]:
        return _PrefetchIterator(self)


class _PrefetchIterator:
    """One pass of a :class:`BlockPrefetcher`; the window bound is read from
    its owner at every refill."""

    def __init__(self, prefetcher: BlockPrefetcher):
        self._owner = prefetcher
        self._read_fn = prefetcher._read_fn
        self._it = iter(prefetcher._items)
        self._window: deque = deque()
        self._fill()

    def _submit_one(self) -> bool:
        try:
            item = next(self._it)
        except StopIteration:
            return False
        try:
            fut = as_future(self._read_fn(item))
        except Exception as e:
            fut = _FailedFuture(e)
        self._window.append((item, fut))
        return True

    def _fill(self) -> None:
        while len(self._window) < self._owner.window_bound and self._submit_one():
            pass

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[object, np.ndarray]:
        if not self._window and not self._submit_one():
            raise StopIteration
        item, fut = self._window.popleft()
        try:
            arr = np.asarray(fut.result())
        finally:
            # refill after the head resolves, also when it failed: its slot
            # refills and the bound holds
            self._fill()
        return item, arr


class _MappedFuture:
    """A future whose result is transformed on resolution (padding)."""

    def __init__(self, fut, fn):
        self._fut = fut
        self._fn = fn

    def result(self):
        return self._fn(self._fut.result())


def async_loader(dataset, bb_fn: Callable, *more: Tuple, pad_to=None, pad_mode: str = "edge") -> Callable:
    """A future-returning ``load_fn`` for ``BlockwiseExecutor.map_blocks``.

    ``bb_fn(block)`` is the box to read from ``dataset``; each extra
    ``(dataset_i, bb_fn_i)`` pair adds an input.  Every read is issued with
    ``read_async``; ``pad_to`` (one outer shape) pads each block when it
    resolves, as the executor stacks a batch into one array.
    """
    streams = ((dataset, bb_fn),) + tuple(more)

    def load(block):
        futs = tuple(ds.read_async(fn(block)) for ds, fn in streams)
        if pad_to is None:
            return futs
        from ..utils.volume_utils import pad_block_to

        return tuple(_MappedFuture(f, lambda a: pad_block_to(np.asarray(a), pad_to, mode=pad_mode)) for f in futs)

    return load
