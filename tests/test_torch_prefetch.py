"""The port's bounded-window read pipelines (``io/prefetch.py``) and the
executor's future-returning loads.

The eight scenarios of ``tests/test_prefetch.py``: window and order, plain
values, the executor overlapping a batch's future loads, ``async_loader``
end to end over the port's ``read_async`` (zarr and N5) and with clipped
edge blocks padded, a failed read mid-window, a failed submission, and
``None`` as an item.  Beside them: every read of a batch issued before any
is resolved (per block and sharded), a retry calling ``load_fn`` afresh,
and the prefetcher's live bound against the reference's on the same reads.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from cluster_tools_tpu.io.prefetch import BlockPrefetcher as JBlockPrefetcher
from cluster_tools_tpu_torch.io.containers import open_container
from cluster_tools_tpu_torch.io.prefetch import BlockPrefetcher, as_future, async_loader
from cluster_tools_tpu_torch.runtime.executor import BlockwiseExecutor
from cluster_tools_tpu_torch.utils.volume_utils import Blocking


def _tracked_reads(fail_on=None, delay=0.01):
    """A future-returning read of ``np.full(2, item)`` on a pool, with the
    most reads ever in flight at once."""
    in_flight, peak, lock = [], [0], threading.Lock()
    pool = ThreadPoolExecutor(4)

    def read(item):
        with lock:
            in_flight.append(item)
            peak[0] = max(peak[0], len(in_flight))

        def work():
            time.sleep(delay)
            with lock:
                in_flight.remove(item)
            if item == fail_on:
                raise OSError(f"injected read failure on {item}")
            return np.full((2,), item)

        return pool.submit(work)

    return read, peak


def test_prefetcher_order_and_window():
    read, peak = _tracked_reads()
    items = list(range(10))
    got = list(BlockPrefetcher(read, items, depth=3))
    assert [i for i, _ in got] == items
    assert all((a == i).all() for i, a in got)
    assert peak[0] <= 3


def test_prefetcher_plain_values():
    got = list(BlockPrefetcher(lambda i: np.array([i]), [1, 2, 3], depth=2))
    assert [int(a[0]) for _, a in got] == [1, 2, 3]
    assert as_future(5).result() == 5


@pytest.mark.parametrize("cls", [BlockPrefetcher, JBlockPrefetcher], ids=["port", "reference"])
def test_prefetcher_set_batch_size_rebounds_the_live_window(cls):
    """Wide batches, then single items mid-sweep: no new read is submitted
    until the window is back under ``depth * 1``; the port and the reference
    submit the same reads at the same turns."""
    submitted = []
    pre = cls(lambda i: submitted.append(i) or np.array([i]), list(range(12)), depth=2, batch_size=3)
    it = iter(pre)
    assert len(submitted) == 6
    next(it)
    assert len(submitted) == 7
    pre.set_batch_size(1)
    turns = []
    for _ in range(5):
        next(it)
        turns.append(len(submitted))
    assert turns == [7, 7, 7, 7, 8]


def test_executor_overlaps_future_loads():
    """All of a batch's read futures are in flight together: the wall stays
    far below the serialized read time."""
    read_delay = 0.15
    pool = ThreadPoolExecutor(16)
    blocking = Blocking((8, 8, 64), (8, 8, 8))
    blocks = [blocking.get_block(i) for i in range(blocking.n_blocks)]

    def load(block):
        def work():
            time.sleep(read_delay)
            return np.ones((8, 8, 8), np.float32) * block.block_id

        return (pool.submit(work),)

    outs = {}

    def store(block, out):
        outs[block.block_id] = np.asarray(out)

    ex = BlockwiseExecutor(target="local", device_batch=2)
    kernel = lambda a: a + 1.0  # noqa: E731
    ex.map_blocks(kernel, blocks, lambda b: (np.zeros((8, 8, 8), np.float32),), lambda b, o: None)
    t0 = time.perf_counter()
    ex.map_blocks(kernel, blocks, load, store)
    wall = time.perf_counter() - t0
    serial = len(blocks) * read_delay
    assert wall < 0.6 * serial, f"no overlap: wall={wall:.2f}s serial={serial:.2f}s"
    assert len(outs) == len(blocks)
    for b in blocks:
        assert (outs[b.block_id] == b.block_id + 1.0).all()


@pytest.mark.parametrize("fmt", ["zarr", "n5"])
def test_executor_read_async_loader(tmp_path, fmt):
    """Chunks -> ``read_async`` futures -> the kernel -> the store."""
    f = open_container(str(tmp_path / f"v.{fmt}"))
    shape, bshape = (16, 16, 32), (8, 8, 16)
    src = f.create_dataset("src", shape=shape, chunks=bshape, dtype="float32")
    data = np.random.default_rng(0).random(shape).astype(np.float32)
    src[...] = data
    dst = f.create_dataset("dst", shape=shape, chunks=bshape, dtype="float32")
    blocking = Blocking(shape, bshape)
    blocks = [blocking.get_block(i) for i in range(blocking.n_blocks)]

    def store(block, out):
        dst[block.bb] = np.asarray(out)

    BlockwiseExecutor(target="local", device_batch=2).map_blocks(lambda a: a * 2.0, blocks,
                                                                 async_loader(src, lambda b: b.bb), store)
    np.testing.assert_array_equal(np.asarray(dst[...]), data * 2.0)


def test_async_loader_pads_clipped_edge_blocks(tmp_path):
    f = open_container(str(tmp_path / "ragged.zarr"))
    shape, bshape = (8, 8, 20), (8, 8, 16)  # the last x-block is clipped to 4
    src = f.create_dataset("src", shape=shape, chunks=bshape, dtype="float32")
    data = np.random.default_rng(1).random(shape).astype(np.float32)
    src[...] = data
    dst = f.create_dataset("dst", shape=shape, chunks=bshape, dtype="float32")
    blocking = Blocking(shape, bshape)
    blocks = [blocking.get_block(i) for i in range(blocking.n_blocks)]

    def store(block, out):
        inner = tuple(slice(0, s.stop - s.start) for s in block.bb)
        dst[block.bb] = np.asarray(out)[inner]

    BlockwiseExecutor(target="local", device_batch=1).map_blocks(
        lambda a: a + 3.0, blocks, async_loader(src, lambda b: b.bb, pad_to=bshape), store)
    np.testing.assert_array_equal(np.asarray(dst[...]), data + 3.0)


def test_prefetcher_failed_read_does_not_abandon_window():
    read, peak = _tracked_reads(fail_on=4)
    items = list(range(10))
    it = iter(BlockPrefetcher(read, items, depth=3))
    got, failed = [], []
    while True:
        try:
            item, arr = next(it)
        except StopIteration:
            break
        except OSError:
            failed.append(4)
            continue
        got.append((item, arr))
    assert failed == [4]
    assert [i for i, _ in got] == [i for i in items if i != 4]
    assert all((a == i).all() for i, a in got)
    assert peak[0] <= 3


def test_prefetcher_submission_failure_is_per_item():
    submitted = []

    def read(item):
        submitted.append(item)
        if item == 1:
            raise ValueError("bad item")
        return np.array([item])

    it = iter(BlockPrefetcher(read, [0, 1, 2, 3], depth=2))
    assert next(it)[0] == 0
    with pytest.raises(ValueError, match="bad item"):
        next(it)
    assert [i for i, _ in it] == [2, 3]
    assert submitted == [0, 1, 2, 3]


def test_prefetcher_none_item_is_a_real_item():
    seen = []

    def read(item):
        seen.append(item)
        return np.zeros(1)

    got = list(BlockPrefetcher(read, [1, None, 2], depth=2))
    assert [i for i, _ in got] == [1, None, 2]
    assert seen == [1, None, 2]


class _Logged:
    """A future that logs when it is resolved."""

    def __init__(self, log, block):
        self._log, self._block = log, block

    def result(self):
        self._log.append(("resolve", self._block.block_id))
        return np.full(2, self._block.block_id, np.float32)


@pytest.mark.parametrize("sweep_mode,device_batch", [("per_block", 4), ("sharded", 1)])
def test_batch_reads_are_issued_before_any_is_resolved(sweep_mode, device_batch):
    """Per block (``device_batch`` blocks a batch) and sharded (8 a call):
    within a batch every ``load_fn`` call comes before the first
    ``.result()``."""
    blocking = Blocking((32,), (2,))
    blocks = [blocking.get_block(i) for i in range(blocking.n_blocks)]
    log, lock = [], threading.Lock()

    def load(block):
        with lock:
            log.append(("issue", block.block_id))
        return (_Logged(log, block),)

    out = np.zeros(32, np.float32)

    def store(block, o):
        out[block.bb] = o

    summary = BlockwiseExecutor(target="local", device_batch=device_batch, io_threads=1).map_blocks(
        lambda x: x * 2, blocks, load, store, sweep_mode=sweep_mode, schedule="given", prefetch=1)
    np.testing.assert_array_equal(out, np.repeat(np.arange(16, dtype=np.float32) * 2, 2))
    bs = summary.get("sharded_batch", device_batch)
    for start in range(0, len(blocks), bs):
        ids = set(range(start, start + bs))
        events = [e for e in log if e[1] in ids]
        kinds = [k for k, _ in events]
        assert kinds == ["issue"] * len(ids) + ["resolve"] * len(ids), (start, events)


def test_retry_calls_load_fn_again():
    """The first attempt resolves the issued futures; a failed one is
    retried by calling ``load_fn`` afresh."""
    calls = {}

    class _Failing:
        def result(self):
            raise OSError("transient read error")

    def load(block):
        calls[block.block_id] = calls.get(block.block_id, 0) + 1
        if block.block_id == 1 and calls[1] == 1:
            return (_Failing(),)
        return (np.full(2, block.block_id, np.float32),)

    blocks = [Blocking((8,), (2,)).get_block(i) for i in range(4)]
    out = np.zeros(8, np.float32)

    def store(block, o):
        out[block.bb] = o

    BlockwiseExecutor(target="local", backoff_base=0.0).map_blocks(lambda x: x, blocks, load, store,
                                                                   sweep_mode="per_block")
    assert calls == {0: 1, 1: 2, 2: 1, 3: 1}
    np.testing.assert_array_equal(out, np.repeat(np.arange(4, dtype=np.float32), 2))
