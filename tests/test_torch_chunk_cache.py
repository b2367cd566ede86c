"""The port's chunk cache (``cluster_tools_tpu_torch/io/chunk_cache.py``) and
the cache-assembled reads of its zarr and N5 datasets.

The scenarios of ``tests/test_chunk_cache.py``, each on the port's zarr and
on its N5: halo'd region reads assembled from cached chunks (sync and
async), bit for bit the stored data, with the reference's counters for the
same reads; single flight; a dropped ``read_async`` future; the stall
fallback; eviction on write, ``write_async`` and a dropped ``write_async``;
failing fast past a failed chunk; a recreated dataset; the kill switch; the
LRU's byte budget; the per-task counters in ``io_metrics.json``; and the
Morton and given sweep orders.  Beside them: a write racing an in-flight
load, the partial-chunk read-modify-write, a handoff spill through the
store, and the executor's in-flight budget less the cache's.
"""

import json
import shutil
import threading
import time

import numpy as np
import pytest

from cluster_tools_tpu.io import chunk_cache as j_chunk_cache
from cluster_tools_tpu.io.containers import open_container as j_open
from cluster_tools_tpu_torch.io import chunk_cache
from cluster_tools_tpu_torch.io.containers import HandoffDataset, open_container
from cluster_tools_tpu_torch.runtime import executor as pex
from cluster_tools_tpu_torch.runtime.task import BaseTask, build
from cluster_tools_tpu_torch.utils import function_utils as fu
from cluster_tools_tpu_torch.utils.volume_utils import Blocking

FORMATS = ("zarr", "n5")


@pytest.fixture
def fresh_cache():
    """A fresh cache of 64 MiB for one test; the default one after it."""
    cache = chunk_cache.configure(max_bytes=64 << 20)
    yield cache
    chunk_cache.configure()


def _dataset(tmp_path, fmt="zarr", key="x", shape=(32, 32, 32), chunks=(8, 8, 8), dtype="float32", seed=0,
             opener=open_container):
    f = opener(str(tmp_path / f"c.{fmt}"))
    ds = f.create_dataset(key, shape=shape, chunks=chunks, dtype=dtype)
    data = np.random.default_rng(seed).random(shape).astype(dtype)
    ds[...] = data
    return ds, data


# -- assembly and the counters ------------------------------------------------


def _halo_reads(ds, data, snapshot, delta):
    """Reference :52's reads; the counter deltas of the enclosing read and
    of its repeat."""
    np.testing.assert_array_equal(ds[0:16, 0:16, 0:16], data[0:16, 0:16, 0:16])
    s0 = snapshot()
    b = np.asarray(ds[0:24, 0:24, 0:24])
    np.testing.assert_array_equal(b, data[0:24, 0:24, 0:24])
    d0 = delta(s0)
    s1 = snapshot()
    np.testing.assert_array_equal(ds[0:24, 0:24, 0:24], b)
    return d0, delta(s1), b.nbytes


@pytest.mark.parametrize("fmt", FORMATS)
def test_halo_reads_assemble_from_cache(tmp_path, fresh_cache, fmt):
    """Reference :52: the enclosing halo'd read covers 27 chunks, of which
    the 8 resident ones hit; its repeat is all hits and no storage byte.
    The reference's cache counts the same reads of its own file alike."""
    ds, data = _dataset(tmp_path, fmt)
    d, d_repeat, nbytes = _halo_reads(ds, data, chunk_cache.snapshot, chunk_cache.delta)
    assert d["hits"] == 8 and d["misses"] == 19 and d["direct_reads"] == 0
    assert d_repeat["misses"] == 0 and d_repeat["hits"] == 27
    assert d_repeat["bytes_from_storage"] == 0 and d_repeat["bytes_served"] == nbytes
    j_chunk_cache.configure(max_bytes=64 << 20)
    try:
        jds, jdata = _dataset(tmp_path / "ref", fmt, opener=j_open)
        jd, jd_repeat, _ = _halo_reads(jds, jdata, j_chunk_cache.snapshot, j_chunk_cache.delta)
        assert (jd, jd_repeat) == (d, d_repeat)
    finally:
        j_chunk_cache.configure()


@pytest.mark.parametrize("fmt", FORMATS)
def test_read_async_goes_through_cache(tmp_path, fresh_cache, fmt):
    ds, data = _dataset(tmp_path, fmt)
    np.testing.assert_array_equal(ds.read_async((slice(0, 16),) * 3).result(), data[0:16, 0:16, 0:16])
    s0 = chunk_cache.snapshot()
    np.testing.assert_array_equal(ds.read_async((slice(0, 16),) * 3).result(), data[0:16, 0:16, 0:16])
    d = chunk_cache.delta(s0)
    assert d["misses"] == 0 and d["hits"] == 8


@pytest.mark.parametrize("fmt", FORMATS)
def test_clipped_and_partial_regions(tmp_path, fresh_cache, fmt):
    """Reference :87: regions off the chunk grid and clipped at the border
    (edge chunks: full size in zarr, truncated in N5)."""
    ds, data = _dataset(tmp_path, fmt, shape=(20, 20, 20), chunks=(8, 8, 8))
    np.testing.assert_array_equal(ds[3:17, 5:20, 0:1], data[3:17, 5:20, 0:1])
    np.testing.assert_array_equal(ds[...], data)
    np.testing.assert_array_equal(ds[19, 3:20, 7], data[19, 3:20, 7])


@pytest.mark.parametrize("fmt", FORMATS)
def test_cached_entries_are_not_corrupted_by_caller_mutation(tmp_path, fresh_cache, fmt):
    ds, data = _dataset(tmp_path, fmt)
    a = ds[0:8, 0:8, 0:8]
    a[:] = -1.0
    np.testing.assert_array_equal(ds[0:8, 0:8, 0:8], data[0:8, 0:8, 0:8])


# -- single flight ------------------------------------------------------------


def test_single_flight_coalesces_concurrent_loads(fresh_cache):
    """Reference :110: four loaders of one in-flight chunk coalesce onto
    the owner's read and see its value."""
    cache = fresh_cache
    key = ("ds", (0, 0, 0))
    kind, token = cache.get_or_begin(key)
    assert kind == cache.OWNER
    kinds, results = [], []

    def worker():
        k, h = cache.get_or_begin(key)
        kinds.append(k)
        results.append(cache.wait(h) if k == cache.WAIT else h)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for _ in range(40):
        if cache.stats["coalesced"] >= 4:
            break
        time.sleep(0.05)
    cache.complete(key, token, np.arange(8.0))
    for t in threads:
        t.join()
    assert kinds == [cache.WAIT] * 4
    assert cache.stats["misses"] == 1 and cache.stats["coalesced"] == 4
    for r in results:
        np.testing.assert_array_equal(r, np.arange(8.0))


def test_single_flight_failure_propagates_and_caches_nothing(fresh_cache):
    cache = fresh_cache
    key = ("ds", (1, 0, 0))
    kind, token = cache.get_or_begin(key)
    kind2, waiter = cache.get_or_begin(key)
    assert (kind, kind2) == (cache.OWNER, cache.WAIT)
    cache.fail(key, token, OSError("storage down"))
    with pytest.raises(OSError, match="storage down"):
        cache.wait(waiter)
    assert len(cache) == 0
    assert cache.get_or_begin(key)[0] == cache.OWNER


def test_write_during_a_load_is_never_cached_nor_joined(fresh_cache):
    """A write dooms the in-flight load of its chunk: the load serves the
    waiters it has but is not cached, and a reader after the write starts a
    fresh load instead of joining the one that may hold pre-write bytes."""
    cache = fresh_cache
    key = ("ds", (0, 0, 0))
    _, old = cache.get_or_begin(key)
    _, early = cache.get_or_begin(key)
    cache.invalidate([key])
    kind, new = cache.get_or_begin(key)
    assert kind == cache.OWNER and new is not old
    cache.complete(key, old, np.zeros(4))
    np.testing.assert_array_equal(cache.wait(early), np.zeros(4))
    assert len(cache) == 0
    assert cache.get_or_begin(key)[0] == cache.WAIT  # the fresh load is still in flight
    cache.complete(key, new, np.ones(4))
    kind, arr = cache.get_or_begin(key)
    assert kind == cache.HIT
    np.testing.assert_array_equal(arr, np.ones(4))


@pytest.mark.parametrize("fmt", FORMATS)
def test_dropped_read_async_future_does_not_strand_later_reads(tmp_path, fresh_cache, fmt):
    ds, data = _dataset(tmp_path, fmt)
    fut = ds.read_async((slice(0, 16),) * 3)
    del fut  # never resolved
    done = {}

    def reader():
        done["v"] = ds[0:16, 0:16, 0:16]

    t = threading.Thread(target=reader)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive(), "read deadlocked on a leaked owner token"
    np.testing.assert_array_equal(done["v"], data[0:16, 0:16, 0:16])


@pytest.mark.parametrize("fmt", FORMATS)
def test_stalled_shared_load_falls_back_to_direct_read(tmp_path, fresh_cache, monkeypatch, fmt):
    monkeypatch.setenv("CTT_CHUNK_CACHE_WAIT_S", "0.2")
    ds, data = _dataset(tmp_path, fmt, chunks=(16, 16, 16))
    cache = fresh_cache
    key = (ds._cache_id, (0, 0, 0))
    kind, token = cache.get_or_begin(key)
    assert kind == cache.OWNER
    s0 = chunk_cache.snapshot()
    np.testing.assert_array_equal(ds[0:16, 0:16, 0:16], data[0:16, 0:16, 0:16])
    assert chunk_cache.delta(s0)["stall_fallbacks"] == 1
    cache.fail(key, token, RuntimeError("abandoned"))


# -- coherence ----------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
def test_write_evicts_overlapping_chunks(tmp_path, fresh_cache, fmt):
    ds, data = _dataset(tmp_path, fmt)
    np.testing.assert_array_equal(ds[...], data)
    assert len(fresh_cache) == 4 * 4 * 4
    new = data[0:16, 0:16, 0:16] + 1.0
    s0 = chunk_cache.snapshot()
    ds[0:16, 0:16, 0:16] = new
    assert chunk_cache.delta(s0)["invalidations"] == 8
    np.testing.assert_array_equal(ds[0:16, 0:16, 0:16], new)
    np.testing.assert_array_equal(ds[16:32, 16:32, 16:32], data[16:32, 16:32, 16:32])


@pytest.mark.parametrize("fmt", FORMATS)
def test_partial_chunk_write_evicts_and_reads_the_disk(tmp_path, fresh_cache, fmt):
    """The read-modify-write of a partial chunk reads the stored chunk, not
    the cache, and evicts it after the write."""
    ds, data = _dataset(tmp_path, fmt, shape=(20, 20, 20))
    np.testing.assert_array_equal(ds[...], data)
    ds[17, 2:5, 19] = 7.0
    want = data.copy()
    want[17, 2:5, 19] = 7.0
    np.testing.assert_array_equal(ds[16:20, 0:8, 16:20], want[16:20, 0:8, 16:20])
    np.testing.assert_array_equal(ds[...], want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_write_async_evicts_too(tmp_path, fresh_cache, fmt):
    ds, data = _dataset(tmp_path, fmt)
    np.testing.assert_array_equal(ds[0:8, 0:8, 0:8], data[0:8, 0:8, 0:8])
    new = data[0:8, 0:8, 0:8] * 2 + 3
    assert ds.write_async((slice(0, 8),) * 3, new).result() is None
    np.testing.assert_array_equal(ds[0:8, 0:8, 0:8], new)


@pytest.mark.parametrize("fmt", FORMATS)
def test_abandoned_write_async_still_evicts(tmp_path, fresh_cache, fmt):
    ds, data = _dataset(tmp_path, fmt, chunks=(16, 16, 16))
    bb = (slice(0, 16),) * 3
    np.testing.assert_array_equal(ds[bb], data[0:16, 0:16, 0:16])
    new = data[0:16, 0:16, 0:16] + 5
    fut = ds.write_async(bb, new)
    del fut
    got = None
    for _ in range(200):
        got = ds[bb]
        if np.array_equal(got, new):
            break
        time.sleep(0.05)
    np.testing.assert_array_equal(got, new)


@pytest.mark.parametrize("fmt", FORMATS)
def test_region_read_fails_fast_past_failed_chunk(tmp_path, fresh_cache, fmt):
    ds, data = _dataset(tmp_path, fmt, chunks=(16, 16, 16))
    cache = fresh_cache
    ka, kb = (ds._cache_id, (0, 0, 0)), (ds._cache_id, (1, 0, 0))
    _, tok_a = cache.get_or_begin(ka)
    _, tok_b = cache.get_or_begin(kb)
    plan = ds._begin_cached_read((slice(0, 32), slice(0, 16), slice(0, 16)))
    assert [k for _k, _b, k, _h in plan.steps] == [cache.WAIT] * 2
    cache.fail(ka, tok_a, RuntimeError("chunk A storage error"))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="chunk A storage error"):
        ds._finish_cached_read(plan)
    assert time.monotonic() - t0 < 5.0
    cache.fail(kb, tok_b, RuntimeError("abandoned"))


@pytest.mark.parametrize("fmt", FORMATS)
def test_recreated_dataset_does_not_serve_predecessor_bytes(tmp_path, fresh_cache, fmt):
    ds, data = _dataset(tmp_path, fmt, chunks=(16, 16, 16))
    np.testing.assert_array_equal(ds[0:16, 0:16, 0:16], data[0:16, 0:16, 0:16])
    shutil.rmtree(str(tmp_path / f"c.{fmt}"))
    ds2 = open_container(str(tmp_path / f"c.{fmt}")).create_dataset(
        "x", shape=(32, 32, 32), chunks=(16, 16, 16), dtype="float32")
    np.testing.assert_array_equal(ds2[0:16, 0:16, 0:16], np.zeros((16, 16, 16), np.float32))


@pytest.mark.parametrize("fmt", FORMATS)
def test_kill_switch_bypasses_everything(tmp_path, fresh_cache, monkeypatch, fmt):
    monkeypatch.setenv("CTT_CHUNK_CACHE", "0")
    ds, data = _dataset(tmp_path, fmt)
    s0 = chunk_cache.snapshot()
    np.testing.assert_array_equal(ds[0:16, 0:16, 0:16], data[0:16, 0:16, 0:16])
    np.testing.assert_array_equal(ds.read_async((slice(0, 16),) * 3).result(), data[0:16, 0:16, 0:16])
    d = chunk_cache.delta(s0)
    assert len(fresh_cache) == 0
    assert d["hits"] == 0 and d["misses"] == 0 and d["direct_reads"] == 2
    monkeypatch.setenv("CTT_CHUNK_CACHE", "1")
    np.testing.assert_array_equal(ds[0:16, 0:16, 0:16], data[0:16, 0:16, 0:16])
    assert len(fresh_cache) == 8


@pytest.mark.parametrize("fmt", FORMATS)
def test_lru_eviction_respects_byte_budget(tmp_path, fmt):
    cache = chunk_cache.configure(max_bytes=3 * 8 * 8 * 8 * 4)  # 3 chunks
    try:
        ds, data = _dataset(tmp_path, fmt)
        for z, y in ((0, 0), (8, 0), (16, 0), (24, 0), (0, 8)):
            np.testing.assert_array_equal(ds[z:z + 8, y:y + 8, 0:8], data[z:z + 8, y:y + 8, 0:8])
        assert len(cache) == 3
        assert cache.cached_bytes <= cache.max_bytes
        assert cache.stats["evictions"] == 2
        # a region over half the budget is one direct read; the resident set stays
        s0 = chunk_cache.snapshot()
        np.testing.assert_array_equal(ds[...], data)
        d = chunk_cache.delta(s0)
        assert d["direct_reads"] == 1 and d["misses"] == 0
        assert len(cache) == 3
    finally:
        chunk_cache.configure()


def test_handoff_spill_through_the_store_evicts(tmp_path, fresh_cache):
    """A handoff spilling into a stored dataset writes through its write
    path: chunks cached before the spill are not served after it."""
    ds, data = _dataset(tmp_path, chunks=(16, 16, 16))
    np.testing.assert_array_equal(ds[...], data)
    h = HandoffDataset(data.shape, (16, 16, 16), "float32", lambda: ds, "x")
    h[...] = data * 3
    assert h.spill() == data.nbytes
    np.testing.assert_array_equal(ds[...], data * 3)
    np.testing.assert_array_equal(h[0:16, 0:16, 0:16], data[0:16, 0:16, 0:16] * 3)


# -- the task layer and the executor -------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
def test_task_records_io_metrics(tmp_path, fresh_cache, fmt):
    ds, data = _dataset(tmp_path, fmt)

    class ReadTask(BaseTask):
        task_name = "cache_probe"

        def run_impl(self):
            total = float(ds[0:16, 0:16, 0:16].sum())  # 8 misses
            total += float(ds[0:24, 0:24, 0:24].sum())  # 8 hits, 19 misses
            return {"total": total}

    tmp_folder = str(tmp_path / "tmp")
    task = ReadTask(tmp_folder=tmp_folder, config_dir=str(tmp_path / "cfg"))
    assert build([task])
    with open(fu.io_metrics_path(tmp_folder)) as f:
        m = json.load(f)["tasks"][task.uid]
    assert m["hits"] == 8 and m["misses"] == 27
    assert m["bytes_served"] > m["bytes_from_storage"] > 0
    assert task.output().read()["io_metrics"]["hits"] == 8
    fu.record_io_metrics(fu.io_metrics_path(tmp_folder), task.uid, {"hits": 2, "misses": 1})
    with open(fu.io_metrics_path(tmp_folder)) as f:
        merged = json.load(f)["tasks"][task.uid]
    assert merged["hits"] == 10 and merged["misses"] == 28


@pytest.mark.parametrize("fmt", FORMATS)
def test_map_blocks_schedule_given_and_morton_agree(tmp_path, fresh_cache, fmt):
    f = open_container(str(tmp_path / f"s.{fmt}"))
    shape, bshape = (16, 16, 32), (8, 8, 8)
    src = f.create_dataset("src", shape=shape, chunks=bshape, dtype="float32")
    data = np.random.default_rng(3).random(shape).astype(np.float32)
    src[...] = data
    blocks = [Blocking(shape, bshape).get_block(i) for i in range(16)]
    ex = pex.BlockwiseExecutor(target="local", device_batch=1)
    outs = {}
    for schedule in ("morton", "given"):
        dst = f.create_dataset(f"dst_{schedule}", shape=shape, chunks=bshape, dtype="float32")
        ex.map_blocks(lambda a: a * 2.0, blocks, lambda b: (src[b.bb],),
                      lambda b, o: dst.__setitem__(b.bb, np.asarray(o)), schedule=schedule)
        outs[schedule] = np.asarray(dst[...])
    np.testing.assert_array_equal(outs["morton"], outs["given"])
    np.testing.assert_array_equal(outs["morton"], data * 2.0)
    with pytest.raises(ValueError, match="schedule"):
        ex.map_blocks(lambda a: a, blocks, lambda b: (data[b.bb],), None, schedule="zigzag")


@pytest.mark.parametrize("cache_on", [True, False])
def test_auto_inflight_budget_leaves_room_for_the_cache(monkeypatch, cache_on):
    """The automatic in-flight budget (a quarter of MemAvailable) less the
    cache's budget while the cache is on, floored at a quarter of it."""
    monkeypatch.setattr(pex, "host_mem_available_bytes", lambda: 4 << 30)
    monkeypatch.setenv("CTT_CHUNK_CACHE", "1" if cache_on else "0")
    blocks = [Blocking((4,), (2,)).get_block(i) for i in range(2)]
    budgets = {}
    for cache_bytes in (256 << 20, 1 << 30):
        chunk_cache.configure(max_bytes=cache_bytes)
        try:
            summary = pex.BlockwiseExecutor(target="local").map_blocks(
                lambda x: x, blocks, lambda b: (np.zeros(2),), sweep_mode="per_block")
        finally:
            chunk_cache.configure()
        budgets[cache_bytes] = summary["inflight_byte_budget"]
    if cache_on:
        assert budgets == {256 << 20: (1 << 30) - (256 << 20), 1 << 30: (1 << 30) // 4}
    else:
        assert budgets == {256 << 20: 1 << 30, 1 << 30: 1 << 30}
