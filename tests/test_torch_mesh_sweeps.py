"""The port's blockwise executor over a mesh of ``n_devices`` shards against
the reference's at the same ``n_devices`` (8 virtual CPU devices), on the
CPU: the same seeded volumes, the same ``Block`` lists, equal outputs bit
for bit.

- every sweep shape (``per_block``, ``sharded``, ``auto``) at k = 1, 2, 4
  and 8 shards, with ``n_blocks`` and the resolved ``sharded_batch`` equal
  to the reference's, and a ragged tail whose batch width rounds up to a
  multiple of the shard count;
- the device page pool twice (the warm sweep sends fewer bytes), and two
  arguments of one page class over two shards of one card (fault C2);
- a ``dispatch`` fault (``CTT_FAULTS``) in a sharded batch: the same
  ``failures.json`` records as the reference's;
- the n-device cases of the reference's ``tests/test_prefetch.py`` and
  ``tests/test_chunk_cache.py``;
- the port's watershed and cc workflows on 1 and 4 shards, equal.

The mode env of the reference (``CT_FILL_MODE``, ``CT_SEED_CCL``,
``CT_TIER_MODE``) is pinned, and both packages' drain handlers are restored
when the file ends (ROADMAP fact 19).
"""

import json
import os
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_tools_tpu.parallel import batch_shard as j_bs
from cluster_tools_tpu.runtime import executor as jex
from cluster_tools_tpu.runtime import faults as jfaults
from cluster_tools_tpu.runtime import supervision as jsup
from cluster_tools_tpu.utils.volume_utils import Blocking as JBlocking
from cluster_tools_tpu_torch.io.containers import open_container
from cluster_tools_tpu_torch.io.prefetch import async_loader
from cluster_tools_tpu_torch.parallel import block_pool
from cluster_tools_tpu_torch.parallel import device_pool
from cluster_tools_tpu_torch.parallel.mesh import backend_devices
from cluster_tools_tpu_torch.runtime import executor as pex
from cluster_tools_tpu_torch.runtime import faults as pfaults
from cluster_tools_tpu_torch.runtime import supervision as psup
from cluster_tools_tpu_torch.utils.volume_utils import Blocking, pad_block_to

SHARDS = [1, 2, 4, 8]


@pytest.fixture(autouse=True, scope="module")
def _restore_drain_handlers():
    """Both packages' executors arm a SIGTERM/SIGUSR1 drain handler in the
    main thread and keep it: after this file's last case, restore both
    signals, both packages' armed flags and their drain latches (ROADMAP
    fact 19)."""
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGUSR1)}
    flags = [(mod, mod._drain_installed) for mod in (jsup, psup)]
    yield
    for sig, handler in saved.items():
        signal.signal(sig, handler)
    for mod, flag in flags:
        mod._drain_installed = flag
        mod.reset_drain()


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    for k, v in (("CT_FILL_MODE", "dense"), ("CT_SEED_CCL", "sparse"), ("CT_TIER_MODE", "cond")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("CTT_MESH_SHARDS", raising=False)
    device_pool.reset()
    yield
    device_pool.reset()


def elementwise(b):
    return torch.where(b < 0.5, b * 2 + 0.25, torch.tensor(1.0, dtype=b.dtype))


def j_elementwise(b):
    return jnp.where(b < jnp.float32(0.5), b * 2 + jnp.float32(0.25), jnp.float32(1.0))


def smooth(b):
    x = (b + torch.roll(b, 1, 0) + torch.roll(b, -1, 0)) / 3.0
    return torch.where(x < 0.5, x, torch.tensor(1.0))


def _batched(kernel):
    def k(*a):
        return kernel(*a)

    k.batched = lambda *a: torch.stack([kernel(*(x[i] for x in a)) for i in range(a[0].shape[0])])
    return k


VOL = np.random.default_rng(19).random((48, 48, 48)).astype(np.float32)
OUTER = (24, 24, 24)


def _blocks(blocking_cls=Blocking, shape=(48, 48, 48), block=(16, 16, 16), halo=(4, 4, 4)):
    b = blocking_cls(shape, block)
    return [b.get_block(i, halo=halo) for i in range(b.n_blocks)]


def _load(b):
    return (pad_block_to(VOL[b.outer_bb], OUTER, constant_values=1.0),)


def _sweep(ex, kernel, blocks, load=_load, **kw):
    """``kernel`` over ``blocks`` of ``VOL``: (output, summary)."""
    out = np.zeros_like(VOL)

    def store(b, raw):
        out[b.bb] = np.asarray(raw)[b.inner_in_outer_bb]

    summary = ex.map_blocks(kernel, blocks, load, store, **kw)
    return out, summary


# -- the mesh ---------------------------------------------------------------


def test_backend_devices_deal_shards_and_default_to_the_seam(monkeypatch):
    assert backend_devices("local", 3) == [torch.device("cpu")] * 3
    assert backend_devices("local") == [torch.device("cpu")]
    monkeypatch.setenv("CTT_MESH_SHARDS", "4")
    ex = pex.BlockwiseExecutor(target="local", device_batch=2)
    assert (ex.n_devices, ex.batch_size) == (4, 8) and ex.devices == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="n_devices"):
        backend_devices("local", 0)
    with pytest.raises(ValueError, match="unknown target"):
        pex.BlockwiseExecutor(target="tpu")


# -- every sweep shape against the reference -----------------------------------


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("mode", ["per_block", "sharded", "auto"])
def test_sweeps_equal_the_reference_at_k_shards(k, mode):
    """27 blocks of 16^3 (halo 4, a 3^3 grid) through both packages'
    executors at ``n_devices=k``: equal outputs, the same sweep shape,
    ``n_blocks`` and batch width, the same sharded calls and ragged
    batches; and equal to the port's own 1-shard per-block sweep."""
    blocks = _blocks()
    want1, _ = _sweep(pex.BlockwiseExecutor(target="local", n_devices=1), elementwise, blocks,
                      sweep_mode="per_block")
    got, s = _sweep(pex.BlockwiseExecutor(target="local", n_devices=k, io_threads=4), elementwise, blocks,
                    sweep_mode=mode)
    snap = jex.dispatch_snapshot()
    ref, js = _sweep(jex.BlockwiseExecutor(target="local", n_devices=k, io_threads=4), j_elementwise,
                     _blocks(JBlocking), sweep_mode=mode, store_verify_fn=None)
    jd = jex.dispatch_delta(snap)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, want1)
    assert s["n_blocks"] == js["n_blocks"] == 27 and s["sweep_mode"] == js["sweep_mode"]
    assert s["n_devices"] == k and len(s["shard_calls"]) == k
    if s["sweep_mode"] == "sharded":
        width = j_bs.resolve_sharded_batch(k, k, None)
        assert s["sharded_batch"] == width
        assert s["batches_dispatched"] == jd["batches_dispatched"] == -(-27 // width)
        assert s["ragged_batches"] == jd["ragged_batches"]
        # a shard runs once a batch in which it holds a real lane
        per = width // k
        want_calls = [sum(1 for b0 in range(0, 27, width) if b0 + s_ * per < 27) for s_ in range(k)]
        assert s["shard_calls"] == want_calls
    else:
        assert s["shard_calls"] == [sum(1 for j in range(27) if j % k == s_) for s_ in range(k)]


@pytest.mark.parametrize("k", SHARDS)
def test_ragged_tail_rounds_to_the_shard_count(k):
    """``sharded_batch=12`` rounds up to a multiple of the shard count; the
    27-block sweep ends in a ragged batch whose padding lanes match the
    reference's; shards holding only padding make no call.  A lane-batched
    kernel with a neighbourhood (``smooth``) equals its 1-shard sweep."""
    blocks = _blocks()
    got, s = _sweep(pex.BlockwiseExecutor(target="local", n_devices=k, io_threads=4), elementwise, blocks,
                    sweep_mode="sharded", sharded_batch=12)
    snap = jex.dispatch_snapshot()
    ref, _ = _sweep(jex.BlockwiseExecutor(target="local", n_devices=k, io_threads=4), j_elementwise,
                    _blocks(JBlocking), sweep_mode="sharded", sharded_batch=12, store_verify_fn=None)
    jd = jex.dispatch_delta(snap)
    np.testing.assert_array_equal(got, ref)
    width = -(-12 // k) * k
    assert s["sharded_batch"] == width and width % k == 0
    assert s["ragged_batches"] == jd["ragged_batches"] >= 1
    assert s["lanes_padded"] == -(-27 // width) * width - 27
    assert sum(s["shard_calls"]) == sum(-(-min(width, 27 - b0) // (width // k)) for b0 in range(0, 27, width))
    one, _ = _sweep(pex.BlockwiseExecutor(target="local", n_devices=1), _batched(smooth), blocks,
                    sweep_mode="sharded", sharded_batch=12)
    many, s_many = _sweep(pex.BlockwiseExecutor(target="local", n_devices=k), _batched(smooth), blocks,
                          sweep_mode="sharded", sharded_batch=12)
    np.testing.assert_array_equal(one, many)
    assert set(s_many["batch_rungs"]) == {"batched"}


# -- the device page pool ------------------------------------------------------


def test_device_pool_twice_over_four_shards():
    """A 20^3 volume in 8^3 blocks (27 clipped blocks, halo 2) over 4
    shards, through the resident page pool: cold and warm equal the pool
    off; the warm sweep hits and sends fewer bytes to the device."""
    vol = np.random.default_rng(3).random((20, 20, 20)).astype(np.float32)
    blocks = _blocks(shape=(20, 20, 20), block=(8, 8, 8), halo=(2, 2, 2))

    def sweep(**kw):
        out = np.zeros_like(vol)

        def store(b, raw):
            out[b.bb] = np.asarray(raw)[b.inner_in_outer_bb]

        snap = device_pool.snapshot()
        s = pex.BlockwiseExecutor(target="local", n_devices=4).map_blocks(
            elementwise, blocks, lambda b: (vol[b.outer_bb],), store, sweep_mode="sharded", sharded_batch=16,
            **kw)
        return out, s, device_pool.delta(snap)

    ref, _, _ = sweep(ragged="off", device_pool="off")
    cold, s_cold, d_cold = sweep(device_pool="on")
    warm, s_warm, d_warm = sweep(device_pool="on")
    np.testing.assert_array_equal(ref, cold)
    np.testing.assert_array_equal(ref, warm)
    assert d_cold["device_pool_misses"] > 0 and d_warm["device_pool_misses"] == 0
    assert d_warm["device_pool_hits"] > 0 and d_warm["h2d_bytes"] < d_cold["h2d_bytes"]
    # one card: its arenas are staged once a batch, for every shard's lanes
    assert d_cold["device_batches_staged"] == s_cold["batches_dispatched"] == 2
    assert sum(s_warm["shard_calls"]) == 7 and s_warm["device_pool_resident_bytes"] > 0
    assert device_pool.get_device_pool().resident_bytes("cpu") == s_warm["device_pool_resident_bytes"]


def test_two_shards_of_one_card_keep_one_page_class_intact():
    """Fault C2 over shards: a kernel of two arguments of one page class,
    ragged batches of 16 lanes over 2 shards of the CPU, and an arena budget
    that holds one batch's pages and no more.  Every batch's misses evict
    the last batch's pages, never a page another shard of the same batch
    maps: the outputs equal the pool off, bit for bit."""
    rng = np.random.default_rng(7)
    a_vol = rng.random((32, 32, 32)).astype(np.float32)
    b_vol = rng.random((32, 32, 32)).astype(np.float32)
    blocks = _blocks(shape=(32, 32, 32), block=(8, 8, 8), halo=(0, 0, 0))

    def kernel(a, b):
        return a * 2 + b

    def sweep(**kw):
        out = np.zeros_like(a_vol)

        def store(blk, raw):
            out[blk.bb] = np.asarray(raw)

        s = pex.BlockwiseExecutor(target="local", n_devices=2).map_blocks(
            kernel, blocks, lambda blk: (a_vol[blk.bb], b_vol[blk.bb]), store, sweep_mode="sharded",
            sharded_batch=16, ragged="on", **kw)
        return out, s

    want, _ = sweep(device_pool="off")
    # 16 lanes x 2 arguments + the fill page: one 8^3 float32 page is 2 KiB
    budget = block_pool._quantize_pages(2 * 16 + 1) * 8 ** 3 * 4
    snap = device_pool.snapshot()
    got, s = sweep(device_pool="on", device_pool_bytes=budget)
    d = device_pool.delta(snap)
    np.testing.assert_array_equal(got, want)
    assert d["device_pool_evictions"] > 0 and d["host_staged_fallbacks"] == 0
    assert s["shard_calls"] == [4, 4]


# -- a dispatch fault ---------------------------------------------------------------


def test_dispatch_fault_on_a_shard_gives_the_reference_records(tmp_path, monkeypatch):
    """``CTT_FAULTS`` fails the sharded call of the batch led by the second
    batch's first block, on 4 shards in both packages: that batch's eight
    blocks run one by one (``degraded:unsharded``), the records are the
    reference's, and the outputs equal the clean run."""
    order = pex.morton_order(_blocks())
    target = int(order[8].block_id)
    spec = {"faults": [{"site": "dispatch", "kind": "oom", "blocks": [target], "fail_attempts": 1}]}
    clean, _ = _sweep(pex.BlockwiseExecutor(target="local", n_devices=4), elementwise, _blocks(),
                      sweep_mode="sharded", sharded_batch=8)
    recs = {}
    monkeypatch.setenv("CTT_FAULTS", json.dumps(spec))
    for side, ex, kern, blocks in (("port", pex, elementwise, _blocks()),
                                   ("jax", jex, j_elementwise, _blocks(JBlocking))):
        for f in (jfaults, pfaults):
            f.reset()
        fp = str(tmp_path / f"{side}.json")
        kw = {} if side == "port" else {"store_verify_fn": None}
        got, s = _sweep(ex.BlockwiseExecutor(target="local", n_devices=4, io_threads=1, backoff_base=1e-4), kern,
                        blocks, sweep_mode="sharded", sharded_batch=8, failures_path=fp, task_name="mesh", **kw)
        np.testing.assert_array_equal(got, clean)
        recs[side] = sorted((r["block_id"], sorted(r["sites"].items()), r["quarantined"], r["resolved"],
                             r.get("resolution")) for r in json.load(open(fp))["records"])
        if side == "port":
            # three sharded calls, then the failed batch's blocks alone, on
            # shard 0; the failed batch made no shard call
            assert s["n_unsharded"] == 8 and s["batches_dispatched"] == 3 + 8
            assert s["shard_calls"] == [3 + 8, 3, 2, 2]
    for f in (jfaults, pfaults):
        f.reset()
    assert recs["port"] == recs["jax"]
    assert len(recs["port"]) == 8 and all(r[4] == "degraded:unsharded" for r in recs["port"])
    assert {r[0] for r in recs["port"]} == {int(b.block_id) for b in order[8:16]}


# -- two cards ------------------------------------------------------------------------


def _two_cards(monkeypatch):
    """Four shards dealt over two cards of the CPU: ``cpu:0`` and ``cpu:1``
    are distinct card keys (their own dispatch locks and arenas) whose
    tensors live on the CPU."""
    monkeypatch.setattr(pex, "backend_devices", lambda target, n: [torch.device("cpu", s % 2) for s in range(n)])
    ex = pex.BlockwiseExecutor(target="local", n_devices=4)
    assert [pex.card_key(d) for d in ex.devices] == ["cpu:0", "cpu:1", "cpu:0", "cpu:1"]
    return ex


def _tagged(fail_id=None):
    """A kernel of (block, block id), ``2 * block + 0.25``, that records the
    thread of each batched call and, when its sub-batch holds ``fail_id``,
    raises a device OOM there (its blocks alone run clean)."""
    threads = set()

    def k(b, i):
        return b * 2 + 0.25

    def batched(b, i):
        threads.add(threading.current_thread().name)
        if fail_id is not None and bool((i == fail_id).any()):
            raise torch.OutOfMemoryError(f"injected OOM for block {fail_id}")
        return b * 2 + 0.25

    k.batched = batched
    return k, threads


def _tagged_load(b):
    return (pad_block_to(VOL[b.outer_bb], OUTER, constant_values=1.0), np.full(1, b.block_id, np.int32))


def test_two_cards_run_their_shards_from_their_own_threads(tmp_path, monkeypatch):
    """Four shards on two cards, ragged batches through the device pool,
    traced: each card's shards run from that card's thread, every shard
    makes its calls, each card keeps its own arenas, the card threads'
    spans reach the trace, and the outputs equal one shard's."""
    from cluster_tools_tpu_torch.runtime import trace

    kernel, threads = _tagged()
    want, _ = _sweep(pex.BlockwiseExecutor(target="local", n_devices=1), kernel, _blocks(), load=_tagged_load,
                     sweep_mode="per_block")
    np.testing.assert_array_equal(want, VOL * np.float32(2) + np.float32(0.25))
    trace.reset()
    trace.configure(enabled=True, trace_dir=str(tmp_path / "trace"))
    try:
        got, s = _sweep(_two_cards(monkeypatch), kernel, _blocks(), load=_tagged_load, sweep_mode="sharded",
                        sharded_batch=8, ragged="on", device_pool="on", task_name="two_cards")
        trace.flush()
        summary = trace.summarize(trace.merge(str(tmp_path / "trace")))
    finally:
        trace.reset()
    np.testing.assert_array_equal(got, want)
    assert threads == {"card_0", "card_1"}
    # 27 blocks in batches of 8: 2 lanes a shard, the last batch on 2 shards
    assert s["n_devices"] == 4 and s["shard_calls"] == [4, 4, 3, 3]
    pool = device_pool.get_device_pool()
    assert pool.resident_bytes("cpu:0") > 0 and pool.resident_bytes("cpu:1") > 0
    assert pool.resident_bytes() == pool.resident_bytes("cpu:0") + pool.resident_bytes("cpu:1")
    assert summary["sites"]["executor.dispatch"]["count"] == sum(s["shard_calls"])


def test_oom_on_one_card_evicts_that_card_and_quarantines_the_batch(tmp_path, monkeypatch):
    """The last batch's third lane sits on shard 1, card ``cpu:1``: its
    batched call raises a device OOM in that card's thread while card
    ``cpu:0`` finishes its lanes.  The batch is quarantined (its three
    blocks run alone, ``degraded:unsharded``, resource ``oom``), the OOM
    ladder evicts ``cpu:1``'s arenas and leaves ``cpu:0``'s, and the
    outputs equal the clean run."""
    order = pex.morton_order(_blocks())
    fail_id = int(order[26].block_id)
    clean_kernel, _ = _tagged()
    ex = _two_cards(monkeypatch)
    clean, _ = _sweep(ex, clean_kernel, _blocks(), load=_tagged_load, sweep_mode="sharded", sharded_batch=8,
                      ragged="on", device_pool="off")
    device_pool.reset()
    kernel, threads = _tagged(fail_id)
    fp = str(tmp_path / "failures.json")
    got, s = _sweep(ex, kernel, _blocks(), load=_tagged_load, sweep_mode="sharded", sharded_batch=8, ragged="on",
                    device_pool="on", failures_path=fp, task_name="two_cards")
    np.testing.assert_array_equal(got, clean)
    assert threads == {"card_0", "card_1"}
    recs = json.load(open(fp))["records"]
    assert sorted(r["block_id"] for r in recs) == sorted(int(b.block_id) for b in order[24:])
    assert all(r["resolution"] == "degraded:unsharded" and r["resolved"] for r in recs)
    assert all("injected OOM" in r["error"] for r in recs)
    # three clean batches; in the failed one shard 0's call ran on cpu:0
    # and shard 1's raised; then the failed batch's blocks alone on shard 0
    assert s["n_unsharded"] == 3 and s["shard_calls"] == [3 + 1 + 3, 3, 3, 3]
    pool = device_pool.get_device_pool()
    assert pool.resident_bytes("cpu:1") == 0 and pool.resident_bytes("cpu:0") > 0


# -- the reference's n-device executor cases (test_prefetch, test_chunk_cache) --------


def test_executor_overlaps_batch_loads_on_four_shards():
    """``tests/test_prefetch.py:76``: future loads of a batch overlap, with
    ``n_devices=4, device_batch=2``."""
    read_delay = 0.05
    pool = ThreadPoolExecutor(16)
    blocking = Blocking((8, 8, 64), (8, 8, 8))
    blocks = [blocking.get_block(i) for i in range(blocking.n_blocks)]

    def load(block):
        def work():
            time.sleep(read_delay)
            return np.ones((8, 8, 8), np.float32) * block.block_id

        return (pool.submit(work),)

    outs = {}
    ex = pex.BlockwiseExecutor(target="local", n_devices=4, device_batch=2)
    kernel = lambda a: a + 1.0  # noqa: E731
    ex.map_blocks(kernel, blocks, lambda b: (np.zeros((8, 8, 8), np.float32),), lambda b, o: None)
    t0 = time.perf_counter()
    s = ex.map_blocks(kernel, blocks, load, lambda b, o: outs.__setitem__(b.block_id, np.asarray(o)))
    wall = time.perf_counter() - t0
    assert wall < 0.6 * len(blocks) * read_delay, f"no overlap: wall={wall:.2f}s"
    assert s["sweep_mode"] == "sharded" and s["n_devices"] == 4
    for b in blocks:
        assert (outs[b.block_id] == b.block_id + 1.0).all()
    pool.shutdown()


@pytest.mark.parametrize("case", ["async", "padded"])
def test_async_loader_on_two_shards(tmp_path, case):
    """``tests/test_prefetch.py:115`` and ``:135``: zarr chunks through
    ``read_async`` futures on ``n_devices=2`` (``device_batch`` 2 and 1),
    clipped edge blocks padded in the second."""
    f = open_container(str(tmp_path / "v.zarr"))
    shape, bshape = ((16, 16, 32), (8, 8, 16)) if case == "async" else ((8, 8, 20), (8, 8, 16))
    src = f.create_dataset("src", shape=shape, chunks=bshape, dtype="float32")
    data = np.random.default_rng(0 if case == "async" else 1).random(shape).astype(np.float32)
    src[...] = data
    dst = f.create_dataset("dst", shape=shape, chunks=bshape, dtype="float32")
    blocking = Blocking(shape, bshape)
    blocks = [blocking.get_block(i) for i in range(blocking.n_blocks)]

    def store(block, out):
        inner = tuple(slice(0, s.stop - s.start) for s in block.bb)
        dst[block.bb] = np.asarray(out)[inner]

    if case == "async":
        ex = pex.BlockwiseExecutor(target="local", n_devices=2, device_batch=2)
        ex.map_blocks(lambda a: a * 2.0, blocks, async_loader(src, lambda b: b.bb), store)
        np.testing.assert_array_equal(np.asarray(dst[...]), data * 2.0)
    else:
        ex = pex.BlockwiseExecutor(target="local", n_devices=2, device_batch=1)
        ex.map_blocks(lambda a: a + 3.0, blocks, async_loader(src, lambda b: b.bb, pad_to=bshape), store)
        np.testing.assert_array_equal(np.asarray(dst[...]), data + 3.0)


def test_schedules_agree_on_two_shards(tmp_path):
    """``tests/test_chunk_cache.py:481``: the Morton and given orders give
    the same stored results on ``n_devices=2``; an unknown schedule is
    refused."""
    f = open_container(str(tmp_path / "s.zarr"))
    shape, bshape = (16, 16, 32), (8, 8, 8)
    src = f.create_dataset("src", shape=shape, chunks=bshape, dtype="float32")
    data = np.random.default_rng(3).random(shape).astype(np.float32)
    src[...] = data
    blocking = Blocking(shape, bshape)
    blocks = [blocking.get_block(i) for i in range(blocking.n_blocks)]
    ex = pex.BlockwiseExecutor(target="local", n_devices=2, device_batch=1)
    outs = {}
    for schedule in ("morton", "given"):
        dst = f.create_dataset(f"dst_{schedule}", shape=shape, chunks=bshape, dtype="float32")
        ex.map_blocks(lambda a: a * 2.0, blocks, lambda b: (data[b.bb],),
                      lambda b, o: dst.__setitem__(b.bb, np.asarray(o)), schedule=schedule)
        outs[schedule] = np.asarray(dst[...])
    np.testing.assert_array_equal(outs["morton"], outs["given"])
    np.testing.assert_array_equal(outs["morton"], data * 2.0)
    with pytest.raises(ValueError, match="schedule"):
        ex.map_blocks(lambda a: a, blocks, lambda b: (data[b.bb],), None, schedule="zigzag")


# -- the workflows on shards --------------------------------------------------------


def _workflows(root, shards, monkeypatch):
    """The port's watershed and cc workflows (``target="local"``) on a 32^3
    map in 16^3 blocks, the executor on ``shards`` shards
    (``CTT_MESH_SHARDS``): (ws labels, cc labels)."""
    from cluster_tools_tpu_torch.runtime.task import build
    from cluster_tools_tpu_torch.tasks.connected_components import ConnectedComponentsWorkflow
    from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries_np

    monkeypatch.setenv("CTT_MESH_SHARDS", str(shards))
    os.makedirs(os.path.join(root, "config"), exist_ok=True)
    with open(os.path.join(root, "config", "global.config"), "w") as fh:
        json.dump({"block_shape": [16, 16, 16]}, fh)
    path = os.path.join(root, "data.zarr")
    f = open_container(path)
    f.require_dataset("b", shape=(32, 32, 32), chunks=(16, 16, 16), dtype="float32")[...] = \
        synthetic_boundaries_np((32, 32, 32), seed=3)
    common = dict(config_dir=os.path.join(root, "config"), max_jobs=2, target="local", input_path=path)
    ws = WatershedWorkflow(tmp_folder=os.path.join(root, "tmp_ws"), input_key="b", output_path=path,
                           output_key="ws", halo=[4, 4, 4], threshold=0.5, **common)
    cc = ConnectedComponentsWorkflow(tmp_folder=os.path.join(root, "tmp_cc"), input_key="b", output_path=path,
                                     output_key="cc", threshold=0.5, threshold_mode="less", **common)
    assert build([ws]) and build([cc])
    return f["ws"][...], f["cc"][...]


def test_workflows_on_four_shards_equal_one(tmp_path, monkeypatch):
    ws1, cc1 = _workflows(str(tmp_path / "one"), 1, monkeypatch)
    ws4, cc4 = _workflows(str(tmp_path / "four"), 4, monkeypatch)
    np.testing.assert_array_equal(ws1, ws4)
    np.testing.assert_array_equal(cc1, cc4)
    assert ws1.max() > 1 and cc1.max() > 1
