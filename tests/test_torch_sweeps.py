"""The port's sweep plane against the reference's: the policy functions,
the ragged paged block pool, the batched and ragged sweeps, the slab sweep
with batch-neighbour halos, the device-resident page pool, and the
executor's sharded path (bit-identity with the per-block path, the
``degraded:unsharded`` and ``degraded:host_staged`` ladders, and the JAX
package's sharded executor on the same volume).

Counterpart of the reference's ``tests/test_sharded.py``,
``test_ragged.py`` and ``test_device_plane.py``, without their
fault-injection, trace and handoff cases.
"""

import itertools
import json
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_tools_tpu.parallel import batch_shard as j_bs
from cluster_tools_tpu.parallel import block_pool as j_pool
from cluster_tools_tpu.runtime import executor as j_ex
from cluster_tools_tpu.runtime import supervision as jsup
from cluster_tools_tpu_torch.parallel import batch_shard as bs
from cluster_tools_tpu_torch.parallel import block_pool
from cluster_tools_tpu_torch.parallel import device_pool
from cluster_tools_tpu_torch.runtime import executor as pex
from cluster_tools_tpu_torch.runtime import supervision as psup
from cluster_tools_tpu_torch.utils.volume_utils import Blocking, pad_block_to


@pytest.fixture(autouse=True, scope="module")
def _restore_drain_handlers():
    """Both packages' executors arm a SIGTERM/SIGUSR1 drain handler in the
    main thread and keep it: after this file's last case, restore both
    signals, both packages' armed flags and their drain latches, so a later
    file in this worker (the reference's preempt test above all) finds them
    as they were (ROADMAP fact 19)."""
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGUSR1)}
    flags = [(mod, mod._drain_installed) for mod in (jsup, psup)]
    yield
    for sig, handler in saved.items():
        signal.signal(sig, handler)
    for mod, flag in flags:
        mod._drain_installed = flag
        mod.reset_drain()


@pytest.fixture(autouse=True)
def _fresh_pool():
    device_pool.reset()
    yield
    device_pool.reset()


def _f(rng, shape):
    return rng.random(shape).astype(np.float32)


def elementwise(b):
    return torch.where(b < 0.5, b * 2 + 0.25, torch.tensor(1.0, dtype=b.dtype))


def j_elementwise(b):
    return jnp.where(b < jnp.float32(0.5), b * 2 + jnp.float32(0.25), jnp.float32(1.0))


def smooth(b):
    x = (b + torch.roll(b, 1, 0) + torch.roll(b, -1, 0)) / 3.0
    return torch.where(x < 0.5, x, torch.tensor(1.0))


# -- the policy functions are the reference's --------------------------------


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_resolve_sharded_batch_matches_reference(n_devices):
    for base, explicit in itertools.product([1, 2, 3, 4, 8], [None, 1, 3, 5, 8, 12, 16]):
        assert bs.resolve_sharded_batch(n_devices, base, explicit) == \
            j_bs.resolve_sharded_batch(n_devices, base, explicit)


@pytest.mark.parametrize("mode", ["auto", "sharded", "per_block"])
def test_use_sharded_sweep_matches_reference(mode):
    for n_dev, n_blocks, batch in itertools.product([1, 2, 8], [0, 1, 2, 7, 8, 9, 64], [1, 8, 12]):
        assert bs.use_sharded_sweep(mode, n_dev, n_blocks, batch) == \
            j_bs.use_sharded_sweep(mode, n_dev, n_blocks, batch)


def test_policy_refusals_and_feed_gate_match_reference():
    for mod in (bs, j_bs):
        with pytest.raises(ValueError, match="unknown sweep_mode"):
            mod.use_sharded_sweep("fast", 1, 8, 8)
    for shape, extent, halo in itertools.product([(24, 4), (25, 4), (4, 4)], [0, 4, 6, 8], [0, 2, 7]):
        assert bs.slab_sweep_device_feed_ok(shape, extent, halo) == j_bs.slab_sweep_device_feed_ok(shape, extent, halo)


# -- the paged block pool, array for array ------------------------------------

PACK_CASES = {
    "mixed": ([(10, 7, 5), (12, 12, 12), (3, 12, 9)], 8, None, (1.5,)),
    "uniform_tail": ([(6, 5, 7)] * 3, 4, None, None),
    "uniform_caller_page": ([(6, 5, 7)] * 3, 4, (4, 4, 4), None),
    "mixed_caller_page": ([(9, 9, 9), (5, 12, 7)], 4, (4, 4, 4), (0.0,)),
    "two_args": ([(9, 8, 7), (4, 8, 3)], 2, None, (0.5, 0)),
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_matches_reference(case):
    shapes, width, page, fills = PACK_CASES[case]
    rng = np.random.default_rng(7)
    lanes = []
    for s in shapes:
        a = _f(rng, s)
        lanes.append((a, (a > 0.5).astype(np.int32)) if case == "two_args" else (a,))
    got = block_pool.PagedBlockPool().pack(lanes, width, page_shape=page, fills=fills)
    want = j_pool.PagedBlockPool().pack(lanes, width, page_shape=page, fills=fills)
    assert tuple(got.specs) == tuple(want.specs)
    assert (got.n_lanes, got.width, got.lanes_padded, got.pages_in_use, got.nbytes) == \
        (want.n_lanes, want.width, want.lanes_padded, want.pages_in_use, want.nbytes)
    for gp, wp, gt, wt, gv, wv in zip(got.pools, want.pools, got.tables, want.tables, got.valids, want.valids):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)
        used = int(gt.max()) + 1
        np.testing.assert_array_equal(gp[:used], wp[:used])
        # the fill page is page 0
        assert np.all(gp[0] == gp[0].flat[0])
    for j in range(got.n_lanes):
        assert got.lane_valid_shape(j) == want.lane_valid_shape(j)


def test_pack_refusals_match_reference():
    bad = [
        (([], 4), "empty"),
        (([(np.zeros((2, 2)),)] * 3, 2), "width"),
        (([(np.zeros((2, 2)),), (np.zeros((2, 2, 2)),)], 4), "rank"),
        (([(np.zeros((2, 2), np.float32),), (np.zeros((2, 2), np.int32),)], 4), "dtype"),
        (([(np.zeros((2, 2)),), (np.zeros((2, 2)), np.zeros((2, 2)))], 4), "arg count"),
    ]
    for (lanes, width), match in bad:
        for mod in (block_pool, j_pool):
            with pytest.raises(ValueError, match=match):
                mod.PagedBlockPool().pack(lanes, width)


def test_pool_buffer_reuse_and_stale_bytes_masked():
    """A released buffer is recycled, and a poisoned (stale) one cannot
    leak into results: the device-side valid-extent mask re-asserts the
    fill (reference ``test_ragged.py::test_pool_buffer_reuse_and_stale_
    bytes_masked``)."""
    rng = np.random.default_rng(1)
    pool = block_pool.PagedBlockPool()
    rb = pool.pack([(_f(rng, (9, 9, 9)),), (_f(rng, (5, 12, 7)),)], width=8)
    key = rb.key()
    for p in rb.pools:
        p[:] = np.float32(np.nan)
    rb.release()
    lanes = [(_f(rng, (9, 9, 9)),), (_f(rng, (5, 12, 7)),)]
    rb2 = pool.pack(lanes, width=8)
    assert pool.buffer_reuses >= 1 and rb2.key() == key
    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    out, rung = bs.ragged_sweep(elementwise, t(rb2.pools), t(rb2.tables), t(rb2.valids), rb2.specs)
    assert rung == "lanes"
    for j, (a,) in enumerate(lanes):
        got = rb2.crop(j, out[j].numpy())
        np.testing.assert_array_equal(got, elementwise(torch.from_numpy(a)).numpy())
        assert np.isfinite(got).all()


@pytest.mark.parametrize("width", [1, 2, 3, 5, 8])
def test_ragged_reassembly_equals_host_padding(width):
    """Every lane rebuilt on the device is bit-equal to its host-padded
    array (fill beyond the valid extent), and padding lanes are all fill,
    at every width."""
    rng = np.random.default_rng(width)
    shapes = [(9, 9, 9), (5, 12, 7), (3, 2, 11), (12, 12, 12), (1, 1, 1)][:width]
    lanes = [(_f(rng, s),) for s in shapes]
    rb = block_pool.PagedBlockPool().pack(lanes, width=width, fills=(-3.0,))
    (spec,) = rb.specs
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    dense = bs.reassemble_lanes(t(rb.pools[0]), t(rb.tables[0]), t(rb.valids[0]), spec).numpy()
    for j in range(width):
        want = np.full(spec.padded_shape, -3.0, np.float32)
        if j < len(lanes):
            a = lanes[j][0]
            want[tuple(slice(0, s) for s in a.shape)] = a
        np.testing.assert_array_equal(dense[j], want)
    out, rung = bs.batched_sweep(elementwise, (torch.from_numpy(dense),))
    assert rung == "lanes"
    np.testing.assert_array_equal(out.numpy(), elementwise(torch.from_numpy(dense)).numpy())


# -- slab sweeps: halos from batch neighbours ---------------------------------


@pytest.mark.parametrize("n_slabs,batch", [(4, 4), (6, 4), (5, 4), (8, 4), (3, 8)])
@pytest.mark.parametrize("feed", ["host", "device"])
def test_slab_sweep_halo_parity(n_slabs, batch, feed):
    """Halos rebuilt from batch neighbours equal per-slab overlapped reads,
    volume ends padded with the fill (reference ``test_sharded.py``
    ``test_slab_sweep_halo_exchange_parity``)."""
    extent, halo = 6, 2
    rng = np.random.default_rng(n_slabs)
    vol = _f(rng, (n_slabs * extent, 5, 4))
    padded = np.pad(vol, ((halo, halo), (0, 0), (0, 0)), constant_values=1.0)
    ref = np.concatenate([smooth(torch.from_numpy(padded[i * extent:(i + 1) * extent + 2 * halo]))[None].numpy()
                          for i in range(n_slabs)])
    snap = device_pool.snapshot()
    src = vol if feed == "host" else torch.from_numpy(vol)
    got = bs.sharded_slab_sweep(src, smooth, extent=extent, halo=halo, batch=batch, fill=1.0, device="cpu")
    np.testing.assert_array_equal(got, ref)
    moved = device_pool.delta(snap)
    if feed == "host":
        assert moved["h2d_bytes"] > 0 and moved["bytes_not_staged"] == 0
    else:
        assert moved["bytes_not_staged"] > 0 and moved["h2d_bytes"] == 0
    kept = bs.sharded_slab_sweep(torch.from_numpy(vol), smooth, extent=extent, halo=halo, batch=batch, fill=1.0,
                                 keep_on_device=True)
    assert isinstance(kept, torch.Tensor)
    np.testing.assert_array_equal(kept.numpy(), ref)


def test_slab_sweep_refusals():
    vol = np.zeros((20, 4, 4), np.float32)
    with pytest.raises(ValueError, match="multiple of the slab extent"):
        bs.sharded_slab_sweep(vol, smooth, extent=6, halo=1, device="cpu")
    with pytest.raises(ValueError, match="halo"):
        bs.sharded_slab_sweep(vol, smooth, extent=4, halo=5, device="cpu")
    with pytest.raises(ValueError, match="n_ranks"):
        bs.sharded_slab_sweep(vol, smooth, extent=4, halo=1, n_ranks=0, device="cpu")


# -- the executor -------------------------------------------------------------


def _grid(shape=(48, 48, 48), block=(16, 16, 16), halo=(4, 4, 4)):
    blocking = Blocking(shape, block)
    return [blocking.get_block(i, halo=halo) for i in range(blocking.n_blocks)]


def _sweep(vol, blocks, kernel, mode, outer=None, fp=None, **kw):
    out = np.zeros(vol.shape, np.float32)

    def load(b):
        raw = vol[b.outer_bb]
        return (pad_block_to(raw, outer, constant_values=1.0) if outer else raw,)

    def store(b, raw):
        out[b.bb] = np.asarray(raw)[b.inner_in_outer_bb]

    summary = pex.BlockwiseExecutor(target="local", io_threads=4, backoff_base=1e-4).map_blocks(
        kernel, blocks, load, store, failures_path=fp, task_name=f"sweep_{mode}", sweep_mode=mode, **kw)
    return out, summary


def _with_batched(kernel, batched):
    def k(*a):
        return kernel(*a)

    k.batched = batched
    return k


@pytest.mark.parametrize("form", ["lanes", "batched"])
@pytest.mark.parametrize("sharded_batch", [8, 16])
def test_sharded_bit_identical_nonpow2_grid_with_ragged_tail(form, sharded_batch):
    """48^3 volume, 16^3 blocks (a 3^3 grid), halo 4: the 27 blocks end in
    a ragged batch.  The sharded sweep equals the per-block sweep, with a
    kernel that carries a lane-batched form and with one that does not."""
    vol = _f(np.random.default_rng(0), (48, 48, 48))
    blocks = _grid()
    outer = (24, 24, 24)
    kernel = smooth if form == "lanes" else _with_batched(smooth, lambda b: torch.stack([smooth(x) for x in b]))
    ref, s_pb = _sweep(vol, blocks, smooth, "per_block", outer)
    got, s_sh = _sweep(vol, blocks, kernel, "sharded", outer, sharded_batch=sharded_batch)
    np.testing.assert_array_equal(ref, got)
    assert s_pb["sweep_mode"] == "per_block" and s_sh["sweep_mode"] == "sharded"
    n_batches = -(-27 // sharded_batch)
    assert s_sh["n_dispatches"] == n_batches < s_pb["n_dispatches"] == 27
    assert s_sh["blocks_dispatched"] == 27 and s_sh["batches_dispatched"] == n_batches
    assert s_sh["batch_rungs"] == [form] * n_batches
    assert s_sh["ragged_batches"] == 1 and s_sh["lanes_padded"] == n_batches * sharded_batch - 27


def test_auto_resolves_as_the_reference_and_mixed_shapes_pack():
    """``auto`` goes sharded once the sweep fills a batch; unpadded loads
    give mixed-shape lanes, which pack through the paged pool
    (chunk-scale pages) and still equal the per-block sweep for an
    elementwise kernel; ``ragged="off"`` runs them per block
    (``degraded:unsharded``)."""
    vol = _f(np.random.default_rng(1), (20, 20, 20))
    blocks = _grid((20, 20, 20), (8, 8, 8), (2, 2, 2))
    ref, _ = _sweep(vol, blocks, elementwise, "per_block")
    got, s = _sweep(vol, blocks, elementwise, "auto")
    np.testing.assert_array_equal(ref, got)
    assert s["sweep_mode"] == "sharded" and s["ragged_batches"] == s["batches_dispatched"] == 4
    off, s_off = _sweep(vol, blocks, elementwise, "auto", ragged="off")
    np.testing.assert_array_equal(ref, off)
    assert s_off["ragged_batches"] == 0 and s_off["n_unsharded"] == 27
    one, s_one = _sweep(vol, blocks[:1], elementwise, "auto")
    assert s_one["sweep_mode"] == "per_block"


def test_batch_oom_runs_per_block_as_degraded_unsharded(tmp_path):
    """A batch whose call raises (``torch.OutOfMemoryError`` or another
    error) quarantines its blocks at the ``dispatch`` site, as in the
    reference, and the quarantine pass runs them one by one through the
    same kernel, attributed ``degraded:unsharded``."""
    vol = _f(np.random.default_rng(2), (48, 48, 48))
    blocks = _grid()
    outer = (24, 24, 24)
    ref, _ = _sweep(vol, blocks, smooth, "per_block", outer)
    calls = {"n": 0}

    def flaky(b, exc):
        calls["n"] += 1
        if calls["n"] == 1:
            raise exc("injected")
        return torch.stack([smooth(x) for x in b])

    for exc, resolution in ((torch.OutOfMemoryError, "degraded:unsharded"), (RuntimeError, "degraded:unsharded")):
        calls["n"] = 0
        fp = str(tmp_path / f"failures_{exc.__name__}.json")
        got, s = _sweep(vol, blocks, _with_batched(smooth, lambda b, exc=exc: flaky(b, exc)), "sharded", outer,
                        fp=fp, sharded_batch=8)
        np.testing.assert_array_equal(ref, got)
        recs = json.load(open(fp))["records"]
        assert len(recs) == 8 and all(r["resolved"] and r["resolution"] == resolution for r in recs)
        assert all("dispatch" in r["sites"] for r in recs)
        assert s["n_unsharded"] == 8


# -- the device-resident page pool --------------------------------------------


def _pool_sweep(vol, **kw):
    blocks = _grid((20, 20, 20), (8, 8, 8), (2, 2, 2))
    snap = device_pool.snapshot()
    out, summary = _sweep(vol, blocks, elementwise, "sharded", sharded_batch=16, **kw)
    return out, summary, device_pool.delta(snap)


def test_resident_pool_warm_resweep_uploads_nothing_new():
    vol = _f(np.random.default_rng(3), (20, 20, 20))
    ref, _, _ = _pool_sweep(vol, ragged="off", device_pool="off")
    cold, s_cold, d_cold = _pool_sweep(vol)
    np.testing.assert_array_equal(ref, cold)
    assert s_cold["device_pool_resident_bytes"] > 0
    assert d_cold["device_batches_staged"] > 0 and d_cold["device_pool_misses"] > 0
    warm, s_warm, d_warm = _pool_sweep(vol, device_pool="on")
    np.testing.assert_array_equal(ref, warm)
    assert d_warm["device_pool_hits"] > 0 and d_warm["device_pool_misses"] == 0
    assert d_warm["bytes_not_staged"] > 0 and d_warm["h2d_bytes"] < d_cold["h2d_bytes"]
    assert s_warm["h2d_bytes"] == d_warm["h2d_bytes"]


def test_fill_and_repeated_pages_hit_within_one_sweep():
    vol = np.zeros((20, 20, 20), np.float32)
    _, _, d = _pool_sweep(vol)
    assert d["device_pool_hits"] > 0 and d["bytes_not_staged"] > 0


def test_budget_and_kill_switch(tmp_path, monkeypatch):
    vol = _f(np.random.default_rng(4), (20, 20, 20))
    ref, _, _ = _pool_sweep(vol, ragged="off", device_pool="off")
    fp = str(tmp_path / "failures.json")
    small, s, d = _pool_sweep(vol, fp=fp, device_pool_bytes=1024)
    np.testing.assert_array_equal(ref, small)
    assert d["host_staged_fallbacks"] > 0 and d["device_batches_staged"] == 0
    recs = [r for r in json.load(open(fp))["records"] if r["task"] == "sweep_sharded.device_pool"]
    assert len(recs) == 1 and recs[0]["resolution"] == "degraded:host_staged" and recs[0]["sites"] == {"h2d": 1}
    monkeypatch.setenv("CTT_DEVICE_POOL", "0")
    assert not device_pool.device_pool_enabled()
    off, s_off, d_off = _pool_sweep(vol, device_pool="on")
    np.testing.assert_array_equal(ref, off)
    assert d_off["device_batches_staged"] == 0 and s_off["device_pool_resident_bytes"] == 0
    monkeypatch.setenv("CTT_DEVICE_POOL_BYTES", "4096")
    assert device_pool.device_pool_budget() == 4096 and device_pool.device_pool_budget(10) == 10


@pytest.mark.parametrize("persistent", [False, True])
def test_upload_oom_evicts_retries_then_stages_from_host(tmp_path, monkeypatch, persistent):
    """``torch.OutOfMemoryError`` at page upload: evict every arena and
    retry once (a transient error is absorbed there); a persistent one
    stages the batch from the host, attributed ``degraded:host_staged``."""
    vol = _f(np.random.default_rng(5), (20, 20, 20))
    ref, _, _ = _pool_sweep(vol, ragged="off", device_pool="off")
    calls = {"n": 0}
    real = torch.Tensor.index_copy_

    def oom_upload(self, *a, **kw):
        calls["n"] += 1
        if persistent or calls["n"] == 1:
            raise torch.OutOfMemoryError("injected")
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "index_copy_", oom_upload)
    fp = str(tmp_path / "failures.json")
    got, _, d = _pool_sweep(vol, fp=fp)
    np.testing.assert_array_equal(ref, got)
    if persistent:
        assert d["host_staged_fallbacks"] > 0
        recs = json.load(open(fp))["records"]
        assert [r["resolution"] for r in recs] == ["degraded:host_staged"]
    else:
        assert d["host_staged_fallbacks"] == 0 and d["device_batches_staged"] > 0


# -- the JAX package's sharded executor on the same volume ---------------------


def test_sharded_executor_matches_the_reference():
    """The reference's ``BlockwiseExecutor`` (8 virtual devices,
    ``sweep_mode="sharded"``) and the port's, on one seeded volume and one
    elementwise kernel: equal outputs, equal dispatch counts."""
    vol = _f(np.random.default_rng(6), (48, 48, 48))
    blocks = _grid()
    outer = (24, 24, 24)
    got, s = _sweep(vol, blocks, elementwise, "sharded", outer, sharded_batch=8)
    want = np.zeros_like(vol)

    def load(b):
        return (pad_block_to(vol[b.outer_bb], outer, constant_values=1.0),)

    def store(b, raw):
        want[b.bb] = np.asarray(raw)[b.inner_in_outer_bb]

    from cluster_tools_tpu.utils.volume_utils import Blocking as JBlocking

    jb = JBlocking(vol.shape, (16, 16, 16))
    snap = j_ex.dispatch_snapshot()
    j_ex.BlockwiseExecutor(target="local", io_threads=4).map_blocks(
        jax.jit(j_elementwise), [jb.get_block(i, halo=(4, 4, 4)) for i in range(jb.n_blocks)], load, store,
        sweep_mode="sharded", sharded_batch=8, store_verify_fn=None)
    j_disp = j_ex.dispatch_delta(snap)
    np.testing.assert_array_equal(got, want)
    assert s["blocks_dispatched"] == j_disp["blocks_dispatched"] == 27
    assert s["batches_dispatched"] == j_disp["batches_dispatched"]
    assert s["ragged_batches"] == j_disp["ragged_batches"]


def test_device_pool_args_of_one_page_class_stay_intact():
    """Two arguments of one page class share an arena that is updated in
    place: staging the second may not evict a page the first still maps
    (ROADMAP Queue C, C2).  Each argument alone fills an arena of 16
    pages."""
    device_pool.reset()
    pool = device_pool.get_device_pool(budget=1 << 20)
    shape, lanes = (8,), 15
    rng = np.random.default_rng(0)
    specs, pools, tables, valids = [], [], [], []
    for _ in range(2):
        data = np.zeros((16,) + shape, np.int64)
        data[1:] = rng.integers(0, 1 << 40, (lanes,) + shape)
        specs.append(block_pool.RaggedArgSpec((1,), shape, "int64", 0, 16))
        pools.append(data)
        tables.append(np.arange(1, 1 + lanes, dtype=np.int32)[:, None])
        valids.append(np.full((lanes, 1), shape[0], np.int32))
    rb = block_pool.RaggedBatch(specs, pools, tables, valids, n_lanes=lanes, width=lanes, pages_in_use=2 * lanes)
    sb = pool.stage(rb, "cpu")
    for a in range(2):
        got = sb.pools[a][torch.from_numpy(sb.tables[a][:, 0].astype(np.int64))].numpy()
        np.testing.assert_array_equal(got, pools[a][1:], err_msg=f"argument {a}")
    device_pool.reset()
