"""Task-graph fusion in the port (``cluster_tools_tpu_torch/runtime/handoff.py``,
the ``MemoryTarget`` layer of ``runtime/task.py``, ``HandoffDataset``).

The registry and runtime scenarios of the reference's ``tests/test_handoff.py``
run on the port with the same assertions, case for case (the line of the
reference test is named in each docstring).  Here a spill is forced by the
byte budget (``CTT_HANDOFF_BYTES``) or, for a failing storage write, by a
monkeypatched write; the fault injector's forced spills are in
``tests/test_torch_integrity.py``.  A spilled dataset is verified back
against the digest sidecars its write recorded.  Then the port against the JAX package (the cc workflow with
handoffs on, spilled and unspilled), the port's fused multicut chain, and the
executor's admission gate.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from cluster_tools_tpu.runtime import supervision as jsup
from cluster_tools_tpu_torch.io import containers as pcont
from cluster_tools_tpu_torch.io.containers import ChunkCorruptionError, HandoffDataset
from cluster_tools_tpu_torch.parallel import device_pool
from cluster_tools_tpu_torch.runtime import executor as pex
from cluster_tools_tpu_torch.runtime import handoff
from cluster_tools_tpu_torch.runtime import supervision as psup
from cluster_tools_tpu_torch.runtime.task import BaseTask, build
from cluster_tools_tpu_torch.utils import function_utils as fu
from cluster_tools_tpu_torch.utils.volume_utils import Blocking, file_reader


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


torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_registry():
    handoff.reset()
    yield
    handoff.reset()


def _mk_handoff(tmp_path, key="a", shape=(8, 8, 8), chunks=(4, 4, 4), dtype="uint64", producer="prod.0",
                failures_path=None):
    path = os.path.join(str(tmp_path), "data.zarr")
    ds, entry = handoff.acquire_dataset(path, key, shape=shape, chunks=chunks, dtype=dtype, producer=producer,
                                        failures_path=failures_path)
    return path, ds, entry


# -- registry and HandoffDataset ------------------------------------------------


def test_dataset_handoff_resolve_and_storage_parity(tmp_path):
    """Reference :52 (its digest-sidecar check becomes the spill's read-back)."""
    path, ds, entry = _mk_handoff(tmp_path)
    assert isinstance(ds, HandoffDataset)
    block = np.arange(64, dtype=np.uint64).reshape(4, 4, 4)
    ds[0:4, 0:4, 0:4] = block
    snap = handoff.snapshot()
    got = handoff.resolve_dataset(path, "a")
    assert got is ds
    assert handoff.delta(snap)["handoffs_served"] == 1
    np.testing.assert_array_equal(got[0:4, 0:4, 0:4], block)
    assert not os.path.exists(os.path.join(path, "a"))
    ds.verify_region((slice(0, 4),) * 3)
    entry.complete = True
    assert handoff.spill_for_headroom() == 8 * 8 * 8 * 8
    stored = file_reader(path)["a"]
    np.testing.assert_array_equal(np.asarray(stored[0:4, 0:4, 0:4]), block)
    # the old handle delegates to storage
    np.testing.assert_array_equal(ds[0:4, 0:4, 0:4], block)
    snap = handoff.snapshot()
    got = handoff.resolve_dataset(path, "a")
    assert not isinstance(got, HandoffDataset)
    assert handoff.delta(snap)["handoff_fallbacks"] == 1


def test_handoff_dataset_digest_catches_rot_and_overwrites_stay_valid(tmp_path):
    """The in-memory region digests: a flipped byte behind the digest is
    caught, a partial overwrite drops the digest it overlaps."""
    _path, ds, _entry = _mk_handoff(tmp_path)
    ds[0:4, 0:4, 0:4] = np.ones((4, 4, 4), np.uint64)
    ds._arr[0, 0, 0] ^= np.uint64(1)
    with pytest.raises(ChunkCorruptionError):
        ds.verify_region((slice(0, 4),) * 3)
    ds[0:2, 0:2, 0:2] = np.zeros((2, 2, 2), np.uint64)
    ds.verify_region((slice(0, 4),) * 3)  # no digest any more: nothing to hold
    ds.verify_region((slice(0, 2),) * 3)


def test_artifact_publish_serves_readonly_views(tmp_path):
    """Reference :111."""
    p = os.path.join(str(tmp_path), "graph", "block_0.npz")
    src = np.arange(6)
    handoff.publish_arrays(p, {"uv": src}, producer="prod.0")
    assert not os.path.exists(p)
    assert handoff.array_exists(p)
    got = handoff.load_arrays(p)["uv"]
    np.testing.assert_array_equal(got, src)
    with pytest.raises(ValueError):
        got[0] = 99
    src[0] = 42
    np.testing.assert_array_equal(handoff.load_arrays(p)["uv"][:1], [0])


def test_artifact_spill_is_crc_verified_on_fallback(tmp_path, monkeypatch):
    """Reference :127, the spill forced by the byte budget."""
    p = os.path.join(str(tmp_path), "costs.npy")
    monkeypatch.setenv("CTT_HANDOFF_BYTES", "1")
    entry = handoff.publish_arrays(p, {"data": np.arange(5.0)}, producer="prod.0")
    assert entry.spilled and os.path.exists(p)
    monkeypatch.delenv("CTT_HANDOFF_BYTES")
    snap = handoff.snapshot()
    np.testing.assert_array_equal(handoff.load_array(p), np.arange(5.0))
    assert handoff.delta(snap)["handoff_fallbacks"] == 1
    arr = np.load(p)
    arr[0] = 123.0
    np.save(p, arr)
    with pytest.raises(ChunkCorruptionError):
        handoff.load_array(p)


def test_budget_admission_spills_at_birth(tmp_path, monkeypatch):
    """Reference :181, with the reference's :148 attribution checks on the
    budget's spill."""
    failures = os.path.join(str(tmp_path), "failures.json")
    monkeypatch.setenv("CTT_HANDOFF_BYTES", "128")  # 8^3 uint64 >> 128
    path, ds, entry = _mk_handoff(tmp_path, producer="watershed.x", failures_path=failures)
    assert not isinstance(ds, HandoffDataset)
    assert entry.spilled and entry.spill_reason.startswith("admission")
    ds[0:4, 0:4, 0:4] = np.ones((4, 4, 4), np.uint64)
    assert handoff.live_bytes() == 0

    class _T:
        pass

    t = _T()
    t.entry = entry
    recs = handoff.finalize_task([t], "watershed.x")
    assert recs == [{"identity": entry.identity, "path": path, "key": "a", "kind": "dataset", "stored": True,
                     "bytes": entry.nbytes}]
    with open(failures) as f:
        frecs = json.load(f)["records"]
    assert any(r["resolution"] == "degraded:spilled" and r["sites"] == {"spill": 1}
               and r["task"] == "watershed.x.handoff" for r in frecs)


def test_spilled_predecessor_forces_write_through(tmp_path):
    """Reference :191."""
    path, ds, entry = _mk_handoff(tmp_path)
    ds[0:4, 0:4, 0:4] = np.full((4, 4, 4), 7, np.uint64)
    entry.complete = True
    handoff.spill_for_headroom()
    ds2, entry2 = handoff.acquire_dataset(path, "a", shape=(8, 8, 8), chunks=(4, 4, 4), dtype="uint64",
                                          producer="pass2.0")
    assert entry2 is entry and not isinstance(ds2, HandoffDataset)
    np.testing.assert_array_equal(np.asarray(ds2[0:2, 0:2, 0:2]), np.full((2, 2, 2), 7, np.uint64))


def test_concurrent_region_writes_lose_no_update(tmp_path):
    """16 threads (more than the cores) write disjoint regions of one
    HandoffDataset under a short switch interval: every region's digest
    verifies, and the bytes counted not stored are exactly those written."""
    import sys

    shape, n_threads = (16, 16, 64), 16
    _path, ds, entry = _mk_handoff(tmp_path, shape=shape, chunks=(4, 4, 4), dtype="uint64")
    snap = handoff.snapshot()
    boxes = [(slice(z, z + 4), slice(y, y + 4), slice(x, x + 4))
             for z in range(0, 16, 4) for y in range(0, 16, 4) for x in range(0, 64, 4)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(k, len(boxes), n_threads):
                ds[boxes[i]] = np.full((4, 4, 4), i + 1, np.uint64)

        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    written = len(boxes) * 64 * 8
    assert ds.not_stored_bytes == written
    assert handoff.delta(snap)["bytes_not_stored"] == written
    for i, bb in enumerate(boxes):
        ds.verify_region(bb)
        assert (ds[bb] == i + 1).all()
    entry.complete = True
    assert handoff.spill_for_headroom() == int(np.prod(shape)) * 8
    assert handoff.delta(snap)["bytes_not_stored"] == 0


# -- task integration: markers, manifests, resume --------------------------------


class _HandoffProducer(BaseTask):
    """One handoff dataset, one block marker."""

    task_name = "ho_producer"

    def run_impl(self):
        cfg = self.get_config()
        out = self.handoff_dataset(cfg["output_path"], cfg["output_key"], shape=(4, 4), chunks=(4, 4),
                                   dtype="uint64")
        if 0 not in set(self.blocks_done()):
            out[0:4, 0:4] = np.arange(16, dtype=np.uint64).reshape(4, 4)
            if isinstance(out, HandoffDataset):
                out.verify_region((slice(0, 4), slice(0, 4)))
            self.log_block_success(0)
        return {"n_blocks": 1}


def _producer(tmp_path, **params):
    cdir = os.path.join(str(tmp_path), "config")
    os.makedirs(cdir, exist_ok=True)
    with open(os.path.join(cdir, "global.config"), "w") as f:
        json.dump({"memory_handoffs": True}, f)
    return _HandoffProducer(tmp_folder=os.path.join(str(tmp_path), "tmp"), config_dir=cdir,
                            output_path=os.path.join(str(tmp_path), "out.zarr"), output_key="x", **params)


def test_manifest_records_memory_target_and_complete_contract(tmp_path):
    """Reference :250."""
    task = _producer(tmp_path)
    assert build([task])
    doc = task.output().read()
    assert doc["handoffs"] == [{
        "identity": handoff.dataset_identity(os.path.join(str(tmp_path), "out.zarr"), "x"),
        "path": os.path.join(str(tmp_path), "out.zarr"), "key": "x", "kind": "dataset", "stored": False,
        "bytes": 128,
    }]
    with open(fu.io_metrics_path(task.tmp_folder)) as f:
        metrics = json.load(f)["tasks"][task.uid]
    assert metrics["handoffs_published"] == 1
    assert metrics["bytes_not_stored"] == 128
    assert task.complete()
    handoff.reset()  # a new process: the registry is gone
    fresh = _producer(tmp_path)
    assert not fresh.complete()
    assert fresh.blocks_done() == []
    assert not fresh.output().exists()
    assert build([fresh])
    assert handoff.is_live(fresh._memory_targets[0].identity)


def test_spilled_manifest_stays_complete_across_restart(tmp_path, monkeypatch):
    """Reference :282, the spill forced by the byte budget."""
    monkeypatch.setenv("CTT_HANDOFF_BYTES", "1")
    task = _producer(tmp_path)
    assert build([task])
    assert task.output().read()["handoffs"][0]["stored"] is True
    handoff.reset()
    monkeypatch.delenv("CTT_HANDOFF_BYTES")
    fresh = _producer(tmp_path)
    assert fresh.complete()
    ds = handoff.resolve_dataset(os.path.join(str(tmp_path), "out.zarr"), "x")
    np.testing.assert_array_equal(np.asarray(ds[0:4, 0:4]), np.arange(16, dtype=np.uint64).reshape(4, 4))


def _stamp_foreign_process(task):
    path = handoff._sentinel_path(task.tmp_folder, task.uid)
    fu.atomic_write_json(path, {"token": "999999.deadbeefdead"})


def test_stale_markers_cleared_for_foreign_memory_runs(tmp_path):
    """Reference :313."""
    task = _producer(tmp_path)
    assert build([task])
    assert task.blocks_done() == [0]
    task2 = _producer(tmp_path)
    task2.handoff_dataset(os.path.join(str(tmp_path), "out.zarr"), "x", shape=(4, 4), chunks=(4, 4),
                          dtype="uint64")
    assert task2.blocks_done() == [0]
    _stamp_foreign_process(task2)
    task3 = _producer(tmp_path)
    assert task3.blocks_done() == []


def test_stale_markers_cleared_even_when_rerun_spills_at_birth(tmp_path, monkeypatch):
    """Reference :333."""
    task = _producer(tmp_path)
    assert build([task])
    handoff.reset()
    _stamp_foreign_process(task)
    monkeypatch.setenv("CTT_HANDOFF_BYTES", "16")
    t2 = _producer(tmp_path)
    ds = t2.handoff_dataset(os.path.join(str(tmp_path), "out.zarr"), "x", shape=(4, 4), chunks=(4, 4),
                            dtype="uint64")
    assert not isinstance(ds, HandoffDataset)
    assert t2.blocks_done() == []
    _stamp_foreign_process(task)
    fu.log_block_success(task.tmp_folder, task.uid, 0)
    monkeypatch.setenv("CTT_HANDOFF", "0")
    t3 = _producer(tmp_path)
    assert t3.blocks_done() == []


def test_failed_spill_retry_reflushes_every_region(tmp_path, monkeypatch):
    """Reference :363, the first storage write failing through a
    monkeypatched zarr write instead of the fault injector."""
    path, ds, entry = _mk_handoff(tmp_path)
    block = np.arange(64, dtype=np.uint64).reshape(4, 4, 4)
    ds[0:4, 0:4, 0:4] = block
    ds[4:8, 4:8, 4:8] = block + 100
    entry.complete = True
    real = pcont.ZarrDataset.__setitem__
    calls = {"n": 0}

    def failing_once(self, bb, value):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("storage write failed")
        return real(self, bb, value)

    monkeypatch.setattr(pcont.ZarrDataset, "__setitem__", failing_once)
    assert handoff.spill_for_headroom() == 0
    assert not entry.spilled and entry.obj is not None
    assert handoff.spill_for_headroom() == 8 * 8 * 8 * 8
    stored = file_reader(path)["a"]
    np.testing.assert_array_equal(np.asarray(stored[0:4, 0:4, 0:4]), block)
    np.testing.assert_array_equal(np.asarray(stored[4:8, 4:8, 4:8]), block + 100)


def test_spill_read_back_mismatch_keeps_the_memory_copy(tmp_path, monkeypatch):
    """A stored chunk that reads back unlike the in-memory bytes fails the
    spill's verification against its sidecar: the entry stays live and
    serves the right bytes."""
    path, ds, entry = _mk_handoff(tmp_path)
    ds[0:4, 0:4, 0:4] = np.full((4, 4, 4), 3, np.uint64)
    entry.complete = True
    real = pcont.ZarrDataset._read_back
    monkeypatch.setattr(pcont.ZarrDataset, "_read_back", lambda self, bb: real(self, bb) + np.uint64(1))
    assert handoff.spill_for_headroom() == 0
    assert not entry.spilled and handoff.resolve_dataset(path, "a") is ds
    np.testing.assert_array_equal(ds[0:4, 0:4, 0:4], np.full((4, 4, 4), 3, np.uint64))


def test_restart_fallback_loads_are_crc_verified(tmp_path, monkeypatch):
    """Reference :389, the spill forced by the byte budget."""
    p = os.path.join(str(tmp_path), "table.npy")
    monkeypatch.setenv("CTT_HANDOFF_BYTES", "1")
    handoff.publish_arrays(p, {"data": np.arange(7.0)}, producer="x.0")
    monkeypatch.delenv("CTT_HANDOFF_BYTES")
    handoff.reset()
    snap = handoff.snapshot()
    np.testing.assert_array_equal(handoff.load_array(p), np.arange(7.0))
    assert handoff.delta(snap)["handoff_fallbacks"] == 1
    arr = np.load(p)
    arr[2] = -1.0
    np.save(p, arr)
    with pytest.raises(ChunkCorruptionError):
        handoff.load_array(p)


def test_post_manifest_spill_keeps_producer_complete(tmp_path):
    """Reference :411."""
    task = _producer(tmp_path)
    assert build([task])
    assert task.complete()
    assert handoff.spill_for_headroom() > 0
    fresh = _producer(tmp_path)
    assert fresh.complete()
    ds = handoff.resolve_dataset(os.path.join(str(tmp_path), "out.zarr"), "x")
    np.testing.assert_array_equal(np.asarray(ds[0:4, 0:4]), np.arange(16, dtype=np.uint64).reshape(4, 4))


def test_admission_spills_only_until_new_target_fits(tmp_path, monkeypatch):
    """Reference :431."""
    monkeypatch.setenv("CTT_HANDOFF_BYTES", "3000")
    ea, eb, ec = [handoff.publish_arrays(os.path.join(str(tmp_path), f"{n}.npy"), {"data": np.zeros(150)},
                                         producer=f"{n}.0") for n in "abc"]
    assert ea.spilled and not eb.spilled
    assert not ec.spilled and ec.obj is not None


def test_knob_off_rerun_overrides_stale_live_payloads(tmp_path, monkeypatch):
    """Reference :447, the artifact's spill forced by the byte budget."""
    p = os.path.join(str(tmp_path), "costs.npy")
    task = _producer(tmp_path)
    assert build([task])
    monkeypatch.setenv("CTT_HANDOFF_BYTES", "1")
    task.save_handoff_array(p, np.arange(3.0))  # spilled: file + sidecar
    monkeypatch.delenv("CTT_HANDOFF_BYTES")
    t2 = _producer(tmp_path)
    with open(os.path.join(str(tmp_path), "config", "global.config"), "w") as f:
        json.dump({"memory_handoffs": False}, f)
    ds = t2.handoff_dataset(os.path.join(str(tmp_path), "out.zarr"), "x", shape=(4, 4), chunks=(4, 4),
                            dtype="uint64")
    assert not isinstance(ds, HandoffDataset)
    ds[0:4, 0:4] = np.full((4, 4), 9, np.uint64)
    got = handoff.resolve_dataset(os.path.join(str(tmp_path), "out.zarr"), "x")
    np.testing.assert_array_equal(np.asarray(got[0:4, 0:4]), np.full((4, 4), 9, np.uint64))
    t2.save_handoff_array(p, np.arange(5.0))
    np.testing.assert_array_equal(handoff.load_array(p), np.arange(5.0))


def test_spill_reconciles_bytes_not_stored(tmp_path):
    """Reference :483."""
    snap = handoff.snapshot()
    _path, ds, entry = _mk_handoff(tmp_path)
    ds[0:4, 0:4, 0:4] = np.ones((4, 4, 4), np.uint64)
    assert handoff.delta(snap)["bytes_not_stored"] == 512
    entry.complete = True
    assert handoff.spill_for_headroom() > 0
    d = handoff.delta(snap)
    assert d["bytes_not_stored"] == 0 and d["bytes_spilled"] > 0


def test_reacquire_waits_out_inflight_spill(tmp_path):
    """Reference :496."""
    path, ds, entry = _mk_handoff(tmp_path)
    ds[0:4, 0:4, 0:4] = np.full((4, 4, 4), 5, np.uint64)
    entry.complete = True
    reg = handoff.get_registry()
    assert reg.claim_spill(entry)

    def _finish():
        time.sleep(0.1)
        assert entry.obj.spill() > 0
        reg.finish_spill(entry, ok=True, reason="headroom")

    th = threading.Thread(target=_finish)
    th.start()
    ds2, entry2 = handoff.acquire_dataset(path, "a", shape=(8, 8, 8), chunks=(4, 4, 4), dtype="uint64",
                                          producer="p2.0")
    th.join()
    assert entry2 is entry
    assert not isinstance(ds2, HandoffDataset)
    np.testing.assert_array_equal(np.asarray(ds2[0:4, 0:4, 0:4]), np.full((4, 4, 4), 5, np.uint64))


def test_spill_claim_is_exclusive(tmp_path):
    """Reference :531."""
    _path, _ds, entry = _mk_handoff(tmp_path)
    reg = handoff.get_registry()
    assert not reg.claim_spill(entry)
    entry.complete = True
    assert reg.claim_spill(entry)
    assert not reg.claim_spill(entry)
    assert not entry.spilled
    assert handoff.spill_for_headroom() == 0
    reg.finish_spill(entry, ok=False, reason="headroom")
    assert not entry.spilled and entry.obj is not None
    assert reg.claim_spill(entry)
    reg.finish_spill(entry, ok=True, reason="headroom")
    assert entry.spilled and entry.obj is None


# -- the device rung (reference tests/test_device_plane.py; on the CPU the
# "device" tensors are CPU tensors) -----------------------------------------------


@pytest.fixture
def fresh_pool():
    device_pool.reset()
    yield
    device_pool.reset()


def test_publish_oom_falls_to_memory_rung(tmp_path, monkeypatch, fresh_pool):
    """Reference test_device_plane.py:274, the out-of-memory error raised by
    a monkeypatch instead of the fault injector."""
    payload = torch.arange(32.0).reshape(4, 8)
    want = payload.numpy().copy()

    def oom(*_a, **_k):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(device_pool, "device_pool_budget", oom)
    fp = str(tmp_path / "failures.json")
    path = str(tmp_path / "probs.npz")
    snap = device_pool.snapshot()
    entry = handoff.publish_device_arrays(path, {"x": payload}, producer="prod.0", failures_path=fp)
    assert entry.kind == "arrays"
    d = device_pool.delta(snap)
    assert d["host_staged_fallbacks"] == 1
    assert d["d2h_bytes"] == want.nbytes
    np.testing.assert_array_equal(np.asarray(handoff.resolve_device_arrays(path)["x"]), want)
    recs = [r for r in json.load(open(fp))["records"] if r["task"] == "prod.0.device_handoff"]
    assert len(recs) == 1
    assert recs[0]["sites"] == {"publish": 1}
    assert recs[0]["resolution"] == "degraded:host_staged"
    assert recs[0]["reason"] == "oom"


def test_device_budget_demotes_oldest_to_memory_rung(tmp_path, monkeypatch, fresh_pool):
    """Reference test_device_plane.py:309."""
    a = torch.arange(1024.0)  # 4 KiB
    b = torch.arange(1024.0) * 2
    monkeypatch.setenv("CTT_DEVICE_POOL_BYTES", str(6 * 1024))
    pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    snap = handoff.snapshot()
    dsnap = device_pool.snapshot()
    ea = handoff.publish_device_arrays(pa, {"x": a}, producer="p.0")
    assert ea.kind == "device_arrays"
    eb = handoff.publish_device_arrays(pb, {"x": b}, producer="p.0")
    assert eb.kind == "device_arrays"
    assert ea.kind == "arrays"
    assert ea.device_crcs is not None
    assert handoff.delta(snap)["device_handoffs_demoted"] == 1
    assert device_pool.delta(dsnap)["d2h_bytes"] >= 4096
    np.testing.assert_array_equal(np.asarray(handoff.resolve_device_arrays(pa)["x"]), a.numpy())
    np.testing.assert_array_equal(np.asarray(handoff.resolve_device_arrays(pb)["x"]), b.numpy())


def test_host_consumer_demotes_device_entry(tmp_path, fresh_pool):
    """Reference test_device_plane.py:334."""
    path = str(tmp_path / "h.npz")
    handoff.publish_device_arrays(path, {"x": torch.arange(8.0)}, producer="p.0")
    got = handoff.load_arrays(path)
    assert isinstance(got["x"], np.ndarray)
    assert not got["x"].flags.writeable
    np.testing.assert_array_equal(got["x"], np.arange(8.0))
    entry = handoff.get_registry().get(handoff.artifact_identity(path))
    assert entry.kind == "arrays" and entry.device_crcs is not None


def test_demoted_entry_spills_with_crc_verified(tmp_path, fresh_pool):
    """Reference test_device_plane.py:348."""
    path = str(tmp_path / "h.npz")
    handoff.publish_device_arrays(path, {"x": torch.arange(8.0)}, producer="p.0")
    handoff.load_arrays(path)
    entry = handoff.get_registry().get(handoff.artifact_identity(path))
    freed = handoff._spill_entry(entry, "test")
    assert freed == entry.nbytes and entry.spilled
    sidecar = json.load(open(path + ".crc.json"))
    assert sidecar["arrays"]["x"] == entry.device_crcs["x"]
    handoff.reset()
    np.testing.assert_array_equal(handoff.load_arrays(path)["x"], np.arange(8.0))
    with pytest.raises(ChunkCorruptionError):
        handoff._write_artifact(str(tmp_path / "rot.npz"), {"x": np.arange(8.0)},
                                expected_crcs={"x": entry.device_crcs["x"] ^ 1})


class _DeviceProducer(BaseTask):
    """Computes on the task's device and publishes on the device rung."""

    task_name = "dev_producer"

    def run_impl(self):
        cfg = self.get_config()
        x = torch.arange(4096, dtype=torch.float32, device=self.device).reshape(16, 16, 16)
        probs = torch.tanh(x * 1e-3) + 0.125
        self.save_handoff_device_arrays(cfg["handoff_path"], probs=probs)
        self.log_block_success(0)
        return {"n_blocks": 1}


class _DeviceConsumer(BaseTask):
    """Resolves the payload (the device rung when live), runs the slab
    sweep on it where it lies, and writes the terminal output."""

    task_name = "dev_consumer"

    def run_impl(self):
        from cluster_tools_tpu_torch.parallel.batch_shard import sharded_slab_sweep

        cfg = self.get_config()
        got = handoff.resolve_device_arrays(cfg["handoff_path"])["probs"]
        vol = got if isinstance(got, torch.Tensor) else np.array(got)
        out = sharded_slab_sweep(vol, lambda x: torch.sqrt(x[:, 1:-1]) * 3, 4, 1, batch=2, keep_on_device=True,
                                 device=self.device)
        np.save(cfg["final_path"], out.cpu().numpy())
        self.log_block_success(0)
        return {"n_blocks": 1}


def _run_fused(tmp_path, sub, device_handoffs=True):
    base = os.path.join(str(tmp_path), sub)
    cdir = os.path.join(base, "config")
    os.makedirs(cdir, exist_ok=True)
    with open(os.path.join(cdir, "global.config"), "w") as f:
        json.dump({"memory_handoffs": True, "device_handoffs": device_handoffs}, f)
    kw = dict(tmp_folder=os.path.join(base, "tmp"), config_dir=cdir, handoff_path=os.path.join(base, "probs.npz"),
              final_path=os.path.join(base, "final.npy"))
    prod, cons = _DeviceProducer(**kw), _DeviceConsumer(**kw)
    assert build([prod])
    assert build([cons])
    return prod, cons, np.load(kw["final_path"])


def test_fused_workflow_zero_intermediate_host_bytes(tmp_path, monkeypatch, fresh_pool):
    """Reference test_device_plane.py:459 (its trace-event checks wait for
    item 11): producer -> consumer through the device rung with no
    intermediate host byte, the payload feeding ``sharded_slab_sweep``
    without an upload, equal to the ``CTT_DEVICE_POOL=0`` twin."""
    snap = device_pool.snapshot()
    prod, cons, final = _run_fused(tmp_path, "dev")
    d = device_pool.delta(snap)
    assert d["device_handoffs_served"] == 1
    assert d["bytes_not_staged"] > 0
    assert d["d2h_bytes"] == 0
    assert d["h2d_bytes"] == 0
    with open(fu.io_metrics_path(prod.tmp_folder)) as f:
        tasks = json.load(f)["tasks"]
    assert tasks[prod.uid]["device_handoffs_published"] == 1
    assert tasks[prod.uid]["bytes_not_stored"] > 0
    assert tasks[cons.uid]["device_handoffs_served"] == 1
    assert tasks[cons.uid]["bytes_not_staged"] > 0
    device_pool.reset()
    handoff.reset()
    monkeypatch.setenv("CTT_DEVICE_POOL", "0")
    _, _, final_host = _run_fused(tmp_path, "host")
    assert np.array_equal(final, final_host)


def test_task_device_knob_gates_rung(tmp_path, fresh_pool):
    """Reference test_device_plane.py:503."""
    base = os.path.join(str(tmp_path), "gated")
    cdir = os.path.join(base, "config")
    os.makedirs(cdir, exist_ok=True)
    with open(os.path.join(cdir, "global.config"), "w") as f:
        json.dump({"memory_handoffs": True}, f)
    prod = _DeviceProducer(tmp_folder=os.path.join(base, "tmp"), config_dir=cdir,
                           handoff_path=os.path.join(base, "probs.npz"), final_path=os.path.join(base, "final.npy"))
    assert build([prod])
    entry = handoff.get_registry().get(handoff.artifact_identity(os.path.join(base, "probs.npz")))
    assert entry is not None and entry.kind == "arrays"


# -- the executor's admission gate -------------------------------------------------


def _sweep_into(ds, vol, blocking, mode, **kw):
    blocks = [blocking.get_block(i) for i in range(blocking.n_blocks)]

    def store(b, raw):
        ds[b.bb] = np.asarray(raw)

    return pex.BlockwiseExecutor(target="local", io_threads=4).map_blocks(
        lambda x: x * 2 + 1, blocks, lambda b: (vol[b.bb],), store, sweep_mode=mode, sharded_batch=8, **kw)


def test_executor_budget_subtracts_live_handoffs(tmp_path, monkeypatch):
    """Reference :671, and the budget the sweep then runs under: a quarter
    of MemAvailable less the chunk cache's budget (while the cache is on),
    then less the live handoff bytes, each floored at a quarter of it."""
    from cluster_tools_tpu_torch.io import chunk_cache

    _path, ds, _entry = _mk_handoff(tmp_path, shape=(32, 32, 32))
    assert handoff.live_bytes() == 32 ** 3 * 8
    assert handoff.spill_for_headroom() == 0  # only complete entries spill
    assert handoff.live_bytes() == 32 ** 3 * 8
    monkeypatch.setattr(pex, "host_mem_available_bytes", lambda: 1_000_000)
    blocking = Blocking((16,), (4,))
    vol = np.arange(16, dtype=np.float32)
    sink = np.zeros(16, np.float32)
    chunk_cache.configure(max_bytes=100_000)
    try:
        after_cache = max(250_000 - 100_000, 250_000 // 4)
        summary = _sweep_into(sink, vol, blocking, "per_block")
        assert summary["inflight_byte_budget"] == max(after_cache - 32 ** 3 * 8, after_cache // 4)
        monkeypatch.setenv("CTT_CHUNK_CACHE", "0")
        summary = _sweep_into(sink, vol, blocking, "per_block")
        assert summary["inflight_byte_budget"] == max(250_000 - 32 ** 3 * 8, 250_000 // 4)
        handoff.reset()
        assert _sweep_into(sink, vol, blocking, "per_block")["inflight_byte_budget"] == 250_000
        monkeypatch.setenv("CTT_CHUNK_CACHE", "1")
        assert _sweep_into(sink, vol, blocking, "per_block")["inflight_byte_budget"] == after_cache
        assert _sweep_into(sink, vol, blocking, "per_block", inflight_byte_budget=0)["inflight_byte_budget"] == 0
    finally:
        chunk_cache.configure()


@pytest.mark.parametrize("mode", ["per_block", "sharded"])
def test_gate_drains_stores_into_a_handoff_dataset(tmp_path, monkeypatch, mode):
    """A sweep of 16 blocks (two sharded batches of 8) storing into a
    HandoffDataset under a budget smaller than one block: every dispatch
    first drains the pending stores, nothing deadlocks, and the output
    equals the unbudgeted one.  Low host memory flushes a completed elder
    handoff to storage before the sweep proceeds."""
    shape, bshape = (16, 16, 32), (8, 8, 8)
    vol = np.random.default_rng(0).random(shape).astype(np.float32)
    blocking = Blocking(shape, bshape)
    want = np.zeros(shape, np.float32)
    _sweep_into(want, vol, blocking, "per_block", inflight_byte_budget=0)
    elder_path, elder, elder_entry = _mk_handoff(tmp_path, key="elder", shape=(4, 4, 4), dtype="float32")
    elder[...] = np.ones((4, 4, 4), np.float32)
    elder_entry.complete = True
    path = os.path.join(str(tmp_path), "data.zarr")
    ds, _entry = handoff.acquire_dataset(path, "out", shape=shape, chunks=bshape, dtype="float32", producer="sweep.0")
    assert isinstance(ds, HandoffDataset)
    monkeypatch.setattr(pex, "host_mem_available_fraction", lambda: 0.01)
    summary = _sweep_into(ds, vol, blocking, mode, inflight_byte_budget=64)
    assert summary["n_blocks"] == 16 and summary["n_backpressure_waits"] > 0
    assert summary["sweep_mode"] == mode
    np.testing.assert_array_equal(ds[...], want)
    assert elder_entry.spilled  # flushed for headroom
    np.testing.assert_array_equal(file_reader(elder_path)["elder"][...], np.ones((4, 4, 4), np.float32))
    assert not _entry.spilled  # the sweep's own target is still being written


def test_out_of_memory_block_waits_for_headroom_and_resolves(tmp_path):
    """A block whose kernel runs out of memory is re-run after the headroom
    wait, attributed ``degraded:backpressure``."""
    blocking = Blocking((16,), (4,))
    blocks = [blocking.get_block(i) for i in range(blocking.n_blocks)]
    out = np.zeros(16, np.float32)
    seen = set()

    def kernel(x):
        if float(x[0]) == 8.0 and 8.0 not in seen:
            seen.add(8.0)
            raise MemoryError("host allocator failed")
        return x + 1

    def store(b, raw):
        out[b.bb] = np.asarray(raw)

    fp = str(tmp_path / "failures.json")
    summary = pex.BlockwiseExecutor(target="local").map_blocks(
        kernel, blocks, lambda b: (np.arange(16, dtype=np.float32)[b.bb],), store, sweep_mode="per_block",
        failures_path=fp, degrade_wait_s=0.05)
    np.testing.assert_array_equal(out, np.arange(16, dtype=np.float32) + 1)
    assert summary["n_quarantined"] == 1
    rec = [r for r in json.load(open(fp))["records"] if r["block_id"] == 2]
    assert rec and rec[0]["resolution"] == "degraded:backpressure" and rec[0]["resource"] == "oom"


class _Stop(Exception):
    pass


def _task_sites(tmp_path):
    """The five map_blocks sites of the reference that pass
    ``inflight_byte_budget``: (task class, params)."""
    from cluster_tools_tpu_torch.tasks import connected_components as cc
    from cluster_tools_tpu_torch.tasks import ilastik as il
    from cluster_tools_tpu_torch.tasks import inference as inf
    from cluster_tools_tpu_torch.tasks import watershed as ws

    path = f"memory://sites-{tmp_path.name}"
    src = file_reader(path).require_dataset("x", shape=(16, 16, 16), chunks=(8, 8, 8), dtype="float32")
    src[...] = np.random.default_rng(0).random((16, 16, 16)).astype(np.float32)
    io = dict(input_path=path, input_key="x", output_path=path, block_shape=[8, 8, 8])
    return [
        (ws.WatershedLocal, dict(io, output_key="ws", threshold=0.5, halo=[2, 2, 2], pass_parity=0)),
        (ws.TwoPassWatershedLocal, dict(io, output_key="ws", threshold=0.5, halo=[2, 2, 2])),
        (cc.BlockComponentsLocal, dict(io, output_key="cc", threshold=0.5)),
        (inf.InferenceLocal, dict(io, output_key="pred", halo=[0, 0, 0])),
        (il.IlastikPredictionLocal, dict(io, output_key="probs", checkpoint_path="unused.npz")),
    ]


def test_inflight_budget_reaches_map_blocks_from_the_five_sites(tmp_path, monkeypatch):
    from cluster_tools_tpu_torch.tasks import ilastik as il
    from cluster_tools_tpu_torch.tasks import inference as inf

    monkeypatch.setattr(inf, "build_model", lambda cfg, dev: torch.nn.Identity())
    monkeypatch.setattr(il, "load_classifier", lambda path, dev: {"n_classes": 2})
    seen = []

    def capture(self, *args, **kwargs):
        seen.append((kwargs.get("inflight_byte_budget"), kwargs.get("degrade_wait_s")))
        raise _Stop

    monkeypatch.setattr(pex.BlockwiseExecutor, "map_blocks", capture)
    sites = _task_sites(tmp_path)
    os.makedirs(tmp_path / "cfg")
    for i, (cls, params) in enumerate(sites):
        task = cls(tmp_folder=str(tmp_path / f"tmp{i}"), config_dir=str(tmp_path / "cfg"),
                   inflight_byte_budget=12345 + i, degrade_wait_s=0.5, **params)
        with pytest.raises(_Stop):
            task.run_impl()
    assert seen == [(12345 + i, 0.5) for i in range(len(sites))]


# -- the port against the JAX package: cc with handoffs on ---------------------------

HANDOFF_KEYS = ("handoffs_published", "handoffs_served", "handoff_fallbacks", "bytes_not_stored", "handoffs_spilled",
                "bytes_spilled")


def _cc_run(side, root, data, env):
    """The cc workflow of one package with handoffs on; returns the labels,
    the per-task handoff counters and manifest records, and the spill
    records of failures.json (identities relative to the run's folder)."""
    if side == "jax":
        from cluster_tools_tpu.runtime import handoff as h
        from cluster_tools_tpu.runtime.task import build as run
        from cluster_tools_tpu.tasks.connected_components import ConnectedComponentsWorkflow as CC
        from cluster_tools_tpu.utils.volume_utils import file_reader as reader
    else:
        h, run, reader = handoff, build, file_reader
        from cluster_tools_tpu_torch.tasks.connected_components import ConnectedComponentsWorkflow as CC
    d = os.path.join(root, side)
    os.makedirs(os.path.join(d, "cfg"))
    with open(os.path.join(d, "cfg", "global.config"), "w") as f:
        json.dump({"block_shape": [8, 8, 8], "memory_handoffs": True}, f)
    path = os.path.join(d, "data.zarr")
    reader(path).require_dataset("x", shape=data.shape, chunks=(8, 8, 8), dtype="float32")[...] = data
    tmp = os.path.join(d, "tmp")
    h.reset()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        # one IO thread: both packages keep one degraded:spilled record a
        # producer task (keyed by task and block_id None), the last spill to
        # land, which concurrent stores would make a race
        wf = CC(tmp_folder=tmp, config_dir=os.path.join(d, "cfg"), max_jobs=1, target="local", input_path=path,
                input_key="x", output_path=path, output_key="cc", block_shape=[8, 8, 8], threshold=0.5)
        assert run([wf]), side
    labels = np.asarray(reader(path)["cc"][...])
    h.reset()
    rel = lambda s: None if s is None else str(s).replace(d, "<run>")  # noqa: E731
    with open(os.path.join(tmp, "io_metrics.json")) as f:
        counters = {uid.split(".")[0]: {k: int(m.get(k, 0)) for k in HANDOFF_KEYS}
                    for uid, m in json.load(f)["tasks"].items()}
    records = {}
    for fname in sorted(os.listdir(tmp)):
        if fname.endswith(".success.json"):
            doc = json.load(open(os.path.join(tmp, fname)))
            records[fname.split(".")[0]] = sorted(
                (r["kind"], r["stored"], r["bytes"], rel(r["identity"]), rel(r["path"]), r["key"])
                for r in doc.get("handoffs", []))
    spills = []
    if os.path.exists(os.path.join(tmp, "failures.json")):
        spills = sorted((r["task"].split(".")[0], r["resolution"], json.dumps(r["sites"]), r["reason"],
                         rel(r["handoff"])) for r in json.load(open(os.path.join(tmp, "failures.json")))["records"])
    return labels, counters, records, spills


@pytest.fixture(scope="module")
def cc_runs(tmp_path_factory):
    """Both packages' cc at 16^3 (block 8^3) with handoffs on, unspilled and
    spilled at birth (``CTT_HANDOFF_BYTES=1``), the reference's mode env pinned."""
    from cluster_tools_tpu.runtime import faults

    faults.configure(None)
    x = ndi.gaussian_filter(np.random.default_rng(5).random((16, 16, 16)), 1.5)
    data = ((x - x.min()) / (x.max() - x.min())).astype(np.float32)
    modes = {"CT_TIER_MODE": "cond", "CT_FILL_MODE": "capacity", "CT_SEED_CCL": "tiled"}
    out = {}
    for case, extra in (("memory", {}), ("spilled", {"CTT_HANDOFF_BYTES": "1"})):
        root = str(tmp_path_factory.mktemp(f"cc-{case}"))
        out[case] = {side: _cc_run(side, root, data, dict(modes, **extra)) for side in ("jax", "port")}
    return out


@pytest.mark.parametrize("case", ["memory", "spilled"])
def test_cc_handoffs_equal_the_jax_package(cc_runs, case):
    jl, jc, jr, js = cc_runs[case]["jax"]
    pl, pc, pr, ps = cc_runs[case]["port"]
    np.testing.assert_array_equal(pl, jl)
    assert pl.max() > 0
    assert pc == jc
    assert pr == jr
    assert ps == js
    if case == "memory":
        assert all(c["handoffs_spilled"] == 0 for c in pc.values())
        assert sum(c["handoffs_served"] for c in pc.values()) > 0
        assert not ps
    else:
        assert sum(c["handoffs_spilled"] for c in pc.values()) > 0
        assert ps and all(s[1] == "degraded:spilled" for s in ps)


# -- the fused multicut chain on the port -------------------------------------------


def _run_mc(tmp_path, name, vol, memory_handoffs):
    from cluster_tools_tpu_torch.workflows import MulticutSegmentationWorkflow

    base = os.path.join(str(tmp_path), name)
    cdir = os.path.join(base, "config")
    os.makedirs(cdir, exist_ok=True)
    with open(os.path.join(cdir, "global.config"), "w") as f:
        json.dump({"block_shape": [8, 8, 8], "memory_handoffs": memory_handoffs}, f)
    path = os.path.join(base, "data.zarr")
    file_reader(path).create_dataset("bmap", shape=vol.shape, chunks=(8, 8, 8), dtype="float32")[...] = vol
    wf = MulticutSegmentationWorkflow(tmp_folder=os.path.join(base, "tmp"), config_dir=cdir, max_jobs=4,
                                      target="local", input_path=path, input_key="bmap", ws_path=path, ws_key="ws",
                                      output_path=path, output_key="seg", threshold=0.5, halo=[2, 2, 2], beta=0.5)
    assert build([wf]), f"{name} workflow failed"
    return base, path


@pytest.fixture(scope="module")
def mc_volume():
    vol = ndi.gaussian_filter(np.random.default_rng(3).random((16, 16, 16)), 2.0)
    return ((vol - vol.min()) / (vol.max() - vol.min())).astype(np.float32)


def test_fused_multicut_chain_writes_no_intermediate_storage(tmp_path, mc_volume):
    """The reference's :586 on the port: handoffs on, no ``ws`` dataset, no
    graph or multicut artifacts, ``seg`` equal to the all-storage run's."""
    _base_off, p_off = _run_mc(tmp_path, "off", mc_volume, False)
    snap = handoff.snapshot()
    base_on, p_on = _run_mc(tmp_path, "on", mc_volume, True)
    d = handoff.delta(snap)
    np.testing.assert_array_equal(np.asarray(file_reader(p_on)["seg"][...]),
                                  np.asarray(file_reader(p_off)["seg"][...]))
    assert "ws" in file_reader(p_off) and "ws" not in file_reader(p_on)
    for sub in ("graph", "features", "multicut"):
        sdir = os.path.join(base_on, "tmp", sub)
        leftovers = [f for f in (os.listdir(sdir) if os.path.isdir(sdir) else []) if not f.endswith(".ckpt.npz")]
        assert leftovers == [], sub
    assert not [f for f in os.listdir(os.path.join(base_on, "tmp")) if f.endswith((".npy", ".npz"))]
    assert d["handoffs_spilled"] == 0 and d["handoff_fallbacks"] == 0
    assert d["handoffs_served"] > 0 and d["bytes_not_stored"] > 0
    with open(fu.io_metrics_path(os.path.join(base_on, "tmp"))) as f:
        tasks = json.load(f)["tasks"]
    assert sum(m.get("handoffs_served", 0) for m in tasks.values()) == d["handoffs_served"]


def test_fused_multicut_chain_equal_when_every_handoff_spills(tmp_path, monkeypatch, mc_volume):
    """The budget forcing every handoff to spill at birth: the consumers
    read the spilled copies and ``seg`` is still the all-storage run's."""
    _base_off, p_off = _run_mc(tmp_path, "off", mc_volume, False)
    monkeypatch.setenv("CTT_HANDOFF_BYTES", "1")
    snap = handoff.snapshot()
    base_on, p_on = _run_mc(tmp_path, "spill", mc_volume, True)
    d = handoff.delta(snap)
    np.testing.assert_array_equal(np.asarray(file_reader(p_on)["seg"][...]),
                                  np.asarray(file_reader(p_off)["seg"][...]))
    assert d["handoffs_spilled"] > 0 and d["bytes_not_stored"] == 0
    assert "ws" in file_reader(p_on)
    recs = json.load(open(os.path.join(base_on, "tmp", "failures.json")))["records"]
    spilled = [r for r in recs if r.get("resolution") == "degraded:spilled"]
    assert spilled and all(r["sites"] == {"spill": 1} for r in spilled)
