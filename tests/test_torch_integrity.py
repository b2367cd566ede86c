"""The port's integrity plane: digest sidecars (``io/containers.py``), the
verifying reader (``io/verified.py``) and lineage repair
(``runtime/repair.py``), against the JAX package; the fault hooks of the
handoffs, the device plane and the chunk cache; and the connected
components workflow under injected faults against the JAX package's.

- Sidecars: the same region write gives the same sidecar file, byte for
  byte, in both packages (zarr and N5).  A store either package wrote
  verifies under the other's reader, and rot injected by one package is
  caught by the other's.
- The verifying reader: every flipped byte is a typed ``corrupt:storage``;
  ``adopt`` re-records a lost sidecar, ``strict`` (or
  ``CTT_SIDECAR_POLICY=strict``) raises ``MissingSidecarError``; unmarked
  datasets and unaligned reads are never policed; ``CTT_CHECKSUMS=0``
  writes no sidecar.
- Lineage: a verified executor store registers its block; rot at rest is
  healed on the next read (``repaired:lineage``), an exhausted budget
  gives ``quarantined:unrepairable``.
- Handoffs (reference ``tests/test_handoff.py:86``, ``:98``, ``:148``),
  the device plane (``tests/test_device_plane.py:210``, ``:255``,
  ``:541``) and the chunk cache (``tests/test_chunk_cache.py:271``,
  ``:288``, ``:408``), rewritten against the port.
- The cc workflow (4x4x4 blocks of 16^3), per block and sharded, under a
  load hang, a kernel NaN, an ``io_write`` flip and a ``dispatch`` OOM:
  labels equal to the fault-free run and ``failures.json`` records equal
  to the JAX package's under the same spec.
"""

import importlib.util
import json
import os
import signal

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from cluster_tools_tpu.io import verified as jverified
from cluster_tools_tpu.io.containers import open_container as j_open
from cluster_tools_tpu.runtime import faults as jfaults
from cluster_tools_tpu.runtime import repair as jrepair
from cluster_tools_tpu.runtime import supervision as jsup
from cluster_tools_tpu.runtime.task import build as j_build
from cluster_tools_tpu.tasks.connected_components import ConnectedComponentsWorkflow as JCC
from cluster_tools_tpu_torch.io import chunk_cache
from cluster_tools_tpu_torch.io import verified
from cluster_tools_tpu_torch.io.containers import ChunkCorruptionError, HandoffDataset, open_container
from cluster_tools_tpu_torch.io.verified import MissingSidecarError, ProductCorruptionError
from cluster_tools_tpu_torch.parallel import device_pool
from cluster_tools_tpu_torch.runtime import faults, handoff, repair
from cluster_tools_tpu_torch.runtime import supervision as psup
from cluster_tools_tpu_torch.runtime.executor import BlockwiseExecutor, region_verifier
from cluster_tools_tpu_torch.runtime.task import build
from cluster_tools_tpu_torch.tasks.connected_components import ConnectedComponentsWorkflow as PCC
from cluster_tools_tpu_torch.tasks.copy_volume import CopyVolumeLocal
from cluster_tools_tpu_torch.utils import function_utils as fu
from cluster_tools_tpu_torch.utils.volume_utils import Blocking


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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Empty lineage registries, zeroed reader counters, no injectors and
    the chunk cache off: these tests rot bytes on storage and must see
    them on the next read."""
    monkeypatch.setenv("CTT_CHUNK_CACHE", "0")
    for mod in (repair, jrepair):
        mod.reset()
    for mod in (verified, jverified):
        mod.reset_stats()
    for f in (faults, jfaults):
        f.reset()
    handoff.reset()
    yield
    for mod in (repair, jrepair):
        mod.reset()
    for mod in (verified, jverified):
        mod.reset_stats()
    for f in (faults, jfaults):
        f.reset()
    handoff.reset()


OPEN = {"port": open_container, "jax": j_open}
FAULTS = {"port": faults, "jax": jfaults}
VERIFIED = {"port": verified, "jax": jverified}


def _sidecars(path):
    d = os.path.join(path, ".ctt_checksums")
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))} if os.path.isdir(d) else {}


# -- the sidecar files ----------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["zarr", "n5"])
@pytest.mark.parametrize("dtype", ["uint64", "float32", "uint8"])
def test_sidecar_bytes_equal_the_reference(tmp_path, fmt, dtype):
    data = (np.random.default_rng(1).random((24, 16, 16)) * 200).astype(dtype)
    for side in OPEN:
        ds = OPEN[side](str(tmp_path / f"{side}.{fmt}")).create_dataset("x", shape=data.shape, chunks=(8, 8, 8),
                                                                     dtype=dtype)
        ds[0:8, 8:16, 0:8] = data[0:8, 8:16, 0:8]
        ds[8:24, 0:16, 0:16] = data[8:24]
        ds[16:24, 0:8, 0:8] = data[16:24, 0:8, 0:8]  # drops the overlapping sidecar
    port, ref = (_sidecars(str(tmp_path / f"{side}.{fmt}" / "x")) for side in ("port", "jax"))
    assert port == ref and len(port) == 2


@pytest.mark.parametrize("fmt", ["zarr", "n5"])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_stores_verify_and_rot_is_caught_across_packages(tmp_path, fmt, writer, reader):
    data = np.arange(16 * 8 * 8, dtype=np.uint16).reshape(16, 8, 8)
    path = str(tmp_path / f"store.{fmt}")
    ds = OPEN[writer](path).create_dataset("x", shape=data.shape, chunks=(8, 8, 8), dtype="uint16",
                                           compression=None)
    bb0, bb1 = (slice(0, 8), slice(None), slice(None)), (slice(8, 16), slice(None), slice(None))
    ds[bb0] = data[bb0]
    # the writer's injector rots block 1's region behind its fresh sidecar
    FAULTS[writer].configure({"faults": [{"site": "io_write", "kind": "corrupt", "blocks": [1]}]})
    with FAULTS[writer].block_context(1):
        ds[bb1] = data[bb1]
    FAULTS[writer].configure(None)
    other = OPEN[reader](path)["x"]
    VERIFIED[reader].mark_product(other)
    other.verify_region(bb0)
    np.testing.assert_array_equal(other[bb0], data[bb0])
    with pytest.raises(VERIFIED[reader].ProductCorruptionError) as ei:
        other[bb1]
    assert ei.value.code == "corrupt:storage"


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_read_rot_injected_by_the_other_package_is_caught(tmp_path, reader):
    writer = "jax" if reader == "port" else "port"
    data = np.arange(64, dtype=np.float32).reshape(4, 4, 4)
    path = str(tmp_path / "rot.zarr")
    ds = OPEN[writer](path).create_dataset("x", shape=data.shape, chunks=(4, 4, 4), dtype="float32")
    ds[...] = data
    FAULTS[writer].configure({"faults": [{"site": "io_read", "kind": "corrupt", "blocks": [0]}]})
    with FAULTS[writer].block_context(0), pytest.raises(VERIFIED[writer].ProductCorruptionError):
        ds[...]  # the rot lands on storage at the writer's read site
    FAULTS[writer].configure(None)
    with pytest.raises(VERIFIED[reader].ProductCorruptionError):
        OPEN[reader](path)["x"][...]


def test_checksums_off_writes_no_sidecar(tmp_path, monkeypatch):
    monkeypatch.setenv("CTT_CHECKSUMS", "0")
    for fmt in ("zarr", "n5"):
        ds = open_container(str(tmp_path / f"off.{fmt}")).create_dataset("x", shape=(8, 8), chunks=(4, 4),
                                                                          dtype="int32")
        ds[0:4, 0:4] = np.ones((4, 4), np.int32)
        assert not os.path.exists(str(tmp_path / f"off.{fmt}" / "x" / ".ctt_checksums"))
        ds.verify_region((slice(0, 4), slice(0, 4)))  # nothing to hold
    assert region_verifier(ds) is not None
    monkeypatch.setenv("CTT_CHECKSUMS", "1")
    ds[0:4, 0:4] = np.ones((4, 4), np.int32)
    assert os.listdir(str(tmp_path / "off.n5" / "x" / ".ctt_checksums")) == ["r_0-4_0-4.json"]


def test_overlap_invalidation_memory_and_async_paths(tmp_path):
    for ds in (open_container(str(tmp_path / "ov.zarr")).create_dataset("x", shape=(8, 8), chunks=(4, 4),
                                                                         dtype="float32"),
               open_container(f"memory://ov-{tmp_path.name}").create_dataset("x", shape=(8, 8), chunks=(4, 4),
                                                                           dtype="float32")):
        ds[0:4, 0:4] = np.ones((4, 4), np.float32)
        assert ds.checksum_entry((slice(0, 4), slice(0, 4)))["crc"] is not None
        ds[2:6, 2:6] = np.zeros((4, 4), np.float32)
        assert ds.checksum_entry((slice(0, 4), slice(0, 4))) is None
        ds.write_async((slice(4, 8), slice(4, 8)), np.full((4, 4), 3, np.float32)).result()
        assert ds.checksum_entry((slice(4, 8), slice(4, 8))) is not None
        faults.configure({"faults": [{"site": "io_write", "kind": "corrupt", "blocks": [5]}]})
        with faults.block_context(5):
            ds.write_async((slice(0, 4), slice(4, 8)), np.full((4, 4), 2, np.float32)).result()
        faults.configure(None)
        with pytest.raises(ChunkCorruptionError):
            ds.verify_region((slice(0, 4), slice(4, 8)))
        with pytest.raises(ProductCorruptionError):
            ds.read_async((slice(0, 4), slice(4, 8))).result()
        np.testing.assert_array_equal(ds.read_async((slice(4, 8), slice(4, 8))).result(), 3)


def test_region_verifier_is_none_for_hdf5(tmp_path):
    pytest.importorskip("h5py")
    ds = open_container(str(tmp_path / "x.h5")).create_dataset("x", shape=(4, 4), chunks=(4, 4), dtype="uint8")
    assert region_verifier(ds) is None


# -- the verifying reader -------------------------------------------------------------------


def _mk_product(tmp_path, shape=(4, 4), chunks=(4, 4), dtype="uint16"):
    ds = open_container(str(tmp_path / "prod.zarr")).create_dataset("a", shape=shape, chunks=chunks, dtype=dtype,
                                                                     compression=None)
    data = np.arange(int(np.prod(shape)), dtype=dtype).reshape(shape)
    bb = tuple(slice(0, c) for c in chunks)
    ds[bb] = data[bb]
    verified.mark_product(ds)
    return ds, data, bb


def _chunk_file(tmp_path):
    d = str(tmp_path / "prod.zarr" / "a")
    (name,) = [f for f in os.listdir(d) if not f.startswith(".")]
    return os.path.join(d, name)


def test_corruption_detected_at_every_byte_offset(tmp_path):
    ds, data, bb = _mk_product(tmp_path)
    chunk = _chunk_file(tmp_path)
    raw = open(chunk, "rb").read()
    assert len(raw) == data.nbytes
    for off in range(len(raw)):
        bad = bytearray(raw)
        bad[off] ^= 0x01
        open(chunk, "wb").write(bytes(bad))
        with pytest.raises(ProductCorruptionError) as ei:
            ds[bb]
        assert ei.value.code == "corrupt:storage"
        open(chunk, "wb").write(raw)
    np.testing.assert_array_equal(ds[bb], data)
    assert verified.stats()["corrupt_detected"] == data.nbytes == verified.stats()["unrepairable_reads"]
    assert repair.stats()["no_lineage"] == data.nbytes


@pytest.mark.parametrize("via", ["mark", "env"])
def test_missing_sidecar_policies(tmp_path, monkeypatch, via):
    ds, data, bb = _mk_product(tmp_path)
    side = str(tmp_path / "prod.zarr" / "a" / ".ctt_checksums" / "r_0-4_0-4.json")
    os.unlink(side)
    np.testing.assert_array_equal(ds[bb], data)  # adopt: re-recorded
    assert verified.stats()["sidecars_adopted"] == 1 and os.path.exists(side)
    os.unlink(side)
    if via == "mark":
        verified.mark_product(ds, policy="strict")
    else:
        monkeypatch.setenv("CTT_SIDECAR_POLICY", "strict")
        verified.mark_product(ds)
    with pytest.raises(MissingSidecarError) as ei:
        ds[bb]
    assert ei.value.code == "corrupt:storage:missing_sidecar"
    # a torn sidecar is missing too
    verified.mark_product(ds, policy="adopt")
    ds[bb]
    open(side, "w").write(open(side).read()[:5])
    verified.mark_product(ds, policy="strict")
    with pytest.raises(MissingSidecarError):
        ds[bb]


def test_unmarked_and_unaligned_reads_are_never_policed(tmp_path):
    ds, data, _ = _mk_product(tmp_path, shape=(8, 8), chunks=(4, 4))
    verified.mark_product(ds, policy="strict")
    with pytest.raises(MissingSidecarError):
        ds[(slice(4, 8), slice(4, 8))]
    assert ds[(slice(3, 5), slice(0, 4))].shape == (2, 4)
    raw = open_container(str(tmp_path / "raw.zarr")).create_dataset("r", shape=(4, 4), chunks=(4, 4),
                                                                     dtype="uint8", compression=None)
    raw[(slice(0, 4), slice(0, 4))]


def test_injected_read_rot_flip_and_sidecar_modes(tmp_path):
    ds, data, bb = _mk_product(tmp_path)
    faults.configure({"faults": [{"site": "io_read", "kind": "corrupt", "blocks": [7]}]})
    with faults.block_context(7), pytest.raises(ProductCorruptionError):
        ds[bb]
    faults.configure(None)
    with pytest.raises(ProductCorruptionError):
        ds[bb]  # the flip lives on storage
    ds[bb] = data[bb]
    verified.mark_product(ds, policy="strict")
    faults.configure({"faults": [{"site": "io_read", "kind": "corrupt", "mode": "sidecar", "blocks": [7]}]})
    with faults.block_context(7), pytest.raises(MissingSidecarError):
        ds[bb]


# -- lineage repair ------------------------------------------------------------------------


@pytest.mark.parametrize("loader", ["sync", "async"])
def test_executor_lineage_heals_rot_on_read(tmp_path, loader):
    f = open_container(str(tmp_path / "sweep.zarr"))
    out = f.create_dataset("o", shape=(8, 8), chunks=(4, 4), dtype="float32", compression=None)
    src = f.create_dataset("i", shape=(8, 8), chunks=(4, 4), dtype="float32", compression=None)
    src[...] = np.arange(64, dtype="float32").reshape(8, 8)
    blocking = Blocking((8, 8), (4, 4))
    failures = str(tmp_path / "failures.json")
    load = (lambda b: (src.read_async(b.bb),)) if loader == "async" else (lambda b: (src[b.bb],))
    BlockwiseExecutor(target="local", backoff_base=1e-4).map_blocks(
        lambda x: x * 2, [blocking.get_block(i) for i in range(4)], load,
        lambda b, raw: out.__setitem__(b.bb, np.asarray(raw)), store_verify_fn=region_verifier(out),
        failures_path=failures, task_name="double")
    assert repair.stats()["producers"] == 4
    bb = blocking.get_block(2).bb
    bad = out._read_back(bb).copy()
    bad[0, 0] += 1.0
    out._write_raw(bb, bad)
    np.testing.assert_array_equal(out[bb], src[bb] * 2)  # healed on read
    assert repair.stats()["repaired"] == 1 and verified.stats()["repaired_reads"] == 1
    recs = [r for r in fu.read_json_if_valid(failures)["records"] if r.get("resolution") == "repaired:lineage"]
    assert recs and recs[0]["resolved"] and recs[0]["block_id"] == 2
    out.verify_region(bb)


def test_repair_budget_gives_quarantined_unrepairable(tmp_path, monkeypatch):
    monkeypatch.setenv("CTT_REPAIR_BUDGET", "2")
    ds, data, bb = _mk_product(tmp_path)
    failures = str(tmp_path / "failures.json")

    def broken():
        raise RuntimeError("upstream inputs are damaged too")

    repair.register_producer(ds, bb, broken, task="prod", block_id=0, failures_path=failures)
    raw = open(_chunk_file(tmp_path), "rb").read()
    open(_chunk_file(tmp_path), "wb").write(bytes([raw[0] ^ 1]) + raw[1:])
    for _ in range(3):
        with pytest.raises(ProductCorruptionError):
            ds[bb]
    st = repair.stats()
    assert st["failed"] == 2 and st["unrepairable"] == 1
    recs = [r for r in fu.read_json_if_valid(failures)["records"]
            if r.get("resolution") == "quarantined:unrepairable"]
    assert recs and recs[0]["quarantined"] and not recs[0]["resolved"]


def test_copy_volume_verifies_retries_and_registers_lineage(tmp_path):
    """The host scaffold: an ``io_write`` flip fails the post-store check,
    the retry re-writes the block, and the verified block's lineage heals
    later rot."""
    src = open_container(str(tmp_path / "src.zarr")).create_dataset("x", shape=(16, 16), chunks=(8, 8),
                                                                     dtype="int32")
    src[...] = np.arange(256, dtype=np.int32).reshape(16, 16)
    (tmp_path / "cfg").mkdir()
    (tmp_path / "cfg" / "global.config").write_text(json.dumps({"block_shape": [8, 8]}))
    faults.configure({"faults": [{"site": "io_write", "kind": "corrupt", "blocks": [2]}]})

    # host_block_map runs process(block_id) outside any block context: tag
    # the writes with the block id so the io_write fault can target one
    class Tagged(CopyVolumeLocal):
        def host_block_map(self, block_ids, process, **kw):
            def tagged(b):
                with faults.block_context(b):
                    process(b)
            return super().host_block_map(block_ids, tagged, **kw)

    t = Tagged(tmp_folder=str(tmp_path / "tmp"), config_dir=str(tmp_path / "cfg"), max_jobs=1,
               input_path=str(tmp_path / "src.zarr"), input_key="x", output_path=str(tmp_path / "dst.zarr"),
               output_key="y")
    assert build([t])
    faults.configure(None)
    dst = open_container(str(tmp_path / "dst.zarr"))["y"]
    np.testing.assert_array_equal(dst[...], src[...])
    assert repair.stats()["producers"] == 4
    bb = (slice(0, 8), slice(8, 16))
    bad = dst._read_back(bb).copy()
    bad[0, 0] += 1
    dst._write_raw(bb, bad)
    np.testing.assert_array_equal(dst[bb], src[bb])
    assert repair.stats()["repaired"] == 1


# -- handoffs (reference tests/test_handoff.py) -------------------------------------------------


def _mk_handoff(tmp_path, producer="prod.0", failures_path=None):
    path = str(tmp_path / "data.zarr")
    ds, entry = handoff.acquire_dataset(path, "a", shape=(8, 8, 8), chunks=(4, 4, 4), dtype="uint64",
                                        producer=producer, failures_path=failures_path)
    return path, ds, entry


def test_handoff_dataset_detects_injected_corruption(tmp_path):
    """Reference :86."""
    _, ds, _ = _mk_handoff(tmp_path)
    faults.configure({"faults": [{"site": "io_write", "kind": "corrupt", "blocks": [3]}]})
    with faults.block_context(3):
        ds[0:4, 0:4, 0:4] = np.ones((4, 4, 4), np.uint64)
    with pytest.raises(ChunkCorruptionError):
        ds.verify_region((slice(0, 4),) * 3)


def test_handoff_dataset_io_fault_hooks_fire(tmp_path):
    """Reference :98."""
    _, ds, _ = _mk_handoff(tmp_path)
    faults.configure({"faults": [{"site": "io_read", "kind": "error", "blocks": [7]}]})
    with faults.block_context(7):
        with pytest.raises(faults.InjectedFault):
            ds[0:2, 0:2, 0:2]
        ds[0:2, 0:2, 0:2]


def test_forced_spill_records_degraded_attribution(tmp_path):
    """Reference :148: a ``spill`` fault at ``publish`` spills at birth."""
    failures = str(tmp_path / "failures.json")
    faults.configure({"faults": [{"site": "publish", "kind": "spill", "fail_attempts": 10 ** 6}]})
    path, ds, entry = _mk_handoff(tmp_path, producer="watershed.x", failures_path=failures)
    assert not isinstance(ds, HandoffDataset) and entry.spilled and entry.spill_reason == "fault"

    class _T:
        pass

    t = _T()
    t.entry = entry
    recs = handoff.finalize_task([t], "watershed.x")
    assert recs == [{"identity": entry.identity, "path": path, "key": "a", "kind": "dataset", "stored": True,
                     "bytes": entry.nbytes}]
    frecs = json.load(open(failures))["records"]
    assert any(r["resolution"] == "degraded:spilled" and r["sites"] == {"spill": 1}
               and r["task"] == "watershed.x.handoff" for r in frecs)


def test_forced_artifact_spill_is_crc_verified(tmp_path):
    """Reference :127 with the injector's forced spill."""
    p = str(tmp_path / "costs.npy")
    faults.configure({"faults": [{"site": "publish", "kind": "spill", "fail_attempts": 10 ** 6}]})
    entry = handoff.publish_arrays(p, {"data": np.arange(5.0)}, producer="prod.0")
    assert entry.spilled and os.path.exists(p)
    faults.configure(None)
    np.testing.assert_array_equal(handoff.load_array(p), np.arange(5.0))
    arr = np.load(p)
    arr[0] = 123.0
    np.save(p, arr)
    with pytest.raises(ChunkCorruptionError):
        handoff.load_array(p)


# -- the device plane (reference tests/test_device_plane.py) ---------------------------------------


@pytest.fixture
def fresh_pool():
    device_pool.reset()
    yield
    device_pool.reset()


def _pool_sweep(vol, mode, fp=None):
    blocks = [Blocking(vol.shape, (8, 8, 8)).get_block(i, [2, 2, 2]) for i in range(27)]
    out = np.zeros(vol.shape, np.float32)
    snap = device_pool.snapshot()
    BlockwiseExecutor(target="local", backoff_base=1e-4).map_blocks(
        lambda x: x * 3 - 1, blocks, lambda b: (vol[b.outer_bb],),
        lambda b, raw: out.__setitem__(b.bb, np.asarray(raw)[b.inner_in_outer_bb]), failures_path=fp,
        task_name="ragged_sharded", sweep_mode=mode, sharded_batch=8)
    return out, device_pool.delta(snap)


def test_h2d_oom_rides_the_ladder_to_host_staging(tmp_path, fresh_pool):
    """Reference :210."""
    vol = np.random.default_rng(0).random((20, 20, 20)).astype(np.float32)
    ref, _ = _pool_sweep(vol, "per_block")
    faults.configure({"seed": 3, "faults": [{"site": "h2d", "kind": "oom", "fail_attempts": 10 ** 6}]})
    fp = str(tmp_path / "failures.json")
    out, d = _pool_sweep(vol, "sharded", fp)
    np.testing.assert_array_equal(out, ref)
    assert d["host_staged_fallbacks"] > 0 and d["device_batches_staged"] == 0
    recs = [r for r in json.load(open(fp))["records"] if r["task"] == "ragged_sharded.device_pool"]
    assert len(recs) == 1 and recs[0]["sites"] == {"h2d": 1} and recs[0]["resolution"] == "degraded:host_staged"


def test_transient_h2d_oom_evicts_and_retries(fresh_pool):
    """Reference :255."""
    vol = np.random.default_rng(1).random((20, 20, 20)).astype(np.float32)
    faults.configure({"seed": 3, "faults": [{"site": "h2d", "kind": "oom", "fail_attempts": 1}]})
    out, d = _pool_sweep(vol, "sharded")
    assert d["host_staged_fallbacks"] == 0 and d["device_batches_staged"] > 0
    faults.configure(None)
    ref, _ = _pool_sweep(vol, "per_block")
    np.testing.assert_array_equal(out, ref)


def test_publish_oom_falls_to_the_memory_rung(tmp_path, fresh_pool):
    """Reference :541."""
    payload = torch.arange(32.0).reshape(4, 8)
    faults.configure({"faults": [{"site": "publish", "kind": "oom", "fail_attempts": 10 ** 6}]})
    fp = str(tmp_path / "failures.json")
    path = str(tmp_path / "probs.npz")
    snap = device_pool.snapshot()
    entry = handoff.publish_device_arrays(path, {"x": payload}, producer="prod.0", failures_path=fp, device="cpu")
    assert entry.kind == "arrays"
    d = device_pool.delta(snap)
    assert d["host_staged_fallbacks"] == 1 and d["d2h_bytes"] == payload.numpy().nbytes
    np.testing.assert_array_equal(np.asarray(handoff.resolve_device_arrays(path)["x"]), payload.numpy())
    recs = [r for r in json.load(open(fp))["records"] if r["task"] == "prod.0.device_handoff"]
    assert len(recs) == 1 and recs[0]["resolution"] == "degraded:host_staged"


# -- the chunk cache (reference tests/test_chunk_cache.py) ------------------------------------------


@pytest.fixture
def cache(monkeypatch):
    monkeypatch.setenv("CTT_CHUNK_CACHE", "1")
    c = chunk_cache.configure(max_bytes=64 << 20)
    yield c
    chunk_cache.configure()


def _cached_dataset(tmp_path, chunks=(8, 8, 8)):
    ds = open_container(str(tmp_path / "c.zarr")).create_dataset("x", shape=(32, 32, 32), chunks=chunks,
                                                                 dtype="float32")
    data = np.random.default_rng(0).random((32, 32, 32)).astype(np.float32)
    ds[...] = data
    return ds, data


def test_injected_io_read_fault_never_populates(tmp_path, cache):
    """Reference :271."""
    ds, data = _cached_dataset(tmp_path)
    faults.configure({"faults": [{"site": "io_read", "kind": "error", "fail_attempts": 1}]})
    with pytest.raises(faults.InjectedFault):
        ds[0:16, 0:16, 0:16]
    assert len(cache) == 0 and cache.stats["bytes_from_storage"] == 0
    np.testing.assert_array_equal(ds[0:16, 0:16, 0:16], data[0:16, 0:16, 0:16])
    assert len(cache) == 8


def test_injected_corruption_never_stays_cached(tmp_path, cache):
    """Reference :288."""
    ds, data = _cached_dataset(tmp_path, chunks=(16, 16, 16))
    bb = (slice(0, 16),) * 3
    faults.configure({"faults": [{"site": "io_write", "kind": "corrupt", "fail_attempts": 1}]})
    ds[bb] = data[bb]
    with pytest.raises(ChunkCorruptionError):
        ds[bb]
    assert len(cache) == 0
    ds[bb] = data[bb]
    np.testing.assert_array_equal(ds[bb], data[bb])
    assert len(cache) == 1


def _report_module():
    spec = importlib.util.spec_from_file_location("failures_report", os.path.join(REPO, "scripts",
                                                                                  "failures_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_failures_report_renders_the_ports_io_metrics(tmp_path):
    """Reference :408, on the port's ``tmp_folder``."""
    mod = _report_module()
    fu.record_io_metrics(str(tmp_path / "io_metrics.json"), "ws.abc123",
                         {"hits": 90, "misses": 10, "coalesced": 4, "bytes_from_storage": 1 << 20,
                          "bytes_served": 5 << 20})
    lines = "\n".join(mod.format_io_metrics(mod.load_io_metrics(str(tmp_path / "failures.json"))))
    assert "ws.abc123" in lines and "90.0%" in lines and "saved 4.0MiB" in lines
    assert mod.main(["prog", str(tmp_path)]) == 0
    (tmp_path / "failures.json").write_text('{"version": 2, "records": [')
    assert mod.main(["prog", str(tmp_path)]) == 1


# -- the cc workflow under faults, against the JAX package ---------------------------------------------

CC_SHAPE = (64, 64, 64)
CC_BLOCK = [16, 16, 16]
CC_SIDES = {"jax": (JCC, j_build, j_open, jfaults), "port": (PCC, build, open_container, faults)}


@pytest.fixture(scope="module")
def cc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cc_faults"))
    x = ndi.gaussian_filter(np.random.default_rng(0).random(CC_SHAPE), 2.0)
    x = ((x - x.min()) / (x.max() - x.min())).astype(np.float32)
    for side in CC_SIDES:
        CC_SIDES[side][2](os.path.join(root, f"{side}.zarr")).require_dataset(
            "b", shape=CC_SHAPE, chunks=tuple(CC_BLOCK), dtype="float32")[...] = x
    return root


def _run_cc(root, side, name, spec=None, **global_config):
    wf_cls, build_fn, opener, fmod = CC_SIDES[side]
    d = os.path.join(root, f"{name}-{side}")
    os.makedirs(os.path.join(d, "cfg"), exist_ok=True)
    with open(os.path.join(d, "cfg", "global.config"), "w") as f:
        json.dump(dict({"block_shape": CC_BLOCK, "sharded_batch": 8}, **global_config), f)
    path = os.path.join(root, f"{side}.zarr")
    fmod.configure(spec)
    try:
        wf = wf_cls(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=1,
                    target="local", input_path=path, input_key="b", output_path=path, output_key=name,
                    threshold=0.5)
        assert build_fn([wf]), side
    finally:
        fmod.reset()
    doc = fu.read_json_if_valid(os.path.join(d, "tmp", "failures.json")) or {"records": []}
    recs = sorted((r["task"].split(".")[0], r["block_id"], sorted(r["sites"].items()), r["quarantined"],
                   r["resolved"], r.get("resolution")) for r in doc["records"] if r.get("block_id") is not None)
    return np.asarray(opener(path)[name][...]), recs


CC_ARMS = [
    ("nan", {"faults": [{"site": "kernel", "kind": "nan", "blocks": [42], "tasks": ["block_components"]}]}, {}),
    ("flip", {"faults": [{"site": "io_write", "kind": "corrupt", "blocks": [7],
                          "tasks": ["block_components"]}]}, {}),
    ("dispatch_oom", {"faults": [{"site": "dispatch", "kind": "oom", "blocks": [8],
                                  "tasks": ["block_components"]}]}, {}),
    ("load_hang", {"faults": [{"site": "load", "kind": "hang", "blocks": [21], "seconds": 4.0,
                               "fail_attempts": 1, "tasks": ["block_components"]}]},
     {"block_deadline_s": 1.5, "watchdog_period_s": 0.1}),
]


@pytest.mark.parametrize("sweep_mode", ["per_block", "sharded"])
@pytest.mark.parametrize("tag,spec,knobs", CC_ARMS, ids=[a[0] for a in CC_ARMS])
def test_cc_workflow_under_faults_equals_the_reference(cc_root, tag, spec, knobs, sweep_mode):
    got = {}
    for side in CC_SIDES:
        ref, recs = _run_cc(cc_root, side, f"clean_{sweep_mode}", sweep_mode=sweep_mode)
        assert recs == []
        out, recs = _run_cc(cc_root, side, f"{tag}_{sweep_mode}", spec, sweep_mode=sweep_mode, **knobs)
        np.testing.assert_array_equal(out, ref)
        got[side] = (out, recs)
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1]
    if tag == "dispatch_oom" and sweep_mode == "per_block":
        assert got["port"][1] == []
    else:
        assert got["port"][1], "the fault did not fire"


def test_whole_reads_verify_block_sidecars_and_keep_them(tmp_path):
    """A whole-volume read of a blockwise product store checks every block
    sidecar against its slice and adopts nothing, so the block sidecars
    survive it; a flipped block is caught inside the whole read."""
    ds = open_container(str(tmp_path / "w.zarr")).create_dataset("a", shape=(8, 8), chunks=(4, 4), dtype="uint16",
                                                                  compression=None)
    data = np.arange(64, dtype=np.uint16).reshape(8, 8)
    blocks = [(slice(a, a + 4), slice(b, b + 4)) for a in (0, 4) for b in (0, 4)]
    for bb in blocks:
        ds[bb] = data[bb]
    verified.mark_product(ds)
    np.testing.assert_array_equal(ds[...], data)
    assert sorted(ds.checksum_regions()) == sorted(tuple((s.start, s.stop) for s in bb) for bb in blocks)
    assert verified.stats()["sidecars_adopted"] == 0
    bad = ds._read_back(blocks[3]).copy()
    bad[0, 0] ^= 1
    ds._write_raw(blocks[3], bad)
    with pytest.raises(ProductCorruptionError):
        ds[...]
