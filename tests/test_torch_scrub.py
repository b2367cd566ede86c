"""The port's resident scrubber (``runtime/scrub.py``) against the JAX
package's: finding and repairing rot at rest from lineage, discovery from
roots, the byte budget and cursor resume, ``repair.register_producer``
enlisting the store, the same ``scrub_state.json`` from both scrubbers on
the same store, and each package's scrubber over sidecars the other wrote.

Counterparts of the reference's ``tests/test_selfheal.py:327-477``; the
resident server's scrub (the reference's ``test_scrub_smoke_server_self_heals``)
runs through the port's ``PipelineServer`` on the CPU.
"""

import json
import os
import signal
import time

import numpy as np
import pytest

from cluster_tools_tpu.io import verified as jverified
from cluster_tools_tpu.io.containers import open_container as j_open
from cluster_tools_tpu.runtime import faults as jfaults
from cluster_tools_tpu.runtime import handoff as jhandoff
from cluster_tools_tpu.runtime import repair as jrepair
from cluster_tools_tpu.runtime import scrub as jscrub
from cluster_tools_tpu_torch.io import verified
from cluster_tools_tpu_torch.io.containers import open_container
from cluster_tools_tpu_torch.runtime import faults, handoff, repair, scrub, supervision
from cluster_tools_tpu_torch.runtime.executor import BlockwiseExecutor, region_verifier
from cluster_tools_tpu_torch.utils import function_utils as fu
from cluster_tools_tpu_torch.utils.volume_utils import Blocking, file_reader

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPEN = {"port": open_container, "jax": j_open}
VERIFIED = {"port": verified, "jax": jverified}
SCRUB = {"port": scrub, "jax": jscrub}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Empty lineage and scrub registries, zeroed reader counters, no
    injectors and the chunk cache off in both packages: these tests rot
    bytes on storage and must see them on the next read."""
    monkeypatch.setenv("CTT_CHUNK_CACHE", "0")

    def reset():
        for mod in (repair, jrepair):
            mod.reset()
        for mod in (scrub, jscrub):
            mod.reset_targets()
        for mod in (verified, jverified):
            mod.reset_stats()
        for f in (faults, jfaults):
            f.configure(None)
        for h in (handoff, jhandoff):
            h.reset()

    reset()
    yield
    reset()


@pytest.fixture(autouse=True)
def _restore_signal_dispositions():
    """The port's executor arms its drain handler in the main thread and
    keeps it, and either package arms its own only over the default
    disposition: restore both signals and the port's flag, so a later test
    in this process, of either package, arms its own handler."""
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGUSR1)}
    installed = supervision._drain_installed
    yield
    for sig, handler in saved.items():
        signal.signal(sig, handler)
    supervision._drain_installed = installed


def _mk_product(side, tmp_path):
    """A one-chunk uncompressed product dataset, written and marked by
    ``side``."""
    f = OPEN[side](os.path.join(str(tmp_path), "prod.zarr"))
    ds = f.create_dataset("a", shape=(4, 4), chunks=(4, 4), dtype="uint16", compression=None)
    data = np.arange(16, dtype="uint16").reshape(4, 4)
    ds[0:4, 0:4] = data
    VERIFIED[side].mark_product(ds)
    return ds, data


def _chunk_file(ds):
    container, key = ds._label.rsplit(":", 1)
    d = os.path.join(container, key)
    files = [f for f in os.listdir(d) if not f.startswith(".")]
    assert len(files) == 1, files
    return os.path.join(d, files[0])


def _run_double_sweep(tmp_path):
    """A tiny port executor sweep (out = 2 * input) with the verified
    store path: ``region_verifier`` registers lineage."""
    f = open_container(os.path.join(str(tmp_path), "sweep.zarr"))
    out = f.create_dataset("o", shape=(8, 8), chunks=(4, 4), dtype="float32", compression=None)
    inp = np.arange(64, dtype="float32").reshape(8, 8)
    blocking = Blocking((8, 8), (4, 4))
    BlockwiseExecutor(target="local", backoff_base=1e-4).map_blocks(
        lambda x: x * 2, [blocking.get_block(i) for i in range(4)], lambda b: (inp[b.bb],),
        lambda b, raw: out.__setitem__(b.bb, np.asarray(raw)), store_verify_fn=region_verifier(out),
        failures_path=os.path.join(str(tmp_path), "failures.json"), task_name="double")
    return out, inp * 2, blocking


def test_constants_equal_the_reference():
    for name in ("STATE_FILENAME", "_DEFAULT_INTERVAL_S", "_DEFAULT_BYTES_PER_INTERVAL", "_TARGET_MAX",
                 "_WALK_DIR_CAP"):
        assert getattr(scrub, name) == getattr(jscrub, name), name


def test_register_producer_enlists_the_store(tmp_path):
    out, _, blocking = _run_double_sweep(tmp_path)
    assert repair.stats()["producers"] == 4
    labels = [label for label, _ in scrub.registered_targets()]
    assert labels == [out._label]
    # in-memory datasets have no sidecar directory: never enlisted
    mem = open_container("memory://scrub-test").create_dataset("m", shape=(4, 4), chunks=(4, 4), dtype="uint8")
    assert scrub.register_target(mem) is False
    scrub.reset_targets()
    assert scrub.registered_targets() == []


def test_scrubber_finds_and_repairs_at_rest(tmp_path):
    """One budgeted scan finds the rotted region, repairs it from the
    producer, and the bytes verify again, with nobody reading the data."""
    out, expected, blocking = _run_double_sweep(tmp_path)
    bb = blocking.get_block(1).bb
    bad = out._read_back(bb).copy()
    bad[1, 1] += 3.0
    out._write_raw(bb, bad)
    s = scrub.Scrubber(base_dir=str(tmp_path), enabled=False)
    assert s.scan_once(budget_bytes=1 << 30) >= 4
    st = s.stats()
    assert st["found_corrupt"] == 1 and st["repaired"] == 1
    assert st["passes"] == 1 and st["unrepairable"] == 0
    assert st["last_corrupt"]["repaired"] is True
    np.testing.assert_array_equal(out[...], expected)
    state = json.load(open(os.path.join(str(tmp_path), "scrub_state.json")))
    assert state["found_corrupt"] == 1 and state["repair"]["repaired"] == 1


def test_scrubber_discovers_at_rest_targets_from_roots(tmp_path):
    """No live registry (a restarted process): sidecar dirs under the roots
    are found and verified; rot without lineage is counted unrepairable."""
    ds, _ = _mk_product("port", tmp_path)
    assert scrub.discover_targets([str(tmp_path)]) == [(os.path.join(str(tmp_path), "prod.zarr"), "a")]
    assert scrub.discover_targets([str(tmp_path)]) == jscrub.discover_targets([str(tmp_path)])
    repair.reset()
    scrub.reset_targets()
    raw = open(_chunk_file(ds), "rb").read()
    with open(_chunk_file(ds), "wb") as f:
        f.write(bytes([raw[0] ^ 1]) + raw[1:])
    s = scrub.Scrubber(base_dir=str(tmp_path), roots=[str(tmp_path)], enabled=False)
    assert s.scan_once(budget_bytes=1 << 30) == 1
    st = s.stats()
    assert st["found_corrupt"] == 1 and st["unrepairable"] == 1
    assert st["repair"]["no_lineage"] >= 1


def test_scrubber_budget_and_cursor_resume(tmp_path):
    """The byte budget holds per slice and the cursor resumes where the
    last slice stopped: four 1-byte slices make one full pass."""
    _run_double_sweep(tmp_path)
    s = scrub.Scrubber(base_dir=str(tmp_path), enabled=False)
    for i in range(4):
        assert s.scan_once(budget_bytes=1) == 1
        if i < 3:
            assert s.stats()["position"]["index"] == i + 1
    st = s.stats()
    assert st["passes"] == 1 and st["scanned_regions"] == 4 and st["scanned_bytes"] == 4 * 64
    assert st["position"]["index"] == 0 and st["coverage"] == 0.0


@pytest.mark.parametrize("writer,scrubber", [("jax", "port"), ("port", "jax")])
def test_scrubber_over_the_other_packages_sidecars(tmp_path, writer, scrubber):
    """A store one package wrote verifies clean under the other's scrubber,
    and rot in it is found there (unrepairable: that process holds no
    lineage); both scrubbers write the same ``scrub_state.json`` keys."""
    ds, _ = _mk_product(writer, tmp_path)
    s = SCRUB[scrubber].Scrubber(base_dir=str(tmp_path), roots=[str(tmp_path)], enabled=False)
    assert s.scan_once(budget_bytes=1 << 30) == 1
    assert s.stats()["found_corrupt"] == 0 and s.stats()["errors"] == 0
    raw = open(_chunk_file(ds), "rb").read()
    with open(_chunk_file(ds), "wb") as f:
        f.write(raw[:5] + bytes([raw[5] ^ 0x10]) + raw[6:])
    assert s.scan_once(budget_bytes=1 << 30) == 1
    st = s.stats()
    assert st["found_corrupt"] == 1 and st["unrepairable"] == 1 and st["passes"] == 2
    assert st["last_corrupt"] == {"dataset": f"{os.path.join(str(tmp_path), 'prod.zarr')}:a",
                                  "region": [[0, 4], [0, 4]], "repaired": False}


def test_scrub_state_equals_the_reference(tmp_path):
    """The same at-rest store scrubbed by both packages: the same
    ``scrub_state.json``, key for key and (but the clock) value for value."""
    docs = {}
    for side in ("port", "jax"):
        root = tmp_path / side
        ds, _ = _mk_product(side, root)
        raw = open(_chunk_file(ds), "rb").read()
        with open(_chunk_file(ds), "wb") as f:
            f.write(bytes([raw[0] ^ 4]) + raw[1:])
        s = SCRUB[side].Scrubber(base_dir=str(root), roots=[str(root)], interval_s=2.0, bytes_per_interval=4096,
                                 enabled=False)
        s.scan_once()
        doc = json.load(open(os.path.join(str(root), "scrub_state.json")))
        doc.pop("time")
        doc["last_corrupt"]["dataset"] = os.path.relpath(doc["last_corrupt"]["dataset"], str(root))
        doc["position"]["dataset"] = os.path.relpath(doc["position"]["dataset"], str(root))
        docs[side] = doc
    assert docs["port"] == docs["jax"]
    assert docs["port"]["found_corrupt"] == 1 and docs["port"]["reader"] and docs["port"]["repair"]


def test_scrub_stops_on_drain_and_stop(tmp_path):
    _run_double_sweep(tmp_path)
    s = scrub.Scrubber(base_dir=str(tmp_path), interval_s=0.05).start()
    try:
        deadline = time.monotonic() + 20
        while s.stats()["scanned_regions"] < 4 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert s.stats()["passes"] >= 1
        supervision.request_drain("test")
        time.sleep(0.5)  # a slice already running finishes
        before = s.stats()["scanned_regions"]
        time.sleep(0.5)
        assert s.stats()["scanned_regions"] == before  # the grace period is not the scrubber's
    finally:
        supervision.reset_drain()
        s.stop()
    assert s._thread is None


def test_port_server_scrub_self_heals(tmp_path):
    """A resident port server finishes a request on the CPU; one block of
    its product is rotted at rest; the server's scrubber finds and repairs
    it from lineage; the product equals its clean bytes and the healing
    shows in ``/healthz``, ``/status``, ``scrub_state.json`` and the
    machine-readable failures report."""
    from cluster_tools_tpu_torch.runtime.server import PipelineServer, ServeClient

    base = str(tmp_path)
    vol = (np.random.default_rng(11).random((16, 16, 16)) > 0.5).astype("float32")
    data = os.path.join(base, "data.zarr")
    file_reader(data).create_dataset("mask", shape=vol.shape, chunks=(8, 8, 8), dtype="float32")[...] = vol
    srv = os.path.join(base, "srv")
    server = PipelineServer(base_dir=srv, max_workers=1,
                            scrub={"interval_s": 0.1, "bytes_per_interval": 1 << 30, "roots": [base]}).start()
    client = ServeClient(server.host, server.port)
    try:
        client.submit(tenant="alice", request_id="r1", workflow="connected_components",
                      config=dict(tmp_folder=os.path.join(base, "req_r1"), target="local",
                                  global_config={"block_shape": [8, 8, 8]},
                                  params=dict(input_path=data, input_key="mask", output_path=data,
                                              output_key="seg", threshold=0.5)))
        assert client.wait("r1", timeout_s=120)["state"] == "done"
        seg = file_reader(data)["seg"]
        clean = np.asarray(seg[...])
        bb = tuple(slice(0, 8) for _ in range(3))
        bad = seg._read_back(bb).copy()
        bad[0, 0, 0] += 1
        seg._write_raw(bb, bad)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            sc = client.healthz().get("scrub") or {}
            if sc.get("found_corrupt", 0) >= 1 and sc.get("repaired", 0) >= 1:
                break
            time.sleep(0.1)
        else:
            raise AssertionError(f"the scrubber never healed the rot: {client.healthz()}")
        assert sc["unrepairable"] == 0
        np.testing.assert_array_equal(np.asarray(file_reader(data)["seg"][...]), clean)
        status = client.status()
        assert status["server"]["scrub"]["repaired"] >= 1 and status["rc"] == 0
        assert json.load(open(os.path.join(srv, "scrub_state.json")))["found_corrupt"] >= 1
        import importlib.util

        spec = importlib.util.spec_from_file_location("_fr_torch_scrub",
                                                      os.path.join(REPO_ROOT, "scripts", "failures_report.py"))
        rep = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(rep)
        jdoc = rep.build_json_report(srv, with_lint=False)
        assert jdoc["scrub"]["repaired"] >= 1 and jdoc["scrub"]["repair"]["repaired"] >= 1
        req_doc = fu.read_json_if_valid(fu.failures_path(os.path.join(base, "req_r1")))
        recs = [r for r in (req_doc or {}).get("records", []) if r.get("resolution") == repair.REPAIRED_LINEAGE]
        assert recs and recs[0]["resolved"] is True
    finally:
        server.stop()


def test_port_server_scrub_heals_a_flushed_watershed_output(tmp_path, monkeypatch):
    """The watershed's output is an in-memory handoff inside the server and
    reaches storage when the request's namespace is flushed: its block
    lineage moves with it (``repair.rehome``), so rot in the stored copy is
    repaired from lineage, bit for bit."""
    import scipy.ndimage as ndi

    from cluster_tools_tpu_torch.runtime.server import PipelineServer

    for name, value in (("CT_TIER_MODE", "cond"), ("CT_FILL_MODE", "capacity"), ("CT_SEED_CCL", "tiled")):
        monkeypatch.setenv(name, value)
    base = str(tmp_path)
    x = ndi.gaussian_filter(np.random.default_rng(5).random((32, 32, 32)), 2.0)
    data = os.path.join(base, "data.zarr")
    file_reader(data).create_dataset("b", shape=x.shape, chunks=(16, 16, 16), dtype="float32")[...] = \
        ((x - x.min()) / (x.max() - x.min())).astype(np.float32)
    server = PipelineServer(base_dir=os.path.join(base, "srv"), max_workers=1, scrub={"enabled": False}).start()
    try:
        server.submit(dict(tenant="t", request_id="w1", workflow="watershed",
                           config=dict(target="local", global_config={"block_shape": [16] * 3},
                                       params=dict(input_path=data, input_key="b", output_path=data,
                                                   output_key="ws", block_shape=[16] * 3, halo=[4, 4, 4],
                                                   threshold=0.5))))
        deadline = time.monotonic() + 120
        while server.request_record("w1")["state"] in ("queued", "running") and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server.request_record("w1")["state"] == "done"
        out = file_reader(data)["ws"]
        assert [label for label, _ in scrub.registered_targets()] == [out._label]
        clean = np.asarray(out[...])
        bb = (slice(16, 32), slice(0, 16), slice(16, 32))
        bad = out._read_back(bb).copy()
        bad[3, 4, 5] ^= 1
        out._write_raw(bb, bad)
        assert server.scrubber.scan_once(budget_bytes=1 << 30) == 8
        st = server.scrubber.stats()
        assert st["found_corrupt"] == 1 and st["repaired"] == 1 and st["unrepairable"] == 0
        np.testing.assert_array_equal(np.asarray(file_reader(data)["ws"][...]), clean)
        state = json.load(open(os.path.join(base, "srv", "scrub_state.json")))
        assert state["found_corrupt"] == 1 and state["repaired"] == 1
    finally:
        server.stop()
