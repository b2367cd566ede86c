"""The port's resident pipeline server (``runtime/server.py``, ``serve.py``)
against the JAX package's, on the CPU.

- Both servers run in process on the same payloads (connected components
  on a 16^3 zarr with block 8, a watershed on a 32^3 zarr with block 16,
  ``"target": "local"``): labels equal bit for bit, the same journal
  records a request, the same ``server_state.json`` keys and tenant
  counts.
- Request namespaces: handoff identities, concurrent requests over one
  artifact path, the executor's and ``host_block_map``'s pool workers in
  the request's namespace, ``flush_namespace`` and ``release_request``.
- The server (counterparts of the reference's ``tests/test_serve.py:195-747``):
  two tenants and the warm resubmission's cache hits, duplicate and
  unknown requests, HTTP backpressure, idempotent replay, re-enqueue of a
  journal the JAX package wrote, crash-loop quarantine, a torn journal
  tail, ``scripts/progress.py`` and ``scripts/failures_report.py`` over the
  port's base directory, a ``mutex_watershed`` request served with the
  direct run's labels and ``/adopt`` without the adoption claim refused,
  and a request naming no target failing with the device error where
  there is no card.
- ``python -m cluster_tools_tpu_torch.serve`` as a child: serve, ``--status``,
  SIGTERM drains with exit 114, the restart replays.  Every child is reaped
  in a ``finally``; no test starts the JAX package's serve entry point.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from cluster_tools_tpu.runtime import faults as jfaults
from cluster_tools_tpu.runtime import handoff as jhandoff
from cluster_tools_tpu.runtime import journal as jjournal
from cluster_tools_tpu.runtime import scrub as jscrub
from cluster_tools_tpu.runtime.server import PipelineServer as JServer
from cluster_tools_tpu.runtime.server import ServeClient as JClient
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
from cluster_tools_tpu_torch.io import chunk_cache
from cluster_tools_tpu_torch.runtime import admission, faults, handoff, scrub, supervision
from cluster_tools_tpu_torch.runtime import journal as journal_mod
from cluster_tools_tpu_torch.runtime.admission import REJECT_DUPLICATE, REJECT_FAULT, REJECT_QUEUE
from cluster_tools_tpu_torch.runtime.executor import BlockwiseExecutor
from cluster_tools_tpu_torch.runtime.server import (QUARANTINE_CRASH_LOOP, PipelineServer, ServeClient,
                                                    ServeRejected, _payload_fingerprint)
from cluster_tools_tpu_torch.utils import function_utils as fu
from cluster_tools_tpu_torch.utils.volume_utils import Blocking, file_reader

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READER = {"port": file_reader, "jax": j_reader}
SERVER = {"port": (PipelineServer, ServeClient), "jax": (JServer, JClient)}


@pytest.fixture(autouse=True)
def _fresh_process_state():
    def reset():
        for h in (handoff, jhandoff):
            h.reset()
        for f in (faults, jfaults):
            f.configure(None)
        for s in (scrub, jscrub):
            s.reset_targets()
        chunk_cache.configure()

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


def _mk_input(base, side="port", shape=(16, 16, 16), seed=0, key="mask", chunks=(8, 8, 8)):
    if key == "mask":
        vol = (np.random.default_rng(seed).random(shape) > 0.5).astype("float32")
    else:
        x = ndi.gaussian_filter(np.random.default_rng(seed).random(shape), 2.0)
        vol = ((x - x.min()) / (x.max() - x.min())).astype(np.float32)
    data = os.path.join(base, f"data_{side}.zarr")
    READER[side](data).require_dataset(key, shape=vol.shape, chunks=chunks, dtype="float32")[...] = vol
    return data


def _payload(base, data, tenant, rid, out_key, block=8, target="local"):
    cfg = dict(tmp_folder=os.path.join(base, "req_" + rid), global_config={"block_shape": [block] * 3},
               params=dict(input_path=data, input_key="mask", output_path=data, output_key=out_key, threshold=0.5))
    if target is not None:
        cfg["target"] = target
    return dict(tenant=tenant, request_id=rid, workflow="connected_components", config=cfg)


def _ws_payload(base, data, tenant, rid, out_key):
    return dict(tenant=tenant, request_id=rid, workflow="watershed",
                config=dict(tmp_folder=os.path.join(base, "req_" + rid), target="local",
                            global_config={"block_shape": [16] * 3},
                            params=dict(input_path=data, input_key="boundaries", output_path=data,
                                        output_key=out_key, block_shape=[16] * 3, halo=[4, 4, 4], threshold=0.5,
                                        min_seed_distance=1.0)))


def _start(base, side="port", **kw):
    kw.setdefault("max_workers", 2)
    server = SERVER[side][0](base_dir=os.path.join(base, "srv"), **kw).start()
    return server, SERVER[side][1](server.host, server.port)


def _journal_types(base):
    recs = journal_mod.scan(journal_mod.journal_path(os.path.join(base, "srv")))[0]
    out = {}
    for r in recs:
        out.setdefault(r["request_id"], []).append(r["type"])
    return out


# -- both packages' servers on the same payloads --------------------------------


@pytest.fixture()
def _pin_modes(monkeypatch):
    monkeypatch.setenv("CT_TIER_MODE", "cond")
    monkeypatch.setenv("CT_FILL_MODE", "capacity")
    monkeypatch.setenv("CT_SEED_CCL", "tiled")


def test_both_servers_give_equal_outputs_records_and_state(tmp_path, _pin_modes):
    """cc (16^3, block 8) from alice and a watershed (32^3, block 16) from
    bob, concurrently, on each package's server: equal labels, the same
    journal lifecycle, the same state-document keys and tenant counts."""
    got = {}
    for side in ("jax", "port"):
        base = str(tmp_path / side)
        data = _mk_input(base, side)
        _mk_input(base, side, shape=(32, 32, 32), key="boundaries", chunks=(16, 16, 16))
        server, client = _start(base, side, tenants={"alice": {}, "bob": {}})
        try:
            client.submit(**_payload(base, data, "alice", "a1", "seg"))
            client.submit(**_ws_payload(base, data, "bob", "b1", "ws"))
            recs = {rid: client.wait(rid, timeout_s=120) for rid in ("a1", "b1")}
            status = client.status()
        finally:
            server.stop()
        assert all(r["state"] == "done" for r in recs.values()), recs
        state = json.load(open(os.path.join(base, "srv", "server_state.json")))
        got[side] = dict(
            seg=np.asarray(READER["port"](data)["seg"][...]), ws=np.asarray(READER["port"](data)["ws"][...]),
            journal=_journal_types(base), state_keys=sorted(state), tenants=state["tenants"],
            request_keys={rid: sorted(r) for rid, r in state["requests"].items()},
            record_keys={rid: sorted(r) for rid, r in recs.items()}, rc=status["rc"],
            handoffs=status["server"]["handoffs"], scrub_keys=sorted(state["scrub"]),
            journal_keys=sorted(state["journal"]))
    port, ref = got["port"], got["jax"]
    assert port["seg"].dtype == ref["seg"].dtype == np.uint64
    np.testing.assert_array_equal(port["seg"], ref["seg"])
    np.testing.assert_array_equal(port["ws"], ref["ws"])
    assert len(np.unique(port["ws"])) > 8 and port["seg"].max() > 1
    for key in ("journal", "state_keys", "tenants", "request_keys", "record_keys", "rc", "handoffs", "scrub_keys",
                "journal_keys"):
        assert port[key] == ref[key], key
    assert port["journal"]["a1"] == ["accepted", "dispatched", "completed"]
    assert port["handoffs"] == {"live_entries": 0, "live_bytes": 0}


# -- request namespaces ---------------------------------------------------------


def test_handoff_identities_namespaced_by_request():
    base = handoff.dataset_identity("/data/vol.zarr", "seg")
    assert base == jhandoff.dataset_identity("/data/vol.zarr", "seg")
    assert handoff.identity_namespace(base) is None
    with admission.request_context("alice", "req-1"):
        ns = handoff.dataset_identity("/data/vol.zarr", "seg")
        assert handoff.in_current_namespace(ns) and not handoff.in_current_namespace(base)
    assert ns == f"req:req-1::{base}" and handoff.identity_namespace(ns) == "req-1"
    with admission.request_context("bob", "req-2"):
        assert not handoff.in_current_namespace(ns)
    assert handoff.in_current_namespace(base)  # batch mode: both None


def test_concurrent_requests_cannot_resolve_each_others_intermediates(tmp_path):
    path = os.path.join(str(tmp_path), "inter.npz")
    payload = {"a": np.arange(5, dtype=np.uint64)}
    with admission.request_context("alice", "r1"):
        handoff.publish_arrays(path, payload, producer="t.0")
        np.testing.assert_array_equal(handoff.load_arrays(path)["a"], payload["a"])
    with admission.request_context("bob", "r2"):
        with pytest.raises(FileNotFoundError):
            handoff.load_arrays(path)


@pytest.mark.parametrize("mode", ["per_block", "sharded"])
def test_executor_pool_workers_stay_in_the_request_namespace(tmp_path, mode):
    """Loads and stores run on the sweep's pools: each re-enters the
    request context, so a block-grain publish is namespaced and the auto
    budget sees the tenant's byte cap."""
    seen = []
    lock = threading.Lock()
    vol = np.arange(16 ** 3, dtype=np.float32).reshape(16, 16, 16)
    blocks = [Blocking(vol.shape, (8, 8, 8)).get_block(i) for i in range(8)]

    def load(b):
        with lock:
            seen.append(("load", handoff._request_namespace(), admission.ambient_byte_cap()))
        return (vol[b.bb],)

    def store(b, raw):
        handoff.publish_arrays(os.path.join(str(tmp_path), f"b{b.block_id}.npz"), {"x": np.asarray(raw)},
                               producer="t.0")
        with lock:
            seen.append(("store", handoff._request_namespace(), admission.ambient_byte_cap()))

    with admission.request_context("alice", "rq", byte_cap=1 << 20):
        BlockwiseExecutor(target="local").map_blocks(lambda x: x + 1, blocks, load, store,
                                                     failures_path=os.path.join(str(tmp_path), "f.json"),
                                                     task_name="scoped", sweep_mode=mode, sharded_batch=4)
    assert len(seen) == 16 and set(seen) == {("load", "rq", 1 << 20), ("store", "rq", 1 << 20)}
    assert all(e.startswith("req:rq::") for e in handoff.get_registry()._entries)
    assert handoff.release_request("rq") == 8 and handoff.live_entries() == 0


def test_host_block_map_workers_stay_in_the_request_namespace(tmp_path):
    from cluster_tools_tpu_torch.tasks.copy_volume import CopyVolumeLocal

    os.makedirs(str(tmp_path / "cfg"))
    with open(str(tmp_path / "cfg" / "global.config"), "w") as f:
        json.dump({"block_shape": [4, 4, 4]}, f)
    task = CopyVolumeLocal(tmp_folder=str(tmp_path / "tmp"), config_dir=str(tmp_path / "cfg"), max_jobs=4,
                           input_path="", input_key="", output_path="", output_key="")
    seen = set()

    def process(block_id):
        seen.add((threading.current_thread().name != "MainThread", handoff._request_namespace()))

    with admission.request_context("bob", "rh"):
        assert task.host_block_map(list(range(8)), process) == 8
    assert seen == {(True, "rh")}


def test_flush_namespace_writes_datasets_back_and_release_drops_all(tmp_path):
    path = os.path.join(str(tmp_path), "out.zarr")
    with admission.request_context("alice", "r5"):
        ds, entry = handoff.acquire_dataset(path, "seg", shape=(8, 8, 8), chunks=(4, 4, 4), dtype="uint64",
                                            producer="t.0")
        ds[:] = np.arange(512, dtype=np.uint64).reshape(8, 8, 8)
        entry.complete = True
        art = os.path.join(str(tmp_path), "private.npz")
        handoff.publish_arrays(art, {"a": np.ones(4)}, producer="t.0")
    assert handoff.flush_namespace("r5") == 512 * 8
    np.testing.assert_array_equal(np.asarray(file_reader(path)["seg"][...]),
                                  np.arange(512, dtype=np.uint64).reshape(8, 8, 8))
    assert not os.path.exists(art)  # artifacts are request-private
    assert handoff.release_request("r5") == 2
    assert handoff.live_entries() == 0


# -- the resident server ----------------------------------------------------------


def test_two_tenants_warm_cache(tmp_path):
    base = str(tmp_path)
    data = _mk_input(base)
    server, client = _start(base, tenants={"alice": {}, "bob": {}})
    try:
        client.submit(**_payload(base, data, "alice", "a1", "seg_a"))
        client.submit(**_payload(base, data, "bob", "b1", "seg_b"))
        assert client.wait("a1", timeout_s=120)["state"] == "done"
        assert client.wait("b1", timeout_s=120)["state"] == "done"
        client.submit(**_payload(base, data, "alice", "a2", "seg_a2"))
        assert client.wait("a2", timeout_s=120)["state"] == "done"
        io_doc = json.load(open(os.path.join(base, "req_a2", "io_metrics.json")))
        assert sum(t.get("hits", 0) for t in io_doc["tasks"].values()) > 0
        assert sum(t.get("misses", 0) for t in io_doc["tasks"].values()) == 0
        status = client.status()
        tenants = status["server"]["tenants"]
        assert tenants["alice"]["completed"] == 2 and tenants["bob"]["completed"] == 1
        assert status["server"]["handoffs"]["live_entries"] == 0 and status["rc"] == 0
        assert status["server"]["programs"] is None and client.healthz()["programs"] is None
        seg = {k: np.asarray(file_reader(data)[k][...]) for k in ("seg_a", "seg_b", "seg_a2")}
        np.testing.assert_array_equal(seg["seg_a"], seg["seg_b"])
        np.testing.assert_array_equal(seg["seg_a"], seg["seg_a2"])
    finally:
        server.stop()


def test_injected_admit_fault_leaves_no_partial_state(tmp_path):
    base = str(tmp_path)
    data = _mk_input(base)
    faults.configure({"seed": 3, "faults": [{"site": "admit", "kind": "reject", "tenants": ["bob"],
                                             "fail_attempts": 1}]})
    server, client = _start(base, tenants={"alice": {}, "bob": {}})
    try:
        with pytest.raises(ServeRejected) as ei:
            client.submit(**_payload(base, data, "bob", "b1", "seg"))
        assert ei.value.code == REJECT_FAULT and ei.value.http_status == 429
        assert not os.path.exists(os.path.join(base, "req_b1"))
        assert handoff.live_entries() == 0 and client.request("b1") is None
        doc = fu.read_json_if_valid(fu.failures_path(os.path.join(base, "srv")))
        recs = [r for r in doc["records"] if r.get("task") == "server.bob"]
        assert recs and recs[0]["resolution"] == REJECT_FAULT and recs[0]["resolved"] is True
        assert recs[0]["sites"] == {"admit": 1}
        assert client.status()["rc"] == 0
        client.submit(**_payload(base, data, "alice", "a1", "seg_a"))
        assert client.wait("a1", timeout_s=120)["state"] == "done"
    finally:
        server.stop()


def test_duplicate_and_unknown_requests(tmp_path):
    base = str(tmp_path)
    data = _mk_input(base, shape=(8, 8, 8))
    server, client = _start(base, max_workers=1)
    try:
        client.submit(**_payload(base, data, "t", "r1", "seg1"))
        doc = client.submit(**_payload(base, data, "t", "r1", "seg1"))
        assert doc["idempotent"] is True and doc["state"] in ("queued", "running", "done")
        with pytest.raises(ServeRejected) as ei:
            client.submit(**_payload(base, data, "t", "r1", "OTHER"))
        assert ei.value.code == REJECT_DUPLICATE
        assert client.status()["server"]["tenants"]["t"]["rejected"] == 1
        with pytest.raises(ServeRejected) as ei:
            client.submit(tenant="t", request_id="r2", workflow="definitely_not_a_workflow")
        assert ei.value.http_status == 400
        rec = client.wait("r1", timeout_s=120)
        assert rec["state"] == "done"
        doc = client.submit(**_payload(base, data, "t", "r1", "seg1"))
        assert doc == {"request_id": "r1", "state": "done", "idempotent": True, "run_s": rec["run_s"],
                       "total_s": rec["total_s"]}
        assert client.request("nope") is None
    finally:
        server.stop()


def test_unported_workflows_and_adoption_are_refused_with_their_items(tmp_path):
    """The names ROADMAP item 12 ported are served: a small
    ``mutex_watershed`` request (with its stitching) finishes with the labels
    of the same workflow run directly.  Adoption without the peer's claim
    stays refused."""
    from cluster_tools_tpu_torch.runtime import netio
    from cluster_tools_tpu_torch.runtime.task import build
    from cluster_tools_tpu_torch.tasks.mutex_watershed import MwsWorkflow

    from .test_mws_stitching import OFFSETS, make_affinities

    base = str(tmp_path)
    gt = np.ones((8, 16, 16), np.uint64)
    gt[:, 6:, :] = 2
    gt[:, :, 10:] += 2
    affs = make_affinities(gt, OFFSETS, noise=0.02, rng=np.random.default_rng(3))
    data = os.path.join(base, "affs.zarr")
    file_reader(data).require_dataset("affs", shape=affs.shape, chunks=(len(OFFSETS), 8, 8, 8),
                                      dtype="float32")[...] = affs
    params = dict(input_path=data, input_key="affs", output_path=data, offsets=OFFSETS, halo=[2, 2, 2],
                  block_shape=[8, 8, 8])
    os.makedirs(os.path.join(base, "direct_cfg"))
    with open(os.path.join(base, "direct_cfg", "global.config"), "w") as f:
        json.dump({"block_shape": [8, 8, 8]}, f)
    assert build([MwsWorkflow(tmp_folder=os.path.join(base, "direct"), config_dir=os.path.join(base, "direct_cfg"),
                              max_jobs=2, target="local", output_key="direct", **params)])
    server, client = _start(base, max_workers=1)
    try:
        client.submit(tenant="t", request_id="mws", workflow="mutex_watershed",
                      config=dict(tmp_folder=os.path.join(base, "req_mws"), target="local",
                                  global_config={"block_shape": [8, 8, 8]}, params=dict(params, output_key="served")))
        assert client.wait("mws", timeout_s=120)["state"] == "done"
        served = file_reader(data)["served"][...]
        np.testing.assert_array_equal(served, file_reader(data)["direct"][...])
        assert (served > 0).all() and len(np.unique(served)) == 4
        # adoption is ported (the fleet): without the peer's adoption claim
        # it is refused, as in the reference (409 adoption_refused)
        from cluster_tools_tpu_torch.runtime.fleet import AdoptionRefused

        with pytest.raises(AdoptionRefused, match="no adoption claim"):
            server.adopt_journal(str(tmp_path / "peer"))
        status, doc = netio.http_json_call(server.host, server.port, "POST", "/adopt",
                                           {"base_dir": str(tmp_path / "peer")}, timeout_s=10)
        assert status == 409 and doc["error"] == "adoption_refused" and "no adoption claim" in doc["detail"]
        assert client.status()["server"]["adoptions"] == []
    finally:
        server.stop()


def test_request_without_target_runs_on_the_card(tmp_path):
    """No ``target`` means the card: without one the request fails with
    the device error in its record, and nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request would run on it")
    base = str(tmp_path)
    data = _mk_input(base, shape=(8, 8, 8))
    server, client = _start(base, max_workers=1)
    try:
        client.submit(**_payload(base, data, "t", "g1", "seg", target=None))
        rec = client.wait("g1", timeout_s=120)
        assert rec["state"] == "failed" and "no CUDA device is available" in rec["error"]
        assert "seg" not in os.listdir(data)
        # the device is resolved before anything of the request is built
        assert not os.path.exists(os.path.join(base, "req_g1"))
    finally:
        server.stop()


def test_server_queue_quota_backpressure_http(tmp_path):
    base = str(tmp_path)
    data = _mk_input(base, shape=(8, 8, 8))
    server, client = _start(base, tenants={"t": {"max_queue_depth": 1, "max_inflight": 1}}, max_workers=1)
    try:
        client.submit(**_payload(base, data, "t", "r1", "s1"))
        client.submit(**_payload(base, data, "t", "r2", "s2"))
        codes = set()
        try:
            client.submit(**_payload(base, data, "t", "r3", "s3"))
        except ServeRejected as e:
            codes.add((e.code, e.http_status))
        assert codes == {(REJECT_QUEUE, 429)}
        assert client.wait("r1", timeout_s=120)["state"] == "done"
        assert client.wait("r2", timeout_s=120)["state"] == "done"
        client.submit(**_payload(base, data, "t", "r3", "s3"))
        assert client.wait("r3", timeout_s=120)["state"] == "done"
    finally:
        server.stop()


# -- the journal: replay, re-enqueue, quarantine, torn tail --------------------------


def test_restart_replays_completed_requests_idempotently(tmp_path):
    base = str(tmp_path)
    data = _mk_input(base, shape=(8, 8, 8))
    payload = _payload(base, data, "alice", "a1", "seg")
    server, client = _start(base, tenants={"alice": {}})
    try:
        client.submit(**payload)
        rec = client.wait("a1", timeout_s=120)
        assert rec["state"] == "done"
    finally:
        server.stop()
    server2, client2 = _start(base, tenants={"alice": {}})
    try:
        rec2 = client2.request("a1")
        assert rec2["state"] == "done" and rec2["replayed"] is True and rec2["run_s"] == rec["run_s"]
        doc = client2.submit(**payload)
        assert doc["idempotent"] is True and doc["state"] == "done"
        snap = client2.status()["server"]["tenants"]["alice"]
        assert snap["submitted"] == 1 and snap["completed"] == 1
        with pytest.raises(ServeRejected) as ei:
            client2.submit(**_payload(base, data, "alice", "a1", "other_key"))
        assert ei.value.code == REJECT_DUPLICATE
    finally:
        server2.stop()


def test_replay_reenqueues_a_request_the_reference_journaled(tmp_path):
    """An accepted-but-never-run request in a journal the JAX package wrote
    is re-run by the port's server with its original tenant and payload."""
    base = str(tmp_path)
    data = _mk_input(base, shape=(8, 8, 8))
    payload = _payload(base, data, "bob", "b1", "seg_b")
    os.makedirs(os.path.join(base, "srv"))
    j = jjournal.Journal(jjournal.journal_path(os.path.join(base, "srv")))
    j.recover()
    j.append_transition(jjournal.ACCEPTED, "b1", tenant="bob", payload=payload,
                        fingerprint=_payload_fingerprint(payload))
    j.close()
    server, client = _start(base, tenants={"bob": {}})
    try:
        health = client.healthz()["journal"]
        assert health["reenqueued"] == 1 and health["quarantined"] == 0
        rec = client.wait("b1", timeout_s=120)
        assert rec["state"] == "done" and rec["replayed"] is True
        assert np.asarray(file_reader(data)["seg_b"][...]).shape == (8, 8, 8)
        assert client.healthz()["journal"]["replay_backlog"] == 0
        assert handoff.live_entries() == 0
    finally:
        server.stop()
    # the reference reads the port's additions to its journal
    folded = jjournal.fold(jjournal.scan(jjournal.journal_path(os.path.join(base, "srv")))[0])
    assert folded["b1"]["state"] == jjournal.COMPLETED and folded["b1"]["attempts"] == 1


def test_replay_quarantines_crash_looping_request(tmp_path):
    base = str(tmp_path)
    data = _mk_input(base, shape=(8, 8, 8))
    payload = _payload(base, data, "eve", "p1", "seg_p")
    os.makedirs(os.path.join(base, "srv"))
    j = journal_mod.Journal(journal_mod.journal_path(os.path.join(base, "srv")))
    j.recover()
    j.append_transition(journal_mod.ACCEPTED, "p1", tenant="eve", payload=payload,
                        fingerprint=_payload_fingerprint(payload))
    for attempt in (1, 2):
        j.append_transition(journal_mod.DISPATCHED, "p1", tenant="eve", attempt=attempt)
    j.close()
    server, client = _start(base, tenants={"eve": {}}, max_replay_attempts=2)
    try:
        rec = client.request("p1")
        assert rec["state"] == "quarantined" and rec["code"] == QUARANTINE_CRASH_LOOP
        health = client.healthz()["journal"]
        assert health["quarantined"] == 1 and health["reenqueued"] == 0
        doc = client.submit(**payload)
        assert doc["idempotent"] is True and doc["state"] == "quarantined"
        with pytest.raises(ServeRejected) as ei:
            client.submit(**_payload(base, data, "eve", "p1", "zz"))
        assert ei.value.code == REJECT_DUPLICATE
        doc = fu.read_json_if_valid(fu.failures_path(os.path.join(base, "srv")))
        recs = [r for r in doc["records"] if r.get("task") == "server.eve" and r.get("block_id") == "request:p1"]
        assert recs and recs[0]["resolution"] == QUARANTINE_CRASH_LOOP
        assert recs[0]["quarantined"] is True and recs[0]["resolved"] is True
        assert recs[0]["sites"] == {"journal_replay": 2}
        assert client.status()["rc"] == 0
        for mod in (journal_mod, jjournal):
            assert mod.fold(mod.scan(j.path)[0])["p1"]["state"] == mod.QUARANTINED
    finally:
        server.stop()


def test_replay_tolerates_torn_journal_tail(tmp_path):
    base = str(tmp_path)
    data = _mk_input(base, shape=(8, 8, 8))
    payload = _payload(base, data, "t", "r1", "seg")
    os.makedirs(os.path.join(base, "srv"))
    jpath = journal_mod.journal_path(os.path.join(base, "srv"))
    j = journal_mod.Journal(jpath)
    j.recover()
    j.append_transition(journal_mod.ACCEPTED, "r1", tenant="t", payload=payload,
                        fingerprint=_payload_fingerprint(payload))
    j.append_transition(journal_mod.ACCEPTED, "r2", tenant="t", payload={"workflow": "connected_components"})
    j.close()
    with open(jpath, "r+b") as f:
        f.truncate(os.path.getsize(jpath) - 7)
    server, client = _start(base)
    try:
        health = client.healthz()["journal"]
        assert health["torn_bytes_truncated"] > 0 and health["reenqueued"] == 1
        assert client.request("r2") is None
        assert client.wait("r1", timeout_s=120)["state"] == "done"
    finally:
        server.stop()


@pytest.mark.parametrize("kind", ["rejected", "quarantined"])
def test_failure_records_equal_the_reference(tmp_path, kind):
    """A typed rejection (an injected ``admit`` fault) and a crash-loop
    quarantine land in ``failures.json`` with the reference's records:
    equal but for the process id in a rejection's block id."""
    got = {}
    for side, (fmod, jmod) in (("port", (faults, journal_mod)), ("jax", (jfaults, jjournal))):
        base = str(tmp_path / side)
        data = _mk_input(base, side, shape=(8, 8, 8))
        payload = _payload(base, data, "eve", "p1", "seg")
        if kind == "quarantined":
            os.makedirs(os.path.join(base, "srv"))
            j = jmod.Journal(jmod.journal_path(os.path.join(base, "srv")))
            j.recover()
            j.append_transition(jmod.ACCEPTED, "p1", tenant="eve", payload=payload,
                                fingerprint=_payload_fingerprint(payload))
            j.append_transition(jmod.DISPATCHED, "p1", tenant="eve", attempt=1)
            j.close()
        else:
            fmod.configure({"seed": 3, "faults": [{"site": "admit", "kind": "reject", "tenants": ["eve"],
                                                   "fail_attempts": 1}]})
        server, client = _start(base, side, tenants={"eve": {}}, max_workers=1, max_replay_attempts=1)
        try:
            if kind == "rejected":
                with pytest.raises(Exception) as ei:
                    client.submit(**payload)
                assert getattr(ei.value, "code", None) == REJECT_FAULT
            status = client.status()
        finally:
            server.stop()
            fmod.configure(None)
        doc = fu.read_json_if_valid(fu.failures_path(os.path.join(base, "srv")))
        recs = []
        for r in doc["records"]:
            r = dict(r)
            r.pop("time", None)
            r["block_id"] = str(r["block_id"]).replace(f":{os.getpid()}:", ":<pid>:")
            recs.append(r)
        got[side] = (recs, status["rc"], sorted(doc))
    assert got["port"] == got["jax"]
    resolution = REJECT_FAULT if kind == "rejected" else QUARANTINE_CRASH_LOOP
    assert [r["resolution"] for r in got["port"][0]] == [resolution] and got["port"][1] == 0


# -- the operator scripts over the port's base directory ------------------------------


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_torch_serve_{name}", os.path.join(REPO_ROOT, "scripts",
                                                                                         f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_progress_and_failures_report_render_the_ports_base_dir(tmp_path):
    base = str(tmp_path)
    data = _mk_input(base, shape=(8, 8, 8))
    server, client = _start(base, tenants={"alice": {}})
    try:
        client.submit(**_payload(base, data, "alice", "a1", "seg"))
        client.wait("a1", timeout_s=120)
    finally:
        server.stop()
    srv = os.path.join(base, "srv")
    prog = _script("progress")
    doc = prog.collect_progress(srv)
    assert doc["server"]["tenants"]["alice"]["completed"] == 1
    assert "server" not in {t["uid"] for t in doc["tasks"]}
    j = doc["server"]["journal"]
    assert j["appended"] == 3 and j["replay_backlog"] == 0
    text = prog.format_progress(doc)
    assert "tenant alice" in text and "1 completed" in text
    assert "journal:" in text and "3 record(s) appended" in text
    rep = _script("failures_report")
    jdoc = rep.build_json_report(srv, with_lint=False)
    assert jdoc["journal"]["n_records"] == 3
    assert jdoc["journal"]["by_type"] == {"accepted": 1, "dispatched": 1, "completed": 1}
    assert jdoc["journal"]["n_replays"] == 0 and jdoc["journal"]["torn_tail_bytes"] == 0
    recs, good, torn = journal_mod.scan(journal_mod.journal_path(srv))
    assert len(recs) == 3 and torn == 0 and good == jdoc["journal"]["bytes"]
    sblock = jdoc["scrub"]
    for key in ("passes", "scanned_regions", "scanned_bytes", "found_corrupt", "repaired", "unrepairable", "reader",
                "repair"):
        assert key in sblock, key
    assert sblock["found_corrupt"] == 0 and sblock["unrepairable"] == 0
    assert rep.build_json_report(base, with_lint=False)["journal"] is None
    # the server's /status report is the same document
    assert server._json_report()["journal"]["n_records"] == 3


def test_serve_cli_status_requires_endpoint(tmp_path):
    from cluster_tools_tpu_torch import serve as serve_cli

    with pytest.raises(FileNotFoundError):
        serve_cli.cmd_status(str(tmp_path))


# -- the entry point as a child process ----------------------------------------------


def _wait_for(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _spawn(base, env):
    return subprocess.Popen([sys.executable, "-m", "cluster_tools_tpu_torch.serve", "--base-dir",
                             os.path.join(base, "srv"), "--max-workers", "1"], cwd=REPO_ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _reap(proc):
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait(timeout=30)


def test_serve_entry_point_drains_with_114_and_replays(tmp_path):
    """The child serves a cc request, answers ``--status``, drains on
    SIGTERM with exit 114 while a slow request is queued, and the restart
    in the same base directory replays it to done."""
    base = str(tmp_path)
    data = _mk_input(base)
    env = dict(os.environ, PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    endpoint = os.path.join(base, "srv", "server.json")
    proc = None
    try:
        proc = _spawn(base, env)
        _wait_for(lambda: os.path.exists(endpoint) or proc.poll() is not None, 120, "the endpoint file")
        assert proc.poll() is None, proc.stdout.read()
        client = ServeClient.from_endpoint_file(os.path.join(base, "srv"))
        client.submit(**_payload(base, data, "alice", "a1", "seg"))
        assert client.wait("a1", timeout_s=120)["state"] == "done"
        st = subprocess.run([sys.executable, "-m", "cluster_tools_tpu_torch.serve", "--status",
                             os.path.join(base, "srv")], cwd=REPO_ROOT, env=env, capture_output=True, text=True,
                            timeout=120)
        assert st.returncode == 0, st.stderr[-2000:]
        assert json.loads(st.stdout)["server"]["tenants"]["alice"]["completed"] == 1
        # a queued request at SIGTERM stays journaled for the restart
        client.submit(**_payload(base, data, "bob", "b1", "seg_b"))
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == supervision.REQUEUE_EXIT_CODE, out[-3000:]
        assert "DRAINED" in out
        proc = _spawn(base, env)
        client = ServeClient.from_endpoint_file(os.path.join(base, "srv"))
        rec = client.wait("b1", timeout_s=120, across_restarts=True)
        assert rec["state"] == "done", rec
        np.testing.assert_array_equal(np.asarray(file_reader(data)["seg"][...]),
                                      np.asarray(file_reader(data)["seg_b"][...]))
        types = _journal_types(base)
        assert types["a1"] == ["accepted", "dispatched", "completed"]
        assert types["b1"][0] == "accepted" and types["b1"][-1] == "completed"
    finally:
        _reap(proc)
