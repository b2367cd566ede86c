"""The port's fleet (``runtime/fleet.py``, ``fleet.py`` and the server's
journal adoption) on the CPU.

- The reference's ``tests/test_fleet.py`` case for case: the
  adoption-claim protocol (exclusivity under contention, stale-break on
  dead pids, claim-gated peer-journal reads), tenant-affine placement with
  typed fleet backpressure, the gateway end to end over in-process port
  servers (``"target": "local"``), journal adoption into a live server,
  the in-process failover, ``drain_emptiest``, the rebuild from disk, the
  reaper's decision table and the fresh-dir lineage names, and
  ``scripts/progress.py`` (unchanged) rendering the fleet and supervisor
  views — also from the documents the port's own gateway and supervisor
  write.
- The gateway and breaker half of the reference's ``tests/test_grayfail.py``
  (``:287-605``): the circuit breaker, ``_member_call`` as its informant,
  breaker-typed backpressure, routing around an open breaker, the hedge
  delay and hedged submission past a wedged member, the fenced member's
  503 and self-drain, the state document and the progress view's zombie
  page.
- Across the packages: the port's server adopts a journal the JAX
  package's server wrote, and the reverse, each under a claim the other
  package took; the adopted request's output equals the original
  owner's.

No case spawns a fleet of processes (the reference's kill cases in
``tests/test_chaos.py`` are ``slow``; their card counterpart is
``chip_smoke.py``'s "fleet" phase).
"""

import http.server
import importlib.util
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from cluster_tools_tpu.runtime import faults as jfaults
from cluster_tools_tpu.runtime import fleet as jfleet
from cluster_tools_tpu.runtime import handoff as jhandoff
from cluster_tools_tpu.runtime import journal as jjournal
from cluster_tools_tpu.runtime import scrub as jscrub
from cluster_tools_tpu.runtime.server import PipelineServer as JServer
from cluster_tools_tpu.runtime.server import ServeClient as JClient
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
from cluster_tools_tpu_torch.fleet import (FleetSupervisor, classify_member_exit, fresh_member_name,
                                           split_generation)
from cluster_tools_tpu_torch.io import chunk_cache
from cluster_tools_tpu_torch.runtime import faults, handoff, netio, scrub, supervision
from cluster_tools_tpu_torch.runtime import journal as journal_mod
from cluster_tools_tpu_torch.runtime.admission import (REJECT_FLEET_BACKLOG, REJECT_FLEET_BREAKER,
                                                       REJECT_FLEET_NO_MEMBER)
from cluster_tools_tpu_torch.runtime.fleet import (CLAIM_FILENAME, FLEET_STATE_FILENAME, AdoptionRefused,
                                                   CircuitBreaker, FleetGateway, acquire_adoption_claim,
                                                   adoption_claim_path, read_adoption_claim, read_peer_journal,
                                                   release_adoption_claim, verify_adoption_claim)
from cluster_tools_tpu_torch.runtime.server import (ENDPOINT_FILENAME, FENCED_RESOLUTION, RETRYABLE_REJECTS,
                                                    PipelineServer, ServeClient, _payload_fingerprint)
from cluster_tools_tpu_torch.runtime.supervision import FENCED_EXIT_CODE, REQUEUE_EXIT_CODE
from cluster_tools_tpu_torch.utils import function_utils as fu
from cluster_tools_tpu_torch.utils.volume_utils import file_reader

from .helpers import stray_serve_pids as _stray_serve_pids

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    """A server's serve loop may arm the drain handler: restore both
    signals and the port's flag and latch after every case."""
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGUSR1)}
    installed = supervision._drain_installed
    yield
    for sig, handler in saved.items():
        signal.signal(sig, handler)
    supervision._drain_installed = installed
    supervision.reset_drain()


def _dead_pid():
    """A pid that is provably dead on this host."""
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    return proc.pid


# -- the adoption-claim protocol ----------------------------------------------


def test_adoption_claim_exclusive_under_contention(tmp_path):
    """N concurrent contenders for one dead member's journal — exactly ONE
    wins the O_CREAT|O_EXCL claim, the live winner is never stolen from,
    and the reference's reader sees the port's claim document."""
    peer = str(tmp_path)
    wins = []
    barrier = threading.Barrier(8)

    def contend(i):
        barrier.wait()
        doc = acquire_adoption_claim(peer, by=f"srv{i}", pid=os.getpid())
        if doc is not None:
            wins.append((i, doc))

    threads = [threading.Thread(target=contend, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(wins) == 1, [w[0] for w in wins]
    winner_i, winner_doc = wins[0]
    held = read_adoption_claim(peer)
    assert held["by"] == f"srv{winner_i}" and held["pid"] == os.getpid()
    assert jfleet.read_adoption_claim(peer) == held
    assert set(held) == {"by", "pid", "host", "time", "token"}
    # re-contending against the live winner still loses, in either package
    assert acquire_adoption_claim(peer, by="late", pid=os.getpid()) is None
    assert jfleet.acquire_adoption_claim(peer, by="late", pid=os.getpid()) is None
    # a release with the WRONG token is a no-op
    release_adoption_claim(peer, {"token": "not-the-token"})
    assert read_adoption_claim(peer) is not None
    release_adoption_claim(peer, winner_doc)
    assert read_adoption_claim(peer) is None


def test_adoption_claim_stale_break_on_dead_pid(tmp_path):
    """A claim whose recorded holder pid is dead on this host is broken
    and re-contended — a crashed adopter must not wedge the failover."""
    peer = str(tmp_path)
    assert acquire_adoption_claim(peer, by="crashed", pid=_dead_pid()) is not None
    doc = acquire_adoption_claim(peer, by="srv1", pid=os.getpid())
    assert doc is not None and doc["by"] == "srv1"
    assert acquire_adoption_claim(peer, by="srv2", pid=os.getpid()) is None


def test_claim_gates_peer_journal_reads(tmp_path):
    """``read_peer_journal`` is the only doorway to a peer's journal: no
    claim -> refused; someone else's claim -> refused; our claim -> the
    scanned records."""
    peer = str(tmp_path)
    j = journal_mod.Journal(journal_mod.journal_path(peer))
    j.recover()
    j.append_transition(journal_mod.ACCEPTED, "r1", tenant="alice", payload={"x": 1}, fingerprint="f1")
    j.close()
    with pytest.raises(AdoptionRefused):
        verify_adoption_claim(peer, pid=os.getpid())
    with pytest.raises(AdoptionRefused):
        read_peer_journal(peer, pid=os.getpid())
    claim = acquire_adoption_claim(peer, by="other", pid=_dead_pid())
    assert claim is not None
    with pytest.raises(AdoptionRefused):
        read_peer_journal(peer, pid=os.getpid())
    release_adoption_claim(peer, claim)
    ours = acquire_adoption_claim(peer, by="me", pid=os.getpid())
    assert [r["request_id"] for r in read_peer_journal(peer, pid=os.getpid())] == ["r1"]
    assert os.path.basename(adoption_claim_path(peer)) == CLAIM_FILENAME == jfleet.CLAIM_FILENAME
    release_adoption_claim(peer, ours)


# -- placement ----------------------------------------------------------------


def _member(name, queued=0, alive=True, draining=False, adopted_by=None):
    return {
        "name": name, "base_dir": f"/tmp/{name}", "host": "127.0.0.1", "port": 1, "pid": os.getpid(),
        "hostname": "h", "alive": alive, "ever_alive": alive, "dead": False, "draining": draining,
        "adopted_by": adopted_by, "queued": queued, "inflight": 0, "replay_backlog": 0, "scrub": None,
        "heartbeat_age_s": 0.1,
    }


def _bare_gateway(tmp_path, members, **kw):
    gw = FleetGateway(base_dir=os.path.join(str(tmp_path), "gw"), member_dirs=[m["base_dir"] for m in members], **kw)
    gw._members.clear()
    for m in members:
        gw._members[m["name"]] = dict(m)
    return gw


def test_placement_affinity_sticks_and_falls_back(tmp_path):
    gw = _bare_gateway(tmp_path, [_member("m0", queued=3), _member("m1", queued=1)], max_member_queue=8)
    target, code, hit = gw._place("alice")
    assert code is None and not hit and target["name"] == "m1"  # least-loaded first
    target, code, hit = gw._place("alice")
    assert hit and target["name"] == "m1"  # sticky thereafter
    gw._members["m1"]["draining"] = True
    target, code, hit = gw._place("alice")
    assert not hit and target["name"] == "m0"
    target, code, hit = gw._place("alice")
    assert hit and target["name"] == "m0"


def test_placement_typed_fleet_backpressure(tmp_path):
    gw = _bare_gateway(tmp_path, [_member("m0", queued=5), _member("m1", queued=5)], max_member_queue=4)
    target, code, _ = gw._place("alice")
    assert target is None and code == REJECT_FLEET_BACKLOG
    for m in gw._members.values():
        m["alive"] = False
    target, code, _ = gw._place("alice")
    assert target is None and code == REJECT_FLEET_NO_MEMBER


# -- the gateway end-to-end over in-process members ---------------------------


def _serve_payload(base, data, tenant, rid, out_key, block=8):
    return dict(tenant=tenant, request_id=rid, workflow="connected_components",
                config=dict(tmp_folder=os.path.join(base, "req_" + rid), target="local",
                            global_config={"block_shape": [block] * 3},
                            params=dict(input_path=data, input_key="mask", output_path=data, output_key=out_key,
                                        threshold=0.5)))


def _mk_input(base, shape=(16, 16, 16), seed=0, reader=file_reader):
    vol = (np.random.default_rng(seed).random(shape) > 0.5).astype("float32")
    data = os.path.join(base, "data.zarr")
    reader(data).create_dataset("mask", shape=vol.shape, chunks=(8, 8, 8), dtype="float32")[...] = vol
    return data


def _start_fleet(base, n=2, **gw_kw):
    members = [PipelineServer(base_dir=os.path.join(base, "members", f"m{i}"), max_workers=1).start()
               for i in range(n)]
    gw_kw.setdefault("health_interval_s", 0.2)
    gw_kw.setdefault("member_stale_s", 1.0)
    gateway = FleetGateway(base_dir=os.path.join(base, "gw"), member_dirs=[s.base_dir for s in members],
                           **gw_kw).start()
    return gateway, members, ServeClient.from_endpoint_file(os.path.join(base, "gw"))


def _stop_all(gateway, members):
    gateway.stop()
    for s in members:
        try:
            s.stop()
        except Exception:
            pass


def test_gateway_routes_two_tenants_and_answers_idempotently(tmp_path):
    base = str(tmp_path)
    data = _mk_input(base)
    gateway, members, client = _start_fleet(base)
    try:
        home_a = client.submit(**_serve_payload(base, data, "alice", "a1", "seg_a"))["member"]
        client.submit(**_serve_payload(base, data, "bob", "b1", "seg_b"))
        assert client.wait("a1", timeout_s=120)["state"] == "done"
        assert client.wait("b1", timeout_s=120)["state"] == "done"
        assert client.submit(**_serve_payload(base, data, "alice", "a2", "seg_a2"))["member"] == home_a
        assert client.wait("a2", timeout_s=120)["state"] == "done"
        dup = client.submit(**_serve_payload(base, data, "alice", "a1", "seg_a"))
        assert dup["state"] == "done"
        assert client.request("a1")["state"] == "done"
        assert client.request("nope") is None
        np.testing.assert_array_equal(np.asarray(file_reader(data)["seg_a"][...]),
                                      np.asarray(file_reader(data)["seg_b"][...]))
        deadline = time.monotonic() + 10.0
        while True:
            state = json.load(open(os.path.join(base, "gw", FLEET_STATE_FILENAME)))
            if state["affinity"]["hits"] >= 2 or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert set(state["members"]) == {"m0", "m1"}
        assert state["affinity"]["hits"] >= 2
        assert state["dead_unadopted"] == []
        status = client.status()
        assert status["rc"] == 0 and status["fleet"]["routes"] >= 3
    finally:
        _stop_all(gateway, members)
    assert _stray_serve_pids() == []


def test_adopt_journal_reenqueues_and_completes(tmp_path):
    """An acknowledged-but-incomplete request from a dead peer's journal
    re-enters the adopter's queue and completes; adoption without the
    claim is refused; the consumed claim stays behind."""
    base = str(tmp_path)
    data = _mk_input(base)
    peer = os.path.join(base, "dead-peer")
    payload = _serve_payload(base, data, "alice", "r1", "seg_adopted")
    j = journal_mod.Journal(journal_mod.journal_path(peer))
    j.recover()
    j.append_transition(journal_mod.ACCEPTED, "r1", tenant="alice", payload=payload,
                        fingerprint=_payload_fingerprint(payload))
    j.close()
    server = PipelineServer(base_dir=os.path.join(base, "srv"), max_workers=1).start()
    client = ServeClient(server.host, server.port)
    try:
        with pytest.raises(AdoptionRefused):
            server.adopt_journal(peer)
        assert acquire_adoption_claim(peer, by="srv", pid=os.getpid()) is not None
        stats = server.adopt_journal(peer)
        assert stats["reenqueued"] == 1 and stats["completed"] == 0
        rec = client.wait("r1", timeout_s=120)
        assert rec["state"] == "done", rec
        assert rec["adopted_from"] == os.path.abspath(peer)
        assert np.asarray(file_reader(data)["seg_adopted"][...]).shape == (16, 16, 16)
        assert read_adoption_claim(peer)["by"] == "srv"
        assert acquire_adoption_claim(peer, by="attacker", pid=os.getpid()) is None
        own = journal_mod.fold(journal_mod.scan(journal_mod.journal_path(server.base_dir))[0])
        assert own["r1"]["state"] == journal_mod.COMPLETED
        state = json.load(open(os.path.join(server.base_dir, "server_state.json")))
        assert state["adoptions"][0]["reenqueued"] == 1
        fails = json.load(open(os.path.join(server.base_dir, "failures.json")))
        assert [r["resolution"] for r in fails["records"] if r["task"] == "server.fleet"] == ["adopted:journal"]
    finally:
        server.stop()
    assert _stray_serve_pids() == []


def test_gateway_failover_adopts_and_wait_survives(tmp_path):
    """Stop a member under a routed tenant: the gateway declares it dead,
    the survivor adopts its journal over /adopt (with a fence minted under
    the claim), ``wait(across_restarts=True)`` rides the failover window
    to the answer now served by the OTHER member, and new traffic for the
    tenant reroutes."""
    base = str(tmp_path)
    data = _mk_input(base)
    gateway, members, client = _start_fleet(base)
    by_name = {os.path.basename(s.base_dir): s for s in members}
    try:
        home = client.submit(**_serve_payload(base, data, "alice", "a1", "seg_a"))["member"]
        assert client.wait("a1", timeout_s=120)["state"] == "done"
        by_name[home].stop()
        survivor = next(n for n in by_name if n != home)
        rec = client.wait("a1", timeout_s=60, across_restarts=True)
        assert rec["state"] == "done", rec
        deadline = time.monotonic() + 30
        state = {}
        while time.monotonic() < deadline:
            state = json.load(open(os.path.join(base, "gw", FLEET_STATE_FILENAME)))
            if state["members"][home].get("adopted_by"):
                break
            time.sleep(0.1)
        assert state["members"][home]["adopted_by"] == survivor
        assert state["dead_unadopted"] == []
        adopt_events = [e for e in state["adoptions"] if e["kind"] == "adopt"]
        assert adopt_events and adopt_events[0]["member"] == home
        claim = read_adoption_claim(by_name[home].base_dir)
        assert claim is not None and claim["by"] == survivor
        assert journal_mod.FenceGuard(by_name[home].base_dir).current() >= 1
        doc2 = client.submit(retry_s=30.0, **_serve_payload(base, data, "alice", "a2", "seg_a2"))
        assert doc2["member"] == survivor
        assert client.wait("a2", timeout_s=120, across_restarts=True)["state"] == "done"
        fails = json.load(open(os.path.join(base, "gw", "failures.json")))
        assert "adopted:journal" in [r.get("resolution") for r in fails["records"]]
    finally:
        _stop_all(gateway, members)
    assert _stray_serve_pids() == []


def test_gateway_drain_emptiest_picks_min_load(tmp_path):
    gw = _bare_gateway(tmp_path, [_member("m0", queued=4), _member("m1", queued=1)])
    picked = gw.drain_emptiest()
    assert picked["member"] == "m1" and gw._members["m1"]["draining"]
    target, code, _ = gw._place("alice")
    assert target["name"] == "m0"
    assert gw.drain_emptiest(member="m1") is None


# -- the operator progress view -----------------------------------------------


def _progress_mod():
    spec = importlib.util.spec_from_file_location("ctt_progress_torch_fleet",
                                                  os.path.join(REPO_ROOT, "scripts", "progress.py"))
    prog = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prog)
    return prog


def test_progress_renders_fleet_view(tmp_path):
    """The progress tool renders the member table from a
    ``fleet_state.json`` — the reference's hand-made document and the one
    the port's gateway writes — and exits 1 on a dead-and-unadopted
    member."""
    prog = _progress_mod()
    base = str(tmp_path)
    state = {
        "version": 1, "role": "gateway", "pid": os.getpid(), "time": time.time(), "draining": False,
        "members": {
            "m0": {"alive": True, "dead": False, "draining": False, "adopted_by": None, "queued": 2,
                   "inflight": 1, "replay_backlog": 0, "heartbeat_age_s": 0.4},
            "m1": {"alive": False, "dead": True, "draining": False, "adopted_by": "m0", "queued": 0,
                   "inflight": 0, "replay_backlog": 3, "heartbeat_age_s": 9.1},
        },
        "affinity": {"enabled": True, "hits": 8, "misses": 2, "hit_rate": 0.8, "map": {"alice": "m0"}},
        "routes": 4, "rejections": {"rejected:fleet_backlog": 1},
        "adoptions": [{"time": time.time(), "kind": "adopt", "member": "m1", "adopter": "m0", "completed": 2,
                       "reenqueued": 1, "quarantined": 0}],
        "dead_unadopted": [],
    }
    fu.atomic_write_json(os.path.join(base, FLEET_STATE_FILENAME), state)
    doc = prog.collect_progress(base)
    assert doc["fleet"]["members"]["m1"]["adopted_by"] == "m0"
    text = prog.format_progress(doc)
    assert "fleet" in text and "m0" in text and "adopted" in text
    assert "hit_rate" in text or "affinity" in text
    assert prog.main(["progress.py", base]) == 0
    state["members"]["m1"]["adopted_by"] = None
    state["dead_unadopted"] = ["m1"]
    fu.atomic_write_json(os.path.join(base, FLEET_STATE_FILENAME), state)
    assert prog.main(["progress.py", base]) == 1
    # the document the port's gateway writes
    gw_base = os.path.join(base, "port")
    m1 = _member("m1", adopted_by="m0", alive=False)
    m1["dead"] = True
    gw = _bare_gateway(gw_base, [_member("m0", queued=2), m1])
    gw._adoptions.append({"time": time.time(), "kind": "adopt", "member": "m1", "adopter": "m0", "completed": 1,
                          "reenqueued": 1, "quarantined": 0})
    gw._write_state()
    doc = prog.collect_progress(gw.base_dir)
    assert doc["fleet"]["members"]["m1"]["adopted_by"] == "m0"
    assert "adopted" in prog.format_progress(doc)
    assert prog.main(["progress.py", gw.base_dir]) == 0


def test_progress_renders_supervisor_view(tmp_path):
    """The control-plane view from ``supervisor_state.json`` — the
    reference's hand-made document and the one the port's supervisor
    writes — with rc 1 on crash-loop quarantines."""
    prog = _progress_mod()
    base = str(tmp_path)
    state = {
        "version": 1, "role": "supervisor", "pid": os.getpid(), "hostname": socket.gethostname(),
        "time": time.time(), "base_dir": base,
        "gateway": {"pid": os.getpid(), "incarnation": 2, "alive": True, "booted": True, "restarts": 1,
                    "port": 8931, "heartbeat_age_s": 0.3, "quarantined": False},
        "members": {
            "m0": {"base_dir": os.path.join(base, "members", "m0"), "pid": os.getpid(), "state": "running",
                   "respawns": 0, "last_rc": None, "backoff_remaining_s": None, "quarantined": False},
            "m1": {"base_dir": os.path.join(base, "members", "m1"), "pid": None, "state": "backoff",
                   "respawns": 2, "last_rc": 1, "backoff_remaining_s": 3.2, "quarantined": False},
        },
        "scale": {"decision": "hold", "reason": "steady", "time": time.time()},
        "crash_loops": [], "gateway_crash_loop": False,
    }
    sup_path = os.path.join(base, "supervisor_state.json")
    fu.atomic_write_json(sup_path, state)
    doc = prog.collect_progress(base)
    assert doc["supervisor"]["gateway"]["incarnation"] == 2
    assert doc["supervisor"]["members"]["m1"]["respawns"] == 2
    text = prog.format_progress(doc)
    for want in ("incarnation 2", "1 restart(s)", "2 respawn(s)", "respawn in 3.2s",
                 "last scale decision: hold (steady)"):
        assert want in text
    assert prog.main(["progress.py", base]) == 0
    state["members"]["m1"]["state"] = "quarantined"
    state["members"]["m1"]["quarantined"] = True
    state["crash_loops"] = ["m1"]
    fu.atomic_write_json(sup_path, state)
    assert prog.main(["progress.py", base]) == 1
    assert "member_crash_loop" in prog.format_progress(prog.collect_progress(base))
    state["crash_loops"] = []
    state["members"]["m1"]["state"] = "backoff"
    state["gateway"]["quarantined"] = True
    fu.atomic_write_json(sup_path, state)
    assert prog.main(["progress.py", base]) == 1
    # the document the port's supervisor writes (no process spawned)
    sup = FleetSupervisor(os.path.join(base, "port"), 1)
    sup.members["m0"] = {"name": "m0", "base_dir": os.path.join(sup.member_root, "m0"), "respawns": 1,
                         "registered": True, "last_rc": -9, "drain_requested": False, "proc": None,
                         "pid": None, "state": "backoff", "spawned_at": time.monotonic(),
                         "backoff_until": time.monotonic() + 5.0}
    sup._write_state()
    doc = prog.collect_progress(sup.base_dir)
    assert doc["supervisor"]["members"]["m0"]["respawns"] == 1
    assert "1 respawn(s)" in prog.format_progress(doc)


# -- the supervisor's reaper decision table -----------------------------------


def test_reaper_decision_table():
    assert classify_member_exit(REQUEUE_EXIT_CODE) == "drained"
    assert classify_member_exit(FENCED_EXIT_CODE) == "fenced"
    for rc in (0, 1, 2, -9, -15, 134, 137):
        assert classify_member_exit(rc) == "crashed", rc


def test_fresh_dir_lineage_names():
    assert fresh_member_name("m0") == "m0-r1"
    assert fresh_member_name("m0-r1") == "m0-r2"
    assert fresh_member_name("m0-r9") == "m0-r10"
    assert split_generation("m0") == ("m0", 0)
    assert split_generation("m0-r3") == ("m0", 3)
    assert split_generation("m-rx") == ("m-rx", 0)
    assert split_generation("s1") == ("s1", 0)
    assert fresh_member_name("s1") == "s1-r1"


# -- gateway state rebuild (the crash-only property) --------------------------


def test_gateway_rebuild_from_disk_property(tmp_path):
    """A restarted gateway rebuilds member table, affinity, routes and the
    adoption view cold from member truth on disk: a torn
    ``fleet_state.json`` is never trusted, and a valid-but-lying one can
    only break ties."""
    base = str(tmp_path)
    data = _mk_input(base)
    gw_dir = os.path.join(base, "gw")
    gateway, members, client = _start_fleet(base)
    state_path = os.path.join(gw_dir, FLEET_STATE_FILENAME)
    try:
        home_a = client.submit(**_serve_payload(base, data, "alice", "a1", "seg_a"))["member"]
        home_b = client.submit(**_serve_payload(base, data, "bob", "b1", "seg_b"))["member"]
        assert client.wait("a1", timeout_s=120)["state"] == "done"
        assert client.wait("b1", timeout_s=120)["state"] == "done"
        gateway.stop()
        with open(state_path, "w") as f:
            f.write('{"version": 1, "members": {"m0": {"al')
        peer = os.path.join(base, "members", "m2")
        os.makedirs(peer, exist_ok=True)
        fu.atomic_write_json(os.path.join(peer, ENDPOINT_FILENAME),
                             {"pid": _dead_pid(), "host": "127.0.0.1", "port": 1, "role": "server", "uid": "server"})
        assert acquire_adoption_claim(peer, by="m0", pid=os.getpid()) is not None
        gw2 = FleetGateway(base_dir=gw_dir, member_dirs=[s.base_dir for s in members] + [peer],
                           health_interval_s=0.2, member_stale_s=1.0, incarnation=2).start()
        try:
            client2 = ServeClient.from_endpoint_file(gw_dir)
            assert client2.request("a1")["state"] == "done"
            assert client2.submit(**_serve_payload(base, data, "alice", "a2", "seg_a2"))["member"] == home_a
            assert client2.wait("a2", timeout_s=120)["state"] == "done"
            st = gw2._state_doc()
            assert st["incarnation"] == 2
            assert st["members"]["m2"]["adopted_by"] == "m0"
            assert "m2" not in st["dead_unadopted"]
            assert set(st["members"]) == {"m0", "m1", "m2"}
        finally:
            gw2.stop()
        fu.atomic_write_json(state_path, {"version": 1, "incarnation": 99,
                                          "affinity": {"map": {"alice": home_b, "bob": home_b}}, "members": {}})
        gw3 = FleetGateway(base_dir=gw_dir, member_dirs=[s.base_dir for s in members], health_interval_s=0.2,
                           member_stale_s=1.0, incarnation=3).start()
        try:
            client3 = ServeClient.from_endpoint_file(gw_dir)
            assert client3.submit(**_serve_payload(base, data, "alice", "a3", "seg_a3"))["member"] == home_a
            assert client3.wait("a3", timeout_s=120)["state"] == "done"
            assert gw3._state_doc()["incarnation"] == 3
        finally:
            gw3.stop()
    finally:
        _stop_all(gateway, members)
    assert _stray_serve_pids() == []


# -- gray failures: the circuit breaker, hedging, fencing ---------------------


class _JsonHandler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        body = json.dumps({"ok": True}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        pass


def test_fenced_exit_code_and_retryable_rejects_equal_the_reference():
    from cluster_tools_tpu.runtime import server as jserver

    assert FENCED_EXIT_CODE == 115 and REQUEUE_EXIT_CODE == 114
    assert FENCED_RESOLUTION in RETRYABLE_REJECTS and REJECT_FLEET_BREAKER in RETRYABLE_REJECTS
    assert set(RETRYABLE_REJECTS) == set(jserver.RETRYABLE_REJECTS)
    assert (jfleet.GATEWAY_UID, jfleet.FLEET_STATE_FILENAME, jfleet.ADOPTION_RESOLUTION) == (
        "gateway", FLEET_STATE_FILENAME, "adopted:journal")


def test_breaker_opens_on_consecutive_failures_only():
    br = CircuitBreaker(threshold=2, cooldown_s=60.0)
    assert br.allow() and br.state == br.CLOSED
    br.record(False)
    br.record(True)
    br.record(False)
    assert br.state == br.CLOSED and br.allow()
    br.record(False)
    assert br.state == br.OPEN and not br.allow()
    snap = br.snapshot()
    assert snap["state"] == "open" and snap["opened_total"] == 1 and snap["consecutive_failures"] == 2


def test_breaker_half_open_single_trial_then_close_or_reopen():
    br = CircuitBreaker(threshold=1, cooldown_s=0.05)
    br.record(False)
    assert br.state == br.OPEN and not br.allow()
    time.sleep(0.06)
    assert br.allow() and br.state == br.HALF_OPEN
    assert not br.allow()
    br.record(False)
    assert br.state == br.OPEN and br.snapshot()["opened_total"] == 2
    time.sleep(0.06)
    assert br.allow()
    br.record(True)
    assert br.state == br.CLOSED and br.allow() and br.allow()


def test_member_call_reports_outcomes_to_the_breaker(tmp_path):
    httpd = http.server.HTTPServer(("127.0.0.1", 0), _JsonHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        good = _member("m0")
        good["port"] = httpd.server_address[1]
        gw = _bare_gateway(tmp_path, [good], breaker_threshold=1, breaker_cooldown_s=0.05)
        with pytest.raises(OSError):
            gw._member_call(dict(good, port=1), "GET", "/healthz", timeout_s=0.5)
        br = gw._breaker_for("m0")
        assert br.state == br.OPEN
        time.sleep(0.06)
        status, _ = gw._member_call(good, "GET", "/healthz", timeout_s=2.0, site="net_probe")
        assert status == 200 and br.state == br.CLOSED
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_submit_skips_open_breaker_and_types_the_reject(tmp_path):
    gw = _bare_gateway(tmp_path, [_member("m0"), _member("m1")], breaker_threshold=1, breaker_cooldown_s=60.0)
    gw._breaker_for("m0").record(False)
    gw._breaker_for("m1").record(False)
    status, doc = gw.submit({"tenant": "alice", "workflow": "x", "request_id": "r1"})
    assert status == 503 and doc["error"] == REJECT_FLEET_BREAKER
    assert gw._rejections[REJECT_FLEET_BREAKER] == 1
    gw._members.clear()
    status, doc = gw.submit({"tenant": "alice", "workflow": "x"})
    assert status == 503 and doc["error"] == REJECT_FLEET_NO_MEMBER


def test_submit_routes_around_open_breaker(tmp_path, monkeypatch):
    gw = _bare_gateway(tmp_path, [_member("m0", queued=0), _member("m1", queued=5)], max_member_queue=64,
                       breaker_threshold=1, breaker_cooldown_s=60.0, hedge=False)
    gw._breaker_for("m0").record(False)
    called = []

    def fake_call(member, method, path, body=None, **kw):
        called.append(member["name"])
        return 200, {"request_id": body["request_id"], "state": "queued"}

    monkeypatch.setattr(gw, "_member_call", fake_call)
    status, doc = gw.submit({"tenant": "alice", "workflow": "x", "request_id": "r1"})
    assert status == 200 and called == ["m1"] and doc["member"] == "m1"


def test_hedge_delay_tracks_p99_within_clamp(tmp_path):
    gw = _bare_gateway(tmp_path, [_member("m0")], hedge_min_delay_s=0.05, hedge_max_delay_s=2.0)
    assert gw._hedge_delay() == 2.0
    gw._submit_latencies.extend([0.01] * 99 + [1.5])
    delay = gw._hedge_delay()
    assert 0.05 <= delay <= 2.0 and delay >= 1.0
    gw._submit_latencies.clear()
    gw._submit_latencies.extend([0.001] * 50)
    assert gw._hedge_delay() == 0.05


def test_hedged_submit_wins_on_wedged_primary_exactly_once(tmp_path):
    """The affine member wedges (accepts, never answers), the hedge fires
    past the delay, the second member answers 200, and the wedged member
    never receives the request."""
    base = str(tmp_path)
    data = _mk_input(base)
    gateway, members, client = _start_fleet(base, call_timeout_s=3.0, hedge_max_delay_s=0.3, breaker_threshold=2,
                                            breaker_cooldown_s=0.5)
    try:
        home = client.submit(**_serve_payload(base, data, "alice", "a1", "seg_a"))["member"]
        other = next(os.path.basename(s.base_dir) for s in members if os.path.basename(s.base_dir) != home)
        faults.configure({"faults": [{"kind": "net_wedge", "site": "net_member", "members": [home],
                                      "seconds": 30.0, "fail_attempts": 99}]})
        t0 = time.monotonic()
        status, doc2 = gateway.submit(_serve_payload(base, data, "alice", "a2", "seg_a2"))
        elapsed = time.monotonic() - t0
        assert status == 200 and doc2["member"] == other
        assert elapsed < 3.0
        assert gateway._hedge_stats["launched"] == 1 and gateway._hedge_stats["won_secondary"] == 1
        home_server = next(s for s in members if os.path.basename(s.base_dir) == home)
        assert "a2" not in home_server._requests
        faults.configure(None)
        assert client.wait("a2", timeout_s=120.0)["state"] == "done"
    finally:
        faults.configure(None)
        _stop_all(gateway, members)


def test_fenced_member_rejects_submits_and_self_drains(tmp_path):
    """A member whose journal was adopted away answers 503
    ``fenced:adopted_away``, appends nothing, flags itself, and its serve
    loop raises Fenced (rc 115 at the entry point)."""
    base = str(tmp_path)
    server = PipelineServer(base_dir=base, max_workers=1).start()
    torn_down = False
    try:
        journal_size = os.path.getsize(journal_mod.journal_path(base))
        journal_mod.mint_fence(base, by="adopt:m1")
        status, doc = netio.http_json_call(server.host, server.port, "POST", "/submit",
                                           {"tenant": "alice", "request_id": "r1",
                                            "workflow": "connected_components", "config": {"target": "local"}},
                                           timeout_s=10.0)
        assert status == 503 and doc["error"] == FENCED_RESOLUTION and server.fenced
        assert os.path.getsize(journal_mod.journal_path(base)) == journal_size
        _, health = netio.http_json_call(server.host, server.port, "GET", "/healthz", timeout_s=10.0)
        assert health["fenced"] is True
        state = server._state_doc()
        assert state["fence"] == dict(state["fence"], fenced=True, own_epoch=0, current_epoch=1)
        fails = json.load(open(os.path.join(base, "failures.json")))
        fenced_recs = [r for r in fails["records"] if r.get("resolution") == FENCED_RESOLUTION]
        assert len(fenced_recs) == 1 and fenced_recs[0]["fence_epoch"] == 1
        box = []

        def run():
            try:
                server.serve_until_drained(poll_s=0.05)
            except BaseException as e:  # noqa: BLE001 - capture verdict
                box.append(e)

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=30.0)
        assert not t.is_alive() and isinstance(box[0], journal_mod.Fenced)
        torn_down = True
    finally:
        if not torn_down:
            server.stop()


def test_state_doc_carries_breaker_fence_and_hedge(tmp_path):
    m0 = _member("m0")
    m0["base_dir"] = str(tmp_path / "m0")
    os.makedirs(m0["base_dir"])
    journal_mod.mint_fence(m0["base_dir"], by="adopt:m1")
    gw = _bare_gateway(tmp_path, [m0], breaker_threshold=2)
    gw._breaker_for("m0").record(False)
    doc = gw._state_doc()
    assert doc["members"]["m0"]["fence_epoch"] == 1
    br = doc["members"]["m0"]["breaker"]
    assert br["state"] == "closed" and br["consecutive_failures"] == 1
    assert doc["hedge"]["enabled"] is True
    assert set(doc["hedge"]) >= {"delay_s", "launched", "won_primary", "won_secondary"}
    hz = gw.healthz()
    assert hz["members"]["m0"]["fence_epoch"] == 1 and hz["members"]["m0"]["breaker"]["state"] == "closed"


def test_progress_renders_breakers_fences_and_zombie_warning(tmp_path):
    prog = _progress_mod()
    base = str(tmp_path)
    m0_dir = os.path.join(base, "members", "m0")
    os.makedirs(m0_dir)
    fu.atomic_write_json(os.path.join(m0_dir, "server_state.json"),
                         {"fence": {"own_epoch": 1, "current_epoch": 1, "fenced": False}})
    state = {
        "version": 1, "role": "gateway", "pid": os.getpid(), "hostname": socket.gethostname(), "time": time.time(),
        "draining": False,
        "members": {
            "m0": {"base_dir": m0_dir, "alive": True, "dead": False, "draining": False, "adopted_by": "m1",
                   "queued": 0, "inflight": 0, "replay_backlog": 0, "heartbeat_age_s": 0.2, "pid": os.getpid(),
                   "hostname": socket.gethostname(), "fence_epoch": 2,
                   "breaker": {"state": "open", "consecutive_failures": 3, "since_transition_s": 1.25,
                               "opened_total": 1}},
            "m1": {"base_dir": os.path.join(base, "members", "m1"), "alive": True, "dead": False,
                   "draining": False, "adopted_by": None, "queued": 1, "inflight": 0, "replay_backlog": 0,
                   "heartbeat_age_s": 0.1, "fence_epoch": 0,
                   "breaker": {"state": "closed", "consecutive_failures": 0, "since_transition_s": 9.0,
                               "opened_total": 0}},
        },
        "affinity": {"enabled": True, "hits": 3, "misses": 1},
        "rejections": {"rejected:fleet_breaker_open": 2},
        "adoptions": [], "dead_unadopted": [],
        "hedge": {"enabled": True, "delay_s": 0.21, "launched": 4, "won_primary": 1, "won_secondary": 3},
    }
    fu.atomic_write_json(os.path.join(base, "fleet_state.json"), state)
    doc = prog.collect_progress(base)
    assert doc["fleet"]["fenced_alive"] == ["m0"]
    text = prog.format_progress(doc)
    for want in ("breaker open (3 fail(s))", "fence epoch 2", "hedges: 4 launched", "rejected:fleet_breaker_open",
                 "FENCED", "still alive"):
        assert want in text
    assert prog.main(["progress.py", base]) == 1
    state["members"]["m0"]["pid"] = 2 ** 22 + 12345
    fu.atomic_write_json(os.path.join(base, "fleet_state.json"), state)
    assert prog.collect_progress(base)["fleet"]["fenced_alive"] == []


# -- adoption across the packages ---------------------------------------------


def _crash_after_accept(journal_module, base, payload):
    """The owner died right after acknowledging ``payload``: its ACCEPTED
    record is the last frame of its journal."""
    j = journal_module.Journal(journal_module.journal_path(base))
    j.recover()
    j.append_transition(journal_module.ACCEPTED, payload["request_id"], tenant=payload["tenant"], payload=payload,
                        fingerprint=_payload_fingerprint(payload))
    j.close()


@pytest.mark.parametrize("owner,adopter", [("jax", "port"), ("port", "jax")])
def test_adoption_across_packages(tmp_path, owner, adopter):
    """One package's server runs r1 to done and dies with r2 acknowledged
    but not run; the other package's server adopts its journal under a
    claim taken with the owner's package: r1 is answered idempotently from
    the owner's journal, r2 runs on the adopter, and its output equals
    the owner's r1 output bit for bit."""
    sides = {"port": (PipelineServer, ServeClient, file_reader, (acquire_adoption_claim, journal_mod)),
             "jax": (JServer, JClient, j_reader, (jfleet.acquire_adoption_claim, jjournal))}
    base = str(tmp_path)
    oserver_cls, oclient_cls, oreader, (oacquire, ojournal) = sides[owner]
    aserver_cls, aclient_cls, _, _ = sides[adopter]
    data = _mk_input(base, reader=oreader)
    owner_dir = os.path.join(base, "owner")
    server = oserver_cls(base_dir=owner_dir, max_workers=1).start()
    try:
        oclient = oclient_cls(server.host, server.port)
        oclient.submit(**_serve_payload(base, data, "alice", "r1", "seg_owner"))
        rec1 = oclient.wait("r1", timeout_s=120)
        assert rec1["state"] == "done", rec1
    finally:
        server.stop()
    _crash_after_accept(ojournal, owner_dir, _serve_payload(base, data, "alice", "r2", "seg_adopted"))
    adopter_srv = aserver_cls(base_dir=os.path.join(base, "adopter"), max_workers=1).start()
    try:
        assert oacquire(owner_dir, by="adopter", pid=os.getpid()) is not None
        stats = adopter_srv.adopt_journal(owner_dir)
        assert (stats["completed"], stats["reenqueued"]) == (1, 1)
        aclient = aclient_cls(adopter_srv.host, adopter_srv.port)
        rec2 = aclient.wait("r2", timeout_s=120)
        assert rec2["state"] == "done", rec2
        assert rec2["adopted_from"] == os.path.abspath(owner_dir)
        again = aclient.submit(**_serve_payload(base, data, "alice", "r1", "seg_owner"))
        assert again["state"] == "done" and again["idempotent"] is True
    finally:
        adopter_srv.stop()
    got = np.asarray(file_reader(data)["seg_adopted"][...])
    want = np.asarray(file_reader(data)["seg_owner"][...])
    np.testing.assert_array_equal(got, want)
    assert got.max() > 1
