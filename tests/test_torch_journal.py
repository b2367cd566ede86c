"""The port's durable submission journal (``runtime/journal.py``) against the
JAX package's: the same records frame to the same bytes, each package scans
and folds the other's file to the same lifecycle, a torn tail is truncated
at every offset, the CRC catches every single-bit flip, rotation keeps the
fold, and a fence minted by either package fences the other's guard.

Counterparts of the reference's ``tests/test_journal.py:49-384``; the torn
fault runs the port's journal in a subprocess (the torn write hard-exits).
"""

import json
import os
import subprocess
import sys
import zlib

import pytest

from cluster_tools_tpu.runtime import faults as jfaults
from cluster_tools_tpu.runtime import journal as jjournal
from cluster_tools_tpu_torch.runtime import faults
from cluster_tools_tpu_torch.runtime import journal as journal_mod
from cluster_tools_tpu_torch.runtime.faults import KILL_EXIT_CODE
from cluster_tools_tpu_torch.runtime.journal import Journal

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"port": journal_mod, "jax": jjournal}


@pytest.fixture(autouse=True)
def _fresh_faults():
    for f in (faults, jfaults):
        f.configure(None)
    yield
    for f in (faults, jfaults):
        f.configure(None)


def _records(n):
    return [{"type": "accepted", "request_id": f"r{i}", "tenant": "t",
             "payload": {"workflow": "connected_components", "i": i, "x": [1.5, None, "é"]}} for i in range(n)]


def _write_journal(mod, path, records):
    j = mod.Journal(path)
    assert j.recover() == []
    for rec in records:
        j.append(rec)
    j.close()
    return j


LIFECYCLE = [
    {"type": "accepted", "request_id": "a", "tenant": "t1", "payload": {"workflow": "w"}, "fingerprint": "fp-a"},
    {"type": "dispatched", "request_id": "a", "attempt": 1},
    {"type": "completed", "request_id": "a", "record": {"state": "done", "run_s": 1.5}},
    {"type": "accepted", "request_id": "b", "tenant": "t2", "payload": {"workflow": "w"}},
    {"type": "dispatched", "request_id": "b", "attempt": 1},
    {"type": "accepted", "request_id": "c", "tenant": "t2", "payload": {"workflow": "w"}},
    {"type": "rejected", "request_id": "d", "tenant": "t1", "code": "rejected:queue_depth"},
    {"type": "accepted", "request_id": "q", "tenant": "t", "payload": {}},
    {"type": "dispatched", "request_id": "q", "attempt": 1},
    {"type": "drained", "request_id": "q"},
    {"type": "accepted", "request_id": "x", "tenant": "t", "payload": {"v": 1}},
    {"type": "dispatched", "request_id": "x", "attempt": 1},
    {"type": "failed", "request_id": "x", "record": {"state": "failed"}},
    {"type": "accepted", "request_id": "x", "tenant": "t", "payload": {"v": 2}},
    {"type": "accepted", "request_id": "x", "tenant": "t", "payload": {"v": 3}},
    {"type": "quarantined", "request_id": "p", "record": {}},
]


# -- framing ------------------------------------------------------------------


def test_constants_equal_the_reference():
    for name in ("JOURNAL_FILENAME", "FENCE_FILENAME", "MAGIC", "MAX_RECORD_BYTES", "ACCEPTED", "DISPATCHED",
                 "COMPLETED", "FAILED", "REJECTED", "QUARANTINED", "DRAINED", "TERMINAL_TYPES",
                 "DEFAULT_ROTATE_BYTES"):
        assert getattr(journal_mod, name) == getattr(jjournal, name), name


def test_frame_bytes_equal_the_reference(tmp_path):
    recs = _records(5) + LIFECYCLE
    for rec in recs:
        assert journal_mod._frame(rec) == jjournal._frame(rec)
    paths = {side: str(tmp_path / f"{side}.log") for side in SIDES}
    stats = {side: _write_journal(mod, paths[side], recs) for side, mod in SIDES.items()}
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    assert stats["port"].bytes == stats["jax"].bytes == os.path.getsize(paths["port"])
    assert stats["port"].appended == len(recs)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_each_package_scans_and_folds_the_others_journal(tmp_path, writer, reader):
    path = str(tmp_path / "journal.log")
    j = SIDES[writer].Journal(path)
    j.recover()
    for rec in LIFECYCLE:
        j.append(rec)
    j.append_transition(SIDES[writer].ACCEPTED, "t9", tenant="z", payload={"workflow": "watershed"})
    j.close()
    got, good, torn = SIDES[reader].scan(path)
    assert (got, good, torn) == SIDES[writer].scan(path)
    assert got[:len(LIFECYCLE)] == LIFECYCLE and torn == 0 and good == os.path.getsize(path)
    folded = SIDES[reader].fold(got)
    assert folded == SIDES[writer].fold(got)
    assert list(folded) == ["a", "b", "c", "d", "q", "x", "t9"]
    assert folded["a"]["state"] == "completed" and folded["a"]["record"] == {"state": "done", "run_s": 1.5}
    assert folded["b"]["state"] == "dispatched" and folded["c"]["state"] == "accepted"
    assert folded["d"]["state"] == "rejected" and folded["d"]["code"] == "rejected:queue_depth"
    assert folded["q"]["state"] == "drained" and folded["q"]["attempts"] == 0
    assert folded["x"]["payload"] == {"v": 2} and folded["x"]["attempts"] == 0
    # a journal the other package wrote recovers and keeps growing here
    j2 = SIDES[reader].Journal(path)
    assert j2.recover() == got
    j2.append({"type": "dispatched", "request_id": "b", "attempt": 2})
    j2.close()
    assert SIDES[writer].fold(SIDES[writer].scan(path)[0])["b"]["attempts"] == 2


def test_scan_missing_file_is_empty(tmp_path):
    assert journal_mod.scan(str(tmp_path / "nope.log")) == ([], 0, 0)


# -- torn-tail recovery at every byte offset ----------------------------------


def test_torn_tail_truncation_at_every_offset(tmp_path):
    """Truncating the journal at any byte offset gives exactly the prefix
    of intact records, in both packages' readers."""
    path = str(tmp_path / "journal.log")
    recs = _records(4)
    _write_journal(journal_mod, path, recs)
    data = open(path, "rb").read()
    sizes = [12 + len(json.dumps(r, separators=(",", ":"), sort_keys=True, default=str).encode()) for r in recs]
    assert sum(sizes) == len(data)
    boundaries = [sum(sizes[:k]) for k in range(len(sizes) + 1)]
    trunc = str(tmp_path / "trunc.log")
    for off in range(len(data) + 1):
        expect = max(k for k in range(len(sizes) + 1) if boundaries[k] <= off)
        with open(trunc, "wb") as f:
            f.write(data[:off])
        got = journal_mod.scan(trunc)
        assert got == (recs[:expect], boundaries[expect], off - boundaries[expect]), f"offset {off}"
        assert jjournal.scan(trunc) == got, f"offset {off}"


@pytest.mark.parametrize("writer", sorted(SIDES))
def test_recover_truncates_torn_tail_and_reuses_file(tmp_path, writer):
    path = str(tmp_path / "journal.log")
    recs = _records(3)
    _write_journal(SIDES[writer], path, recs)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 5)
    j = Journal(path)
    assert j.recover() == recs[:2]
    assert j.torn_bytes_truncated > 0
    j.append(recs[2])
    j.close()
    assert jjournal.scan(path) == (recs, os.path.getsize(path), 0)
    assert j.health()["torn_bytes_truncated"] == j.torn_bytes_truncated


def test_scan_stops_at_corrupt_crc(tmp_path):
    path = str(tmp_path / "journal.log")
    recs = _records(3)
    _write_journal(journal_mod, path, recs)
    data = bytearray(open(path, "rb").read())
    first = 12 + len(json.dumps(recs[0], separators=(",", ":"), sort_keys=True).encode())
    data[first + 14] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))
    got, good, torn = journal_mod.scan(path)
    assert got == recs[:1] and good == first and torn > 0
    assert jjournal.scan(path) == (got, good, torn)


def test_crc_framing_detects_single_bit_flips(tmp_path):
    """Every single-bit flip inside a frame is caught by the framing."""
    path = str(tmp_path / "journal.log")
    rec = {"type": "accepted", "request_id": "r0", "tenant": "t"}
    _write_journal(journal_mod, path, [rec])
    clean = open(path, "rb").read()
    payload = json.dumps(rec, separators=(",", ":"), sort_keys=True, default=str).encode()
    assert clean[:4] == b"CTJ1" and zlib.crc32(payload) == int.from_bytes(clean[8:12], "little")
    for byte in range(len(clean)):
        for bit in range(8):
            data = bytearray(clean)
            data[byte] ^= 1 << bit
            with open(path, "wb") as f:
                f.write(bytes(data))
            assert journal_mod.scan(path)[0] == [], f"bit flip at byte {byte} bit {bit} survived"


# -- the injected torn append -------------------------------------------------


def test_torn_append_hook_is_one_shot_via_latch(tmp_path):
    spec = {"state_dir": str(tmp_path), "faults": [{"site": "journal", "kind": "torn", "after": 2,
                                                      "keep_fraction": 0.25}]}
    inj = faults.configure(spec)
    assert [inj.torn_append() for _ in range(3)] == [None, 0.25, None]
    inj2 = faults.configure(spec)
    assert all(inj2.torn_append() is None for _ in range(4))


def test_torn_fault_tears_real_append_and_recovery_truncates(tmp_path):
    """The torn write lands a prefix of the 2nd frame and hard-exits; the
    restarted process (latched fault) truncates it and completes the
    journal, which the JAX package reads the same."""
    path = str(tmp_path / "journal.log")
    script = (
        "from cluster_tools_tpu_torch.runtime.journal import Journal\n"
        f"j = Journal({path!r})\n"
        "j.recover()\n"
        "for r in ('r0', 'r1', 'r2'):\n"
        "    j.append({'type': 'accepted', 'request_id': r})\n"
        "j.close()\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["CTT_FAULTS"] = json.dumps({"state_dir": str(tmp_path / "state"),
                                    "faults": [{"site": "journal", "kind": "torn", "after": 2}]})
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == KILL_EXIT_CODE, proc.stderr[-2000:]
    got, _, torn = journal_mod.scan(path)
    assert [r["request_id"] for r in got] == ["r0"] and torn > 0
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got, _, torn = jjournal.scan(path)
    assert [r["request_id"] for r in got] == ["r0", "r0", "r1", "r2"] and torn == 0


# -- rotation -------------------------------------------------------------------


def _lifecycle(j, rid, terminal="completed", attempts=1):
    j.append({"type": "accepted", "request_id": rid, "tenant": "t",
              "payload": {"workflow": "connected_components", "rid": rid}, "fingerprint": f"fp-{rid}"})
    for a in range(attempts):
        j.append({"type": "dispatched", "request_id": rid, "tenant": "t", "attempt": a + 1})
    if terminal:
        j.append({"type": terminal, "request_id": rid, "tenant": "t", "record": {"request_id": rid,
                                                                                  "state": terminal}})


def test_rotation_equals_the_reference_and_preserves_fold(tmp_path):
    """Past the threshold both packages archive the same ``.old`` and write
    the same snapshot segment, which folds back to the same promises."""
    out = {}
    for side, mod in SIDES.items():
        path = str(tmp_path / side / "journal.log")
        os.makedirs(os.path.dirname(path))
        j = mod.Journal(path)
        j.recover()
        for i in range(20):
            _lifecycle(j, f"done{i}")
        _lifecycle(j, "live0", terminal=None, attempts=2)
        _lifecycle(j, "gone0", terminal="rejected", attempts=0)
        for _ in range(10):
            j.append({"type": "dispatched", "request_id": "live0", "tenant": "t", "attempt": 1})
            j.append({"type": "drained", "request_id": "live0", "tenant": "t"})
        before = mod.fold(mod.scan(path)[0])
        big = os.path.getsize(path)
        assert j.maybe_rotate(before, max_bytes=big + 1) is False
        assert j.maybe_rotate(before, max_bytes=big - 1, keep_terminal=15) is True
        j.close()
        assert os.path.getsize(path + ".old") == big and j.rotations == 1 and j.rotated_from_bytes == big
        out[side] = (open(path, "rb").read(), open(path + ".old", "rb").read(), before)
    assert out["port"][:2] == out["jax"][:2]
    seg, _, before = out["port"]
    path = str(tmp_path / "port" / "journal.log")
    after = jjournal.fold(jjournal.scan(path)[0])
    terminal = [rid for rid, e in before.items() if e["state"] in journal_mod.TERMINAL_TYPES]
    kept = [rid for rid in before if rid not in terminal[:-15]]
    assert "live0" in kept and len(kept) == 16
    assert list(after) == kept
    for rid in kept:
        for key in ("state", "attempts", "payload", "record", "fingerprint"):
            assert after[rid][key] == before[rid][key], (rid, key)


def test_rotation_skipped_under_threshold_or_disabled(tmp_path, monkeypatch):
    path = str(tmp_path / "journal.log")
    j = Journal(path)
    j.recover()
    _lifecycle(j, "a")
    folded = journal_mod.fold(journal_mod.scan(path)[0])
    assert j.maybe_rotate(folded, max_bytes=1 << 30) is False
    assert j.maybe_rotate(folded, max_bytes=0) is False
    monkeypatch.setenv("CTT_JOURNAL_ROTATE_BYTES", "0")
    assert journal_mod.rotate_bytes_default() == 0 and j.maybe_rotate(folded) is False
    j.close()
    assert not os.path.exists(path + ".old")


def test_port_server_boot_rotates_a_reference_journal(tmp_path):
    """A fat journal the JAX package wrote is rotated on the port server's
    boot, and a completed id still answers from the snapshot."""
    from cluster_tools_tpu_torch.runtime.server import PipelineServer

    base = str(tmp_path)
    path = journal_mod.journal_path(base)
    j = jjournal.Journal(path)
    j.recover()
    for i in range(30):
        _lifecycle(j, f"d{i}")
    j.close()
    big = os.path.getsize(path)
    server = PipelineServer(base_dir=base, max_workers=1, journal_rotate_bytes=big // 4,
                            scrub={"enabled": False}).start()
    try:
        assert os.path.exists(path + ".old") and os.path.getsize(path) <= big
        health = server.journal_health()
        assert health["rotations"] == 1 and health["replayed"] == 30
        rec = server.request_record("d3")
        assert rec is not None and rec["state"] == "completed" and rec["replayed"] is True
    finally:
        server.stop()


# -- fencing --------------------------------------------------------------------


@pytest.mark.parametrize("minter,guard", [("port", "jax"), ("jax", "port")])
def test_fence_minted_by_either_package_fences_the_others_guard(tmp_path, minter, guard):
    base = str(tmp_path)
    assert SIDES[guard].read_fence(base) == {"epoch": 0, "minted_by": None, "time": None}
    g = SIDES[guard].FenceGuard(base)
    assert g.own_epoch == 0
    g.check()  # never minted: nothing to fence
    assert SIDES[minter].mint_fence(base, by="survivor") == 1
    doc = SIDES[guard].read_fence(base)
    assert doc["epoch"] == 1 and doc["minted_by"] == "survivor"
    with pytest.raises(SIDES[guard].Fenced) as ei:
        g.check()
    assert (ei.value.own_epoch, ei.value.current_epoch, ei.value.minted_by) == (0, 1, "survivor")
    assert g.current() == 1 and g.rereads == 1
    # a guard booted on the minted epoch owns it; the next mint fences it
    g2 = SIDES[guard].FenceGuard(base)
    g2.check()
    assert SIDES[guard].mint_fence(base, by="second") == 2
    with pytest.raises(SIDES[guard].Fenced):
        g2.check()
    assert json.load(open(SIDES[minter].fence_path(base)))["epoch"] == 2


def test_fenced_journal_refuses_the_append(tmp_path):
    base = str(tmp_path)
    j = Journal(journal_mod.journal_path(base))
    j.recover()
    j.fence_guard = journal_mod.FenceGuard(base)
    j.append({"type": "accepted", "request_id": "a"})
    jjournal.mint_fence(base, by="other")
    with pytest.raises(journal_mod.Fenced):
        j.append({"type": "accepted", "request_id": "b"})
    j.close()
    assert [r["request_id"] for r in journal_mod.scan(j.path)[0]] == ["a"]
    # an unparseable fence file reads as epoch 0
    with open(journal_mod.fence_path(base), "w") as f:
        f.write("{not json")
    assert journal_mod.read_fence(base)["epoch"] == 0 == jjournal.read_fence(base)["epoch"]


def test_snapshot_records_equal_the_reference():
    folded = journal_mod.fold(LIFECYCLE)
    assert jjournal.fold(LIFECYCLE) == folded
    for ent in folded.values():
        assert journal_mod.snapshot_records(ent) == jjournal.snapshot_records(ent)
        back = journal_mod.fold(journal_mod.snapshot_records(ent))[ent["request_id"]]
        assert back["state"] == ent["state"]
