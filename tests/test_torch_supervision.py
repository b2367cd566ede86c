"""The port's supervision primitives (``runtime/supervision.py``): heartbeats,
the watchdog, first-wins commits, ``array_digest`` and the drain latch; the
executor's speculative duplicates; and the hardened watershed sweep per
block under injected faults.

``array_digest`` must give the JAX package's CRC for the same numpy leaves.
The watershed case runs the port's ``WatershedWorkflow`` on a 4x4x4 grid
of 16^3 blocks (halo 4, zarr on disk, checksums on) fault-free and then
under one ``CTT_FAULTS`` spec with a load hang far past
``block_deadline_s``, a kernel NaN and an ``io_write`` bit flip; the labels
must equal the fault-free run bit for bit and ``failures.json`` must carry
each fault with the record the JAX package's executor gives the same spec
(``tests/test_torch_faults.py`` holds those specs equal to the reference).
The deadline is far below the hang, and no exact duplicate count is held
(ROADMAP fact 16).  Two ``gpu``-marked cases (skipped without a card):
a speculative duplicate on the card agrees with its primary, and the
hardened watershed on the card under the same faults equals its CPU
twins' fault-free run.  On the card: ``python3 -m pytest
tests/test_torch_supervision.py -m gpu -q``.
"""

import json
import os
import signal
import subprocess
import threading
import time

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from cluster_tools_tpu.runtime.supervision import array_digest as j_digest
from cluster_tools_tpu_torch.runtime import faults as pfaults
from cluster_tools_tpu_torch.runtime import supervision as sup
from cluster_tools_tpu_torch.runtime.executor import BlockwiseExecutor
from cluster_tools_tpu_torch.runtime.task import BaseTask, build
from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow
from cluster_tools_tpu_torch.utils import function_utils as fu
from cluster_tools_tpu_torch.utils.volume_utils import Blocking, file_reader

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean():
    pfaults.reset()
    sup.reset_drain()
    yield
    pfaults.reset()
    pfaults.set_current_task(None)
    sup.reset_drain()


# -- heartbeats -------------------------------------------------------------------


def test_heartbeat_roundtrip_and_torn_file(tmp_path):
    folder = str(tmp_path)
    assert sup.read_heartbeat(folder, "t") is None
    sup.write_heartbeat(folder, "t")
    hb = sup.read_heartbeat(folder, "t")
    assert hb["pid"] == os.getpid() and abs(hb["time"] - time.time()) < 5.0
    with open(sup.heartbeat_path(folder, "t"), "w") as f:
        f.write('{"time": 1')
    assert sup.read_heartbeat(folder, "t") is None


def test_heartbeat_writer_beats_until_stopped(tmp_path):
    folder = str(tmp_path)
    w = sup.HeartbeatWriter(folder, "job", interval_s=0.05).start()
    try:
        first = sup.read_heartbeat(folder, "job")["time"]
        deadline = time.time() + 5.0
        while time.time() < deadline and sup.read_heartbeat(folder, "job")["time"] <= first:
            time.sleep(0.02)
        assert sup.read_heartbeat(folder, "job")["time"] > first
    finally:
        w.stop()
    last = sup.read_heartbeat(folder, "job")["time"]
    time.sleep(0.15)
    assert sup.read_heartbeat(folder, "job")["time"] == last


def test_pid_alive():
    assert sup.pid_alive(os.getpid())
    p = subprocess.Popen(["true"])
    p.wait()
    assert not sup.pid_alive(p.pid)


# -- the watchdog, first wins, the digest -------------------------------------------


def test_watchdog_fires_once_per_overdue_token():
    fired = []
    w = sup.Watchdog(0.1, 0.02, lambda tok, info, el: fired.append((tok, info))).start()
    try:
        w.register("a", block_id=1, stage="load")
        w.register("b", block_id=2, stage="load")
        w.clear("b")
        deadline = time.time() + 5.0
        while time.time() < deadline and not fired:
            time.sleep(0.02)
        time.sleep(0.2)
    finally:
        w.stop()
    assert [t for t, _ in fired] == ["a"] and fired[0][1]["block_id"] == 1


def test_first_wins_commit_and_withdraw():
    c = sup.FirstWins()
    assert c.commit(1, "x") == c.WIN
    assert c.commit(1, "x") == c.AGREE
    assert c.commit(1, "y") == c.MISMATCH
    c.withdraw(1, "other")
    assert c.commit(1, "x") == c.AGREE
    c.withdraw(1, "x")
    assert c.commit(1, "z") == c.WIN


LEAVES = [
    [np.arange(8, dtype=np.float32)],
    [np.arange(12, dtype=np.int64).reshape(3, 4), np.ones(3, np.uint8)],
    [np.zeros((2, 3, 4), np.uint64), np.array(True), np.float32(1.5)],
    [np.asfortranarray(np.random.default_rng(0).random((5, 6)))],
    [],
]


@pytest.mark.parametrize("leaves", LEAVES, ids=["f32", "i64_u8", "u64_bool_scalar", "fortran", "empty"])
def test_array_digest_equals_the_reference(leaves):
    assert sup.array_digest(leaves) == j_digest(leaves)


def test_array_digest_bit_sensitivity():
    a = np.arange(8, dtype=np.float32)
    b = a.copy()
    assert sup.array_digest([a]) == sup.array_digest([b])
    b.view(np.uint8)[0] ^= 1
    assert sup.array_digest([a]) != sup.array_digest([b])
    assert sup.array_digest([a]) != sup.array_digest([a.astype(np.float64)])
    assert sup.array_digest([a]) != sup.array_digest([a.reshape(2, 4)])


# -- the drain latch ---------------------------------------------------------------------


def test_drain_latch_and_signal_handler(monkeypatch):
    """From default dispositions the handler arms; SIGUSR1 then flips the
    latch instead of killing the process.  (Another test in the process
    may have armed the reference's handler, or the port's: both start
    from the defaults here and are restored after.)"""
    assert not sup.drain_requested()
    prev = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGUSR1)}
    monkeypatch.setattr(sup, "_drain_installed", False)
    try:
        for sig in prev:
            signal.signal(sig, signal.SIG_DFL)
        assert sup.install_drain_handler()
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 5.0
        while not sup.drain_requested() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sup.drain_requested() and "SIGUSR1" in (sup.drain_reason() or "")
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
        sup.reset_drain()
    assert not sup.drain_requested() and sup.drain_reason() is None
    # off the main thread signal handlers cannot be installed: the call
    # raises nothing (it answers whether a handler is armed)
    out = []
    t = threading.Thread(target=lambda: out.append(sup.install_drain_handler()))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and out in ([False], [True])


def test_drain_interrupt_is_a_base_exception():
    err = sup.DrainInterrupt("evicted", [3, 1])
    assert not isinstance(err, Exception) and err.remaining_ids == [1, 3]
    assert "2 block(s) left" in str(err)


def test_build_stops_at_the_drain_latch(tmp_path):
    ran = []

    class T(BaseTask):
        task_name = "drainbuild"

        def run_impl(self):
            ran.append(self.params["i"])
            sup.request_drain("preempted")
            return {}

    tasks = [T(str(tmp_path / "tmp"), "", i=i) for i in range(3)]
    with pytest.raises(sup.DrainInterrupt):
        build(tasks)
    assert ran == [0]
    sup.reset_drain()
    assert build(tasks[1:2]) and ran == [0, 1]


def test_host_block_map_drains_and_the_rerun_resumes(tmp_path):
    seen = []

    class T(BaseTask):
        task_name = "drainmap"

        def run_impl(self):
            def process(block_id):
                seen.append(block_id)
                if block_id == 1 and sup.drain_reason() is None:
                    sup.request_drain("eviction notice")

            return {"n": self.host_block_map(list(range(6)), process)}

    t = T(str(tmp_path / "tmp"), "", max_jobs=1)
    with pytest.raises(sup.DrainInterrupt) as exc:
        t.run()
    assert seen == [0, 1] and exc.value.remaining_ids == [2, 3, 4, 5]
    sup.reset_drain()
    t.run()
    assert seen == [0, 1, 2, 3, 4, 5]


def test_host_block_map_deadline_records_a_hung_block(tmp_path):
    (tmp_path / "cfg").mkdir()
    (tmp_path / "cfg" / "hungmap.config").write_text(json.dumps({"block_deadline_s": 0.2,
                                                                 "watchdog_period_s": 0.05}))

    class T(BaseTask):
        task_name = "hungmap"

        def run_impl(self):
            return {"n": self.host_block_map([0, 1, 2], lambda b: time.sleep(0.8 if b == 1 else 0.0))}

    T(str(tmp_path / "tmp"), str(tmp_path / "cfg"), max_jobs=3).run()
    recs = json.load(open(fu.failures_path(str(tmp_path / "tmp"))))["records"]
    assert [(r["block_id"], r["sites"], r["resolved"]) for r in recs] == [(1, {"hung": 1}, True)]


# -- speculative duplicates -----------------------------------------------------------------


def _spec_case(tmp_path, kernel, store_hang=0.0):
    shape, bshape = (32, 8, 8), (8, 8, 8)
    data = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    blocks = [Blocking(shape, bshape).get_block(i) for i in range(4)]
    out = np.zeros(shape, np.float32)
    lock = threading.Lock()
    stores, done = [], []

    def store(b, raw):
        with lock:
            stores.append(int(b.block_id))
        out[b.bb] = np.asarray(raw)

    fp = str(tmp_path / "failures.json")
    summary = BlockwiseExecutor(target="local", backoff_base=1e-4).map_blocks(
        kernel, blocks, lambda b: (data[b.bb],), store, on_block_done=lambda b: done.append(int(b.block_id)),
        block_deadline_s=0.3, watchdog_period_s=0.05, failures_path=fp, task_name="spec_unit")
    return data, out, stores, done, summary, {r["block_id"]: r for r in json.load(open(fp))["records"]}


def test_speculative_duplicate_agrees_and_stores_once(tmp_path):
    """A store stuck past the deadline: the duplicate and the primary both
    finish, agree bit for bit, and the block is stored and marked once."""
    pfaults.configure({"faults": [{"site": "store", "kind": "hang", "blocks": [0], "seconds": 1.5,
                                   "fail_attempts": 1}]})
    data, out, stores, done, summary, recs = _spec_case(tmp_path, lambda x: x * 2)
    np.testing.assert_array_equal(out, data * 2)
    assert summary["n_speculated"] >= 1 and summary["n_hung"] >= 1
    assert stores.count(0) == 1 and done.count(0) == 1
    assert recs[0]["resolved"] and recs[0].get("duplicate") == "agreed"


def test_speculative_mismatch_is_surfaced(tmp_path):
    """A kernel whose every run of block 0 differs: the duplicate's digest
    disagrees with the stored winner, a ``determinism`` failure is
    recorded, the quarantine recompute disagrees again, and the sweep
    raises naming the block instead of picking a copy."""
    pfaults.configure({"faults": [{"site": "load", "kind": "hang", "blocks": [0], "seconds": 1.5,
                                   "fail_attempts": 1}]})
    calls = {"n": 0}
    lock = threading.Lock()

    def kernel(x):
        with lock:
            if float(x.flatten()[0]) == 0.0:
                calls["n"] += 1
                return x + calls["n"]
        return x + 1

    with pytest.raises(RuntimeError, match=r"ids: \[0\]"):
        _spec_case(tmp_path, kernel)
    rec = {r["block_id"]: r for r in json.load(open(tmp_path / "failures.json"))["records"]}[0]
    assert rec["sites"]["determinism"] >= 1 and rec["quarantined"] and not rec["resolved"]


@pytest.mark.gpu
def test_speculative_duplicate_on_the_card_agrees_with_its_primary(tmp_path):
    """On the card the duplicate runs its block alone while the primary's
    load is stuck; both copies' outputs are back on the host before the
    digest compare, so they agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel calls of the primary and its duplicate on the card")
    pfaults.configure({"faults": [{"site": "load", "kind": "hang", "blocks": [2], "seconds": 2.0,
                                   "fail_attempts": 1}]})
    shape, bshape = (64, 64, 64), (32, 32, 32)
    data = np.random.default_rng(1).random(shape).astype(np.float32)
    blocks = [Blocking(shape, bshape).get_block(i) for i in range(8)]
    out = np.zeros(shape, np.float32)

    def store(b, raw):
        out[b.bb] = np.asarray(raw)

    fp = str(tmp_path / "failures.json")
    summary = BlockwiseExecutor(target="gpu").map_blocks(
        lambda x: torch.sqrt(x * 3 + 1), blocks, lambda b: (data[b.bb],), store, block_deadline_s=0.5,
        watchdog_period_s=0.05, failures_path=fp, task_name="spec_card", sweep_mode="per_block")
    # the kernel's own result on the card: the card's and the CPU's float32
    # results of this kernel differ in the last place on some voxels
    np.testing.assert_array_equal(out, torch.sqrt(torch.from_numpy(data).cuda() * 3 + 1).cpu().numpy())
    assert summary["n_speculated"] >= 1
    rec = {r["block_id"]: r for r in json.load(open(fp))["records"]}[2]
    assert rec["resolved"] and rec.get("duplicate") == "agreed"


# -- the hardened watershed sweep per block -----------------------------------------------------

SHAPE = (64, 64, 64)
BLOCK = [16, 16, 16]


def _boundaries():
    x = ndi.gaussian_filter(np.random.default_rng(0).random(SHAPE), 2.0)
    return ((x - x.min()) / (x.max() - x.min())).astype(np.float32)


@pytest.fixture(scope="module")
def ws_root(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CT_TIER_MODE", "cond")
        mp.setenv("CT_FILL_MODE", "capacity")
        mp.setenv("CT_SEED_CCL", "tiled")
        root = str(tmp_path_factory.mktemp("ws_faults"))
        file_reader(os.path.join(root, "in.zarr")).require_dataset(
            "b", shape=SHAPE, chunks=tuple(BLOCK), dtype="float32")[...] = _boundaries()
        yield root


def run_ws(root, name, **global_config):
    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "cfg"), exist_ok=True)
    with open(os.path.join(d, "cfg", "global.config"), "w") as f:
        json.dump(dict({"block_shape": BLOCK}, **global_config), f)
    out_path = os.path.join(d, "out.zarr")
    wf = WatershedWorkflow(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=2,
                           target="local", input_path=os.path.join(root, "in.zarr"), input_key="b",
                           output_path=out_path, output_key="ws", block_shape=BLOCK, halo=[4, 4, 4],
                           threshold=0.5)
    assert build([wf])
    doc = fu.read_json_if_valid(fu.failures_path(os.path.join(d, "tmp"))) or {"records": []}
    return file_reader(out_path)["ws"][...], doc["records"], os.path.join(d, "tmp")


def test_hardened_per_block_watershed_equals_the_fault_free_run(ws_root):
    ref, recs, _ = run_ws(ws_root, "clean", sweep_mode="per_block")
    assert recs == [] and len(np.unique(ref)) > 16
    pfaults.configure({"faults": [
        {"site": "load", "kind": "hang", "blocks": [21], "seconds": 5.0, "fail_attempts": 1},
        {"site": "kernel", "kind": "nan", "blocks": [42]},
        {"site": "io_write", "kind": "corrupt", "blocks": [7]},
    ]})
    got, recs, tmp = run_ws(ws_root, "faulted", sweep_mode="per_block", block_deadline_s=2.0,
                            watchdog_period_s=0.1)
    np.testing.assert_array_equal(got, ref)
    by_block = {r["block_id"]: r for r in recs if r.get("block_id") is not None}
    assert (by_block[21]["sites"], by_block[21]["quarantined"], by_block[21]["resolved"]) == ({"hung": 1}, True, True)
    assert (by_block[42]["sites"], by_block[42]["quarantined"], by_block[42]["resolved"]) == (
        {"validate": 1}, True, True)
    assert (by_block[7]["sites"], by_block[7]["quarantined"], by_block[7]["resolved"]) == (
        {"corrupt": 1, "store": 1}, False, True)
    assert set(by_block) == {7, 21, 42}
    manifest = [json.load(open(os.path.join(tmp, f))) for f in os.listdir(tmp) if f.startswith("watershed.")
                and f.endswith(".success.json")][0]
    assert manifest["sweep"]["n_speculated"] >= 1


@pytest.mark.gpu
def test_hardened_watershed_on_the_card_equals_its_cpu_twin(ws_root):
    """The per-block hardened sweep on the card (B1-B4 launched) under the
    same faults equals the fault-free run of its CPU twins."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the watershed kernels B1-B4 on the card")
    from cluster_tools_tpu_torch.ops import kernels as K

    ref, _, _ = run_ws(ws_root, "card_clean_cpu", sweep_mode="per_block")
    pfaults.configure({"faults": [
        {"site": "load", "kind": "hang", "blocks": [21], "seconds": 4.0, "fail_attempts": 1},
        {"site": "kernel", "kind": "nan", "blocks": [42]},
        {"site": "io_write", "kind": "corrupt", "blocks": [7]},
    ]})
    d = os.path.join(ws_root, "card_faulted")
    os.makedirs(os.path.join(d, "cfg"), exist_ok=True)
    with open(os.path.join(d, "cfg", "global.config"), "w") as f:
        json.dump({"block_shape": BLOCK, "sweep_mode": "per_block", "block_deadline_s": 1.5,
                   "watchdog_period_s": 0.1}, f)
    K.reset_counts()
    wf = WatershedWorkflow(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=2,
                           target="gpu", input_path=os.path.join(ws_root, "in.zarr"), input_key="b",
                           output_path=os.path.join(d, "out.zarr"), output_key="ws", block_shape=BLOCK,
                           halo=[4, 4, 4], threshold=0.5)
    assert build([wf])
    assert all(K.LAUNCHES[k] > 0 for k in ("tile_ccl", "tile_ws_propagate", "edt_cascade", "apply_remap"))
    np.testing.assert_array_equal(file_reader(os.path.join(d, "out.zarr"))["ws"][...], ref)
    recs = {r["block_id"]: r for r in json.load(open(fu.failures_path(os.path.join(d, "tmp"))))["records"]}
    assert recs[21]["sites"] == {"hung": 1} and recs[42]["sites"] == {"validate": 1}
    assert recs[7]["sites"] == {"corrupt": 1, "store": 1} and all(r["resolved"] for r in recs.values())
