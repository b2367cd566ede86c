"""The port's fault injector (``cluster_tools_tpu_torch/runtime/faults.py``)
and its executor under injected faults, against the JAX package.

- The injector: for each spec of the reference tests' grid
  (``tests/test_robustness.py:23-85``, ``tests/test_degradation.py:93-134``,
  ``tests/test_supervision.py:48-117``) the same sequence of hook calls goes
  through both packages' injectors and must fire at the same (site, block,
  attempt), raise the same types and messages, sleep the same hangs and
  count the same attempts.  Equal, no tolerance.
- ``corrupt`` over the port's output trees (tensors, tuples, lists, dicts).
- The executor: the same ``CTT_FAULTS`` spec, the same seeded volume and a
  4x4x4 grid of 8^3 blocks (halo 2) on ``memory://`` datasets with
  ``region_verifier`` go through both packages' ``map_blocks`` (one device,
  one IO thread, per block and sharded); the outputs equal the fault-free
  run bit for bit and the ``failures.json`` records (block, sites,
  quarantined, resolved, resolution) are equal.
"""

import json
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from cluster_tools_tpu.io.containers import MemoryContainer as JMem
from cluster_tools_tpu.runtime import executor as jex
from cluster_tools_tpu.runtime import faults as jfaults
from cluster_tools_tpu.utils.volume_utils import Blocking as JBlocking
from cluster_tools_tpu_torch.io.containers import MemoryContainer as PMem
from cluster_tools_tpu_torch.runtime import executor as pex
from cluster_tools_tpu_torch.runtime import faults as pfaults
from cluster_tools_tpu_torch.runtime import supervision as psup
from cluster_tools_tpu_torch.utils.volume_utils import Blocking as PBlocking

torch.set_num_threads(1)

SIDES = {"jax": (jfaults, jex, JMem, JBlocking), "port": (pfaults, pex, PMem, PBlocking)}


@pytest.fixture(autouse=True)
def _reset_injectors():
    for f in (jfaults, pfaults):
        f.reset()
        f.set_current_task(None)
    psup.reset_drain()
    yield
    for f in (jfaults, pfaults):
        f.reset()
        f.set_current_task(None)
    psup.reset_drain()


# -- the injector, case for case -------------------------------------------------

# (id, config, calls): ("fail", site, block, voxels), ("hang", site, block),
# ("chunk", site, block), ("corrupt", site, block), ("spill",), ("lose",),
# ("task", uid)
GRID = [
    ("disabled", {}, [("fail", "load", 0, None), ("corrupt", "kernel", 0), ("hang", "load", 0)]),
    ("attempt_gating", {"faults": [{"site": "load", "kind": "error", "blocks": [3], "fail_attempts": 2}]},
     [("fail", "load", 1, None), ("fail", "store", 3, None)] + [("fail", "load", 3, None)] * 3),
    ("rate_seeded", {"seed": 11, "faults": [{"site": "io_read", "kind": "error", "rate": 0.5,
                                             "fail_attempts": 10 ** 6}]},
     [("fail", "io_read", b, None) for b in range(32)] * 2),
    ("kernel_nan", {"faults": [{"site": "kernel", "kind": "nan", "blocks": [2]}]},
     [("corrupt", "kernel", 2), ("corrupt", "kernel", 2), ("corrupt", "kernel", 0)]),
    ("oom_min_voxels", {"faults": [{"site": "load", "kind": "oom", "min_voxels": 1000, "fail_attempts": 10 ** 6}]},
     [("fail", "load", 0, 999), ("fail", "load", 0, None), ("fail", "load", 0, 1000), ("fail", "load", 0, 5000)]),
    ("enospc_store", {"faults": [{"site": "store", "kind": "enospc", "blocks": [2], "fail_attempts": 1}]},
     [("fail", "store", 1, None), ("fail", "store", 2, None), ("fail", "store", 2, None)]),
    ("hang_load", {"faults": [{"site": "load", "kind": "hang", "blocks": [2], "seconds": 0.15,
                               "fail_attempts": 1}]},
     [("hang", "load", 1), ("hang", "store", 2), ("hang", "load", 2), ("hang", "load", 2)]),
    ("corrupt_io_write", {"faults": [{"site": "io_write", "kind": "corrupt", "blocks": [3], "fail_attempts": 2}]},
     [("chunk", "io_write", 1)] + [("chunk", "io_write", 3)] * 3),
    ("corrupt_read_sidecar", {"faults": [{"site": "io_read", "kind": "corrupt", "mode": "sidecar"}]},
     [("chunk", "io_read", None), ("chunk", "io_read", None)]),
    ("job_loss", {"faults": [{"site": "submit", "kind": "job_loss", "fail_attempts": 2}]}, [("lose",)] * 3),
    ("tasks_filter", {"faults": [{"site": "load", "kind": "error", "tasks": ["watershed"], "fail_attempts": 1}]},
     [("task", "graph.12ab34cd"), ("fail", "load", 0, None), ("task", "watershed.deadbeef"),
      ("fail", "load", 0, None), ("fail", "load", 0, None)]),
    ("spill_publish", {"faults": [{"site": "publish", "kind": "spill", "fail_attempts": 2}]}, [("spill",)] * 3),
    ("dispatch_oom", {"faults": [{"site": "dispatch", "kind": "oom", "blocks": [0, 8], "fail_attempts": 1}]},
     [("fail", "dispatch", b, 4096) for b in (0, 4, 8, 0, 8)]),
    ("compute_oom_gate", {"faults": [{"site": "compute", "kind": "oom", "min_voxels": 1000,
                                      "fail_attempts": 10 ** 6}]},
     [("fail", "compute", 0, 1728), ("fail", "compute", 0, 343), ("fail", "compute", 1, 1728)]),
    ("h2d_oom", {"faults": [{"site": "h2d", "kind": "oom", "fail_attempts": 2}]},
     [("fail", "h2d", 0, 10), ("fail", "h2d", 0, 10), ("fail", "h2d", 0, 10)]),
    ("publish_oom", {"faults": [{"site": "publish", "kind": "oom"}]},
     [("fail", "publish", None, None), ("fail", "publish", None, None)]),
    ("solve_worker", {"faults": [{"site": "solve", "kind": "error", "blocks": [1]}]},
     [("fail", "solve", 0, None), ("fail", "solve", 1, None), ("fail", "solve", None, None)]),
    ("hop_hang_error", {"faults": [{"site": "hop", "kind": "hang", "seconds": 0.05},
                                   {"site": "hop", "kind": "error", "blocks": [1]}]},
     [("hang", "hop", 0), ("fail", "hop", 0, None), ("hang", "hop", 1), ("fail", "hop", 1, None)]),
    ("io_write_enospc", {"seed": 3, "faults": [{"site": "io_write", "kind": "enospc", "rate": 0.3,
                                                "fail_attempts": 5}]},
     [("fail", "io_write", b % 7, 64) for b in range(40)]),
]

INVALID = [
    {"faults": [{"site": "submit", "kind": "oom"}]},
    {"faults": [{"site": "load", "kind": "enospc"}]},
    {"faults": [{"site": "block_done", "kind": "preempt"}]},
    {"faults": [{"site": "block_done", "kind": "kill", "after": 1}]},
    {"faults": [{"site": "kernel", "kind": "hang"}]},
    {"faults": [{"site": "load", "kind": "corrupt"}]},
    {"faults": [{"site": "io_read", "kind": "corrupt", "mode": "nonsense"}]},
    {"faults": [{"site": "load", "kind": "job_loss"}]},
    {"faults": [{"site": "store", "kind": "nan"}]},
    {"faults": [{"site": "load", "kind": "spill"}]},
    {"faults": [{"site": "load", "kind": "teleport"}]},
    {"faults": [{"site": "publish", "kind": "error"}]},
]


def _tree():
    return (np.arange(4, dtype=np.float32), np.arange(3, dtype=np.int32), np.ones(2, np.uint64), True)


def _drive(fmod, cfg, calls, sleeps):
    inj = fmod.FaultInjector(cfg)
    out = []
    for call in calls:
        kind = call[0]
        if kind == "task":
            fmod.set_current_task(call[1])
        elif kind == "fail":
            try:
                inj.maybe_fail(call[1], call[2], voxels=call[3])
                out.append(None)
            except Exception as e:
                out.append((type(e).__name__, getattr(e, "attempt", None), getattr(e, "errno", None), str(e)))
        elif kind == "hang":
            n = len(sleeps)
            inj.maybe_hang(call[1], call[2])
            out.append(("slept", sleeps[n:]))
        elif kind == "chunk":
            out.append(inj.chunk_corrupt(call[1], call[2]))
        elif kind == "corrupt":
            res = inj.corrupt(call[1], call[2], _tree())
            out.append([np.asarray(a).tobytes() for a in res])
        elif kind == "spill":
            out.append(inj.force_spill())
        elif kind == "lose":
            out.append(inj.lose_job())
    fmod.set_current_task(None)
    return out, sorted(inj._counts.items())


@pytest.mark.parametrize("cfg,calls", [g[1:] for g in GRID], ids=[g[0] for g in GRID])
def test_injector_fires_as_the_reference(cfg, calls, monkeypatch):
    sleeps = []
    monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(float(s)))
    got = {side: _drive(SIDES[side][0], cfg, calls, sleeps) for side in SIDES}
    assert got["port"] == got["jax"]
    assert got["port"][0], "the grid case drove no hook"


@pytest.mark.parametrize("cfg", INVALID, ids=[c["faults"][0]["kind"] + "@" + c["faults"][0]["site"] for c in INVALID])
def test_injector_refuses_as_the_reference(cfg):
    msgs = []
    for side in SIDES:
        with pytest.raises(ValueError) as exc:
            SIDES[side][0].FaultInjector(cfg)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_unit_hash_and_env_config_match(monkeypatch, tmp_path):
    """``_unit`` is the reference's CRC32 of seed and key; ``CTT_FAULTS``
    takes inline JSON or a file path in both packages."""
    for seed in (0, 7, 123456):
        j, p = jfaults.FaultInjector({"seed": seed}), pfaults.FaultInjector({"seed": seed})
        for parts in (("load", 3, 1), ("io_read", None, 2), ("dispatch", 64, 9)):
            assert p._unit(*parts) == j._unit(*parts)
    spec = {"faults": [{"site": "store", "kind": "error", "blocks": [4]}]}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    for raw in (json.dumps(spec), str(path)):
        monkeypatch.setenv("CTT_FAULTS", raw)
        for f in (jfaults, pfaults):
            f.reset()
            assert f.get_injector().enabled and f.get_injector().specs == spec["faults"]


@pytest.mark.parametrize("make", [
    lambda: (torch.arange(4, dtype=torch.float32), torch.arange(3, dtype=torch.int32)),
    lambda: [torch.ones(2, dtype=torch.int64), np.ones(3, np.uint64)],
    lambda: {"a": torch.zeros(2), "b": (np.ones(2, np.float32), torch.ones(1, dtype=torch.int16))},
], ids=["tuple", "list", "dict"])
def test_corrupt_maps_over_torch_trees(make):
    """The port's ``corrupt`` poisons every leaf of its output trees as the
    reference's does a pytree: float NaN, signed INT_MIN, unsigned max;
    tensors come back as tensors of their dtype."""
    inj = pfaults.FaultInjector({"faults": [{"site": "kernel", "kind": "nan", "blocks": [1]}]})
    assert inj.corrupt("kernel", 0, make()) is not None
    bad = inj.corrupt("kernel", 1, make())
    assert type(bad) is type(make())
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        else:
            leaves.append(t)

    walk(bad)
    for leaf in leaves:
        a = leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf
        if a.dtype.kind == "f":
            assert np.isnan(a).all()
        elif a.dtype.kind == "i":
            assert (a == np.iinfo(a.dtype).min).all()
        else:
            assert (a == np.iinfo(a.dtype).max).all()
    # one attempt by default: the re-run is returned as it was
    again = make()
    assert inj.corrupt("kernel", 1, again) is again


def test_block_context_is_thread_local():
    assert pfaults.current_block_id() is None
    with pfaults.block_context(7):
        seen = []
        t = threading.Thread(target=lambda: seen.append(pfaults.current_block_id()))
        t.start()
        t.join()
        assert seen == [None] and pfaults.current_block_id() == 7
        with pfaults.block_context(9):
            assert pfaults.current_block_id() == 9
        assert pfaults.current_block_id() == 7
    assert pfaults.current_block_id() is None


# -- the executor under faults, against the JAX package ---------------------------------

SHAPE = (32, 32, 32)
BLOCK = (8, 8, 8)
DATA = np.random.default_rng(5).random(SHAPE).astype(np.float32)


def _kernel(x):
    return x * 2 + 1


def _sweep(side, tag, sweep_mode, spec=None, **kw):
    """``x * 2 + 1`` over the 4x4x4 grid through one package: a warm-up run
    (the reference compiles its program once an executor), then the run
    under ``spec``.  Returns ``(output, records, summary)``."""
    fmod, exmod, mem, blocking_cls = SIDES[side]
    c = mem.open(f"memory://faults-{tag}-{side}-{sweep_mode}")
    inp = c.require_dataset("x", shape=SHAPE, chunks=BLOCK, dtype="float32")
    inp[...] = DATA
    blocking = blocking_cls(SHAPE, BLOCK)
    blocks = [blocking.get_block(i, [2, 2, 2]) for i in range(blocking.n_blocks)]
    ex_kw = {"n_devices": 1} if side == "jax" else {}
    ex = exmod.BlockwiseExecutor(target="local", io_threads=1, backoff_base=1e-4, **ex_kw)

    def run(key, fp):
        out = c.require_dataset(key, shape=SHAPE, chunks=BLOCK, dtype="float32")

        def store(b, raw):
            out[b.bb] = np.asarray(raw)[b.inner_in_outer_bb]

        summary = ex.map_blocks(_kernel, blocks, lambda b: (inp[b.outer_bb],), store, failures_path=fp,
                                task_name="unit", store_verify_fn=exmod.region_verifier(out),
                                sweep_mode=sweep_mode, sharded_batch=8, degrade_wait_s=0.01, **kw)
        return out[...], summary

    ref, _ = run("warm", None)
    np.testing.assert_array_equal(ref, DATA * 2 + 1)
    fmod.configure(spec)
    with tempfile.TemporaryDirectory() as d:
        fp = f"{d}/failures.json"
        try:
            got, summary = run("faulted", fp)
        finally:
            fmod.reset()
        try:
            recs = json.load(open(fp))["records"]
        except FileNotFoundError:
            recs = []
    return got, recs, summary


def _rec_key(recs):
    return sorted((r.get("block_id") if r.get("block_id") is not None else -1, sorted(r["sites"].items()),
                   r["quarantined"], r["resolved"], r.get("resolution"), r.get("split_depth"))
                  for r in recs)


EXEC_SPECS = [
    ("load_transient", {"faults": [{"site": "load", "kind": "error", "blocks": [5], "fail_attempts": 1}]}),
    ("load_persistent", {"faults": [{"site": "load", "kind": "error", "blocks": [5], "fail_attempts": 3}]}),
    ("store_persistent", {"faults": [{"site": "store", "kind": "error", "blocks": [9], "fail_attempts": 4}]}),
    ("kernel_nan", {"faults": [{"site": "kernel", "kind": "nan", "blocks": [3]}]}),
    ("load_oom", {"faults": [{"site": "load", "kind": "oom", "blocks": [7]}]}),
    ("compute_oom", {"faults": [{"site": "compute", "kind": "oom", "blocks": [7]}]}),
    ("store_enospc", {"faults": [{"site": "store", "kind": "enospc", "blocks": [2]}]}),
    ("io_read_error", {"faults": [{"site": "io_read", "kind": "error", "blocks": [4], "fail_attempts": 2}]}),
    ("io_write_flip", {"faults": [{"site": "io_write", "kind": "corrupt", "blocks": [6]}]}),
    ("io_write_flip_persistent", {"faults": [{"site": "io_write", "kind": "corrupt", "blocks": [6],
                                              "fail_attempts": 3}]}),
    ("dispatch_oom", {"faults": [{"site": "dispatch", "kind": "oom", "blocks": [0], "fail_attempts": 1}]}),
    ("mixed", {"faults": [{"site": "kernel", "kind": "nan", "blocks": [11]},
                          {"site": "io_write", "kind": "corrupt", "blocks": [20]},
                          {"site": "load", "kind": "error", "blocks": [40], "fail_attempts": 1},
                          {"site": "dispatch", "kind": "oom", "blocks": [8]}]}),
]


@pytest.mark.parametrize("sweep_mode", ["per_block", "sharded"])
@pytest.mark.parametrize("tag,spec", EXEC_SPECS, ids=[s[0] for s in EXEC_SPECS])
def test_executor_records_equal_the_reference(tag, spec, sweep_mode):
    got = {side: _sweep(side, tag, sweep_mode, spec) for side in SIDES}
    for side in SIDES:
        np.testing.assert_array_equal(got[side][0], DATA * 2 + 1)
    assert _rec_key(got["port"][1]) == _rec_key(got["jax"][1])
    if tag == "dispatch_oom" and sweep_mode == "per_block":
        # the batch-grain site belongs to the sharded call alone
        assert got["port"][1] == [] and got["jax"][1] == []
        return
    assert got["port"][1], "the fault did not fire"
    if "dispatch" in json.dumps(spec) and sweep_mode == "sharded":
        # the batch led by the targeted block ran block by block
        assert sum(r.get("resolution") == "degraded:unsharded" for r in got["port"][1]) == 8
        assert got["port"][2]["n_unsharded"] == 8


@pytest.mark.parametrize("sweep_mode", ["per_block", "sharded"])
def test_hung_load_is_speculated_as_the_reference(sweep_mode):
    """A load stuck far past ``block_deadline_s``: the watchdog records it
    ``hung`` and a speculative duplicate resolves it; the late primary
    agrees.  At least one duplicate; no exact count (fact 16)."""
    spec = {"faults": [{"site": "load", "kind": "hang", "blocks": [13], "seconds": 3.0, "fail_attempts": 1}]}
    got = {side: _sweep(side, "hang", sweep_mode, spec, block_deadline_s=1.0, watchdog_period_s=0.1)
           for side in SIDES}
    for side in SIDES:
        np.testing.assert_array_equal(got[side][0], DATA * 2 + 1)
        assert got[side][2]["n_speculated"] >= 1 and got[side][2]["n_hung"] >= 1
    assert _rec_key(got["port"][1]) == _rec_key(got["jax"][1])
    rec = {r["block_id"]: r for r in got["port"][1]}[13]
    assert rec["sites"] == {"hung": 1} and rec["quarantined"] and rec["resolved"]
    assert rec.get("duplicate") == "agreed"


def test_permanent_failure_raises_naming_the_block():
    spec = {"faults": [{"site": "store", "kind": "error", "blocks": [1], "fail_attempts": 10 ** 6}]}
    for side in SIDES:
        with pytest.raises(RuntimeError, match=r"ids: \[1\]"):
            _sweep(side, "perm", "per_block", spec)
