"""The last public functions of the JAX package with a counterpart in the
port: ``ops/unionfind.py::apply_assignment``, ``runtime/task.py::DummyTask``,
``utils/volume_utils.py::{bb_from_roi,normalize}``,
``utils/function_utils.py::{log_job_success,jobs_done}`` and
``runtime/executor.py::{dispatch_snapshot,dispatch_delta}``, each against
the JAX package's on the same seeded inputs, bit for bit."""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_tools_tpu.ops import unionfind as j_uf
from cluster_tools_tpu.runtime import executor as j_ex
from cluster_tools_tpu.runtime import supervision as j_sup
from cluster_tools_tpu.runtime import task as j_task
from cluster_tools_tpu.utils import function_utils as j_fu
from cluster_tools_tpu.utils import volume_utils as j_vu
from cluster_tools_tpu_torch.ops import unionfind as p_uf
from cluster_tools_tpu_torch.runtime import executor as p_ex
from cluster_tools_tpu_torch.runtime import supervision as p_sup
from cluster_tools_tpu_torch.runtime import task as p_task
from cluster_tools_tpu_torch.utils import function_utils as p_fu
from cluster_tools_tpu_torch.utils import volume_utils as p_vu

DISPATCH_KEYS = ("batches_dispatched", "blocks_dispatched", "ragged_batches", "lanes_padded", "pages_in_use")


@pytest.fixture(autouse=True, scope="module")
def _restore_drain_handlers():
    """Both packages' executors arm a SIGTERM/SIGUSR1 drain handler in the
    main thread and keep it: restore both signals, both packages' armed
    flags and their drain latches after this file (ROADMAP fact 19)."""
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGUSR1)}
    flags = [(mod, mod._drain_installed) for mod in (j_sup, p_sup)]
    yield
    for sig, handler in saved.items():
        signal.signal(sig, handler)
    for mod, flag in flags:
        mod._drain_installed = flag
        mod.reset_drain()


@pytest.mark.parametrize("dtype", ["int32", "uint32", "uint8", "int16", "uint16", "int64", "uint64"])
def test_apply_assignment_equals_the_reference(dtype):
    """Labels of every dtype, some below 0 or at and past ``n_labels``
    (clipped into the table), through a table on the labels' device; the
    64-bit dtypes under x64, where the reference keeps them."""
    rng = np.random.default_rng(11)
    n_labels = 40
    lo = -6 if np.issubdtype(np.dtype(dtype), np.signedinteger) else 0
    labels = rng.integers(lo, n_labels + 9, (9, 10, 11)).astype(dtype)
    table = rng.integers(0, 1000, n_labels).astype(np.int64 if "64" in dtype else np.int32)
    with jax.enable_x64("64" in dtype):
        want = np.asarray(j_uf.apply_assignment(labels, table, n_labels))
    got = p_uf.apply_assignment(torch.from_numpy(labels), torch.from_numpy(table), n_labels)
    assert got.device.type == "cpu"
    got = got.numpy()
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)


def test_apply_assignment_clips_the_top_of_uint64():
    labels = np.array([0, 5, 2**63 + 3, 2**64 - 1, 29, 30, 31], np.uint64)
    table = np.arange(30, dtype=np.int64) * 7
    with jax.enable_x64(True):
        want = np.asarray(j_uf.apply_assignment(labels, table, 30))
    got = p_uf.apply_assignment(labels, table, 30).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_bb_from_roi_equals_the_reference():
    rng = np.random.default_rng(3)
    begin = rng.integers(0, 50, 3)
    end = begin + rng.integers(1, 50, 3)
    assert p_vu.bb_from_roi(begin, end) == j_vu.bb_from_roi(begin, end)
    assert p_vu.bb_from_roi([0, 2], [4, 8]) == (slice(0, 4), slice(2, 8))


@pytest.mark.parametrize("case", ["uint8", "float64", "constant"])
def test_normalize_equals_the_reference(case):
    rng = np.random.default_rng(5)
    data = {"uint8": rng.integers(3, 250, (12, 13, 14)).astype(np.uint8),
            "float64": rng.normal(2.0, 5.0, (12, 13, 14)),
            "constant": np.full((4, 5, 6), 7.0, np.float32)}[case]
    want = j_vu.normalize(data)
    got = p_vu.normalize(data)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_job_markers_equal_the_reference(tmp_path):
    for fu, root in ((j_fu, tmp_path / "ref"), (p_fu, tmp_path / "port")):
        for job in (2, 0, 1):
            fu.log_job_success(str(root), "task_a", job)
        fu.log_block_success(str(root), "task_a", 4)
        assert fu.jobs_done(str(root), "task_a") == [0, 1, 2]
        fu.clean_up_for_retry(str(root), "task_a")
        assert fu.jobs_done(str(root), "task_a") == []
        assert fu.blocks_done(str(root), "task_a") == [4]
    # the same marker files, written atomically (no temp file left)
    for sub in ("ref", "port"):
        fu = j_fu if sub == "ref" else p_fu
        fu.log_job_success(str(tmp_path / sub), "task_b", 3)
    ref_dir = tmp_path / "ref" / "markers" / "task_b"
    port_dir = tmp_path / "port" / "markers" / "task_b"
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir)) == ["job_3.json"]
    assert json.loads((port_dir / "job_3.json").read_text())["job_id"] == 3


class _JobMarkingTask(p_task.BaseTask):
    """Writes a job marker, then fails the first attempt; the retry sees
    the markers the failed attempt left."""

    task_name = "job_marking"

    def run_impl(self):
        seen = p_fu.jobs_done(self.tmp_folder, self.uid)
        attempt = len(os.listdir(os.path.join(self.tmp_folder, "attempts")))
        with open(os.path.join(self.tmp_folder, "attempts", f"{attempt}.json"), "w") as f:
            json.dump(seen, f)
        p_fu.log_job_success(self.tmp_folder, self.uid, 0)
        if attempt == 0:
            raise RuntimeError("first attempt fails")
        return {"ok": True}


def test_retry_clears_job_markers(tmp_path):
    """As the reference's task-level retries: ``build`` drops a failed
    task's job markers (``clean_up_for_retry``) before its next attempt."""
    tmp = tmp_path / "tmp"
    os.makedirs(tmp / "attempts")
    t = _JobMarkingTask(str(tmp), "", max_retries=1, retry_backoff_s=0.01)
    assert p_task.build([t])
    seen = [json.loads((tmp / "attempts" / f"{i}.json").read_text()) for i in range(2)]
    assert seen == [[], []]
    assert p_fu.jobs_done(t.tmp_folder, t.uid) == [0]


def test_dummy_task_equals_the_reference(tmp_path, monkeypatch):
    ref = j_task.DummyTask(str(tmp_path / "ref"))
    port = p_task.DummyTask(str(tmp_path / "port"))
    assert port.task_name == ref.task_name == "dummy"
    assert p_task.build([port]) and j_task.build([ref])
    assert port.output().exists() and ref.output().exists()
    assert port.requires() == ref.requires() == []
    # the default tmp_folder lies under the process's temporary directory
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path / "tmpdir"))
    os.makedirs(tmp_path / "tmpdir")
    assert p_task.DummyTask().tmp_folder == str(tmp_path / "tmpdir" / "ctt_dummy")


def _sweep_task(side, root, vol, out, blocking):
    """A task of ``side``'s package whose run is one sharded sweep of 27
    blocks (a ragged tail) over ``vol`` into ``out``."""
    task_mod, ex = (j_task, j_ex) if side == "ref" else (p_task, p_ex)
    kernel = (jax.jit(lambda b: b * 2 + jnp.float32(1)) if side == "ref"
              else (lambda b: b * 2 + 1))
    outer = tuple(blocking.block_shape)

    class Sweep(task_mod.BaseTask):
        task_name = "sweep"

        def run_impl(self):
            def load(b):
                return (p_vu.pad_block_to(vol[b.bb], outer),)

            def store(b, raw):
                out[b.bb] = np.asarray(raw)[tuple(slice(0, s.stop - s.start) for s in b.bb)]

            blocks = [blocking.get_block(i) for i in range(blocking.n_blocks)]
            summary = ex.BlockwiseExecutor(target="local", io_threads=2).map_blocks(
                kernel, blocks, load, store, sweep_mode="sharded", sharded_batch=8, store_verify_fn=None)
            return {"summary": {k: summary.get(k) for k in DISPATCH_KEYS}}

    return Sweep(str(root), "")


def test_dispatch_counters_equal_the_reference(tmp_path):
    """The process-wide dispatch counters: a sweep's delta equals its
    summary's counts and the reference's delta on the same sweep, and it
    lands in the task's io_metrics.json as the reference's does."""
    vol = np.random.default_rng(2).random((44, 44, 44)).astype(np.float32)
    got = {}
    for side, ex, build, fu, blocking_cls in (("ref", j_ex, j_task.build, j_fu, j_vu.Blocking),
                                              ("port", p_ex, p_task.build, p_fu, p_vu.Blocking)):
        out = np.zeros_like(vol)
        task = _sweep_task(side, tmp_path / side, vol, out, blocking_cls(vol.shape, (16, 16, 16)))
        snap = ex.dispatch_snapshot()
        assert build([task])
        delta = ex.dispatch_delta(snap)
        np.testing.assert_array_equal(out, vol * 2 + 1)
        with open(fu.io_metrics_path(task.tmp_folder)) as f:
            metrics = json.load(f)["tasks"][task.uid]
        got[side] = ({k: int(delta[k]) for k in DISPATCH_KEYS}, {k: int(metrics[k]) for k in DISPATCH_KEYS},
                     delta["sweep_s"] > 0 and metrics["sweep_s"] > 0)
        if side == "port":
            assert got[side][0] == task.output().read()["summary"]
    assert got["port"] == got["ref"]
    assert got["port"][0]["blocks_dispatched"] == 27 and got["port"][0]["ragged_batches"] > 0
