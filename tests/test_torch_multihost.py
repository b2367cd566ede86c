"""The port across processes: real ``torch.distributed`` collectives (gloo
on the CPU) between local worker processes, each running its shards on
threads — the stand-in for a pod, as ``tests/test_multihost.py`` is the
reference's.  The distributed CCL and exact EDT across process cuts
(against scipy), the split ws+cc step over a 2 x 2 pod against the same
step on a 4-shard in-process mesh, bit for bit, and the launcher's
timeout."""

import json
import time

import numpy as np
import pytest
import torch

from cluster_tools_tpu_torch.parallel import multihost
from cluster_tools_tpu_torch.parallel.mesh import make_mesh
from cluster_tools_tpu_torch.parallel.multihost import ENV_DEMO, launch_workers
from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split
from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries_np

torch.set_num_threads(1)


def _check_workers(results, n, marker):
    assert len(results) == n
    for pid, (rc, out, err) in enumerate(results):
        assert rc == 0, f"worker {pid} failed:\n{err[-2000:]}"
        assert marker in out, f"worker {pid} missing {marker}:\n{out[-500:]}"
        assert f"processes={n}" in out
        assert "torch.distributed backend gloo" in err


@pytest.mark.parametrize("num_processes,devices_per_process", [(2, 1), (2, 2)])
def test_cc_merges_across_process_boundaries(num_processes, devices_per_process):
    results = launch_workers(num_processes, "cluster_tools_tpu_torch.parallel.multihost:cc_pod_demo",
                             devices_per_process=devices_per_process, timeout=120, device="cpu")
    _check_workers(results, num_processes, "CC_POD_OK")
    assert f"devices={num_processes * devices_per_process}" in results[0][1]


def test_split_step_over_a_pod_equals_the_in_process_mesh(tmp_path):
    vol = synthetic_boundaries_np((32, 32, 128), seed=0, passes=3)[None]
    np.save(tmp_path / "v.npy", vol)
    cfg = dict(halo=2, threshold=0.45, dt_max_distance=4.0, min_seed_distance=1.0, stitch_ws_threshold=0.5,
               fill_mode="capacity", seed_mode="sparse", tier_mode="cond")
    job = dict(volume=str(tmp_path / "v.npy"), cfg=cfg, out=str(tmp_path / "o.npz"))
    results = launch_workers(2, "cluster_tools_tpu_torch.parallel.multihost:ws_ccl_pod_demo",
                             devices_per_process=2, timeout=120, device="cpu",
                             extra_env={ENV_DEMO: json.dumps(job)})
    _check_workers(results, 2, "WS_CCL_POD_OK")
    pod = np.load(tmp_path / "o.npz")
    ws, cc, n_fg, overflow = make_ws_ccl_split(make_mesh(4, grid=(1, 4), devices="cpu"), **cfg)(vol)
    np.testing.assert_array_equal(pod["ws"], ws.numpy())
    np.testing.assert_array_equal(pod["cc"], cc.numpy())
    assert float(pod["n_fg"]) == float(n_fg) and bool(pod["overflow"]) is overflow is False


def hang():
    """A worker target that never returns."""
    time.sleep(3600)


def test_launcher_kills_every_worker_on_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="exceeded timeout=3s; killed all 2 worker process group"):
        launch_workers(2, "tests.test_torch_multihost:hang", timeout=3, device="cpu")
    assert time.monotonic() - t0 < 30


def test_launcher_and_backend_default_to_the_card(monkeypatch):
    assert multihost.choose_backend(torch.device("cpu"), 2)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    backend, reason = multihost.choose_backend(torch.device("cuda"), 2)
    assert backend == "gloo" and "NCCL refuses two ranks on one device" in reason
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert multihost.choose_backend(torch.device("cuda"), 2)[0] == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_workers(2, "tests.test_torch_multihost:hang", timeout=3)
