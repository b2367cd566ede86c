"""The resident server on the card: two watershed requests running at once
share the process's kernel libraries, caching allocator, device page pool
and default stream, and must give the labels of the same two requests run
one after the other; each request counts its own kernel launches.

Torch only; every test is ``gpu``-marked and skips without a CUDA device.
Run on the card: ``python3 -m pytest tests/test_torch_serve_card.py -m gpu``.
"""

import os

import numpy as np
import pytest
import torch

from cluster_tools_tpu_torch.io import chunk_cache
from cluster_tools_tpu_torch.runtime import handoff, scrub
from cluster_tools_tpu_torch.runtime.server import PipelineServer, ServeClient
from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries_np
from cluster_tools_tpu_torch.utils.volume_utils import file_reader

KERNELS = ("edt_cascade", "tile_ccl", "tile_ws_propagate", "apply_remap")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: requests without a target run their kernels on the card")
    return torch.device("cuda")


@pytest.fixture
def server(cuda, tmp_path, monkeypatch):
    monkeypatch.setenv("CT_TIER_MODE", "cond")
    monkeypatch.setenv("CT_FILL_MODE", "capacity")
    handoff.reset()
    scrub.reset_targets()
    chunk_cache.configure()
    srv = PipelineServer(base_dir=str(tmp_path / "srv"), tenants={"alice": {}, "bob": {}}, max_workers=2,
                         scrub={"enabled": False}).start()
    try:
        yield srv, ServeClient(srv.host, srv.port, timeout_s=60)
    finally:
        srv.stop()
        handoff.reset()


def _volume(tmp_path, seeds=(0, 1), edge=256):
    data = str(tmp_path / "data.zarr")
    f = file_reader(data)
    for seed in seeds:
        f.require_dataset(f"b{seed}", shape=(edge,) * 3, chunks=(128,) * 3, dtype="float32")[...] = \
            synthetic_boundaries_np((edge,) * 3, seed=seed)
    return data


def _ws(data, tenant, rid, seed, out_key):
    # no target: the card
    return dict(tenant=tenant, request_id=rid, workflow="watershed",
                config=dict(max_jobs=8, global_config={"block_shape": [128] * 3},
                            params=dict(input_path=data, input_key=f"b{seed}", output_path=data, output_key=out_key,
                                        block_shape=[128] * 3, halo=[16] * 3, threshold=0.45, dt_max_distance=16.0,
                                        min_seed_distance=2.0)))


@pytest.mark.gpu
def test_two_concurrent_watersheds_equal_the_same_requests_in_turn(server, tmp_path):
    srv, client = server
    data = _volume(tmp_path)
    client.submit(**_ws(data, "alice", "a1", 0, "together0"))
    client.submit(**_ws(data, "bob", "b1", 1, "together1"))
    together = {rid: client.wait(rid, timeout_s=600) for rid in ("a1", "b1")}
    in_turn = {}
    for rid, tenant, seed in (("a2", "alice", 0), ("b2", "bob", 1)):
        client.submit(**_ws(data, tenant, rid, seed, f"turn{seed}"))
        in_turn[rid] = client.wait(rid, timeout_s=600)
    for rec in list(together.values()) + list(in_turn.values()):
        assert rec["state"] == "done", rec
        assert all(rec["kernel_launches"].get(k, 0) > 0 for k in KERNELS), rec["kernel_launches"]
    assert together["a1"]["kernel_launches"] == in_turn["a2"]["kernel_launches"]
    assert together["b1"]["kernel_launches"] == in_turn["b2"]["kernel_launches"]
    f = file_reader(data)
    for seed in (0, 1):
        a, b = f[f"together{seed}"][...], f[f"turn{seed}"][...]
        assert a.dtype == np.uint64 and len(np.unique(a)) > 100
        np.testing.assert_array_equal(a, b)
    status = client.status()
    assert status["rc"] == 0 and status["server"]["handoffs"]["live_entries"] == 0
    assert os.path.exists(os.path.join(srv.base_dir, "journal.log"))
