"""The blockwise executor over several shards on the card: the port's
watershed and cc workflows on 1 shard and on 4 (every shard on the cards
dealt round-robin; on one card all four share it) give the same labels,
and the hand kernels' launches grow with the shard calls, never with the
blocks.

Torch only; every test is ``gpu``-marked and skips without a CUDA device.
Run on the card: ``python3 -m pytest tests/test_torch_mesh_sweeps_card.py -m gpu``.
"""

import json
import os

import numpy as np
import pytest
import torch

from cluster_tools_tpu_torch.io.containers import open_container
from cluster_tools_tpu_torch.ops import kernels as K
from cluster_tools_tpu_torch.runtime.executor import BlockwiseExecutor
from cluster_tools_tpu_torch.runtime.task import build
from cluster_tools_tpu_torch.tasks.connected_components import ConnectedComponentsWorkflow
from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow
from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries_np


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the executor's shards on the card")
    return torch.device("cuda")


def _run(root, shards, monkeypatch):
    monkeypatch.setenv("CTT_MESH_SHARDS", str(shards))
    monkeypatch.setenv("CT_FILL_MODE", "capacity")
    monkeypatch.setenv("CT_TIER_MODE", "cond")
    cfg = os.path.join(root, "cfg")
    os.makedirs(cfg, exist_ok=True)
    with open(os.path.join(cfg, "global.config"), "w") as fh:
        json.dump({"block_shape": [32, 32, 64], "sharded_batch": 4 * shards}, fh)
    path = os.path.join(root, "data.zarr")
    f = open_container(path)
    f.require_dataset("b", shape=(64, 64, 128), chunks=(32, 32, 64), dtype="float32")[...] = \
        synthetic_boundaries_np((64, 64, 128), seed=5)
    common = dict(config_dir=cfg, max_jobs=4, input_path=path, output_path=path)
    K.reset_counts()
    assert build([WatershedWorkflow(tmp_folder=os.path.join(root, "tws"), input_key="b", output_key="ws",
                                    halo=[8, 8, 8], threshold=0.45, **common)])
    launches = dict(K.LAUNCHES)
    assert build([ConnectedComponentsWorkflow(tmp_folder=os.path.join(root, "tcc"), input_key="b", output_key="cc",
                                              threshold=0.45, threshold_mode="less", **common)])
    return f["ws"][...], f["cc"][...], launches


@pytest.mark.gpu
def test_four_shards_on_the_card_equal_one(cuda, tmp_path, monkeypatch):
    """8 blocks of 32 x 32 x 64: one batch of 4 on 1 shard makes two calls;
    on 4 shards (``sharded_batch`` 16, 4 lanes a shard) one batch of 8 lanes
    runs on shards 0 and 1.  Equal labels; B1-B4 launched once a shard call."""
    ws1, cc1, l1 = _run(str(tmp_path / "one"), 1, monkeypatch)
    ws4, cc4, l4 = _run(str(tmp_path / "four"), 4, monkeypatch)
    assert np.array_equal(ws1, ws4) and np.array_equal(cc1, cc4)
    assert l1.get("tile_ws_propagate", 0) == l4.get("tile_ws_propagate", 0) == 2
    assert l1.get("edt_cascade", 0) == 3 * l1["tile_ws_propagate"] == l4.get("edt_cascade", 0)


@pytest.mark.gpu
def test_executor_deals_shards_over_the_cards(cuda):
    ex = BlockwiseExecutor(target="gpu", n_devices=4)
    count = torch.cuda.device_count()
    assert ex.devices == [torch.device("cuda", i % count) for i in range(4)] and ex.batch_size == 4
    vol = np.random.default_rng(0).random((32, 32, 64)).astype(np.float32)
    from cluster_tools_tpu_torch.utils.volume_utils import Blocking

    blocking = Blocking(vol.shape, (16, 16, 16))
    blocks = [blocking.get_block(i) for i in range(blocking.n_blocks)]
    out = np.zeros_like(vol)

    def store(b, o):
        out[b.bb] = o

    s = ex.map_blocks(lambda x: x * 2 + 1, blocks, lambda b: (vol[b.bb],), store, sweep_mode="sharded")
    assert np.array_equal(out, vol * 2 + 1)
    assert s["n_devices"] == 4 and s["shard_calls"] == [2, 2, 2, 2]
