"""The sweep plane on the card: the lane-batched watershed and CCL against
their per-lane runs (kernels B1-B4 launched over the stack), and the
device-resident page pool reusing its CUDA pages on a warm re-sweep.

Torch only; every test is ``gpu``-marked and skips without a CUDA device.
Run on the card: ``python3 -m pytest tests/test_torch_sweeps_card.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from cluster_tools_tpu_torch.ops import ccl as pccl
from cluster_tools_tpu_torch.ops import kernels as K
from cluster_tools_tpu_torch.ops import tile_ccl as tccl
from cluster_tools_tpu_torch.ops import tile_ws as tws
from cluster_tools_tpu_torch.parallel import device_pool
from cluster_tools_tpu_torch.runtime.executor import BlockwiseExecutor
from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries_np
from cluster_tools_tpu_torch.utils.volume_utils import Blocking


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lane-batched kernels and the resident page pool on the card")
    return torch.device("cuda")


@pytest.fixture
def stack(cuda):
    shape = (40, 48, 96)  # z and x are not multiples of the tile
    lanes = [synthetic_boundaries_np(shape, seed=s) for s in range(3)] + [np.ones(shape, np.float32)]
    return torch.from_numpy(np.stack(lanes)).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("fill_mode", ["capacity", "dense"])
def test_batched_watershed_on_the_card_equals_per_lane(stack, fill_mode, monkeypatch):
    monkeypatch.setenv("CT_TIER_MODE", "cond")
    monkeypatch.setenv("CT_SEED_CCL", "tiled")
    kw = dict(threshold=0.3, dt_max_distance=8.0, fill_mode=fill_mode, impl="cuda")
    K.reset_counts()
    lab, ovf = tws.dt_watershed_lanes(stack, **kw)
    torch.cuda.synchronize()
    launched = dict(K.LAUNCHES)
    for name in ("edt_cascade", "tile_ccl", "tile_ws_propagate", "apply_remap"):
        assert launched.get(name, 0) > 0, (name, launched)
    for i in range(stack.shape[0]):
        want, want_ovf = tws._dt_watershed_core(stack[i], None, None, **kw)
        assert torch.equal(lab[i], want), i
        assert bool(ovf[i]) == want_ovf
    # the card's lanes equal the plain twins on the CPU
    cpu, _ = tws.dt_watershed_lanes(stack.cpu(), **dict(kw, impl="torch"))
    assert torch.equal(lab.cpu(), cpu)


@pytest.mark.gpu
def test_batched_ccl_on_the_card_equals_per_lane(stack):
    masks = stack < 0.3
    lab, ovf = tccl.label_components_tiled_lanes(masks, impl="cuda")
    for i in range(masks.shape[0]):
        want, want_ovf = tccl.label_components_tiled_tensor(masks[i], impl="cuda")
        assert torch.equal(lab[i], want) and bool(ovf[i]) == want_ovf
    got = pccl.label_components_batched(masks, 1)
    for i in range(masks.shape[0]):
        assert torch.equal(got[i], pccl.label_components_batched(masks[i:i + 1], 1)[0])


@pytest.mark.gpu
def test_device_pool_reuses_cuda_pages(cuda):
    device_pool.reset()
    # the reference's geometry (tests/test_device_plane.py): 27 clipped
    # blocks whose pages all fit one arena, so a warm re-sweep hits every
    # page (an arena holds what a batch needs, under an LRU)
    vol = np.random.default_rng(4).random((20, 20, 20)).astype(np.float32)
    blocking = Blocking(vol.shape, (8, 8, 8))
    blocks = [blocking.get_block(i, halo=(2, 2, 2)) for i in range(blocking.n_blocks)]

    def sweep(**kw):
        out = np.zeros_like(vol)

        def store(b, o):
            out[b.bb] = o[b.inner_in_outer_bb]

        s = BlockwiseExecutor(target="gpu").map_blocks(
            lambda x: torch.where(x < 0.5, x * 2 + 0.25, 1.0), blocks, lambda b: (vol[b.outer_bb],), store,
            sharded_batch=16, **kw)
        return out, s

    ref, _ = sweep(sweep_mode="per_block")
    cold, s_cold = sweep(sweep_mode="sharded", device_pool="on")
    warm, s_warm = sweep(sweep_mode="sharded", device_pool="on")
    assert np.array_equal(ref, cold) and np.array_equal(ref, warm)
    assert s_cold["device_pool_misses"] > 0 and s_warm["device_pool_misses"] == 0
    assert s_warm["device_pool_hits"] > 0 and s_warm["h2d_bytes"] < s_cold["h2d_bytes"]
    assert s_warm["device_pool_resident_bytes"] > 0
    arena = next(iter(device_pool.get_device_pool()._arenas.values()))
    assert arena.pool.is_cuda
    device_pool.reset()
