"""The sharded ws+cc step on the card: an 8-shard mesh on one device, the
fused and split steps on the kernels against their ``impl="torch"`` runs
bit for bit, every main-path kernel launched; the mesh-exact EDT's
full-extent B3 passes against scipy.

Torch only; every test is ``gpu``-marked and skips without a CUDA device.
Run on the card: ``python3 -m pytest tests/test_torch_sharded_card.py -m gpu``.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu_torch.ops import kernels as K
from cluster_tools_tpu_torch.parallel.distributed_edt import distributed_distance_transform_squared
from cluster_tools_tpu_torch.parallel.mesh import make_mesh
from cluster_tools_tpu_torch.parallel.pipeline import make_ws_ccl_step
from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split
from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries_np

CFG = dict(halo=4, threshold=0.45, dt_max_distance=8.0, min_seed_distance=2.0, seed_mode="sparse",
           fill_mode="capacity", tier_mode="cond", stitch_ws_threshold=0.5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sharded step's kernels on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("builder", ["fused", "split"])
def test_sharded_step_on_the_card_equals_twins(cuda, builder):
    vol = np.stack([synthetic_boundaries_np((64, 64, 256), seed=s) for s in (0, 1)])
    mesh = make_mesh(8)
    assert mesh.grid == (2, 4) and all(d.type == "cuda" for d in mesh.devices)
    build = make_ws_ccl_step if builder == "fused" else make_ws_ccl_split
    K.reset_counts()
    got = build(mesh, **CFG)(vol)
    torch.cuda.synchronize()
    launched = dict(K.LAUNCHES)
    assert all(launched.get(k, 0) > 0 for k in ("tile_ccl", "tile_ws_propagate", "edt_cascade", "apply_remap"))
    want = build(mesh, impl="torch", **CFG)(vol)
    for a, b in zip(got[:3], want[:3]):
        assert a.is_cuda and torch.equal(a, b)
    assert got[3] is want[3] is False


@pytest.mark.gpu
def test_exact_edt_full_radius_on_the_card(cuda):
    mask = np.random.default_rng(0).random((64, 64, 64)) < 0.98
    mask[0, 0, 0] = False
    K.reset_counts()
    got = distributed_distance_transform_squared(mask, make_mesh(4, axis_names=("spz", "spy"), grid=(2, 2)),
                                                 sp_axis=("spz", "spy"))
    assert K.LAUNCHES["edt_cascade"] == 4 * 3
    np.testing.assert_array_equal(got.cpu().numpy().astype(np.float64),
                                  np.round(ndimage.distance_transform_edt(mask) ** 2))
