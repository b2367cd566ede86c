"""The whole slice: the port's single-device ws+cc step against the JAX
split chain on a one-device (1x1) CPU mesh, on all four outputs, with zero
tolerance.  The JAX side runs ``impl="xla"`` (its split stages hard-code
``interpret=False``), the port its twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_tools_tpu.parallel import make_mesh
from cluster_tools_tpu.parallel.split_pipeline import make_ws_ccl_split as j_make_split
from cluster_tools_tpu_torch.ops import kernels as K
from cluster_tools_tpu_torch.parallel.halo import crop_halo, exchange_halo
from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split
from cluster_tools_tpu_torch.utils.reference_io import from_reference
from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries, synthetic_boundaries_np

SHAPE = (1, 24, 48, 128)

# one intra-op thread: the suite runs many test processes side by side, and
# torch's default thread pool oversubscribes the cores under that load
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def boundaries():
    return synthetic_boundaries_np(SHAPE, seed=3, passes=3)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(1, axis_names=("dp", "sp"), devices=jax.devices("cpu")[:1])


@pytest.mark.parametrize("fill_mode,seed_mode", [("capacity", "sparse"), ("dense", "tiled")])
def test_split_step_matches_reference_on_1x1_mesh(monkeypatch, boundaries, mesh, fill_mode, seed_mode):
    monkeypatch.setenv("CT_TIER_MODE", "cond")
    cfg = dict(halo=4, threshold=0.45, dt_max_distance=4.0, min_seed_distance=1.0,
               fill_mode=fill_mode, seed_mode=seed_mode)
    want = j_make_split(mesh, impl="xla", **cfg)(jnp.asarray(boundaries))
    tensors, kw = from_reference(boundaries, mesh=mesh, impl="xla", stitch_ws_threshold=0.45,
                                 device="cpu", **cfg)
    step = make_ws_ccl_split(**kw)
    assert set(step.stages) == {"seeds", "flow", "fill", "cc"}
    seen = []
    got = step.run_staged(tensors["volume"], lambda name, *a: seen.append(name))
    assert seen == ["seeds", "flow", "fill", "cc"]
    ws, cc, n_fg, overflow = got
    assert ws.dtype == torch.int32 and cc.dtype == torch.int32 and ws.shape == SHAPE
    np.testing.assert_array_equal(ws.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(cc.numpy(), np.asarray(want[1]))
    assert float(n_fg) == float(want[2]) and n_fg.dtype == torch.float32
    assert overflow is False and bool(want[3]) is False
    assert int(n_fg) == int((cc > 0).sum())


def test_split_step_on_cpu_runs_the_twins_only(boundaries):
    K.reset_counts()
    make_ws_ccl_split(device="cpu", halo=4, threshold=0.45, seed_mode="tiled")(boundaries)
    assert sum(K.LAUNCHES.values()) == 0
    assert K.RUNGS  # every remap site chose a rung
    with pytest.raises(ValueError):
        make_ws_ccl_split(device="cpu", impl="cuda")


def test_halo_pad_and_crop():
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    padded = exchange_halo(x, 2, 0, fill=1.0)
    assert padded.shape == (6, 3, 4)
    assert (padded[:2] == 1.0).all() and (padded[-2:] == 1.0).all()
    assert torch.equal(crop_halo(padded, 2, 0), x)
    # between two shards: each side's halo is the neighbour's rows, as in the reference
    from jax.sharding import PartitionSpec as JP

    from cluster_tools_tpu.compat import shard_map as j_shard_map
    from cluster_tools_tpu.parallel.halo import exchange_halo as j_exchange_halo
    from cluster_tools_tpu_torch.parallel import spmd
    from cluster_tools_tpu_torch.parallel.mesh import make_mesh as p_make_mesh

    vol = np.arange(2 * 4 * 3 * 4, dtype=np.float32).reshape(8, 3, 4)
    jm = make_mesh(2, axis_names=("sp",), devices=jax.devices("cpu")[:2])
    want = j_shard_map(lambda v: j_exchange_halo(v, 1, 0, "sp", 2, fill=1.0), mesh=jm, in_specs=JP("sp"),
                       out_specs=JP("sp"))(vol)
    got = spmd.shard_map(lambda v: exchange_halo(v, 1, 0, "sp", 2, fill=1.0), p_make_mesh(2, ("sp",), devices="cpu"),
                         spmd.P("sp"), spmd.P("sp"))(vol)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[5], vol[4])  # shard 0's high halo: shard 1's first row


def test_synthetic_makers():
    v = synthetic_boundaries_np((8, 16, 16), seed=0)
    assert v.dtype == np.float32 and v.min() == 0.0 and v.max() == 1.0
    t = synthetic_boundaries((1, 8, 16, 16), torch.Generator().manual_seed(0))
    assert t.dtype == torch.float32 and float(t.min()) == 0.0 and float(t.max()) == 1.0
    np.testing.assert_array_equal(v, synthetic_boundaries_np((8, 16, 16), seed=0))
