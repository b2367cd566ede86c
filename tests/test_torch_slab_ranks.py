"""``parallel/batch_shard.py::sharded_slab_sweep`` across ranks: each batch
split over a mesh of ``n_ranks`` CPU shards, the halos at the shards' cuts
exchanged by ``spmd.ppermute``.  Held against ``n_ranks=1`` (bit for bit,
host and device feeds, ragged tails, batches rounded up to a multiple of
the ranks) and against the JAX package's ``sharded_slab_sweep`` on its
8-device CPU mesh, with the same elementwise-exact kernel on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_tools_tpu.parallel import make_mesh as j_make_mesh
from cluster_tools_tpu.parallel.batch_shard import sharded_slab_sweep as j_sweep
from cluster_tools_tpu_torch.parallel import batch_shard as bs
from cluster_tools_tpu_torch.parallel import spmd

EXTENT, HALO = 6, 2


def p_kernel(x):
    return x * 2.0 + torch.roll(x, 1, 0) - torch.roll(x, -2, 1)


def j_kernel(x):
    return x * 2.0 + jnp.roll(x, 1, 0) - jnp.roll(x, -2, 1)


def _vol(n_slabs, seed=0):
    return np.random.default_rng(seed).random((n_slabs * EXTENT, 5, 4)).astype(np.float32)


@pytest.mark.parametrize("n_ranks", [2, 3, 4, 8])
@pytest.mark.parametrize("n_slabs,batch", [(8, 4), (6, 4), (5, None), (3, 8), (16, 8)])
def test_ranks_equal_one_rank(n_slabs, batch, n_ranks):
    vol = _vol(n_slabs, n_slabs)
    want = bs.sharded_slab_sweep(vol, p_kernel, extent=EXTENT, halo=HALO, batch=batch, fill=0.5, device="cpu")
    snap = spmd.COUNTERS.snapshot()
    got = bs.sharded_slab_sweep(vol, p_kernel, extent=EXTENT, halo=HALO, batch=batch, fill=0.5, device="cpu",
                                n_ranks=n_ranks)
    np.testing.assert_array_equal(got, want)
    assert spmd.COUNTERS.snapshot()["slab_sweep"]["ppermute"]["calls"] > \
        snap.get("slab_sweep", {}).get("ppermute", {}).get("calls", 0)
    kept = bs.sharded_slab_sweep(torch.from_numpy(vol), p_kernel, extent=EXTENT, halo=HALO, batch=batch, fill=0.5,
                                 n_ranks=n_ranks, keep_on_device=True)
    assert isinstance(kept, torch.Tensor)
    np.testing.assert_array_equal(kept.numpy(), want)


@pytest.mark.parametrize("n_slabs,batch", [(16, 8), (12, None), (10, 8)])
def test_ranks_equal_the_reference_mesh(n_slabs, batch):
    vol = _vol(n_slabs, 7)
    mesh = j_make_mesh(8, axis_names=("blocks",), devices=jax.devices("cpu"))
    want = np.asarray(j_sweep(vol, j_kernel, mesh, EXTENT, HALO, batch=batch, fill=0.5))
    got = bs.sharded_slab_sweep(vol, p_kernel, extent=EXTENT, halo=HALO, batch=batch, fill=0.5, device="cpu",
                                n_ranks=8)
    np.testing.assert_array_equal(got, want)
