"""The whole slice: the port's fused and split ws+cc steps on 8-shard CPU
meshes against the JAX package's builders on its 8-device CPU mesh, with
zero tolerance on all four outputs — dp x sp = (2, 4), the stitch with and
without compaction, the overflow flag, a two-axis decomposition with the
mesh-exact EDT, and the fused step's legacy branch; and split == fused in
the port.  The JAX side runs ``impl="xla"``; the mode variables are pinned
on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu.parallel import make_mesh as j_make_mesh
from cluster_tools_tpu.parallel.pipeline import make_ws_ccl_step as j_make_step
from cluster_tools_tpu.parallel.split_pipeline import make_ws_ccl_split as j_make_split
from cluster_tools_tpu_torch.ops import kernels as K
from cluster_tools_tpu_torch.parallel import spmd
from cluster_tools_tpu_torch.parallel.mesh import make_mesh
from cluster_tools_tpu_torch.parallel.pipeline import make_ws_ccl_step
from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split
from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries_np

from .helpers import assert_labels_equivalent

torch.set_num_threads(1)

MODES = {"CT_FILL_MODE": "capacity", "CT_SEED_CCL": "sparse", "CT_TIER_MODE": "cond"}
PORT_MODES = dict(fill_mode="capacity", seed_mode="sparse", tier_mode="cond")
BASE = dict(halo=2, threshold=0.45, dt_max_distance=4.0, min_seed_distance=1.0)
CONFIGS = {
    "plain": {},
    "stitch": dict(stitch_ws_threshold=0.5),
    "stitch_compacted": dict(stitch_ws_threshold=0.5, max_labels_per_shard=4096),
    "overflow": dict(max_labels_per_shard=4),
}


def _reference(build, mesh, vol, **cfg):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in MODES.items():
            mp.setenv(k, v)
        out = build(mesh, impl="xla", **cfg)(jnp.asarray(vol))
        return tuple(np.asarray(o) for o in out[:2]) + (float(out[2]), bool(out[3]))


def _assert_equal(got, want, what):
    ws, cc, n_fg, overflow = got
    assert ws.dtype == torch.int32 and cc.dtype == torch.int32 and n_fg.dtype == torch.float32
    np.testing.assert_array_equal(ws.numpy(), want[0], err_msg=f"{what}: ws")
    np.testing.assert_array_equal(cc.numpy(), want[1], err_msg=f"{what}: cc")
    assert float(n_fg) == want[2], what
    assert overflow is want[3], what


@pytest.fixture(scope="module")
def volume():
    return np.stack([synthetic_boundaries_np((32, 32, 128), seed=s, passes=3) for s in (0, 1)])


@pytest.fixture(scope="module")
def meshes():
    return (j_make_mesh(8, axis_names=("dp", "sp"), devices=jax.devices("cpu")),
            make_mesh(8, axis_names=("dp", "sp"), devices=["cpu"] * 8))


@pytest.fixture(scope="module")
def reference_runs(volume, meshes):
    jm = meshes[0]
    return {name: _reference(j_make_step, jm, volume, **BASE, **cfg) for name, cfg in CONFIGS.items()}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("builder", ["fused", "split"])
def test_step_matches_reference_dp_sp(volume, meshes, reference_runs, config, builder):
    build = make_ws_ccl_step if builder == "fused" else make_ws_ccl_split
    got = build(meshes[1], **BASE, **CONFIGS[config], **PORT_MODES)(volume)
    want = reference_runs[config]
    _assert_equal(got, want, f"{builder} {config}")
    assert want[3] is (config == "overflow")
    if config == "plain":
        assert int(got[2]) == int((got[1] > 0).sum())
        for i in range(volume.shape[0]):
            assert_labels_equivalent(got[1][i].numpy(), ndimage.label(volume[i] < np.float32(0.45))[0])


def test_split_matches_reference_split_chain(volume, meshes):
    """The port's split chain against the reference's split chain itself."""
    want = _reference(j_make_split, meshes[0], volume, **BASE, stitch_ws_threshold=0.5)
    step = make_ws_ccl_split(meshes[1], **BASE, stitch_ws_threshold=0.5, **PORT_MODES)
    assert set(step.stages) == {"seeds", "flow", "fill", "cc"}
    seen = []
    spmd.COUNTERS.reset()
    got = step.run_staged(volume, lambda name, *a: seen.append(name))
    assert seen == ["seeds", "flow", "fill", "cc"]
    _assert_equal(got, want, "split chain")
    counts = spmd.COUNTERS.snapshot()
    # halos in seeds, the merges' gathers in fill and cc, the count's psum in cc
    assert counts["seeds"]["ppermute"]["calls"] and counts["fill"]["all_gather"]["calls"]
    assert counts["cc"]["psum"]["calls"] and "all_to_all" not in counts["seeds"]


@pytest.mark.parametrize("builder", ["fused", "split"])
def test_two_axis_exact_edt_matches_reference(volume, builder):
    """A (dp, spz, spy) = (2, 2, 2) mesh: z and y each sharded, seeds from
    the mesh-exact EDT (all-to-all reshards), fragments stitched and
    compacted across both families of cuts."""
    axes, grid = ("dp", "spz", "spy"), (2, 2, 2)
    cfg = dict(halo=2, threshold=0.45, min_seed_distance=1.0, sp_axis=("spz", "spy"), exact_edt=True,
               stitch_ws_threshold=0.5, max_labels_per_shard=4096)
    want = _reference(j_make_step, j_make_mesh(8, axis_names=axes, grid=grid, devices=jax.devices("cpu")),
                      volume, **cfg)
    pm = make_mesh(8, axis_names=axes, grid=grid, devices="cpu")
    build = make_ws_ccl_step if builder == "fused" else make_ws_ccl_split
    spmd.COUNTERS.reset()
    _assert_equal(build(pm, **cfg, **PORT_MODES)(volume), want, f"two-axis {builder}")
    stage = "step" if builder == "fused" else "seeds"
    assert spmd.COUNTERS.snapshot()[stage]["all_to_all"]["calls"] > 0


def test_fused_legacy_branch_matches_reference():
    rng = np.random.default_rng(5)
    vol = rng.random((2, 16, 12, 12)).astype(np.float32)
    cfg = dict(halo=2, threshold=0.5, impl="legacy")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in MODES.items():
            mp.setenv(k, v)
        out = j_make_step(j_make_mesh(8, axis_names=("dp", "sp"), devices=jax.devices("cpu")), **cfg)(
            jnp.asarray(vol))
        want = tuple(np.asarray(o) for o in out[:2]) + (float(out[2]), bool(out[3]))
    got = make_ws_ccl_step(make_mesh(8, devices="cpu"), **cfg, **PORT_MODES)(vol)
    _assert_equal(got, want, "legacy")
    with pytest.raises(ValueError, match="tiled kernels"):
        make_ws_ccl_split(make_mesh(8, devices="cpu"), impl="legacy")
    with pytest.raises(ValueError, match="exact_edt"):
        make_ws_ccl_step(make_mesh(8, devices="cpu"), impl="legacy", exact_edt=True)


def test_split_equals_fused_and_runs_the_twins_only(volume, meshes):
    """On the CPU both builders run the twins: no kernel launch, and the
    two agree bit for bit (here in the tiled seed mode and dense fill)."""
    modes = dict(fill_mode="dense", seed_mode="tiled", tier_mode="cond")
    K.reset_counts()
    fused = make_ws_ccl_step(meshes[1], **BASE, stitch_ws_threshold=0.5, **modes)(volume)
    split = make_ws_ccl_split(meshes[1], **BASE, stitch_ws_threshold=0.5, **modes)(volume)
    assert sum(K.LAUNCHES.values()) == 0 and K.RUNGS
    for a, b in zip(fused[:3], split[:3]):
        assert torch.equal(a, b)
    assert fused[3] is split[3] is False


def test_step_builders_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (make_ws_ccl_step, make_ws_ccl_split):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        with pytest.raises(ValueError):
            build(device="cpu", impl="cuda")
