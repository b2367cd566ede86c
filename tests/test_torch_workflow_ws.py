"""The port's watershed workflow (single- and two-pass) against the JAX
package's, on the CPU (``target="local"``).

Each case writes one seeded 32^3 boundary map to a tensorstore zarr (for
the JAX workflow) and to the port's numpy zarr, runs both with blocks of
16 and halo 4, and requires the output files to be equal bit for bit
(uint64).  The mode env (``CT_FILL_MODE``, ``CT_SEED_CCL``,
``CT_TIER_MODE``) is pinned on both sides.  Also function-level parity of
``dt_watershed_seeded_tiled``, ``filter_small_segments`` and
``gaussian_smooth``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from cluster_tools_tpu.ops.filters import gaussian_smooth as j_gaussian
from cluster_tools_tpu.ops.tile_ws import dt_watershed_seeded_tiled as j_seeded_tiled
from cluster_tools_tpu.ops.watershed import distance_transform_watershed as j_dtws
from cluster_tools_tpu.ops.watershed import filter_small_segments as j_filter
from cluster_tools_tpu.runtime.task import build as j_build
from cluster_tools_tpu.tasks.watershed import WatershedWorkflow as JWS
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
from cluster_tools_tpu_torch.ops.filters import gaussian_smooth
from cluster_tools_tpu_torch.ops.tile_ws import dt_watershed_seeded_tiled
from cluster_tools_tpu_torch.ops.watershed import filter_small_segments
from cluster_tools_tpu_torch.runtime.task import build as p_build
from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow as PWS
from cluster_tools_tpu_torch.utils.volume_utils import file_reader as p_reader

torch.set_num_threads(1)

SIDES = {"jax": (JWS, j_build, j_reader), "port": (PWS, p_build, p_reader)}
SHAPE = (32, 32, 32)
BLOCK = [16, 16, 16]


@pytest.fixture(scope="module", autouse=True)
def _pin_modes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CT_TIER_MODE", "cond")
        mp.setenv("CT_FILL_MODE", "capacity")
        mp.setenv("CT_SEED_CCL", "tiled")
        yield


def _boundaries(shape=SHAPE, seed=0):
    x = ndi.gaussian_filter(np.random.default_rng(seed).random(shape), 2.0)
    return ((x - x.min()) / (x.max() - x.min())).astype(np.float32)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ws"))
    for side in SIDES:
        ds = SIDES[side][2](os.path.join(root, f"{side}.zarr")).require_dataset(
            "boundaries", shape=SHAPE, chunks=tuple(BLOCK), dtype="float32")
        ds[...] = _boundaries()
    return root


def run_ws(root, name, halo=(4, 4, 4), **params):
    """The watershed workflow on both sides; returns ``{side: labels}``."""
    out = {}
    for side in SIDES:
        d = os.path.join(root, f"{name}-{side}")
        os.makedirs(os.path.join(d, "cfg"), exist_ok=True)
        with open(os.path.join(d, "cfg", "global.config"), "w") as f:
            json.dump({"block_shape": BLOCK}, f)
        path = os.path.join(root, f"{side}.zarr")
        wf = SIDES[side][0](tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=2,
                            target="local", input_path=path, input_key="boundaries", output_path=path,
                            output_key=name, block_shape=BLOCK, halo=list(halo), threshold=0.5, **params)
        assert SIDES[side][1]([wf]), side
        out[side] = np.asarray(SIDES[side][2](path)[name][:])
    return out


def _assert_equal(out):
    assert out["port"].dtype == np.uint64 and out["jax"].dtype == np.uint64
    np.testing.assert_array_equal(out["port"], out["jax"])
    assert len(np.unique(out["port"])) > 8


@pytest.mark.parametrize("seed_mode", ["tiled", "sparse"])
def test_single_pass_matches_reference(root, monkeypatch, seed_mode):
    monkeypatch.setenv("CT_SEED_CCL", seed_mode)
    out = run_ws(root, f"single_{seed_mode}", min_seed_distance=1.0)
    _assert_equal(out)
    assert (out["port"] > 0).all()


def test_size_filter_matches_reference(root):
    _assert_equal(run_ws(root, "size_filter", size_filter=30))


def test_sigma_seeds_matches_reference(root):
    _assert_equal(run_ws(root, "sigma", sigma_seeds=1.0))


def test_legacy_impl_matches_reference(root):
    _assert_equal(run_ws(root, "legacy", impl="legacy"))


def test_two_d_matches_reference(root):
    _assert_equal(run_ws(root, "two_d", two_d=True, halo=(0, 4, 4)))


@pytest.fixture(scope="module")
def two_pass(root):
    return run_ws(root, "two_pass", two_pass=True)


def test_two_pass_matches_reference(two_pass):
    _assert_equal(two_pass)
    labels = two_pass["port"]
    spans = sum(np.intersect1d(np.unique(np.take(labels, 15, axis=a)), np.unique(np.take(labels, 16, axis=a))).size
                for a in range(3))
    assert spans > 0, "no label crosses a block face"


def test_two_pass_resume_is_a_noop(root, two_pass):
    again = run_ws(root, "two_pass", two_pass=True)
    np.testing.assert_array_equal(again["port"], two_pass["jax"])


@pytest.fixture(scope="module")
def block_case():
    b = _boundaries((24, 24, 24), seed=3)
    rng = np.random.default_rng(4)
    ext = np.zeros(b.shape, np.int32)
    ext[:3] = rng.integers(0, 4, (3, 24, 24))
    mask = rng.random(b.shape) < 0.98
    return b, ext, mask


def test_dt_watershed_seeded_tiled_matches_reference(block_case):
    b, ext, mask = block_case
    cfg = dict(threshold=0.5, min_seed_distance=1.0, dt_max_distance=8.0, fill_mode="capacity", seed_mode="tiled")
    want, want_ovf = j_seeded_tiled(jnp.asarray(b), jnp.asarray(ext), mask=jnp.asarray(mask), impl="pallas",
                                    interpret=True, **cfg)
    got, ovf = dt_watershed_seeded_tiled(b, ext, mask=mask, device="cpu", **cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ovf == bool(want_ovf)
    assert (got.numpy() > b.size).any() and ((got.numpy() > 0) & (got.numpy() <= b.size)).any()


@pytest.mark.parametrize("max_label", [None, 2 * 24 ** 3])
def test_filter_small_segments_matches_reference(block_case, max_label):
    b, _, _ = block_case
    lab = np.array(j_dtws(jnp.asarray(b), threshold=0.5))
    if max_label is not None:
        lab = np.where(lab % 3 == 0, lab + b.size, lab).astype(np.int32)
    want = np.asarray(j_filter(jnp.asarray(lab), jnp.asarray(b), jnp.int32(25), max_label=max_label))
    got = filter_small_segments(lab, b, 25, max_label=max_label, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) < len(np.unique(lab))


# XLA's CPU build contracts some of the reference's multiply-adds into fused
# ones; the port rounds each multiply and add (ROADMAP Queue C).  The
# largest difference on these inputs: 4 float32 ulps.
GAUSSIAN_MAX_ULPS = 4


@pytest.mark.parametrize("shape,sigma,sampling", [((20, 24, 30), 1.0, None), ((16, 40), 1.5, None),
                                                  ((18, 18, 18), 2.0, (2.0, 1.0, 1.0))])
def test_gaussian_smooth_matches_reference_within_ulps(shape, sigma, sampling):
    rng = np.random.default_rng(5)
    x = (rng.random(shape) * 100).astype(np.float32)
    x[x > 90] = 1e12
    want = np.asarray(j_gaussian(jnp.asarray(x), sigma, sampling))
    got = gaussian_smooth(x, sigma, sampling, device="cpu").numpy()
    ulps = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
    assert ulps.max() <= GAUSSIAN_MAX_ULPS
    np.testing.assert_array_equal(gaussian_smooth(x, 0.0, device="cpu").numpy(), x)
