"""The port's connected-components and relabel workflows against the JAX
package's, on the CPU (``target="local"``).

Each case writes the same seeded input to a tensorstore zarr for the JAX
workflow and to the port's numpy zarr for the port's, runs both, and
requires the two output files to be equal bit for bit (uint64).  Also:
resume is a no-op, and ``label_components_keyed`` / ``union_find_host``
equal their references.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from cluster_tools_tpu.ops.ccl import label_components_keyed as j_keyed
from cluster_tools_tpu.ops.unionfind import union_find_host as j_uf_host
from cluster_tools_tpu.runtime.task import build as j_build
from cluster_tools_tpu.tasks.connected_components import ConnectedComponentsWorkflow as JCC
from cluster_tools_tpu.tasks.relabel import RelabelWorkflow as JRelabel
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
from cluster_tools_tpu_torch.ops.ccl import label_components_keyed
from cluster_tools_tpu_torch.ops.unionfind import union_find_host
from cluster_tools_tpu_torch.runtime.task import build as p_build
from cluster_tools_tpu_torch.tasks.connected_components import ConnectedComponentsWorkflow as PCC
from cluster_tools_tpu_torch.tasks.relabel import RelabelWorkflow as PRelabel
from cluster_tools_tpu_torch.utils.volume_utils import file_reader as p_reader

torch.set_num_threads(1)

SIDES = {"jax": (JCC, JRelabel, j_build, j_reader), "port": (PCC, PRelabel, p_build, p_reader)}


@pytest.fixture(scope="module", autouse=True)
def _pin_modes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CT_TIER_MODE", "cond")
        mp.setenv("CT_FILL_MODE", "capacity")
        mp.setenv("CT_SEED_CCL", "tiled")
        yield


def _blobs(shape, seed, p=0.45, sigma=1.5):
    x = ndi.gaussian_filter(np.random.default_rng(seed).random(shape), sigma)
    return (x - x.min()) / (x.max() - x.min())


def _write(side, root, key, data, chunks):
    ds = SIDES[side][3](os.path.join(root, f"{side}.zarr")).require_dataset(
        key, shape=data.shape, chunks=chunks, dtype=str(data.dtype))
    ds[...] = data


def _read(side, root, key):
    return np.asarray(SIDES[side][3](os.path.join(root, f"{side}.zarr"))[key][:])


def run_cc(root, name, data, block_shape, **params):
    """The cc workflow on both sides; returns ``{side: labels}``."""
    out = {}
    for side in SIDES:
        d = os.path.join(root, f"{name}-{side}")
        os.makedirs(os.path.join(d, "cfg"), exist_ok=True)
        with open(os.path.join(d, "cfg", "global.config"), "w") as f:
            json.dump({"block_shape": list(block_shape)}, f)
        _write(side, root, name, data, block_shape)
        wf = SIDES[side][0](tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=2,
                            target="local", input_path=os.path.join(root, f"{side}.zarr"), input_key=name,
                            output_path=os.path.join(root, f"{side}.zarr"), output_key=name + "_cc",
                            block_shape=list(block_shape), **params)
        assert SIDES[side][2]([wf]), side
        out[side] = _read(side, root, name + "_cc")
    return out


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("cc"))


def _assert_equal(out):
    assert out["port"].dtype == np.uint64 and out["jax"].dtype == np.uint64
    np.testing.assert_array_equal(out["port"], out["jax"])
    assert out["port"].max() > 1


@pytest.mark.parametrize("connectivity", [1, 2, 3])
def test_cc_connectivity_matches_reference(root, connectivity):
    mask = (_blobs((32, 32, 32), seed=connectivity) < 0.45).astype(np.uint8)
    out = run_cc(root, f"conn{connectivity}", mask, (16, 16, 16), connectivity=connectivity)
    _assert_equal(out)
    ref, n = ndi.label(mask, ndi.generate_binary_structure(3, connectivity))
    assert out["port"].max() == n


def test_cc_threshold_less_matches_reference(root):
    vol = _blobs((32, 32, 32), seed=7).astype(np.float32)
    _assert_equal(run_cc(root, "thr", vol, (16, 16, 16), threshold=0.4, threshold_mode="less"))


def test_cc_irregular_edge_blocks_match_reference(root):
    mask = (_blobs((30, 27, 20), seed=8) > 0.55).astype(np.uint8)
    _assert_equal(run_cc(root, "irregular", mask, (16, 16, 16), connectivity=2))


def test_cc_2d_volume_matches_reference(root):
    mask = (_blobs((40, 36), seed=9, sigma=2.0) > 0.5).astype(np.uint8)
    _assert_equal(run_cc(root, "flat", mask, (16, 16)))


def test_cc_keyed_matches_reference(root):
    seg = (np.floor(_blobs((32, 32, 32), seed=10, sigma=3.0) * 6)).astype(np.uint64) * np.uint64(1 << 40)
    # (as in the reference, a block without background voxels keys its
    # smallest segment 0, i.e. background: ROADMAP Queue C, fact 5)
    _assert_equal(run_cc(root, "keyed", seg, (16, 16, 16), keyed=True))


@pytest.fixture(scope="module")
def cc_resume(root):
    mask = (_blobs((32, 32, 32), seed=11) < 0.5).astype(np.uint8)
    return run_cc(root, "resume", mask, (16, 16, 16))


def test_cc_resume_is_a_noop(root, cc_resume):
    _assert_equal(cc_resume)
    d = os.path.join(root, "resume-port")
    manifests = sorted(f for f in os.listdir(os.path.join(d, "tmp")) if f.endswith(".success.json"))
    stamps = [os.path.getmtime(os.path.join(d, "tmp", f)) for f in manifests]
    wf = PCC(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=2, target="local",
             input_path=os.path.join(root, "port.zarr"), input_key="resume",
             output_path=os.path.join(root, "port.zarr"), output_key="resume_cc", block_shape=[16, 16, 16])
    assert p_build([wf])
    assert [os.path.getmtime(os.path.join(d, "tmp", f)) for f in manifests] == stamps
    np.testing.assert_array_equal(_read("port", root, "resume_cc"), cc_resume["jax"])


@pytest.mark.parametrize("in_place", [False, True])
def test_relabel_matches_reference(root, in_place):
    rng = np.random.default_rng(12)
    labels = rng.choice(np.array([0, 5, 2**40 + 3, 77, 2**33, 9], np.uint64), size=(24, 20, 20))
    name = f"relabel{int(in_place)}"
    out = {}
    for side in SIDES:
        d = os.path.join(root, f"{name}-{side}")
        _write(side, root, name, labels, (16, 16, 16))
        params = {} if in_place else {"output_path": os.path.join(root, f"{side}.zarr"), "output_key": name + "_out"}
        wf = SIDES[side][1](tmp_folder=os.path.join(d, "tmp"), config_dir=d, max_jobs=2, target="local",
                            input_path=os.path.join(root, f"{side}.zarr"), input_key=name,
                            block_shape=[16, 16, 16], **params)
        assert SIDES[side][2]([wf]), side
        out[side] = _read(side, root, name if in_place else name + "_out")
    np.testing.assert_array_equal(out["port"], out["jax"])
    assert sorted(np.unique(out["port"])) == list(range(6))


@pytest.mark.parametrize("connectivity", [1, 3])
def test_label_components_keyed_matches_reference(connectivity):
    keys = (np.floor(_blobs((12, 14, 16), seed=13, sigma=1.0) * 4)).astype(np.int32)
    want = np.asarray(j_keyed(jnp.asarray(keys), connectivity=connectivity))
    got = label_components_keyed(keys, connectivity=connectivity, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_union_find_host_matches_reference():
    rng = np.random.default_rng(14)
    pairs = rng.integers(0, 500, (300, 2)).astype(np.int64)
    np.testing.assert_array_equal(union_find_host(pairs, 600), j_uf_host(pairs, 600))
    np.testing.assert_array_equal(union_find_host(pairs[:0], 5), j_uf_host(pairs[:0], 5))
