"""The port's host per-block kernels (``cluster_tools_tpu_torch/ops/host.py``)
and the watershed task's ``impl="host"`` against the JAX package's, on the
CPU.

Seeded smooth boundary maps of 64^3 to 96^3 (numpy) go through both
packages.  ``host_dt_watershed`` (EDT cap, seed distance, anisotropic
sampling, mask), ``host_ws_ccl`` and ``host_label_components`` are equal
bit for bit on the host C++ rung of each package, on each one's scipy path
(``force_python``) and on 2-D input (scipy in both).  The
``WatershedWorkflow`` with ``impl="host"`` writes the same uint64 labels
as the reference's, and both refuse the same options (2-D, size filter,
agglomeration, ``sigma_seeds``, connectivity 2, two-pass) with the same
message.
"""

import json
import os

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import cluster_tools_tpu.native as jnat
import cluster_tools_tpu.ops.host as J
import cluster_tools_tpu_torch.native as pnat
import cluster_tools_tpu_torch.ops.host as P
from cluster_tools_tpu.runtime.task import build as j_build
from cluster_tools_tpu.tasks.watershed import WatershedWorkflow as JWS
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
from cluster_tools_tpu_torch.runtime.task import build as p_build
from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow as PWS
from cluster_tools_tpu_torch.utils.volume_utils import file_reader as p_reader

torch.set_num_threads(1)

SIDES = {"jax": dict(ws=JWS, build=j_build, reader=j_reader), "port": dict(ws=PWS, build=p_build, reader=p_reader)}
SHAPE = (96, 80, 64)
BLOCK = [48, 40, 32]


def _bmap(shape, seed, sigma=2.5):
    x = ndi.gaussian_filter(np.random.default_rng(seed).random(shape), sigma)
    return ((x - x.min()) / (x.max() - x.min())).astype(np.float32)


@pytest.fixture(scope="module")
def vol():
    return _bmap(SHAPE, 0)


KW = {
    "plain": dict(threshold=0.5),
    "cap-seed": dict(threshold=0.5, dt_max_distance=6.0, min_seed_distance=1.5),
    "sampling": dict(threshold=0.45, sampling=(2.0, 1.0, 1.0), dt_max_distance=8.0),
    "mask": dict(threshold=0.55, min_seed_distance=1.0, mask=True),
}


@pytest.mark.parametrize("rung", ["native", "scipy"])
@pytest.mark.parametrize("case", sorted(KW))
def test_host_dt_watershed_equal(vol, case, rung):
    kw = dict(KW[case])
    if kw.pop("mask", False):
        kw["mask"] = _bmap(SHAPE, 1, 4.0) < 0.52
    if rung == "native":
        pnat.reset_counts()
        got = P.host_dt_watershed(vol, **kw)
        assert pnat.COUNTS["edt_sq"] == 1 and pnat.COUNTS["ws_flood"] == 1
        want = J.host_dt_watershed(vol, **kw)
    else:
        with pnat.force_python(), jnat.force_python():
            got = P.host_dt_watershed(vol, **kw)
            want = J.host_dt_watershed(vol, **kw)
    assert got.shape == vol.shape and (got > 0).any()
    np.testing.assert_array_equal(got, want)


def test_host_ws_ccl_and_components_equal(vol):
    got = P.host_ws_ccl(vol, 0.5, dt_max_distance=4.0, min_seed_distance=1.0)
    want = J.host_ws_ccl(vol, 0.5, dt_max_distance=4.0, min_seed_distance=1.0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == int((vol < 0.5).sum())
    np.testing.assert_array_equal(P.host_label_components(vol < 0.4), J.host_label_components(vol < 0.4))


def test_host_dt_watershed_2d_takes_scipy_in_both():
    img = _bmap((96, 80), 2, 2.0)
    pnat.reset_counts()
    got = P.host_dt_watershed(img, 0.5, dt_max_distance=5.0, min_seed_distance=1.0)
    assert sum(pnat.COUNTS.values()) == 0
    np.testing.assert_array_equal(got, J.host_dt_watershed(img, 0.5, dt_max_distance=5.0, min_seed_distance=1.0))


def _run(root, side, name, **params):
    s = SIDES[side]
    d = os.path.join(root, f"{name}-{side}")
    os.makedirs(os.path.join(d, "cfg"))
    with open(os.path.join(d, "cfg", "global.config"), "w") as f:
        json.dump({"block_shape": BLOCK}, f)
    path = os.path.join(root, f"{side}.zarr")
    wf = s["ws"](tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=4, target="local",
                 input_path=path, input_key="bmap", output_path=path, output_key=name, block_shape=BLOCK,
                 impl="host", **params)
    try:
        ok, raised = s["build"]([wf]), ""
    except NotImplementedError as e:  # a refusal may propagate out of the build
        ok, raised = False, f"NotImplementedError: {e}"
    tmp = os.path.join(d, "tmp")
    logs = raised + "".join(open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp)) if f.endswith(".log"))
    return ok, (np.asarray(s["reader"](path)[name][:]) if ok else None), logs


@pytest.fixture(scope="module")
def root(tmp_path_factory, vol):
    root = str(tmp_path_factory.mktemp("host"))
    for side in SIDES:
        f = SIDES[side]["reader"](os.path.join(root, f"{side}.zarr"))
        f.require_dataset("bmap", shape=SHAPE, chunks=tuple(BLOCK), dtype="float32")[...] = vol
    return root


@pytest.mark.parametrize("case", ["default", "cap-seed"])
def test_watershed_task_host_equals_reference(root, case):
    params = dict(threshold=0.5, halo=[8, 8, 8])
    if case == "cap-seed":
        params.update(dt_max_distance=6.0, min_seed_distance=1.5)
    pnat.reset_counts()
    ok_p, got, logs_p = _run(root, "port", f"ws-{case}", **params)
    assert ok_p, logs_p[-3000:]
    n_blocks = 8
    assert pnat.COUNTS["edt_sq"] == n_blocks and pnat.COUNTS["ws_flood"] == n_blocks
    ok_j, want, logs_j = _run(root, "jax", f"ws-{case}", **params)
    assert ok_j, logs_j[-3000:]
    assert got.dtype == np.uint64 and (got > 0).any()
    np.testing.assert_array_equal(got, want)


REFUSALS = {
    "two_d": (dict(two_d=True), "impl='host' is 3-D only"),
    "size_filter": (dict(size_filter=10), "does not support size_filter"),
    "agglomerate": (dict(agglomerate_threshold=0.5), "does not support size_filter / agglomerate_threshold"),
    "sigma_seeds": (dict(sigma_seeds=1.0), "does not support sigma_seeds"),
    "connectivity": (dict(connectivity=2), "supports connectivity=1 only"),
    "two_pass": (dict(two_pass=True), "not supported for two-pass watershed"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_watershed_task_host_refusals_match(root, case):
    params, message = REFUSALS[case]
    for side in SIDES:
        ok, _, logs = _run(root, side, f"refuse-{case}", threshold=0.5, halo=[8, 8, 8], **params)
        assert not ok, side
        assert "NotImplementedError" in logs and message in logs, (side, logs[-2000:])
