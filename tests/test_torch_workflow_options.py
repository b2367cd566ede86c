"""Workflow options of the watershed, two-pass and cc workflows that the
other port tests do not run, against the JAX package, on the CPU.

One shared seeded 32^3 input (a smooth boundary map, a mask of it, and a
binary foreground) is written to both sides' zarrs; each case runs both
workflows (blocks of 16, ``target="local"``, modes pinned) and requires
the output files to be equal bit for bit (uint64).  An ROI is given, as
the reference reads it, through ``global.config``.
"""

import json
import os

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from cluster_tools_tpu.runtime.task import build as j_build
from cluster_tools_tpu.tasks.connected_components import ConnectedComponentsWorkflow as JCC
from cluster_tools_tpu.tasks.watershed import WatershedWorkflow as JWS
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
from cluster_tools_tpu_torch.runtime.task import build as p_build
from cluster_tools_tpu_torch.tasks.connected_components import ConnectedComponentsWorkflow as PCC
from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow as PWS
from cluster_tools_tpu_torch.utils.volume_utils import file_reader as p_reader

torch.set_num_threads(1)

SIDES = {"jax": dict(ws=JWS, cc=JCC, build=j_build, reader=j_reader),
         "port": dict(ws=PWS, cc=PCC, build=p_build, reader=p_reader)}
SHAPE = (32, 32, 32)
BLOCK = [16, 16, 16]
ROI = {"roi_begin": [0, 4, 17], "roi_end": [10, 30, 32]}  # 2 of the 8 blocks


@pytest.fixture(scope="module", autouse=True)
def _pin_modes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CT_TIER_MODE", "cond")
        mp.setenv("CT_FILL_MODE", "capacity")
        mp.setenv("CT_SEED_CCL", "tiled")
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("options"))
    x = ndi.gaussian_filter(np.random.default_rng(0).random(SHAPE), 2.0)
    bmap = ((x - x.min()) / (x.max() - x.min())).astype(np.float32)
    mask = (ndi.gaussian_filter(np.random.default_rng(1).random(SHAPE), 3.0) < 0.52).astype(np.uint8)
    fg = (bmap < 0.45).astype(np.uint8)
    for side in SIDES:
        f = SIDES[side]["reader"](os.path.join(root, f"{side}.zarr"))
        for key, data in (("bmap", bmap), ("mask", mask), ("fg", fg)):
            f.require_dataset(key, shape=SHAPE, chunks=tuple(BLOCK), dtype=str(data.dtype))[...] = data
    return root


def run_both(root, kind, name, global_config=None, **params):
    """The ``kind`` workflow ("ws" or "cc") on both sides; returns
    ``{side: labels}``."""
    out = {}
    for side, s in SIDES.items():
        d = os.path.join(root, f"{name}-{side}")
        os.makedirs(os.path.join(d, "cfg"))
        with open(os.path.join(d, "cfg", "global.config"), "w") as f:
            json.dump(dict({"block_shape": BLOCK}, **(global_config or {})), f)
        path = os.path.join(root, f"{side}.zarr")
        if kind == "ws":
            params = dict(dict(input_key="bmap", threshold=0.5, halo=[4, 4, 4]), **params)
        else:
            params = dict(dict(input_key="fg"), **params)
        if "mask_key" in params:
            params["mask_path"] = path
        wf = s[kind](tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=2,
                     target="local", input_path=path, output_path=path, output_key=name, block_shape=BLOCK,
                     **params)
        assert s["build"]([wf]), side
        out[side] = np.asarray(s["reader"](path)[name][:])
    return out


CASES = {
    # watershed (single pass); options that compile alike share a run
    "ws_mask_roi": ("ws", ROI, dict(mask_key="mask")),
    # anisotropic sampling, and dt_max_distance derived from the halo
    # (max(8, 5 * 2.0) = 10)
    "ws_sampling_halo_dt_max": ("ws", None, dict(sampling=[2.0, 1.0, 1.0], halo=[5, 5, 5])),
    "ws_conn2_size_filter": ("ws", None, dict(connectivity=2, size_filter=40)),
    "ws_conn3_size_filter": ("ws", None, dict(connectivity=3, size_filter=40)),
    # two-pass
    "ws2_legacy": ("ws", None, dict(two_pass=True, impl="legacy")),
    "ws2_mask_size_filter_sigma_seeds": ("ws", None, dict(two_pass=True, mask_key="mask", size_filter=40,
                                                          sigma_seeds=1.0)),
    # connected components
    "cc_mask": ("cc", None, dict(mask_key="mask", threshold=0.5)),
    "cc_roi": ("cc", ROI, dict(threshold=0.5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_workflow_option_matches_reference(root, case):
    kind, global_config, params = CASES[case]
    out = run_both(root, kind, case, global_config, **params)
    assert out["port"].dtype == out["jax"].dtype == np.uint64
    np.testing.assert_array_equal(out["port"], out["jax"])
    labels = out["port"]
    assert len(np.unique(labels)) > 2
    if "mask_key" in params:
        mask = np.asarray(p_reader(os.path.join(root, "port.zarr"))["mask"][:]) > 0
        assert not labels[~mask].any() and labels[mask].any()
    if global_config is not None:
        # blocks outside the ROI are never written
        inside = np.zeros(SHAPE, bool)
        lo = [b // 16 * 16 for b in ROI["roi_begin"]]
        hi = [-(-e // 16) * 16 for e in ROI["roi_end"]]
        inside[tuple(slice(a, b) for a, b in zip(lo, hi))] = True
        assert not labels[~inside].any()
