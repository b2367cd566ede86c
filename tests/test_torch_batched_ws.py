"""The lane-batched DT watershed and CCL against per-lane calls, and the
sharded workflows against the JAX package's.

``dt_watershed_lanes`` and ``label_components_tiled_lanes`` run a ``[B,
z, y, x]`` stack of blocks in one call (kernels B1-B4 once over the stack,
everything between them per row); each lane must equal, bit for bit, what
the single-lane function gives for it alone, overflow flag included.  The
cc task's batched forms (``label_components_batched`` and the keyed
labeller with a lane axis) likewise.  Then the single-pass, two-pass and
cc workflows with ``sweep_mode="sharded"`` on a 12-block grid, the JAX
package's and the port's, write equal files.  The mode env is pinned.
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
from cluster_tools_tpu_torch.ops import ccl as pccl
from cluster_tools_tpu_torch.ops import tile_ccl as tccl
from cluster_tools_tpu_torch.ops import tile_ws as tws
from cluster_tools_tpu_torch.runtime.task import build as p_build
from cluster_tools_tpu_torch.tasks.connected_components import ConnectedComponentsWorkflow as PCC
from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow as PWS
from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries_np
from cluster_tools_tpu_torch.utils.volume_utils import file_reader as p_reader

torch.set_num_threads(1)

# z = 20 is not a multiple of the lanes' z tile (16): each lane pads alone
SHAPE = (20, 24, 40)


@pytest.fixture(scope="module", autouse=True)
def _pin_modes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CT_TIER_MODE", "cond")
        mp.setenv("CT_FILL_MODE", "capacity")
        mp.setenv("CT_SEED_CCL", "tiled")
        yield


def _blob(shape):
    """One dark ball in a bright volume: a single seed plateau, no tile
    face crossed by foreground."""
    zz, yy, xx = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    d = np.sqrt((zz - 4.0) ** 2 + (yy - 5.0) ** 2 + (xx - 6.0) ** 2)
    return np.clip(d / 4.0, 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def stack():
    """Lanes of different content: two synthetic boundary maps, one ball,
    one all-boundary (empty) lane."""
    lanes = [synthetic_boundaries_np(SHAPE, seed=0), synthetic_boundaries_np(SHAPE, seed=1), _blob(SHAPE),
             np.ones(SHAPE, np.float32)]
    return torch.from_numpy(np.stack(lanes))


KW = dict(threshold=0.3, dt_max_distance=8.0, impl="torch")


def _check_lanes(b, ext=None, m=None, **kw):
    kw = dict(KW, **kw)
    lab, ovf = tws.dt_watershed_lanes(b, ext, m, **kw)
    assert lab.shape == b.shape and ovf.shape == (b.shape[0],)
    for i in range(b.shape[0]):
        want, want_ovf = tws._dt_watershed_core(b[i], None if ext is None else ext[i], None if m is None else m[i],
                                                **kw)
        torch.testing.assert_close(lab[i], want, rtol=0, atol=0)
        assert bool(ovf[i]) == want_ovf, i
    return lab, ovf


@pytest.mark.parametrize("fill_mode", ["capacity", "dense"])
def test_lanes_of_different_content_equal_per_lane(stack, fill_mode):
    lab, ovf = _check_lanes(stack, fill_mode=fill_mode)
    assert not ovf.any()
    assert len(torch.unique(lab[0])) > 8
    # the ball's one seed floods its whole lane; the all-boundary lane has none
    assert len(torch.unique(lab[2])) == 1 and lab[2].min() > 0
    assert not lab[3].any()


@pytest.mark.parametrize("seed_mode,caps,flags", [
    ("sparse", {"seed_cap": 64}, [True, True, False, False]),
    ("tiled", {"pair_cap": 1}, [False, True, False, False]),
])
def test_a_lane_that_overflows_alone_is_the_only_one(stack, seed_mode, caps, flags):
    """A lane past a capacity overflows exactly as it does alone, and its
    neighbours in the batch do not."""
    _, ovf = _check_lanes(stack, seed_mode=seed_mode, **caps)
    assert ovf.tolist() == flags
    _, ovf1 = _check_lanes(stack[[2, 1, 3]], seed_mode=seed_mode, **caps)
    assert ovf1.tolist() == [False, True, False]


def test_pass_two_external_seeds(stack):
    rng = np.random.default_rng(2)
    ext = (rng.random(stack.shape) < 0.003) * rng.integers(1, 12, stack.shape)
    ext[2] = 0
    lab, _ = _check_lanes(stack, ext=torch.from_numpy(ext.astype(np.int32)))
    n = int(np.prod(SHAPE))
    assert (lab[0] > n).any() and not (lab[2] > n).any()


def test_sigma_seeds_and_mask(stack):
    m = torch.from_numpy(np.random.default_rng(3).random(stack.shape) > 0.1)
    m[3] = False  # an all-masked lane
    lab, _ = _check_lanes(stack, m=m, sigma_seeds=1.0)
    assert not lab[3].any() and not lab[0][~m[0]].any()


@pytest.mark.parametrize("tier", ["big", "small"])
def test_tier_modes_equal_per_lane_and_agree_with_cond(stack, tier):
    """``cond`` is one tier decision per batch; the tiers give equal labels
    wherever neither truncates, so a lane's answer does not depend on
    which tier its batch took."""
    lab, ovf = _check_lanes(stack, tier_mode=tier)
    cond, cond_ovf = tws.dt_watershed_lanes(stack, **KW, tier_mode="cond")
    for i in range(stack.shape[0]):
        if not ovf[i]:
            torch.testing.assert_close(lab[i], cond[i], rtol=0, atol=0)


def test_tiled_ccl_lanes_equal_per_lane(stack):
    masks = stack < 0.3
    for tier in ("cond", "big", "small"):
        lab, ovf = tccl.label_components_tiled_lanes(masks, impl="torch", tier=tier)
        for i in range(masks.shape[0]):
            want, want_ovf = tccl.label_components_tiled_tensor(masks[i], impl="torch", tier=tier)
            torch.testing.assert_close(lab[i], want, rtol=0, atol=0)
            assert bool(ovf[i]) == want_ovf
    lab, ovf = tccl.label_components_tiled_lanes(masks, impl="torch", pair_cap=8)
    assert ovf.tolist() == [True, True, False, False]
    for i in range(masks.shape[0]):
        want, _ = tccl.label_components_tiled_tensor(masks[i], impl="torch", pair_cap=8)
        torch.testing.assert_close(lab[i], want, rtol=0, atol=0)


def test_lane_chunks_keep_the_stack_below_the_sentinel(monkeypatch, stack):
    """A stack whose flat indices would reach the kernels' sentinel runs in
    chunks of lanes, with the same answer."""
    want, _ = tws.dt_watershed_lanes(stack, **KW)
    monkeypatch.setattr(tccl, "BIG", 2 ** 30)
    n_pad = 32 * 32 * 128
    assert tccl.lane_chunks(4, n_pad) == [(0, 4)]
    assert tccl.lane_chunks(5, 2 ** 28) == [(0, 3), (3, 5)]
    monkeypatch.setattr(tws, "lane_chunks", lambda b, n: [(i, i + 1) for i in range(b)])
    got, _ = tws.dt_watershed_lanes(stack, **KW)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("connectivity", [1, 3])
def test_cc_batched_forms_equal_per_item(stack, connectivity):
    m = stack < 0.3
    got = pccl.label_components_batched(m, connectivity)
    keys = torch.from_numpy((np.asarray(stack) * 4).astype(np.int32))
    keyed = pccl.label_components_keyed_tensor(keys, connectivity, lead=1)
    for i in range(m.shape[0]):
        torch.testing.assert_close(got[i], pccl.label_components_batched(m[i:i + 1], connectivity)[0], rtol=0, atol=0)
        torch.testing.assert_close(keyed[i], pccl.label_components_keyed_tensor(keys[i], connectivity), rtol=0,
                                   atol=0)


# -- sharded workflows: the JAX package and the port write equal files ---------

WF_SHAPE = (48, 32, 32)   # 3 x 2 x 2 = 12 blocks of 16^3
WF_BLOCK = [16, 16, 16]
SIDES = {"jax": (JWS, JCC, j_build, j_reader), "port": (PWS, PCC, p_build, p_reader)}


@pytest.fixture(scope="module")
def wf_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded_wf"))
    x = ndi.gaussian_filter(np.random.default_rng(5).random(WF_SHAPE), 2.0)
    x = ((x - x.min()) / (x.max() - x.min())).astype(np.float32)
    for side in SIDES:
        ds = SIDES[side][3](os.path.join(root, f"{side}.zarr")).require_dataset(
            "boundaries", shape=WF_SHAPE, chunks=tuple(WF_BLOCK), dtype="float32")
        ds[...] = x
    return root


def _run(root, name, kind, **params):
    out = {}
    for side in SIDES:
        d = os.path.join(root, f"{name}-{side}")
        os.makedirs(os.path.join(d, "cfg"), exist_ok=True)
        with open(os.path.join(d, "cfg", "global.config"), "w") as f:
            json.dump({"block_shape": WF_BLOCK, "sweep_mode": "sharded"}, f)
        path = os.path.join(root, f"{side}.zarr")
        common = dict(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=2,
                      target="local", input_path=path, input_key="boundaries", output_path=path, output_key=name)
        if kind == "cc":
            wf = SIDES[side][1](threshold=0.5, threshold_mode="less", **common, **params)
        else:
            wf = SIDES[side][0](halo=[4, 4, 4], threshold=0.5, **common, **params)
        assert SIDES[side][2]([wf]), side
        out[side] = np.asarray(SIDES[side][3](path)[name][:])
    np.testing.assert_array_equal(out["port"], out["jax"])
    assert len(np.unique(out["port"])) > 8
    return out


@pytest.mark.parametrize("name,kind,params", [
    ("single", "ws", {}),
    ("two_pass", "ws", {"two_pass": True}),
    ("cc", "cc", {}),
])
def test_sharded_workflows_match_reference(wf_root, name, kind, params):
    _run(wf_root, name, kind, **params)
