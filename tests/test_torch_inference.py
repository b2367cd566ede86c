"""The port's U-Net, checkpoints and ``InferenceWorkflow`` against the JAX
package's, on the CPU.

- ``UNet3D``: the same seeded flax parameters, carried across by
  ``models/flax_import.py``, through flax's ``UNet3D`` and the port's; at
  the reference's default width (base 16, depth 2, GroupNorm) on a 32^3
  input and at base 4 with other depths, ``norm=None``, three outputs and
  two inputs.  Tolerances are the reference's own: float32 logits within
  atol/rtol 2e-4 (``tests/test_inference.py::
  test_torch_checkpoint_import_numerical_parity``), bfloat16 sigmoid
  outputs within atol 2e-2 (``test_inference_blockwise_matches_single_shot``).
- Checkpoints: the flax npz round trip through the port is exact; a torch
  ``.pt`` of the reference's torch twin loads into both packages;
  ``model: {"name": "auto"}`` infers the reference's config; mismatches
  raise naming a tensor; ``.msgpack`` is refused (ROADMAP item 8b).
- ``InferenceWorkflow``: the JAX and port workflows (``target="local"``)
  on the same 40x32x24 uint8 volume and npz (base 4, depth 2, GroupNorm),
  block 16^3 with clipped and padded edge blocks, halo 8: sigmoid with
  min/max, softmax with percentiles, logits with a fixed range and an ROI;
  the output files agree within the dtype's tolerance above, and block
  markers resume alike.

The card's forward against the CPU's is held by the ``gpu``-marked tests of
``tests/test_torch_prediction_card.py`` (torch only: the card's machine has
no flax).
"""

import glob
import json
import math
import os

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_tools_tpu.models import UNet3D as JUNet3D
from cluster_tools_tpu.models.torch_import import infer_unet_config as j_infer_unet_config
from cluster_tools_tpu.runtime.task import build as j_build
from cluster_tools_tpu.tasks.inference import InferenceWorkflow as JInferenceWorkflow
from cluster_tools_tpu.tasks.inference import load_checkpoint as j_load_checkpoint
from cluster_tools_tpu.tasks.inference import save_checkpoint as j_save_checkpoint
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
from cluster_tools_tpu_torch.models import UNet3D, get_model
from cluster_tools_tpu_torch.models.flax_import import flax_to_state_dict, state_dict_to_flax
from cluster_tools_tpu_torch.models.torch_import import import_torch_unet, infer_unet_config, load_torch_checkpoint
from cluster_tools_tpu_torch.runtime.task import build as p_build
from cluster_tools_tpu_torch.tasks.inference import InferenceWorkflow as PInferenceWorkflow
from cluster_tools_tpu_torch.tasks.inference import load_checkpoint, save_checkpoint
from cluster_tools_tpu_torch.utils.volume_utils import file_reader as p_reader

torch.set_num_threads(1)

TOL = {"float32": dict(atol=2e-4, rtol=2e-4), "bfloat16": dict(atol=2e-2, rtol=0)}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def flax_variables(seed, x_shape, perturbed=True, **kw):
    """Seeded random parameters of flax ``UNet3D(**kw)`` (shapes from
    ``eval_shape``, values from numpy): kernels normal at the lecun scale;
    GroupNorm scales 1 and biases 0 as flax initialises them, or, with
    ``perturbed``, scales near 1 and biases nonzero so that every leaf's
    map is exercised.

    The float32 tests take perturbed parameters.  The bfloat16 tests take
    flax's: two bfloat16 implementations round different products, and with
    perturbed scales and biases the sigmoid outputs of the two packages
    differ by up to 1.3e-2 at base 4 (2.2e-2 on the workflow's padded
    blocks), each package as far from a float64 forward; with flax's they
    differ by 2e-3 to 1.4e-2."""
    model = JUNet3D(**kw)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct(x_shape, jnp.float32))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, s in sorted(tu.flatten_dict(shapes).items()):
        if path[-1] == "kernel":
            a = rng.normal(0.0, 1.0 / math.sqrt(math.prod(s.shape[:-1])), s.shape)
        elif path[-1] == "scale":
            a = 1.0 + 0.1 * rng.normal(size=s.shape) * perturbed
        else:
            a = 0.1 * rng.normal(size=s.shape) * perturbed
        flat[path] = a.astype(np.float32)
    return model, tu.unflatten_dict(flat)


def flat_npz(variables):
    return {"/".join(k): np.asarray(v) for k, v in tu.flatten_dict(variables).items()}


def port_model(variables, **kw):
    model = UNet3D(**kw)
    model.load_state_dict(flax_to_state_dict(flat_npz(variables), model))
    return model.eval()


def jax_logits(model, variables, x):
    """flax forward of an NCDHW numpy input; NCDHW float32 logits."""
    y = jax.jit(model.apply)(variables, jnp.asarray(np.moveaxis(x, 1, -1)))
    return np.moveaxis(np.asarray(y, np.float32), -1, 1)


def port_logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def assert_forward_close(dtype, got, want):
    if dtype == "bfloat16":
        got, want = 1.0 / (1.0 + np.exp(-got)), 1.0 / (1.0 + np.exp(-want))
    np.testing.assert_allclose(got, want, **TOL[dtype])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_full_width_matches_flax(dtype):
    """Base 16, depth 2, GroupNorm: the reference task's default model."""
    x = np.random.default_rng(1).random((1, 1, 32, 32, 32)).astype(np.float32)
    jm, variables = flax_variables(0, (1, 32, 32, 32, 1), perturbed=dtype == "float32", dtype=JDTYPE[dtype])
    pm = port_model(variables, dtype=getattr(torch, dtype))
    got = port_logits(pm, x)
    assert got.shape == (1, 1, 32, 32, 32) and got.dtype == np.float32
    assert_forward_close(dtype, got, jax_logits(jm, variables, x))


VARIANTS = {
    "depth1": dict(base_features=4, depth=1),
    "depth3": dict(base_features=4, depth=3),
    "norm_none": dict(base_features=4, depth=2, norm=None),
    "out3_in2": dict(base_features=4, depth=2, out_channels=3, in_channels=2),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_unet_variants_match_flax(variant, dtype):
    kw = dict(VARIANTS[variant])
    cin = kw.pop("in_channels", 1)
    x = np.random.default_rng(2).random((1, cin, 16, 16, 16)).astype(np.float32)
    jm, variables = flax_variables(3, (1, 16, 16, 16, cin), perturbed=dtype == "float32", dtype=JDTYPE[dtype], **kw)
    pm = port_model(variables, in_channels=cin, dtype=getattr(torch, dtype), **kw)
    got = port_logits(pm, x)
    assert got.shape == (1, kw.get("out_channels", 1), 16, 16, 16)
    assert_forward_close(dtype, got, jax_logits(jm, variables, x))


def test_unet_refuses_shapes_off_the_multiple():
    with pytest.raises(ValueError, match="divisible by 4"):
        UNet3D(base_features=4)(torch.zeros(1, 1, 16, 16, 18))
    with pytest.raises(ValueError, match="unknown model"):
        get_model("resnet")


def test_seeded_init_is_deterministic_and_device_free():
    a, b = UNet3D(base_features=4), UNet3D(base_features=4)
    for (k, u), (_, v) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(u, v), k
    b.reset_parameters(torch.Generator().manual_seed(5))
    assert not torch.equal(a.state_dict()["Conv_0.weight"], b.state_dict()["Conv_0.weight"])
    assert all(p.dtype == torch.float32 for p in a.parameters())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_flax_npz_round_trip_is_exact(tmp_path):
    """JAX ``save_checkpoint`` -> port -> port ``save_checkpoint`` -> JAX
    ``load_checkpoint`` gives back every array bit for bit, with or without
    the leading ``params/``."""
    jm, variables = flax_variables(4, (1, 2, 2, 2, 1), base_features=4, depth=1)
    src = str(tmp_path / "jax.npz")
    j_save_checkpoint(src, variables)
    pm = UNet3D(base_features=4, depth=1)
    sd = load_checkpoint(src, pm)
    dst = str(tmp_path / "port.npz")
    save_checkpoint(dst, pm)
    back = j_load_checkpoint(dst, jm, (1, 2, 2, 2, 1))
    want, got = flat_npz(variables), flat_npz(back)
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k
    bare = str(tmp_path / "bare.npz")
    np.savez(bare, **{k[len("params/"):]: v for k, v in want.items()})
    pm2 = UNet3D(base_features=4, depth=1)
    load_checkpoint(bare, pm2)
    for k, v in sd.items():
        assert torch.equal(pm2.state_dict()[k], v), k


def _torch_unet3d(in_ch, out_channels, base_features, depth):
    """The torch twin of the reference's tests (``tests/test_inference.py::
    _torch_unet3d``): the same layers, registered in application order."""
    import torch.nn as tnn

    act = tnn.GELU(approximate="tanh")

    def conv_block(cin, cout):
        return tnn.Sequential(
            tnn.Conv3d(cin, cout, 3, padding=1), tnn.GroupNorm(min(8, cout), cout), act,
            tnn.Conv3d(cout, cout, 3, padding=1), tnn.GroupNorm(min(8, cout), cout), act,
        )

    layers = []
    feats, cin = base_features, in_ch
    for _ in range(depth):
        layers.append(conv_block(cin, feats))
        layers.append(tnn.Conv3d(feats, feats * 2, 2, stride=2))
        cin, feats = feats * 2, feats * 2
    layers.append(conv_block(cin, feats))
    for _ in range(depth):
        feats //= 2
        layers.append(tnn.ConvTranspose3d(feats * 2, feats, 2, stride=2))
        layers.append(conv_block(feats * 2, feats))
    layers.append(tnn.Conv3d(feats, out_channels, 1))

    class TorchUNet3D(tnn.Module):
        def __init__(self):
            super().__init__()
            self.layers = tnn.ModuleList(layers)

        def forward(self, x):
            i, skips = 0, []
            for _ in range(depth):
                x = self.layers[i](x)
                skips.append(x)
                x = self.layers[i + 1](x)
                i += 2
            x = self.layers[i](x)
            i += 1
            for skip in reversed(skips):
                x = self.layers[i](x)
                x = self.layers[i + 1](torch.cat([x, skip], dim=1))
                i += 2
            return self.layers[i](x)

    return TorchUNet3D()


def test_torch_checkpoint_loads_into_both_packages(tmp_path):
    """A ``.pt`` of the seeded torch twin: the port's and the JAX package's
    imports give the same float32 forward (atol/rtol 2e-4), and both agree
    with the twin itself (whose GroupNorm epsilon is torch's 1e-5) within
    the same tolerance."""
    gen_state = torch.random.get_rng_state()
    torch.manual_seed(0)
    net = _torch_unet3d(1, 2, 4, 2).eval()
    torch.random.set_rng_state(gen_state)
    path = str(tmp_path / "model.pt")
    torch.save({"state_dict": net.state_dict()}, path)
    x = np.random.default_rng(5).random((1, 1, 16, 16, 16)).astype(np.float32)

    pm = UNet3D(out_channels=2, base_features=4, depth=2, dtype=torch.float32)
    load_checkpoint(path, pm)
    jm = JUNet3D(out_channels=2, base_features=4, depth=2, dtype=jnp.float32)
    jv = j_load_checkpoint(path, jm, (1, 16, 16, 16, 1))
    got = port_logits(pm, x)
    np.testing.assert_allclose(got, jax_logits(jm, jv, x), **TOL["float32"])
    with torch.no_grad():
        np.testing.assert_allclose(got, net(torch.from_numpy(x)).numpy(), **TOL["float32"])


def test_auto_config_matches_the_reference(tmp_path):
    """``infer_unet_config`` equals the reference's on a non-default twin,
    and ``import_torch_unet`` builds and loads that model (forward within
    the reference's atol/rtol 3e-4 of the twin, ``test_import_torch_unet_
    infers_architecture``)."""
    gen_state = torch.random.get_rng_state()
    torch.manual_seed(1)
    net = _torch_unet3d(3, 5, 8, 3).eval()
    torch.random.set_rng_state(gen_state)
    want = {"out_channels": 5, "base_features": 8, "depth": 3, "norm": "group", "in_channels": 3}
    assert infer_unet_config(net.state_dict()) == j_infer_unet_config(net.state_dict()) == want
    path = str(tmp_path / "user.pt")
    torch.save({"model_state_dict": net.state_dict()}, path)
    model, sd = import_torch_unet(path, dtype=torch.float32)
    assert (model.depth, model.out_channels, model.in_channels) == (3, 5, 3)
    assert list(sd) == list(model.state_dict())
    x = np.random.default_rng(6).random((1, 3, 16, 16, 16)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(port_logits(model, x), net(torch.from_numpy(x)).numpy(), atol=3e-4, rtol=3e-4)


def test_mismatched_checkpoints_raise_naming_a_tensor(tmp_path):
    net = _torch_unet3d(1, 2, 4, 1)
    path = str(tmp_path / "model.pt")
    torch.save(net.state_dict(), path)
    with pytest.raises(ValueError, match=r"mismatch[\s\S]*first unmappable tensor: port '"):
        load_torch_checkpoint(path, UNet3D(out_channels=2, base_features=4, depth=2))
    with pytest.raises(ValueError, match="ConvBlock_0.Conv_0.weight"):
        load_torch_checkpoint(path, UNet3D(out_channels=2, base_features=8, depth=1))
    _, v1 = flax_variables(7, (1, 8, 8, 8, 1), base_features=4, depth=1)
    npz = str(tmp_path / "depth1.npz")
    j_save_checkpoint(npz, v1)
    with pytest.raises(ValueError, match="ConvBlock_3/"):
        load_checkpoint(npz, UNet3D(base_features=4, depth=2))
    with pytest.raises(ValueError, match="ConvBlock_0/Conv_0/kernel"):
        load_checkpoint(npz, UNet3D(base_features=8, depth=1))
    with pytest.raises(ValueError, match="no place"):
        load_checkpoint(npz, UNet3D(base_features=4, depth=1, norm=None))


def test_msgpack_is_refused_naming_item_8b(tmp_path):
    with pytest.raises(NotImplementedError, match="item 8b"):
        load_checkpoint(str(tmp_path / "model.msgpack"), UNet3D())


def test_infer_unet_config_names_offending_tensor():
    with pytest.raises(ValueError, match="lin.weight"):
        infer_unet_config({"lin.weight": torch.zeros(4, 4)})
    with pytest.raises(ValueError, match="census|conv tensors"):
        infer_unet_config({"c1.weight": torch.zeros(4, 1, 3, 3, 3), "c1.bias": torch.zeros(4),
                           "c2.weight": torch.zeros(4, 4, 3, 3, 3), "c2.bias": torch.zeros(4)})


# ---------------------------------------------------------------------------
# the workflow
# ---------------------------------------------------------------------------

SHAPE = (40, 32, 24)
BLOCK = [16, 16, 16]
SIDES = {"jax": (JInferenceWorkflow, j_build, j_reader), "port": (PInferenceWorkflow, p_build, p_reader)}
UNET4 = dict(name="unet3d", base_features=4, depth=2)
# bfloat16 cases run GroupNorm and a sigmoid head: a three-class softmax at
# base 4 differs between the packages by up to 2e-2 in bfloat16 (1.1e-2 to
# 2.0e-2 over three seeds), so the softmax case runs in float32.  float32
# cases run without GroupNorm: XLA's float32 mean over a 32^3 window on the
# CPU is off its float64 value by ~2e-3 (test_float32_groupnorm_block_
# is_close_to_float64 holds the port's instead).
CASES = {
    "sigmoid_minmax": dict(model=dict(UNET4, out_channels=1), out=1, dtype="bfloat16",
                           params=dict(activation="sigmoid")),
    "softmax_percentile": dict(model=dict(UNET4, out_channels=3, dtype="float32", norm=None), out=3,
                               dtype="float32", params=dict(activation="softmax", normalize_percentile=99.0)),
    "logits_range_roi": dict(model=dict(UNET4, out_channels=2, dtype="float32", norm=None), out=2,
                             dtype="float32", params=dict(activation=None, normalize_range=[10.0, 240.0],
                                                          roi_begin=[8, 0, 4], roi_end=[30, 12, 24])),
    # the architecture inferred from a torch checkpoint of the reference's twin
    "auto_torch": dict(model=dict(name="auto"), out=2, dtype="bfloat16",
                       params=dict(activation="sigmoid", normalize_range=[0.0, 255.0])),
}


def _run(side, root, name, ckpt, model, **params):
    wf_cls, build, reader = SIDES[side]
    d = os.path.join(root, f"{name}-{side}")
    os.makedirs(os.path.join(d, "cfg"), exist_ok=True)
    with open(os.path.join(d, "cfg", "global.config"), "w") as f:
        json.dump({"block_shape": BLOCK}, f)
    data = os.path.join(root, f"{side}.zarr")
    wf = wf_cls(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=2, target="local",
                input_path=data, input_key="raw", output_path=data, output_key=name, checkpoint_path=ckpt,
                model=model, halo=[8, 8, 8], block_shape=BLOCK,
                **params)
    assert build([wf]), side
    return np.asarray(reader(data)[name][...]), os.path.join(d, "tmp")


@pytest.fixture(scope="module")
def workflow_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("inference"))
    raw = (np.random.default_rng(8).random(SHAPE) * 255).astype(np.uint8)
    for side in SIDES:
        SIDES[side][2](os.path.join(root, f"{side}.zarr")).require_dataset(
            "raw", shape=SHAPE, chunks=(16, 16, 16), dtype="uint8")[...] = raw
    out = {}
    for i, (name, case) in enumerate(sorted(CASES.items())):
        if case["model"]["name"] == "auto":
            gen_state = torch.random.get_rng_state()
            torch.manual_seed(2)
            net = _torch_unet3d(1, case["out"], 4, 1)
            torch.random.set_rng_state(gen_state)
            ckpt = os.path.join(root, f"{name}.pt")
            torch.save(net.state_dict(), ckpt)
        else:
            kw = {k: v for k, v in case["model"].items() if k != "name"}
            _, variables = flax_variables(10 + i, (1, 16, 16, 16, 1), perturbed=case["dtype"] == "float32", **kw)
            ckpt = os.path.join(root, f"{name}.npz")
            j_save_checkpoint(ckpt, variables)
        out[name] = {side: _run(side, root, name, ckpt, case["model"], **case["params"]) for side in SIDES}
    return root, out


@pytest.mark.parametrize("name", sorted(CASES))
def test_inference_workflow_matches_jax(workflow_runs, name):
    _, runs = workflow_runs
    (want, _), (got, _) = runs[name]["jax"], runs[name]["port"]
    case = CASES[name]
    assert got.shape == want.shape == (case["out"],) + SHAPE
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL[case["dtype"]])
    if case["params"]["activation"] == "softmax":
        np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-5)
    if "roi_begin" in case["params"]:
        # blocks outside the ROI are never written
        assert not got[:, 32:].any() and not got[:, :, 16:].any()
        assert (got[:, :32, :16] != 0).all()


def test_float32_groupnorm_block_is_close_to_float64():
    """A zero-padded edge block of the workflow through a float32 GroupNorm
    U-Net: the port's forward is within atol/rtol 2e-4 of the same network
    in float64.  (The reference's flax forward on the CPU is not: XLA sums
    GroupNorm's float32 means over 3.3e4 voxels in one running sum, ~2e-3
    off, which is why the workflow's float32 case runs ``norm=None``.)"""
    kw = dict(base_features=4, depth=2, out_channels=2)
    _, variables = flax_variables(10, (1, 16, 16, 16, 1), **kw)
    raw = (np.random.default_rng(8).random((24, 24, 24)) * 255).astype(np.uint8)
    x = np.pad((raw.astype(np.float32) - 10.0) / 230.0, [(0, 8)] * 3)[None, None]
    got = port_logits(port_model(variables, dtype=torch.float32, **kw), x)
    exact = port_model(variables, dtype=torch.float64, **kw).double()
    with torch.no_grad():
        want = exact(torch.from_numpy(x).double()).numpy()
    np.testing.assert_allclose(got, want, **TOL["float32"])


def test_inference_resume_behaves_alike(workflow_runs):
    """A finished workflow is skipped; with the success manifests gone and
    the markers of odd blocks removed, only those blocks run again, on both
    sides."""
    root, runs = workflow_runs
    name = "sigmoid_minmax"
    case = CASES[name]
    kept = {}
    for side in SIDES:
        first, tmp = runs[name][side]
        data = SIDES[side][2](os.path.join(root, f"{side}.zarr"))
        data[name][...] = np.full(first.shape, -1.0, np.float32)
        again, _ = _run(side, root, name, os.path.join(root, f"{name}.npz"), case["model"], **case["params"])
        assert (again == -1.0).all(), side  # the success manifest holds: nothing ran
        for f in glob.glob(os.path.join(tmp, "*.success.json")):
            os.remove(f)
        markers = sorted(glob.glob(os.path.join(tmp, "markers", "*", "block_*.json")))
        assert len(markers) == 12, side
        for m in markers:
            if int(os.path.basename(m)[len("block_"):-len(".json")]) % 2:
                os.remove(m)
        resumed, _ = _run(side, root, name, os.path.join(root, f"{name}.npz"), case["model"], **case["params"])
        kept[side] = resumed == -1.0
        np.testing.assert_array_equal(resumed[~kept[side]], first[~kept[side]])
    np.testing.assert_array_equal(kept["port"], kept["jax"])
    assert 0 < kept["port"].mean() < 1
