"""The port's ``FusedSegmentationWorkflow`` / ``FusedSegmentationLocal``
(``cluster_tools_tpu_torch/tasks/fused.py``) against the JAX package's on
the CPU: the reference on its 8 virtual CPU devices, the port on 8 CPU
shards (``CTT_MESH_SHARDS=8``, the counterpart of the reference's device
count), ``slab`` and ``grid`` decompositions, ``fused`` and ``split``
execution.  The ws and cc datasets are compared bit for bit, and so are the
manifests (``n_foreground``, ``written``, ``mesh``); the resume case
(``tests/test_connected_components_workflow.py:225-241``) and the overflow
refusal too.  The mode variables are pinned on both sides.  The grid
cases live in ``tests/test_torch_fused_grid.py`` (each JAX step compiles
for seconds, so the two files share the work under xdist)."""

import json
import os

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from cluster_tools_tpu.runtime.task import build as j_build
from cluster_tools_tpu.tasks.fused import FusedSegmentationLocal as JFused
from cluster_tools_tpu.tasks.fused import FusedSegmentationWorkflow as JFusedWF
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
from cluster_tools_tpu_torch.parallel.mesh import visible_shards
from cluster_tools_tpu_torch.runtime.task import build as p_build
from cluster_tools_tpu_torch.tasks.fused import FusedSegmentationLocal as PFused
from cluster_tools_tpu_torch.tasks.fused import FusedSegmentationWorkflow as PFusedWF
from cluster_tools_tpu_torch.utils.volume_utils import file_reader as p_reader

torch.set_num_threads(1)

SIDES = {"jax": dict(task=JFused, wf=JFusedWF, build=j_build, reader=j_reader),
         "port": dict(task=PFused, wf=PFusedWF, build=p_build, reader=p_reader)}


@pytest.fixture(scope="module", autouse=True)
def _pin():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CT_TIER_MODE", "cond")
        mp.setenv("CT_FILL_MODE", "capacity")
        mp.setenv("CT_SEED_CCL", "tiled")
        mp.setenv("CTT_MESH_SHARDS", "8")
        yield


def _vol(shape, seed):
    v = ndi.gaussian_filter(np.random.default_rng(seed).random(shape).astype(np.float32), 2)
    return (v - v.min()) / (v.max() - v.min())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fused"))
    for side, s in SIDES.items():
        f = s["reader"](os.path.join(root, f"{side}.zarr"))
        for key, vol, chunks in (("slab", _vol((64, 32, 32), 0), (32, 32, 32)),
                                 ("grid", _vol((32, 32, 32), 1), (16, 16, 16))):
            f.require_dataset(key, shape=vol.shape, chunks=chunks, dtype="float32")[...] = vol
    return root


CASES = {
    # name: (input key, block shape, params)
    "slab": ("slab", [32, 32, 32], dict(threshold=0.6, halo=4, stitch_ws_threshold=0.6)),
    "grid": ("grid", [16, 16, 16], dict(threshold=0.6, halo=2, decomposition="grid")),
}


def _run(root, side, case, execution, cls="task", **over):
    key, block, params = CASES[case]
    tag = f"{case}-{execution}-{cls}-{side}" + "".join(f"-{k}" for k in over)
    d = os.path.join(root, tag)
    os.makedirs(os.path.join(d, "cfg"), exist_ok=True)
    with open(os.path.join(d, "cfg", "global.config"), "w") as f:
        json.dump({"block_shape": block}, f)
    s = SIDES[side]
    path = os.path.join(root, f"{side}.zarr")
    kw = dict(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), input_path=path, input_key=key,
              output_path=path, ws_key=f"ws-{tag}", cc_key=f"cc-{tag}", block_shape=block, execution=execution,
              **params)
    kw.update(over)
    if cls == "wf":
        task = s["wf"](target="local", max_jobs=2, **kw)
    else:
        task = s["task"](max_jobs=2, **kw)
    ok = s["build"]([task])
    return ok, task, path, tag


def _read(side, path, key):
    return np.asarray(SIDES[side]["reader"](path, "r")[key][...])


def test_visible_shards_is_the_mesh_seam():
    assert visible_shards("cpu") == 8


def check_equals_the_reference(root, case, execution):
    docs, outs = {}, {}
    for side in ("jax", "port"):
        ok, task, path, tag = _run(root, side, case, execution)
        assert ok, side
        docs[side] = task.output().read()
        outs[side] = {k: _read(side, path, f"{k}-{tag}") for k in ("ws", "cc")}
    for k in ("ws", "cc"):
        assert outs["port"][k].dtype == outs["jax"][k].dtype == np.uint64
        np.testing.assert_array_equal(outs["port"][k], outs["jax"][k], err_msg=k)
    for k in ("n_foreground", "mesh"):
        assert docs["port"][k] == docs["jax"][k], k
    assert {k.split("-")[0]: v for k, v in docs["port"]["written"].items()} == \
        {k.split("-")[0]: v for k, v in docs["jax"]["written"].items()}
    vol = _read("port", os.path.join(root, "port.zarr"), CASES[case][0])
    assert docs["port"]["n_foreground"] == int((vol < 0.6).sum())
    assert docs["port"]["mesh"] == ("sp=8" if case == "slab" else "spz=4 spy=2")


@pytest.mark.parametrize("execution", ["fused", "split"])
def test_fused_task_equals_the_reference(root, execution):
    check_equals_the_reference(root, "slab", execution)


def test_fused_workflow_surfaces_the_inner_summary(root):
    """The workflow's manifest carries the inner task's summary (the
    reference's ``tests/test_handoff.py:681`` case)."""
    ok, task, path, _tag = _run(root, "port", "slab", "fused", cls="wf", cc_key=None)
    assert ok
    doc = task.output().read()
    assert set(doc) >= {"n_foreground", "written", "mesh"}
    assert [k.split("-")[0] for k in doc["written"]] == ["ws"]
    assert doc["n_foreground"] == int((_read("port", path, "slab") < 0.6).sum())


def test_fused_task_refuses_an_overflow(root):
    ok, task, _path, _tag = _run(root, "port", "slab", "fused", max_labels_per_shard=4)
    assert not ok
    with pytest.raises(RuntimeError, match="overflowed a label capacity"):
        task.run()
