"""The sharded global solves through the workflows: the JAX package's and
the port's ``MulticutSegmentationWorkflow`` (``skip_ws``, ``gaec_parallel``)
and ``AgglomerativeClusteringWorkflow`` with ``solver_shards=4`` on the
CPU (``target="local"``), on the volumes of ``tests/test_torch_workflow_mc.py``
(``make_case``'s 16^3 supervoxels, and the reference's watershed of the
seeded 32^3 boundary map, written into both containers).

As in that file, the port is fed the reference's ``graph/costs.npy``
(multicut) or ``graph/features.npy`` (agglomeration), so the solves see the
same float inputs; the assignment tables, the written segmentations, the
solver manifests' tree blocks and the reduce-tree counters in
``io_metrics.json`` must then be equal.  Both packages run their
Python solver paths (each one's ``native.force_python``); the watershed
modes are pinned.
"""

import json
import os
import shutil

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import cluster_tools_tpu.native as native
import cluster_tools_tpu_torch.native as pnative
from cluster_tools_tpu.runtime.task import build as j_build
from cluster_tools_tpu.tasks.watershed import WatershedWorkflow as JWS
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
from cluster_tools_tpu.workflows import AgglomerativeClusteringWorkflow as JAC
from cluster_tools_tpu.workflows import MulticutSegmentationWorkflow as JMC
from cluster_tools_tpu_torch import workflows as pwf
from cluster_tools_tpu_torch.runtime.task import build as p_build
from cluster_tools_tpu_torch.utils.volume_utils import file_reader as p_reader

from .test_multicut_workflow import make_case

torch.set_num_threads(1)

SIDES = {
    "jax": dict(mc=JMC, ac=JAC, build=j_build, reader=j_reader),
    "port": dict(mc=pwf.MulticutSegmentationWorkflow, ac=pwf.AgglomerativeClusteringWorkflow, build=p_build,
                 reader=p_reader),
}
AC_IMPL = {"jax": "numpy", "port": "numpy"}
SHARDS = 4

CASES = {
    # name: (boundary key, supervoxel key, n_scales, block)
    "sv16_n0": ("bmap16", "sv16", 0, 8),
    "ws32_n0": ("bmap32", "ws32", 0, 16),
    "ws32_n1": ("bmap32", "ws32", 1, 16),
}

#: the reduce-tree counters both packages record (timings excluded)
TREE_COUNTERS = ("sharded_solves", "unsharded_fallbacks", "solve_shards", "solve_levels", "tree_rounds",
                 "boundary_edges_in", "boundary_edges_out", "collective_hops", "packet_fallbacks",
                 "contraction_dispatches", "solver_calls", "solver_rounds", "solver_edges_in", "solver_edges_out")


@pytest.fixture(scope="module", autouse=True)
def _pin_modes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CT_TIER_MODE", "cond")
        mp.setenv("CT_FILL_MODE", "capacity")
        mp.setenv("CT_SEED_CCL", "tiled")
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("reduce_tasks"))
    _, sv, bmap16 = make_case()
    x = ndi.gaussian_filter(np.random.default_rng(0).random((32, 32, 32)), 2.0)
    bmap32 = ((x - x.min()) / (x.max() - x.min())).astype(np.float32)
    for side, s in SIDES.items():
        f = s["reader"](os.path.join(root, f"{side}.zarr"))
        for key, data, chunks in (("bmap16", bmap16, (8, 8, 8)), ("sv16", sv, (8, 8, 8)),
                                  ("bmap32", bmap32, (16, 16, 16))):
            f.require_dataset(key, shape=data.shape, chunks=chunks, dtype=str(data.dtype))[...] = data
    # one watershed (the reference's) feeds both sides' solves
    d = os.path.join(root, "ws32")
    os.makedirs(os.path.join(d, "cfg"))
    path = os.path.join(root, "jax.zarr")
    assert j_build([JWS(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=2,
                        target="local", input_path=path, input_key="bmap32", output_path=path, output_key="ws32",
                        block_shape=[16] * 3, halo=[4, 4, 4], threshold=0.5)])
    ws = np.asarray(j_reader(path)["ws32"][:])
    p_reader(os.path.join(root, "port.zarr")).require_dataset("ws32", shape=ws.shape, chunks=(16, 16, 16),
                                                              dtype=str(ws.dtype))[...] = ws
    assert len(np.unique(ws)) > 50
    return root


def _find(task, cls_name):
    if type(task).__name__ == cls_name:
        return task
    for dep in task.requires():
        hit = _find(dep, cls_name)
        if hit is not None:
            return hit
    return None


def run(root, side, kind, case, feed=None):
    """One sharded workflow of ``kind`` ("mc" or "ac") on ``side``; with
    ``feed`` (the reference's run directory) the port builds the chain up
    to the solver's input, takes the reference's artifact, then builds the
    rest."""
    bkey, svkey, n_scales, block = CASES[case]
    tag = f"{kind}-{case}-{side}"
    d = os.path.join(root, tag)
    os.makedirs(os.path.join(d, "cfg"))
    with open(os.path.join(d, "cfg", "global.config"), "w") as f:
        json.dump({"block_shape": [block] * 3}, f)
    with open(os.path.join(d, "cfg", "agglomerative_clustering.config"), "w") as f:
        json.dump({"impl": AC_IMPL[side], "solver_shards": SHARDS}, f)
    s = SIDES[side]
    path = os.path.join(root, f"{side}.zarr")
    params = dict(input_path=path, input_key=bkey, ws_path=path, ws_key=svkey, skip_ws=True, output_path=path,
                  output_key=tag, block_shape=[block] * 3)
    if kind == "mc":
        params.update(beta=0.5, n_scales=n_scales, agglomerator="gaec_parallel", solver_shards=SHARDS)
    wf = s[kind](tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=2, target="local",
                 **params)
    if feed is not None:
        artifact, producer = ("costs.npy", "ProbsToCostsLocal") if kind == "mc" else \
            ("features.npy", "EdgeFeaturesWorkflow")
        assert s["build"]([_find(wf, producer)])
        shutil.copy(os.path.join(feed, "tmp", "graph", artifact), os.path.join(d, "tmp", "graph", artifact))
    if side == "jax":
        with native.force_python():
            assert s["build"]([wf]), tag
    else:
        with pnative.force_python():
            assert s["build"]([wf]), tag
    return d


def _manifest(d, prefix):
    tmp = os.path.join(d, "tmp")
    docs = [json.load(open(os.path.join(tmp, f))) for f in os.listdir(tmp)
            if f.split(".")[0] == prefix and f.endswith(".success.json")]
    assert len(docs) == 1, prefix
    return docs[0]


def _tree_block(solver):
    """The solver manifest without its wall-clock fields."""
    out = {k: v for k, v in solver.items() if k != "levels"}
    out["levels"] = [{k: v for k, v in lv.items() if k not in ("solve_s", "merge_s")} for lv in solver["levels"]]
    return out


def _counters(d, prefix):
    with open(os.path.join(d, "tmp", "io_metrics.json")) as f:
        tasks = json.load(f)["tasks"]
    (m,) = [m for uid, m in tasks.items() if uid.split(".")[0] == prefix]
    return {k: int(m.get(k, 0)) for k in TREE_COUNTERS}


def _check(root, kind, case, table, task_prefix):
    dj = run(root, "jax", kind, case)
    dp = run(root, "port", kind, case, feed=dj)
    for name in ("keys", "values"):
        a, b = (np.load(os.path.join(d, "tmp", table))[name] for d in (dj, dp))
        assert a.dtype == b.dtype == np.uint64
        np.testing.assert_array_equal(b, a)
    segs = [np.asarray(SIDES[side]["reader"](os.path.join(root, f"{side}.zarr"))[os.path.basename(d)][:])
            for side, d in (("jax", dj), ("port", dp))]
    np.testing.assert_array_equal(segs[1], segs[0])
    sj, sp = (_manifest(d, task_prefix)["solver"] for d in (dj, dp))
    assert sp["sharded"] is True and sp["shards"] == SHARDS and sp["reduce_plane"] == "host"
    assert _tree_block(sp) == _tree_block(sj)
    assert _counters(dp, task_prefix) == _counters(dj, task_prefix)
    assert _counters(dp, task_prefix)["sharded_solves"] == 1
    return segs[1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_multicut_equals_the_reference(root, case):
    seg = _check(root, "mc", case, os.path.join("multicut", "mc_assignments.npz"), "solve_global")
    assert len(np.unique(seg)) > 1


def test_sharded_agglomerative_clustering_equals_the_reference(root):
    seg = _check(root, "ac", "ws32_n0", "agglomerative_assignments.npz", "agglomerative_clustering")
    assert 1 < len(np.unique(seg)) < len(np.unique(np.asarray(p_reader(os.path.join(root, "port.zarr"))["ws32"][:])))
