"""The port's workflows read from its zarr and from its N5 on disk, with the
chunk cache off (``CTT_CHUNK_CACHE=0``) and on, against each other and
against the JAX package's run on the same input (``target="local"``).

One seeded 64^3 boundary map, blocks and chunks of 32^3, halo 8.  This
file: the single-pass watershed and connected components, whose files
equal the reference's bit for bit in all four arms, and the watershed
task's counters: with the cache on they are the sweep's chunk cover (one
miss a distinct chunk, the rest hits or coalesced waits, no direct read),
with it off one direct read a block and no hit.  The two-pass watershed
and the multicut chain run in ``test_torch_workflow_io_ws2.py`` and
``test_torch_workflow_io_mc.py`` (one file each keeps every file within
a minute here), on this file's fixtures.  The mode env is pinned on both
sides; the reference solves in Python.
"""

import itertools
import json
import os

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import cluster_tools_tpu.native as native
import cluster_tools_tpu_torch.native as pnative
from cluster_tools_tpu.runtime.task import build as j_build
from cluster_tools_tpu.tasks.connected_components import ConnectedComponentsWorkflow as JCC
from cluster_tools_tpu.tasks.watershed import WatershedWorkflow as JWS
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
from cluster_tools_tpu.workflows import MulticutSegmentationWorkflow as JMC
from cluster_tools_tpu_torch import workflows as pwf
from cluster_tools_tpu_torch.io import chunk_cache
from cluster_tools_tpu_torch.runtime.task import build as p_build
from cluster_tools_tpu_torch.tasks.connected_components import ConnectedComponentsWorkflow as PCC
from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow as PWS
from cluster_tools_tpu_torch.utils.volume_utils import Blocking
from cluster_tools_tpu_torch.utils.volume_utils import file_reader as p_reader


torch.set_num_threads(1)

SHAPE = (64, 64, 64)
BLOCK = [32, 32, 32]
HALO = [8, 8, 8]
# port runs: (container format, cache on)
ARMS = [("zarr", False), ("zarr", True), ("n5", False), ("n5", True)]


@pytest.fixture(scope="module", autouse=True)
def _pin_modes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CT_TIER_MODE", "cond")
        mp.setenv("CT_FILL_MODE", "capacity")
        mp.setenv("CT_SEED_CCL", "tiled")
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wfio"))
    x = ndi.gaussian_filter(np.random.default_rng(5).random(SHAPE), 2.0)
    bmap = ((x - x.min()) / (x.max() - x.min())).astype(np.float32)
    for reader, name in ((j_reader, "jax.zarr"), (p_reader, "port.zarr"), (p_reader, "port.n5")):
        reader(os.path.join(root, name)).require_dataset("bmap", shape=SHAPE, chunks=tuple(BLOCK),
                                                         dtype="float32")[...] = bmap
    return root


def _workflow(kind, cls, d, path, tag):
    common = dict(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=2, target="local",
                  input_path=path, input_key="bmap", output_path=path, output_key=tag, block_shape=BLOCK)
    if kind == "cc":
        return cls(threshold=0.5, **common)
    if kind == "mc":
        return cls(ws_path=path, ws_key=f"ws_{tag}", halo=HALO, threshold=0.5, n_scales=1, beta=0.5, **common)
    return cls(halo=HALO, threshold=0.5, two_pass=kind == "ws2", **common)


def _run(root, kind, side, fmt="zarr", cache_on=True):
    """One workflow; returns its run directory, its output key and its
    container."""
    tag = f"{kind}-{side}-{fmt}-{'on' if cache_on else 'off'}"
    d = os.path.join(root, tag)
    os.makedirs(os.path.join(d, "cfg"))
    with open(os.path.join(d, "cfg", "global.config"), "w") as f:
        json.dump({"block_shape": BLOCK}, f)
    path = os.path.join(root, f"{side}.{fmt}")
    if side == "jax":
        cls = {"ws": JWS, "ws2": JWS, "cc": JCC, "mc": JMC}[kind]
        with native.force_python():
            assert j_build([_workflow(kind, cls, d, path, tag)]), tag
        return d, tag, path
    cls = {"ws": PWS, "ws2": PWS, "cc": PCC, "mc": pwf.MulticutSegmentationWorkflow}[kind]
    chunk_cache.configure()
    with pytest.MonkeyPatch.context() as mp, pnative.force_python():
        mp.setenv("CTT_CHUNK_CACHE", "1" if cache_on else "0")
        assert p_build([_workflow(kind, cls, d, path, tag)]), tag
    return d, tag, path


def all_runs(root, kinds):
    """``{kind: {"jax": run, (fmt, cache_on): run}}``."""
    return {kind: {"jax": _run(root, kind, "jax"), **{arm: _run(root, kind, "port", *arm) for arm in ARMS}}
            for kind in kinds}


@pytest.fixture(scope="module")
def runs(root):
    return all_runs(root, ("ws", "cc"))


def _read(run, key=None):
    d, tag, path = run
    reader = j_reader if path.endswith("jax.zarr") else p_reader
    return np.asarray(reader(path)[key or tag][...])


def assert_files_equal(runs, kind):
    want = _read(runs[kind]["jax"])
    assert want.dtype == np.uint64 and len(np.unique(want)) > 8
    for arm in ARMS:
        np.testing.assert_array_equal(_read(runs[kind][arm]), want, err_msg=str(arm))


@pytest.mark.parametrize("kind", ["ws", "cc"])
def test_files_equal_across_formats_cache_and_reference(runs, kind):
    assert_files_equal(runs, kind)


def _sweep_cover():
    """``(chunk reads, distinct chunks, distinct chunk bytes, blocks)`` of
    one watershed sweep's outer reads over the 32^3 chunk grid."""
    blocking = Blocking(SHAPE, BLOCK)
    steps = []
    for b in range(blocking.n_blocks):
        blk = blocking.get_block(b, HALO)
        ranges = [range(lo // c, (hi - 1) // c + 1) for lo, hi, c in zip(blk.outer_begin, blk.outer_end, BLOCK)]
        steps += list(itertools.product(*ranges))
    distinct = set(steps)
    nbytes = sum(int(np.prod([min(c, s - i * c) for i, c, s in zip(idx, BLOCK, SHAPE)])) * 4 for idx in distinct)
    return len(steps), len(distinct), nbytes, blocking.n_blocks


@pytest.mark.parametrize("fmt", ["zarr", "n5"])
def test_watershed_task_counters_are_the_chunk_cover(runs, fmt):
    n_steps, n_distinct, nbytes, n_blocks = _sweep_cover()
    assert (n_steps, n_distinct) == (64, 8)
    metrics = {}
    for on in (False, True):
        d = runs["ws"][(fmt, on)][0]
        with open(os.path.join(d, "tmp", "io_metrics.json")) as f:
            tasks = json.load(f)["tasks"]
        metrics[on] = next(m for uid, m in tasks.items() if uid.startswith("watershed."))
    on, off = metrics[True], metrics[False]
    assert on["misses"] == n_distinct and on["bytes_from_storage"] == nbytes
    assert on["hits"] + on["coalesced"] == n_steps - n_distinct
    assert on.get("direct_reads", 0) == 0 and on.get("stall_fallbacks", 0) == 0
    assert off["direct_reads"] == n_blocks and off.get("hits", 0) == 0 and off.get("misses", 0) == 0
