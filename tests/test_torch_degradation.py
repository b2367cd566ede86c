"""Graceful degradation in the port (``runtime/executor.py``): typed
resource errors, ``split_block``, the degrade ladder (headroom wait,
degrade-and-split to ``min_block_shape``), the drain latch in a sweep, the
hardened sharded watershed sweep and a split inference sweep.

- ``classify_resource_error``, ``split_block`` and ``is_sub_block`` equal
  the JAX package's on the cases of ``tests/test_degradation.py:57-225``
  and more geometries.
- The degrade ladder: the cases of ``tests/test_degradation.py:227-360``
  run through both packages' ``map_blocks`` (``x + 1`` over a 2-block
  halo'd volume, one device); the outputs equal ``data + 1`` and the
  ``failures.json`` records (block, sites, quarantined, resolved,
  resolution, split depth) and the split counters are equal.
- Drain: a sweep stops claiming batches, raises ``DrainInterrupt``, and the
  resumed run completes to the same output.
- The sharded watershed (4x4x4 blocks of 16^3, 8 blocks a call) under a
  kernel NaN, an ``io_write`` flip and a ``dispatch`` OOM equals its
  fault-free run bit for bit, each fault attributed.
- ``InferenceWorkflow`` (float32 U-Net, depth 1, blocks of 32^3, halo 12
  covering its receptive radius of 8) with ``allow_block_split`` under a
  full-block ``compute`` OOM: split into sub-blocks and equal to its
  unsplit run within the reference tests' float32 tolerance (atol/rtol
  2e-4).  The blocks lie in an ROI whose halos hold data: a block clipped
  at the volume's far end is zero-padded to the kernel shape, a sub-block
  to its own, and within the receptive radius of that end the two differ
  (in both packages), which is no fault of the split.
"""

import errno
import json
import os

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from cluster_tools_tpu.runtime import executor as jex
from cluster_tools_tpu.runtime import faults as jfaults
from cluster_tools_tpu.utils.volume_utils import Blocking as JBlocking
from cluster_tools_tpu_torch.runtime import executor as pex
from cluster_tools_tpu_torch.runtime import faults as pfaults
from cluster_tools_tpu_torch.runtime import supervision as sup
from cluster_tools_tpu_torch.runtime.task import build
from cluster_tools_tpu_torch.tasks.inference import InferenceWorkflow
from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow
from cluster_tools_tpu_torch.utils import function_utils as fu
from cluster_tools_tpu_torch.utils.volume_utils import Blocking as PBlocking
from cluster_tools_tpu_torch.utils.volume_utils import file_reader

torch.set_num_threads(1)

SIDES = {"jax": (jfaults, jex, JBlocking), "port": (pfaults, pex, PBlocking)}


@pytest.fixture(autouse=True)
def _clean():
    for f in (jfaults, pfaults):
        f.reset()
    sup.reset_drain()
    yield
    for f in (jfaults, pfaults):
        f.reset()
    sup.reset_drain()


# -- resource errors and split geometry --------------------------------------------


def _chained():
    try:
        try:
            raise MemoryError("inner allocation")
        except MemoryError as inner:
            raise RuntimeError("store failed") from inner
    except RuntimeError as wrapped:
        return wrapped


ERRORS = [MemoryError("boom"), OSError(errno.ENOSPC, "full"), OSError(errno.EDQUOT, "quota"),
          OSError(errno.EIO, "io"), ValueError("nope"), RuntimeError("harmless"),
          RuntimeError("RESOURCE_EXHAUSTED: out of memory"), KeyError("RESOURCE_EXHAUSTED in passing"),
          jfaults.InjectedOOM("load", 0, 1), jfaults.InjectedENOSPC("store", 2, 1), _chained()]


@pytest.mark.parametrize("err", ERRORS, ids=lambda e: type(e).__name__ + ":" + str(e)[:20])
def test_classify_resource_error_equals_the_reference(err):
    assert pex.classify_resource_error(err) == jex.classify_resource_error(err)


def test_classify_torch_out_of_memory():
    assert pex.classify_resource_error(torch.OutOfMemoryError("CUDA out of memory")) == "oom"
    assert pex.classify_resource_error(pfaults.InjectedOOM("compute", 1, 1)) == "oom"
    assert pex.classify_resource_error(pfaults.InjectedENOSPC("io_write", 1, 1)) == "enospc"


SPLITS = [
    # (volume, block, halo, split halo, min shape)
    ((16, 16, 16), (16, 16, 16), (2, 2, 2), (2, 2, 2), (8, 8, 8)),
    ((16, 16, 16), (16, 16, 16), (2, 2, 2), None, (8, 8, 8)),
    ((16, 16, 16), (16, 16, 16), (2, 2, 2), (2, 2, 2), (16, 8, 8)),
    ((40, 24, 16), (16, 16, 16), (4, 4, 4), None, (2, 2, 2)),
    ((40, 24, 16), (16, 16, 16), (4, 4, 4), (3, 1, 0), (5, 5, 5)),
    ((9, 30), (9, 16), (1, 2), None, None),
    ((8, 8, 8), (8, 8, 8), (0, 0, 0), None, (8, 8, 8)),
]


def _geom(b):
    return (int(b.block_id), tuple(b.begin), tuple(b.end), tuple(b.outer_begin), tuple(b.outer_end))


@pytest.mark.parametrize("shape,block,halo,split_halo,min_shape", SPLITS)
def test_split_block_equals_the_reference(shape, block, halo, split_halo, min_shape):
    pb, jb = PBlocking(shape, block), JBlocking(shape, block)
    for bid in range(pb.n_blocks):
        got = pex.split_block(pb.get_block(bid, list(halo)), halo=split_halo, min_shape=min_shape)
        want = jex.split_block(jb.get_block(bid, list(halo)), halo=split_halo, min_shape=min_shape)
        if want is None:
            assert got is None
            continue
        assert [_geom(s) for s in got] == [_geom(s) for s in want]
        assert all(pex.is_sub_block(s) for s in got) and not pex.is_sub_block(pb.get_block(bid))
        # the sub-blocks tile the parent's inner region, once each, recursively
        cover = np.zeros(shape, int)
        for s in got:
            cover[s.bb] += 1
        assert cover[pb.get_block(bid).bb].min() == 1 == cover.max()


# -- the degrade ladder against the reference ---------------------------------------------


def _run_degrade(side, spec, fp, splittable=False, **kw):
    fmod, exmod, blocking_cls = SIDES[side]
    if spec is not None:
        fmod.configure(spec)
    shape, bshape = (32, 8, 8), (16, 8, 8)
    data = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    out = np.zeros(shape, np.float32)
    blocking = blocking_cls(shape, bshape)
    blocks = [blocking.get_block(i, halo=[2, 2, 2]) for i in range(blocking.n_blocks)]
    ex_kw = {"n_devices": 1} if side == "jax" else {}
    ex = exmod.BlockwiseExecutor(target="local", backoff_base=1e-4, **ex_kw)
    try:
        summary = ex.map_blocks(lambda x: x + 1, blocks, lambda b: (data[b.outer_bb],),
                                lambda b, raw: out.__setitem__(b.bb, np.asarray(raw)[b.inner_in_outer_bb]),
                                failures_path=fp, task_name="unit", splittable=splittable, split_halo=(2, 2, 2),
                                min_block_shape=(2, 2, 2), degrade_wait_s=0.05, **kw)
    finally:
        fmod.reset()
    return out, data, summary


def _records(fp):
    try:
        recs = json.load(open(fp))["records"]
    except FileNotFoundError:
        return []
    return sorted((r["block_id"], sorted(r["sites"].items()), r["quarantined"], r["resolved"], r.get("resolution"),
                   r.get("split_depth"), r.get("resource")) for r in recs)


LADDER = [
    ("load_oom_transient", {"faults": [{"site": "load", "kind": "oom", "blocks": [1], "fail_attempts": 1}]}, False),
    ("split_depth_1", {"faults": [{"site": "load", "kind": "oom", "min_voxels": 1000, "fail_attempts": 10 ** 6}]},
     True),
    ("split_recursive", {"faults": [{"site": "load", "kind": "oom", "min_voxels": 300, "fail_attempts": 10 ** 6}]},
     True),
    ("store_enospc_transient", {"faults": [{"site": "store", "kind": "enospc", "blocks": [0],
                                            "fail_attempts": 1}]}, False),
    ("store_enospc_split", {"faults": [{"site": "store", "kind": "enospc", "min_voxels": 1000,
                                        "fail_attempts": 10 ** 6}]}, True),
    ("compute_oom_transient", {"faults": [{"site": "compute", "kind": "oom", "blocks": [1], "fail_attempts": 1}]},
     False),
    ("compute_oom_split", {"faults": [{"site": "compute", "kind": "oom", "min_voxels": 1000,
                                       "fail_attempts": 10 ** 6}]}, True),
    ("no_fault_budget_1", None, False),
]


@pytest.mark.parametrize("tag,spec,splittable", LADDER, ids=[c[0] for c in LADDER])
def test_degrade_ladder_equals_the_reference(tmp_path, tag, spec, splittable):
    got = {}
    for side in SIDES:
        fp = str(tmp_path / f"{side}.json")
        kw = {"inflight_byte_budget": 1} if spec is None else {}
        out, data, summary = _run_degrade(side, spec, fp, splittable, **kw)
        np.testing.assert_array_equal(out, data + 1)
        got[side] = (_records(fp), {k: summary.get(k, 0) for k in ("n_split", "n_sub_blocks", "split_depth",
                                                                     "n_degraded", "n_quarantined")})
    assert got["port"] == got["jax"]
    if splittable:
        assert got["port"][1]["n_split"] >= 2 and all(r[4] == "degraded:split" for r in got["port"][0])
    elif spec is not None:
        assert got["port"][0] and all(r[4] == "degraded:backpressure" for r in got["port"][0])


@pytest.mark.parametrize("tag,spec", [
    ("not_splittable", {"faults": [{"site": "load", "kind": "oom", "min_voxels": 1000, "fail_attempts": 10 ** 6}]}),
    ("below_the_floor", {"faults": [{"site": "load", "kind": "oom", "min_voxels": 100, "fail_attempts": 10 ** 6}]}),
])
def test_persistent_exhaustion_fails_attributed_as_the_reference(tmp_path, tag, spec):
    got = {}
    for side in SIDES:
        fp = str(tmp_path / f"{side}.json")
        with pytest.raises(RuntimeError, match="failed"):
            _run_degrade(side, spec, fp, splittable=tag == "below_the_floor")
        got[side] = _records(fp)
        errors = [r.get("error") or "" for r in json.load(open(fp))["records"]]
        if tag == "below_the_floor":
            assert any("cannot split further" in e for e in errors)
    assert got["port"] == got["jax"] and all(not r[3] for r in got["port"] if r[0] is not None)


# -- drain ---------------------------------------------------------------------------------


def test_executor_drain_finishes_inflight_and_resumes(tmp_path):
    fp = str(tmp_path / "failures.json")
    shape, bshape = (512, 8, 8), (8, 8, 8)
    data = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    out = np.zeros(shape, np.float32)
    blocks = [PBlocking(shape, bshape).get_block(i) for i in range(64)]
    done_ids = []

    def on_done(b):
        done_ids.append(int(b.block_id))
        if len(done_ids) == 1:
            sup.request_drain("test preemption")

    ex = pex.BlockwiseExecutor(target="local", backoff_base=1e-4, io_threads=1)
    with pytest.raises(sup.DrainInterrupt) as exc:
        ex.map_blocks(lambda x: x + 1, blocks, lambda b: (data[b.bb],),
                      lambda b, raw: out.__setitem__(b.bb, np.asarray(raw)), on_block_done=on_done,
                      failures_path=fp, task_name="unit", sweep_mode="per_block")
    assert exc.value.remaining_ids and set(exc.value.remaining_ids).isdisjoint(done_ids)
    rec = [r for r in json.load(open(fp))["records"] if r.get("resolution") == "requeued:preempt"]
    assert rec and rec[0]["sites"] == {"preempt": 1} and rec[0]["task"] == "unit.drain"
    sup.reset_drain()
    ex.map_blocks(lambda x: x + 1, blocks, lambda b: (data[b.bb],),
                  lambda b, raw: out.__setitem__(b.bb, np.asarray(raw)), done_block_ids=done_ids, task_name="unit")
    np.testing.assert_array_equal(out, data + 1)


# -- the hardened sharded watershed sweep -------------------------------------------------------

SHAPE = (64, 64, 64)
BLOCK = [16, 16, 16]


@pytest.fixture(scope="module")
def ws_root(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CT_TIER_MODE", "cond")
        mp.setenv("CT_FILL_MODE", "capacity")
        mp.setenv("CT_SEED_CCL", "tiled")
        root = str(tmp_path_factory.mktemp("ws_sharded"))
        x = ndi.gaussian_filter(np.random.default_rng(0).random(SHAPE), 2.0)
        file_reader(os.path.join(root, "in.zarr")).require_dataset(
            "b", shape=SHAPE, chunks=tuple(BLOCK), dtype="float32")[...] = ((x - x.min()) / (x.max() - x.min()))
        yield root


def _run_ws(root, name, **global_config):
    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "cfg"), exist_ok=True)
    with open(os.path.join(d, "cfg", "global.config"), "w") as f:
        json.dump(dict({"block_shape": BLOCK, "sweep_mode": "sharded", "sharded_batch": 8}, **global_config), f)
    out_path = os.path.join(d, "out.zarr")
    wf = WatershedWorkflow(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=2,
                           target="local", input_path=os.path.join(root, "in.zarr"), input_key="b",
                           output_path=out_path, output_key="ws", block_shape=BLOCK, halo=[4, 4, 4],
                           threshold=0.5)
    assert build([wf])
    doc = fu.read_json_if_valid(fu.failures_path(os.path.join(d, "tmp"))) or {"records": []}
    return file_reader(out_path)["ws"][...], doc["records"]


def test_hardened_sharded_watershed_equals_the_fault_free_run(ws_root):
    ref, recs = _run_ws(ws_root, "clean")
    assert recs == [] and len(np.unique(ref)) > 16
    # Morton batches of 8: block 8 leads the third batch, 42 and 7 sit in
    # others.  (A sharded call of eight CPU watershed blocks outlasts any
    # deadline short enough for a test, so the sharded load hang is held in
    # tests/test_torch_faults.py and tests/test_torch_integrity.py with
    # cheaper kernels.)
    pfaults.configure({"faults": [
        {"site": "kernel", "kind": "nan", "blocks": [42]},
        {"site": "io_write", "kind": "corrupt", "blocks": [7]},
        {"site": "dispatch", "kind": "oom", "blocks": [8], "fail_attempts": 1},
    ]})
    got, recs = _run_ws(ws_root, "faulted")
    np.testing.assert_array_equal(got, ref)
    by_block = {r["block_id"]: r for r in recs if r.get("block_id") is not None}
    assert by_block[42]["sites"] == {"validate": 1} and by_block[42]["resolved"]
    assert by_block[7]["sites"] == {"corrupt": 1, "store": 1} and not by_block[7]["quarantined"]
    unsharded = sorted(b for b, r in by_block.items() if r.get("resolution") == "degraded:unsharded")
    assert unsharded == [8, 9, 12, 13, 24, 25, 28, 29]
    assert all(by_block[b]["sites"] == {"dispatch": 1, "oom": 1} for b in unsharded)


# -- a split inference sweep ------------------------------------------------------------------------

INF_SHAPE = (80, 80, 80)


def _run_inference(root, name, **global_config):
    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "cfg"), exist_ok=True)
    with open(os.path.join(d, "cfg", "global.config"), "w") as f:
        json.dump(dict({"block_shape": [32, 32, 32]}, **global_config), f)
    data = os.path.join(root, "raw.zarr")
    wf = InferenceWorkflow(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=1,
                           target="local", input_path=data, input_key="raw", output_path=data, output_key=name,
                           model=dict(name="unet3d", base_features=4, depth=1, out_channels=2, dtype="float32",
                                      norm=None),
                           halo=[12, 12, 12], block_shape=[32, 32, 32], activation="sigmoid",
                           normalize_range=[0.0, 255.0], allow_block_split=True, min_block_shape=[8, 8, 8],
                           roi_begin=[0, 0, 0], roi_end=[64, 64, 64])
    assert build([wf])
    doc = fu.read_json_if_valid(fu.failures_path(os.path.join(d, "tmp"))) or {"records": []}
    return file_reader(data)[name][...], doc["records"]


def test_split_inference_equals_its_unsplit_run(tmp_path):
    root = str(tmp_path)
    raw = (np.random.default_rng(8).random(INF_SHAPE) * 255).astype(np.uint8)
    file_reader(os.path.join(root, "raw.zarr")).require_dataset(
        "raw", shape=INF_SHAPE, chunks=(32, 32, 32), dtype="uint8")[...] = raw
    ref, recs = _run_inference(root, "unsplit")
    assert recs == []
    # every full block (44^3 outer voxels) runs out of memory, every 16^3
    # sub-block (at most 40^3 outer) fits
    pfaults.configure({"faults": [{"site": "compute", "kind": "oom", "min_voxels": 41 ** 3,
                                   "fail_attempts": 10 ** 6}]})
    got, recs = _run_inference(root, "split")
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
    assert len(recs) == 8
    assert all(r["resolution"] == "degraded:split" and r["split_depth"] == 1 and r["resource"] == "oom"
               for r in recs)
