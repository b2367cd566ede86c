"""The port's io layer and task runtime against the JAX package.

The port's numpy zarr v2 container and the reference's tensorstore zarr
read each other's files (both compressors, four dtypes, partial edge
chunks, region writes spanning chunks); the block-grid math equals the
reference's; targets resolve to ``<Op>Local`` / ``<Op>GPU``; a workflow
without a target needs the card; the executor retries, quarantines and
names its failed blocks; and every option the port does not carry is
refused with ``NotImplementedError``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from cluster_tools_tpu.io.containers import ZarrContainer as JZarr
from cluster_tools_tpu.runtime.executor import morton_order as j_morton
from cluster_tools_tpu.tasks.write import apply_assignment_np as j_apply
from cluster_tools_tpu.utils import volume_utils as jvu
from cluster_tools_tpu_torch.io.containers import ZarrContainer, open_container
from cluster_tools_tpu_torch.runtime import executor as pex
from cluster_tools_tpu_torch.runtime.task import build, get_task_cls
from cluster_tools_tpu_torch.tasks import connected_components as pcc
from cluster_tools_tpu_torch.tasks import relabel as prl
from cluster_tools_tpu_torch.tasks import watershed as pws
from cluster_tools_tpu_torch.tasks.write import apply_assignment_np
from cluster_tools_tpu_torch.utils import function_utils as fu
from cluster_tools_tpu_torch.utils import volume_utils as pvu

SHAPE = (10, 7, 13)
CHUNKS = (4, 4, 8)
DTYPES = ("float32", "uint8", "bool", "uint64")
COMPRESSIONS = ("gzip", None)


def _data(dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random(SHAPE) * 300
    if dtype == "bool":
        return a > 150
    if dtype == "uint64":
        return (a * 1e9).astype(np.uint64) + np.uint64(2**60)
    return a.astype(dtype)


def _writes(ds, a):
    """Region writes spanning chunks, partial edge chunks and a single plane;
    returns what the dataset must hold afterwards (fill 0 elsewhere)."""
    want = np.zeros(SHAPE, a.dtype)
    for bb in ((slice(1, 9), slice(2, 7), slice(3, 13)), (slice(0, 1), slice(None), slice(None)),
               (slice(9, 10), slice(0, 3), slice(5, 6))):
        ds[bb] = a[bb]
        want[bb] = a[bb]
    ds[4, 1:6, 2] = a[4, 1:6, 2]
    want[4, 1:6, 2] = a[4, 1:6, 2]
    return want


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_port_reads_reference_zarr(tmp_path, dtype, compression):
    a = _data(dtype)
    ds = JZarr(str(tmp_path / "ref.zarr")).create_dataset(
        "x", shape=SHAPE, chunks=CHUNKS, dtype=dtype, compression=compression,
        fill_value=False if dtype == "bool" else 0)
    want = _writes(ds, a)
    got = ZarrContainer(str(tmp_path / "ref.zarr"), "r")["x"]
    assert got.shape == SHAPE and got.chunks == CHUNKS and got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got[:], want)
    np.testing.assert_array_equal(got[3:8, 1, 2:12], want[3:8, 1, 2:12])
    np.testing.assert_array_equal(got[..., 7], want[..., 7])


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_reads_port_zarr(tmp_path, dtype, compression):
    a = _data(dtype, seed=1)
    ds = ZarrContainer(str(tmp_path / "port.zarr")).create_dataset(
        "x", shape=SHAPE, chunks=CHUNKS, dtype=dtype, compression=compression,
        fill_value=False if dtype == "bool" else 0)
    want = _writes(ds, a)
    np.testing.assert_array_equal(ds[:], want)
    got = JZarr(str(tmp_path / "port.zarr"))["x"]
    assert tuple(got.shape) == SHAPE and np.dtype(got.dtype) == np.dtype(dtype)
    np.testing.assert_array_equal(np.asarray(got[:]), want)
    meta = json.loads((tmp_path / "port.zarr" / "x" / ".zarray").read_text())
    assert meta["compressor"] == ({"id": "zlib", "level": 1} if compression else None)


def test_zarr_require_dataset_checks_and_keeps_data(tmp_path):
    f = ZarrContainer(str(tmp_path / "a.zarr"))
    ds = f.require_dataset("k", shape=(8, 8), chunks=(4, 4), dtype="uint64")
    ds[:4, :4] = 7
    again = ZarrContainer(str(tmp_path / "a.zarr")).require_dataset("k", shape=(8, 8), chunks=(8, 8), dtype="uint64")
    assert int(again[0, 0]) == 7 and int(again[7, 7]) == 0
    with pytest.raises(ValueError, match="exists with shape"):
        f.require_dataset("k", shape=(8, 9), chunks=(4, 4), dtype="uint64")
    with pytest.raises(ValueError, match="tile whole chunks"):
        f.require_dataset("k", shape=(8, 8), chunks=(2, 2), dtype="uint64")
    with pytest.raises(KeyError):
        ZarrContainer(str(tmp_path / "a.zarr"), "r")["missing"]


def test_memory_container_is_a_registry():
    a = open_container("memory://io-test")
    ds = a.require_dataset("x", shape=(4, 4), chunks=(2, 2), dtype="float32")
    ds[1:3, 1:3] = 2.5
    b = open_container("memory://io-test")
    assert "x" in b and float(b["x"][1, 1]) == 2.5 and float(b["x"][0, 0]) == 0.0
    assert pvu.get_shape("memory://io-test", "x") == (4, 4)


@pytest.mark.parametrize("path", ["v.h5", "v.hdf5"])
def test_n5_and_h5_are_refused(tmp_path, monkeypatch, path):
    """N5 is ported (``tests/test_torch_n5_h5.py``); HDF5 is refused, naming
    the package, where ``h5py`` cannot be imported (the card's machine)."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        open_container(str(tmp_path / path))
    assert not (tmp_path / path).exists()


GRIDS = [((10, 7, 13), (4, 4, 8), (1, 2, 3)), ((32, 32, 32), (16, 16, 16), (4, 4, 4)),
         ((5, 17), (5, 4), (2, 0)), ((9,), (4,), (3,))]


@pytest.mark.parametrize("shape,block_shape,halo", GRIDS)
def test_blocking_matches_reference(shape, block_shape, halo):
    jb, pb = jvu.Blocking(shape, block_shape), pvu.Blocking(shape, block_shape)
    assert pb.grid_shape == jb.grid_shape and pb.n_blocks == jb.n_blocks
    for bid in range(jb.n_blocks):
        for h in (None, halo):
            j, p = jb.get_block(bid, h), pb.get_block(bid, h)
            assert (p.begin, p.end, p.outer_begin, p.outer_end) == (j.begin, j.end, j.outer_begin, j.outer_end)
            assert p.inner_in_outer_bb == j.inner_in_outer_bb and p.outer_shape == j.outer_shape
        assert pb.block_grid_position(bid) == tuple(int(v) for v in jb.block_grid_position(bid))
        for off in ((1,) * len(shape), (-1,) + (0,) * (len(shape) - 1)):
            assert pb.neighbor_id_offset(bid, off) == jb.neighbor_id_offset(bid, off)
    roi_begin = [s // 3 for s in shape]
    roi_end = [s - 1 for s in shape]
    assert pvu.blocks_in_volume(shape, block_shape, roi_begin, roi_end) == \
        jvu.blocks_in_volume(shape, block_shape, roi_begin, roi_end)
    assert pvu.blocks_in_volume(shape, block_shape) == jvu.blocks_in_volume(shape, block_shape)
    blocks = [pb.get_block(b, halo) for b in range(pb.n_blocks)][::-1]
    jblocks = [jb.get_block(b, halo) for b in range(jb.n_blocks)][::-1]
    assert [b.block_id for b in pex.morton_order(blocks)] == [b.block_id for b in j_morton(jblocks)]
    data = np.arange(int(np.prod(block_shape)), dtype=np.float32).reshape(block_shape)[
        tuple(slice(0, max(1, b - 1)) for b in block_shape)]
    np.testing.assert_array_equal(pvu.pad_block_to(data, block_shape, constant_values=1.0),
                                  jvu.pad_block_to(data, block_shape, constant_values=1.0))


def test_apply_assignment_matches_reference():
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(1, 1000, 50).astype(np.uint64))
    values = rng.integers(1, 20, len(keys)).astype(np.uint64)
    labels = rng.integers(0, 1000, (8, 9)).astype(np.uint64)
    np.testing.assert_array_equal(apply_assignment_np(labels, keys, values), j_apply(labels, keys, values))
    np.testing.assert_array_equal(apply_assignment_np(labels, keys[:0], values[:0]), j_apply(labels, keys[:0], values[:0]))


@pytest.mark.parametrize("module,name", [(pws, "Watershed"), (pws, "TwoPassWatershed"),
                                         (pcc, "BlockComponents"), (pcc, "MergeAssignments"),
                                         (prl, "FindUniques")])
def test_get_task_cls_maps_targets(module, name):
    assert get_task_cls(module, name, "local") is getattr(module, name + "Local")
    assert get_task_cls(module, name, "gpu") is getattr(module, name + "GPU")
    assert get_task_cls(module, name, "local").target == "local"
    assert get_task_cls(module, name, "gpu").target == "gpu"
    with pytest.raises(NotImplementedError, match="item 11"):
        get_task_cls(module, name, "slurm")
    with pytest.raises(ValueError):
        get_task_cls(module, name, "tpu")


@pytest.mark.parametrize("workflow", [pws.WatershedWorkflow, pcc.ConnectedComponentsWorkflow, prl.RelabelWorkflow])
def test_workflow_without_target_needs_a_gpu(tmp_path, monkeypatch, workflow):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workflow(tmp_folder=str(tmp_path / "tmp"), config_dir=str(tmp_path), input_path="memory://x",
                 input_key="x", output_path="memory://x", output_key="y")
    wf = workflow(tmp_folder=str(tmp_path / "tmp"), config_dir=str(tmp_path), target="local",
                  input_path="memory://x", input_key="x", output_path="memory://x", output_key="y")
    assert wf.target == "local"


def _small_workspace(tmp_path, global_config):
    os.makedirs(tmp_path / "cfg", exist_ok=True)
    (tmp_path / "cfg" / "global.config").write_text(json.dumps(dict({"block_shape": [8, 8, 8]}, **global_config)))
    path = f"memory://refuse-{tmp_path.name}"
    ds = open_container(path).require_dataset("x", shape=(16, 16, 16), chunks=(8, 8, 8), dtype="float32")
    ds[...] = np.random.default_rng(0).random((16, 16, 16)).astype(np.float32)
    return path


REFUSED = [
    # degrade-and-split rides the fault plane (item 11); memory_handoffs,
    # refused here until task-graph fusion was ported, runs in NOW_PORTED
    ("cc", {"allow_block_split": True}, {}, "item 11"),
    ("cc", {"block_deadline_s": 5.0}, {}, "item 11"),
    # impl="host" runs (tests/test_torch_host.py); its refusals stay
    ("ws", {}, {"impl": "host", "sigma_seeds": 1.0}, "sigma_seeds"),
    # the in-block agglomeration is single-pass only, as in the reference
    ("ws", {}, {"agglomerate_threshold": 0.3, "pass_parity": 0}, "pass_parity"),
    ("ws2", {}, {"impl": "host"}, "two-pass"),
    ("ws2", {}, {"agglomerate_threshold": 0.3}, "two_pass"),
]


@pytest.mark.parametrize("kind,global_config,params,item", REFUSED)
def test_refused_options_raise(tmp_path, kind, global_config, params, item):
    path = _small_workspace(tmp_path, global_config)
    common = dict(tmp_folder=str(tmp_path / "tmp"), config_dir=str(tmp_path / "cfg"), target="local",
                  input_path=path, input_key="x", output_path=path, output_key="y")
    if kind == "cc":
        wf = pcc.ConnectedComponentsWorkflow(threshold=0.5, **common, **params)
    else:
        wf = pws.WatershedWorkflow(halo=[2, 2, 2], two_pass=kind == "ws2", **common, **params)
    with pytest.raises(NotImplementedError, match=item):
        build([wf])


# sweep modes the port refused before it had the sharded sweep, the paged
# pool and the device page pool: each now runs and equals the per-block sweep
NOW_PORTED = [
    ("cc", {"sweep_mode": "sharded"}, {}),
    ("cc", {"device_pool": "on", "sweep_mode": "sharded", "ragged": "on"}, {}),
    ("ws", {"sweep_mode": "sharded"}, {}),
    # task-graph fusion: the provisional labels and the artifacts stay in
    # memory, the final labels equal the all-storage run's
    ("cc", {"memory_handoffs": True}, {}),
]


@pytest.mark.parametrize("kind,global_config,params", NOW_PORTED)
def test_ported_sweep_modes_equal_per_block(tmp_path, kind, global_config, params):
    outs = []
    for tag, gc in (("pb", {"sweep_mode": "per_block"}), ("mode", global_config)):
        base = tmp_path / tag
        path = _small_workspace(base, gc)
        common = dict(tmp_folder=str(base / "tmp"), config_dir=str(base / "cfg"), target="local",
                      input_path=path, input_key="x", output_path=path, output_key="y")
        if kind == "cc":
            wf = pcc.ConnectedComponentsWorkflow(threshold=0.5, **common, **params)
        else:
            wf = pws.WatershedWorkflow(halo=[2, 2, 2], **common, **params)
        assert build([wf])
        outs.append(open_container(path)["y"][...])
        if gc.get("memory_handoffs"):
            # the provisional labels never reached storage
            assert not os.path.exists(base / "tmp" / "cc_blocks.zarr" / "labels")
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].max() > 0


@pytest.mark.parametrize("kwargs,item", [({"block_deadline_s": 1.0}, "item 11"),
                                         ({"splittable": True}, "item 11"),
                                         ({"store_verify_fn": lambda b: None}, "item 11")])
def test_executor_refuses_unported_modes(kwargs, item):
    blocks = [pvu.Blocking((4,), (2,)).get_block(0)]
    with pytest.raises(NotImplementedError, match=item):
        pex.BlockwiseExecutor(target="local").map_blocks(lambda x: x, blocks, lambda b: (np.zeros(2),), **kwargs)


@pytest.mark.parametrize("kwargs", [{"sweep_mode": "sharded"}, {"sweep_mode": "sharded", "ragged": "on"},
                                    {"sweep_mode": "sharded", "ragged": "on", "device_pool": "on"}])
def test_executor_runs_the_sweep_plane_modes(kwargs):
    blocking = pvu.Blocking((22,), (2,))
    blocks = [blocking.get_block(b) for b in range(blocking.n_blocks)]
    vol = np.random.default_rng(3).random(22).astype(np.float32)
    outs = []
    for kw in ({"sweep_mode": "per_block"}, kwargs):
        out = np.zeros_like(vol)

        def store(b, o, out=out):
            out[b.bb] = o

        summary = pex.BlockwiseExecutor(target="local").map_blocks(
            lambda x: x * 2 + 1, blocks, lambda b: (vol[b.bb],), store, **kw)
        outs.append(out)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert summary["sweep_mode"] == "sharded" and summary["blocks_dispatched"] == len(blocks)


def test_executor_retries_quarantines_and_names_failed_blocks(tmp_path):
    blocking = pvu.Blocking((12,), (2,))
    blocks = [blocking.get_block(b) for b in range(blocking.n_blocks)]
    calls, stored, done = {}, {}, []

    def load(block):
        calls[block.block_id] = calls.get(block.block_id, 0) + 1
        if block.block_id == 1 and calls[1] == 1:
            raise OSError("transient read error")  # retried
        return (np.full(2, block.block_id, np.int32),)

    def kernel(x):
        assert isinstance(x, torch.Tensor)
        if int(x[0]) == 3:
            raise RuntimeError("kernel fault in block 3")
        if int(x[0]) == 4:
            return x - 10  # negative labels: quarantined by validate_labels
        return x * 2, int(x[0]) == 5

    def store(block, out):
        stored[block.block_id] = out

    ex = pex.BlockwiseExecutor(target="local", io_threads=3, backoff_base=0.0)
    fpath = fu.failures_path(str(tmp_path))
    with pytest.raises(RuntimeError, match=r"2/6 blocks failed.*ids: \[3, 4\]"):
        ex.map_blocks(kernel, blocks, load, store, on_block_done=lambda b: done.append(b.block_id),
                      validate_fn=pex.validate_labels, failures_path=fpath, task_name="t", schedule="given")
    assert sorted(done) == [0, 1, 2, 5]
    np.testing.assert_array_equal(stored[2][0], [4, 4])
    assert stored[5][1].dtype == bool and bool(stored[5][1])
    recs = {r["block_id"]: r for r in json.load(open(fpath))["records"]}
    assert recs[1]["resolved"] and recs[1]["sites"] == {"load": 1}
    assert not recs[3]["resolved"] and recs[3]["sites"]["compute"] == 2 and "kernel fault" in recs[3]["error"]
    assert not recs[4]["resolved"] and recs[4]["sites"]["validate"] == 2
    # resume: done blocks are skipped
    calls.clear()
    summary = ex.map_blocks(lambda x: x, blocks, load, store, done_block_ids=[0, 1, 2, 5], schedule="given")
    assert sorted(calls) == [3, 4] and summary["n_blocks"] == 2


def test_markers_and_failure_manifest(tmp_path):
    tmp = str(tmp_path)
    fu.log_block_success(tmp, "task", 3)
    fu.log_block_success(tmp, "task", 1)
    with open(os.path.join(tmp, "markers", "task", "block_7.json"), "w") as f:
        f.write('{"block_id": 7, "ti')  # torn marker: pruned, not done
    assert fu.blocks_done(tmp, "task") == [1, 3]
    fu.record_failures(fu.failures_path(tmp), "a", [{"block_id": 1, "error": "x"}])
    fu.record_failures(fu.failures_path(tmp), "a", [{"block_id": 1, "error": "y"}, {"block_id": 2}])
    recs = json.load(open(fu.failures_path(tmp)))["records"]
    assert [(r["task"], r["block_id"], r.get("error")) for r in recs] == [("a", 1, "y"), ("a", 2, None)]
    fu.clear_block_markers(tmp, "task")
    assert fu.blocks_done(tmp, "task") == []


def test_zarr_concurrent_partial_chunk_writes(tmp_path):
    """More writer threads than cores, each writing its own voxels of chunks
    the others write too (read-modify-write of partial chunks), with a short
    switch interval: no write may be lost."""
    import sys
    import threading

    ds = ZarrContainer(str(tmp_path / "s.zarr")).create_dataset("x", shape=(8, 64), chunks=(8, 16), dtype="int32",
                                                                 compression="gzip")
    n_threads = 4 * (os.cpu_count() or 1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def write(t):
            for col in range(t, 64, n_threads):
                ds[:, col] = t + 1

        threads = [threading.Thread(target=write, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    want = np.broadcast_to((np.arange(64) % n_threads + 1).astype(np.int32), (8, 64))
    np.testing.assert_array_equal(ds[...], want)
