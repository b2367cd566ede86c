"""The plain reference against the port's plain path on the CPU, the control
that has to fail, and the harness seeing ``correct`` come out false when
the timed path is broken underneath."""

import time

import numpy as np
import pytest
import torch

import harness
from compare import canonical
from conftest import CELLS, DRIVERS
from reference import ws_cc

STEP = dict(halo=8, threshold=0.45, dt_max_distance=6.0, min_seed_distance=2.0, seed_mode="sparse",
            fill_mode="capacity", tier_mode="cond")


def _map(shape, seed, passes, levels=None):
    gen = torch.Generator().manual_seed(seed)
    from volumes import synthetic_boundaries

    b = synthetic_boundaries(shape, gen, passes)
    if levels:
        # few grey levels: many equal saddles, so the fill's tie order decides
        b = torch.round(b * levels) / levels
    return b


@pytest.mark.parametrize("seed,shape,passes,levels,shards", [
    (1, (1, 32, 48, 40), 3, None, 1),
    (2, (1, 24, 40, 130), 2, 8, 1),
    (3, (1, 64, 32, 40), 3, None, 4),
    (4, (1, 40, 33, 50), 1, 4, 1),
    (5, (1, 48, 20, 36), 2, 16, 2),
])
def test_the_reference_step_equals_the_port_plain_path(seed, shape, passes, levels, shards):
    from cluster_tools_tpu_torch.parallel.mesh import make_mesh
    from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split

    b = _map(shape, seed, passes, levels)
    mesh = make_mesh(shards, grid=(1, shards), devices=["cpu"] * shards) if shards > 1 else None
    ws, cc, n_fg, overflow = make_ws_ccl_split(mesh, device=None if mesh else "cpu", **STEP)(b)
    ref_ws, ref_cc, ref_n = ws_cc.step_reference(b[0], shards, STEP["halo"], STEP["threshold"],
                                                 STEP["dt_max_distance"], STEP["min_seed_distance"])
    assert not overflow
    assert torch.equal(ws[0].long(), ref_ws)
    assert torch.equal(canonical(cc[0]), ref_cc)
    assert float(n_fg) == ref_n


def test_the_count_rounds_as_the_step_sums_it():
    # each slab's count rounds to float32 first, then the sum rounds: three
    # slabs of 2**24 + 1 voxels sum to 3 * 2**24, where the exact total
    # would round to 3 * 2**24 + 4
    assert ws_cc.float32_count([2**24 + 1] * 3) == 3 * 2**24
    assert float(np.float32(3 * (2**24 + 1))) == 3 * 2**24 + 4
    assert ws_cc.float32_count([3, 5]) == 8.0


# blocks that divide the volume, and blocks ragged at each axis's end as
# upstream's [50, 512, 512] are on CREMI-A's 125 x 1250 x 1250
@pytest.mark.parametrize("shape,seed", [((40, 48, 40), 9), ((45, 50, 44), 10)])
def test_the_reference_workflow_equals_the_port_workflow(tmp_path, monkeypatch, shape, seed):
    import json
    import os

    from cluster_tools_tpu_torch.io.containers import open_container
    from cluster_tools_tpu_torch.runtime.task import build
    from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow

    for k, v in {"CT_FILL_MODE": "capacity", "CT_TIER_MODE": "cond", "CT_SEED_CCL": "sparse"}.items():
        monkeypatch.setenv(k, v)
    b = _map(shape, seed, 3, 32)
    block, halo = [20, 24, 20], [4, 4, 4]
    path = "memory://port_bench_test/wf"
    open_container(path).require_dataset("b", shape=b.shape, chunks=block, dtype="float32")[...] = b.numpy()
    os.makedirs(tmp_path / "cfg")
    (tmp_path / "cfg" / "global.config").write_text(json.dumps({"block_shape": block}))
    wf = WatershedWorkflow(tmp_folder=str(tmp_path / "tmp"), config_dir=str(tmp_path / "cfg"), max_jobs=2,
                           block_shape=block, input_path=path, input_key="b", output_path=path, output_key="ws",
                           target="local", halo=halo, threshold=0.45, dt_max_distance=6.0, min_seed_distance=2.0)
    assert build([wf])
    got = torch.from_numpy(open_container(path)["ws"][...].astype(np.int64))
    want = ws_cc.workflow_reference(b, block, halo, 0.45, 6.0, 2.0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_three_seeds(tiny_root, cell):
    from control import readings

    spec = harness.Spec(tiny_root)
    for seed in (11, 12, 2**31 + 5):
        got = readings(spec, cell, seed, "cpu")
        assert any(v["value"] > v["limit"] for v in got.values()), (seed, got)


def _alter_one_label(monkeypatch):
    from cluster_tools_tpu_torch.ops import tile_ws

    real = tile_ws._ws_fill_lanes

    def fill(*args, **kwargs):
        out, overflow = real(*args, **kwargs)
        out = out.clone()
        # each lane's centre voxel: the halo around it is cropped away
        _, z, y, x = out.shape
        out[:, z // 2, y // 2, x // 2] += 1
        return out, overflow

    monkeypatch.setattr(tile_ws, "_ws_fill_lanes", fill)


def _drop_half_the_batch(monkeypatch):
    from cluster_tools_tpu_torch.tasks import watershed

    real = watershed.dt_watershed_lanes

    def lanes(b, *args, **kwargs):
        labels, overflow = real(b, *args, **kwargs)
        labels = labels.clone()
        labels[b.shape[0] // 2:] = 0
        return labels, overflow

    monkeypatch.setattr(watershed, "dt_watershed_lanes", lanes)


# the faults each driver's timed path can have
FAULTS = {"step": (_alter_one_label,), "workflow": (_alter_one_label, _drop_half_the_batch)}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[DRIVERS[c]]],
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_comes_out_not_correct(tiny_root, monkeypatch, cell, fault):
    spec = harness.Spec(tiny_root)
    fault(monkeypatch)
    res, checks = harness.run_cell(spec, cell, 31, 0.5, False, "cpu", time.perf_counter())
    assert res["correct"] is False, res["checks"]
