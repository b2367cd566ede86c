"""The lifted multicut, mutex-watershed and stitching workflows on the card,
each with ``target="gpu"`` equal bit for bit to the same workflow with
``target="local"`` (the CPU):

- ``LiftedMulticutSegmentationWorkflow`` with its own watershed (the hand
  kernels launch through the sweep) on a seeded boundary map, the
  connected components of its foreground as the attribution, with
  ``solver_shards`` 1 and 2: labels, ``lmc_assignments.npz`` and
  ``lifted_problem.npz``;
- ``MwsWorkflow`` with its stitching on affinities of a
  ``synthetic_em_volume`` ground truth with the default offsets;
- ``StitchingWorkflow`` with ``merge_mode="multicut"`` on the unstitched
  blocks and the volume's boundary map, with ``solver_shards`` 1 and 2
  (the contraction engine's torch rung on the card).

Torch only; every test is ``gpu``-marked and skips without a CUDA device.
Run on the card: ``python3 -m pytest tests/test_torch_lifted_card.py -m gpu``.
"""

import json
import os

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from chip_smoke import affinities_from_labels
from cluster_tools_tpu_torch.ops import kernels as K
from cluster_tools_tpu_torch.runtime.task import build
from cluster_tools_tpu_torch.tasks.mutex_watershed import DEFAULT_OFFSETS, MwsWorkflow
from cluster_tools_tpu_torch.tasks.stitching import StitchingWorkflow
from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries_np, synthetic_em_volume
from cluster_tools_tpu_torch.utils.volume_utils import file_reader
from cluster_tools_tpu_torch.workflows import LiftedMulticutSegmentationWorkflow


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lifted, MWS and stitching workflows on the card")
    monkeypatch.setenv("CT_TIER_MODE", "cond")
    monkeypatch.setenv("CT_FILL_MODE", "capacity")
    return torch.device("cuda")


def _run(root, target, workflow_cls, block, **params):
    tmp = os.path.join(root, target)
    os.makedirs(os.path.join(tmp, "cfg"), exist_ok=True)
    with open(os.path.join(tmp, "cfg", "global.config"), "w") as f:
        json.dump({"block_shape": list(block)}, f)
    assert build([workflow_cls(tmp_folder=os.path.join(tmp, "tmp"), config_dir=os.path.join(tmp, "cfg"),
                               max_jobs=4, target=target, block_shape=list(block), **params)])
    return os.path.join(tmp, "tmp")


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("solver_shards", [1, 2])
def test_lifted_workflow_on_the_card_equals_the_cpu(cuda, tmp_path, solver_shards):
    b = synthetic_boundaries_np((64, 64, 64), seed=3)
    nuclei, _ = ndi.label(b < 0.45)
    path = str(tmp_path / "d.zarr")
    f = file_reader(path)
    f.require_dataset("bmap", shape=b.shape, chunks=(32, 32, 32), dtype="float32")[...] = b
    f.require_dataset("nuclei", shape=b.shape, chunks=(32, 32, 32), dtype="uint64")[...] = nuclei.astype(np.uint64)
    out = {}
    for target in ("gpu", "local"):
        K.reset_counts()
        tmp = _run(str(tmp_path), target, LiftedMulticutSegmentationWorkflow, (32, 32, 32), input_path=path,
                   input_key="bmap", ws_path=path, ws_key=f"ws_{target}", output_path=path,
                   output_key=f"seg_{target}", labels_path=path, labels_key="nuclei", halo=[8, 8, 8],
                   threshold=0.45, solver_shards=solver_shards)
        if target == "gpu":
            assert all(K.LAUNCHES.get(k, 0) > 0 for k in ("tile_ccl", "tile_ws_propagate", "edt_cascade",
                                                             "apply_remap")), dict(K.LAUNCHES)
        out[target] = dict(seg=f[f"seg_{target}"][...], **{
            f"lmc/{k}": v for k, v in _npz(os.path.join(tmp, "lifted_multicut", "lmc_assignments.npz")).items()},
            **{f"lifted/{k}": v for k, v in _npz(os.path.join(tmp, "lifted", "lifted_problem.npz")).items()})
    _same(out["gpu"], out["local"])
    assert len(out["gpu"]["lifted/edges"]) > 0 and len(np.unique(out["gpu"]["seg"])) > 1


@pytest.mark.gpu
def test_mws_and_stitching_on_the_card_equal_the_cpu(cuda, tmp_path):
    bmap, gt, _ = synthetic_em_volume(shape=(32, 64, 64), n_objects=8, seed=11, with_mask=False)
    affs = affinities_from_labels(gt, DEFAULT_OFFSETS, 0.05, 11)
    path = str(tmp_path / "affs.zarr")
    f = file_reader(path)
    f.require_dataset("affs", shape=affs.shape, chunks=(len(DEFAULT_OFFSETS), 32, 32, 32),
                      dtype="float32")[...] = affs
    f.require_dataset("bmap", shape=bmap.shape, chunks=(32, 32, 32), dtype="float32")[...] = bmap
    block = (32, 32, 32)
    for target in ("gpu", "local"):
        for stitch in (True, False):
            _run(str(tmp_path / f"mws{int(stitch)}"), target, MwsWorkflow, block, input_path=path, input_key="affs",
                 output_path=path, output_key=f"mws{int(stitch)}_{target}", stitch=stitch)
        for shards in (1, 2):
            key = f"mc{shards}_{target}"
            f.require_dataset(key, shape=gt.shape, chunks=block, dtype="uint64")[...] = f[f"mws0_{target}"][...]
            # the multicut mode reads a boundary map (cost > 0 below the threshold)
            _run(str(tmp_path / key), target, StitchingWorkflow, block, seg_path=path, seg_key=key, input_path=path,
                 input_key="bmap", merge_mode="multicut", stitch_threshold=0.5, solver_shards=shards)
    for key in ("mws1", "mws0", "mc1", "mc2"):
        np.testing.assert_array_equal(f[f"{key}_gpu"][...], f[f"{key}_local"][...], err_msg=key)
    n_blocks = len(np.unique(f["mws0_gpu"][...]))
    assert len(np.unique(f["mws1_gpu"][...])) < n_blocks and len(np.unique(f["mc2_gpu"][...])) < n_blocks
