"""The postprocessing and analysis workflows on the card: the order-1
resample of ``tasks/transformations.py`` and connected components on a
segmentation (the keyed labeller) with ``target="gpu"``, each equal bit
for bit to the same workflow with ``target="local"`` (the CPU).

Torch only; every test is ``gpu``-marked and skips without a CUDA device.
Run on the card: ``python3 -m pytest tests/test_torch_analysis_card.py -m gpu``.
"""

import json
import os

import numpy as np
import pytest
import torch

from cluster_tools_tpu_torch.runtime.task import build
from cluster_tools_tpu_torch.tasks.postprocess import ConnectedComponentsOnSegmentationWorkflow
from cluster_tools_tpu_torch.tasks.transformations import TransformationsWorkflow, resample_linear
from cluster_tools_tpu_torch.utils.volume_utils import file_reader


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the analysis workflows on the card")
    return torch.device("cuda")


def _run(tmp_path, target, workflow_cls, data, **params):
    root = tmp_path / target
    os.makedirs(root / "config")
    with open(root / "config" / "global.config", "w") as f:
        json.dump({"block_shape": [32, 32, 32]}, f)
    path = str(root / "d.zarr")
    file_reader(path).require_dataset("in", shape=data.shape, chunks=(32, 32, 32), dtype=str(data.dtype))[...] = data
    assert build([workflow_cls(tmp_folder=str(root / "tmp"), config_dir=str(root / "config"), max_jobs=4,
                               target=target, input_path=path, input_key="in", output_path=path, output_key="out",
                               block_shape=[32, 32, 32], **params)])
    return file_reader(path)["out"][...]


@pytest.mark.gpu
def test_order1_resample_on_the_card_equals_the_cpu(cuda, tmp_path):
    rng = np.random.default_rng(0)
    buf = torch.from_numpy((rng.standard_normal((40, 44, 48)) * 100).astype(np.float32))
    coords = torch.from_numpy((rng.random((3, 1 << 20)) * np.array([[42], [46], [50]]) - 1).astype(np.float32))
    want = resample_linear(buf, coords, 7.5)
    got = resample_linear(buf.to(cuda), coords.to(cuda), 7.5).cpu()
    assert torch.equal(got, want)
    th = 0.3
    rot = (np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)], [0, np.sin(th), np.cos(th)]]) * 1.1).tolist()
    data = (rng.random((64, 64, 64)) * 100).astype(np.float32)
    kw = dict(matrix=rot, offset=[1.5, -2.0, 3.25], order=1, fill_value=0.0)
    np.testing.assert_array_equal(_run(tmp_path, "gpu", TransformationsWorkflow, data, **kw),
                                  _run(tmp_path, "local", TransformationsWorkflow, data, **kw))


@pytest.mark.gpu
def test_cc_on_segmentation_on_the_card_equals_the_cpu(cuda, tmp_path):
    seg = np.random.default_rng(1).integers(0, 4, (64, 64, 64)).astype(np.uint64)
    got = _run(tmp_path, "gpu", ConnectedComponentsOnSegmentationWorkflow, seg)
    np.testing.assert_array_equal(got, _run(tmp_path, "local", ConnectedComponentsOnSegmentationWorkflow, seg))
    assert got.max() > 4
