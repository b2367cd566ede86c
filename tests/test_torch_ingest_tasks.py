"""The ingest tasks the cluster targets drive — ``tasks/copy_volume.py``,
``tasks/thresholded_components.py`` and the size filter of
``tasks/postprocess.py`` — against the JAX package's in-process ``local``
runs, with zero tolerance.

The copy-volume cases of the reference's ``tests/test_aux_tasks.py``
(``:89`` cast and scale, ``:222`` narrowing integer casts clip, ``:249``
and ``:275`` ``fit_to_roi`` on aligned and unaligned ROIs) and its
``:162`` (thresholded components with the size filter) and ``:198``
(threshold) run on both packages; each keeps the reference's own oracle
check too.  ``ThresholdedComponentsWorkflow`` with the size filter also
runs with every task a ``slurm`` job (stub scheduler binaries; the
port's jobs are torch processes), equal to the JAX package's local run.
"""

import json
import os

import numpy as np
import pytest
import scipy.ndimage as ndi

from cluster_tools_tpu.runtime.task import build as jbuild
from cluster_tools_tpu.tasks import copy_volume as jcv
from cluster_tools_tpu.tasks import thresholded_components as jtc
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
from cluster_tools_tpu_torch.runtime import faults
from cluster_tools_tpu_torch.runtime.task import build
from cluster_tools_tpu_torch.tasks import copy_volume as pcv
from cluster_tools_tpu_torch.tasks import thresholded_components as ptc
from cluster_tools_tpu_torch.utils.volume_utils import file_reader

from .helpers import assert_labels_equivalent, stub_slurm_bins

SIDES = {"port": (file_reader, build, pcv, ptc), "jax": (j_reader, jbuild, jcv, jtc)}


@pytest.fixture(autouse=True)
def _fresh_faults():
    faults.configure(None)
    yield
    faults.configure(None)


def _run(tmp_path, side, mod_name, cls_name, data, in_key, out_key, target="local", config=None, **params):
    """Write ``data`` into the side's zarr and run ``cls_name`` of the
    side's ``mod_name`` module on it; returns the output array."""
    reader, build_fn, cv, tc = SIDES[side]
    mod = {"copy_volume": cv, "thresholded_components": tc}[mod_name]
    root = tmp_path / side
    config_dir = root / "config"
    os.makedirs(config_dir, exist_ok=True)
    with open(config_dir / "global.config", "w") as f:
        json.dump(dict({"block_shape": [16, 16, 16]}, **(config or {})), f)
    path = str(root / "d.zarr")
    chunks = (1,) * (data.ndim - 3) + (16, 16, 16)
    reader(path).require_dataset(in_key, shape=data.shape, chunks=chunks, dtype=str(data.dtype))[...] = data
    kw = dict(tmp_folder=str(root / "tmp"), config_dir=str(config_dir), max_jobs=2, input_path=path,
              input_key=in_key, output_path=path, output_key=out_key, block_shape=[16, 16, 16], **params)
    if cls_name.endswith("Workflow"):
        kw["target"] = target
    assert build_fn([getattr(mod, cls_name)(**kw)])
    return np.asarray(reader(path)[out_key][...])


def _both(tmp_path, *args, **kw):
    out = {side: _run(tmp_path, side, *args, **kw) for side in SIDES}
    assert out["port"].dtype == out["jax"].dtype and out["port"].shape == out["jax"].shape
    np.testing.assert_array_equal(out["port"], out["jax"])
    return out["port"]


def test_copy_volume_cast_and_scale(rng, tmp_path):
    data = rng.random((24, 24, 24)).astype(np.float32)
    out = _both(tmp_path, "copy_volume", "CopyVolumeWorkflow", data, "raw", "u8", dtype="uint8", scale_factor=255.0)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, np.clip(np.round(data.astype(np.float64) * 255.0), 0, 255))


def test_copy_volume_int_narrowing_clips(tmp_path):
    """Int->narrower-int casts clip, not wrap modulo 2^n."""
    data = np.zeros((16, 16, 16), np.uint64)
    data[0, 0, 0] = 2**40  # > uint32 range
    data[0, 0, 1] = 7
    out = _both(tmp_path, "copy_volume", "CopyVolumeWorkflow", data, "big", "small", dtype="uint32")
    assert out[0, 0, 0] == np.iinfo(np.uint32).max and out[0, 0, 1] == 7


@pytest.mark.parametrize("roi", [((16, 0, 16), (32, 16, 32)), ((8, 0, 5), (24, 16, 21))],
                         ids=["aligned", "unaligned"])
def test_copy_volume_fit_to_roi(rng, tmp_path, roi):
    """``fit_to_roi``: the output covers exactly the ROI, shifted to the
    origin; non-block-aligned ROI edges are clipped, not shifted out of
    bounds."""
    data = rng.random((32, 32, 32)).astype(np.float32)
    (b0, b1, b2), (e0, e1, e2) = roi
    out = _both(tmp_path, "copy_volume", "CopyVolumeWorkflow", data, "roi_src", "roi_out", roi_begin=list(roi[0]),
                roi_end=list(roi[1]), fit_to_roi=True)
    assert out.shape == (16, 16, 16)
    np.testing.assert_array_equal(out, data[b0:e0, b1:e1, b2:e2])


def test_copy_volume_channel_offset_and_out_chunks(rng, tmp_path):
    """Channel slicing, an affine offset before a signed cast and output
    chunks smaller than the block, against the reference."""
    data = (rng.random((2, 32, 32, 32)) * 400 - 200).astype(np.float32)
    out = _both(tmp_path, "copy_volume", "CopyVolumeWorkflow", data, "multi", "c1", channel=1, offset=-50.0,
                scale_factor=0.5, dtype="int8", out_chunks=[8, 8, 8])
    np.testing.assert_array_equal(out, np.clip(np.round(data[1].astype(np.float64) * 0.5 - 50.0), -128, 127))
    with pytest.raises(ValueError, match="multiple of"):
        pcv.CopyVolumeLocal(tmp_folder=str(tmp_path / "bad"), config_dir=str(tmp_path / "port" / "config"),
                            input_path=str(tmp_path / "port" / "d.zarr"), input_key="c1",
                            output_path=str(tmp_path / "port" / "d.zarr"), output_key="bad",
                            block_shape=[16, 16, 16], out_chunks=[12, 12, 12]).run_impl()


def test_threshold_task(rng, tmp_path):
    data = rng.random((24, 24, 24)).astype(np.float32)
    out = _both(tmp_path, "thresholded_components", "ThresholdLocal", data, "raw", "mask", threshold=0.5)
    np.testing.assert_array_equal(out, (data > 0.5).astype(np.uint8))


@pytest.fixture(scope="module")
def blobs():
    vol = ndi.gaussian_filter(np.random.default_rng(42).random((32, 32, 32)), 1.5).astype(np.float32)
    return vol, float(np.quantile(vol, 0.55))


@pytest.fixture(scope="module")
def jax_components(blobs, tmp_path_factory):
    """The JAX package's local ThresholdedComponentsWorkflow with the size
    filter: the reference of the local and slurm cases below."""
    vol, thr = blobs
    return _run(tmp_path_factory.mktemp("jax_tcw"), "jax", "thresholded_components", "ThresholdedComponentsWorkflow",
                vol, "raw", "labels", threshold=thr, min_size=10)


def test_thresholded_components_with_size_filter(blobs, jax_components, tmp_path):
    vol, thr = blobs
    labels = _run(tmp_path, "port", "thresholded_components", "ThresholdedComponentsWorkflow", vol, "raw", "labels",
                  threshold=thr, min_size=10)
    np.testing.assert_array_equal(labels, jax_components)
    expected, _ = ndi.label(vol > thr)
    sizes = np.bincount(expected.ravel())
    keep = np.zeros_like(expected)
    for lab in range(1, len(sizes)):
        if sizes[lab] >= 10:
            keep[expected == lab] = lab
    assert_labels_equivalent(labels, keep)
    uniq = np.unique(labels)
    np.testing.assert_array_equal(uniq, np.arange(len(uniq)))  # dense after filtering


def test_thresholded_components_on_slurm_equals_reference(blobs, jax_components, tmp_path, monkeypatch):
    """Every task of threshold -> cc -> size filter as a slurm job (stub
    sbatch/squeue): the labels equal the JAX package's local run."""
    bindir = stub_slurm_bins(str(tmp_path / "fakebin"))
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    vol, thr = blobs
    labels = _run(tmp_path, "port", "thresholded_components", "ThresholdedComponentsWorkflow", vol, "raw", "labels",
                  target="slurm", config=dict(poll_interval_s=0.2, result_grace_s=2.0), threshold=thr, min_size=10)
    np.testing.assert_array_equal(labels, jax_components)
    cdir = tmp_path / "port" / "tmp" / "cluster"
    specs = sorted(json.load(open(cdir / f))["cls"] for f in os.listdir(cdir) if f.endswith(".spec.json"))
    assert {"BlockLabelSizesLocal", "SizeFilterAssignmentsLocal", "WriteLocal", "CopyVolumeLocal"} <= set(specs)
