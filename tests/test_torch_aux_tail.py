"""``tasks/statistics.py`` and ``tasks/downscaling.py`` against the JAX
package's ``local`` runs with zero tolerance.

The statistics case and the three downscaling cases of the reference's
``tests/test_aux_tasks.py`` (``:64``, ``:117``, ``:148``, ``:303``) run on
both packages on the same seeded numpy input.  The statistics are float64
sums in the reference's order, so the port's report equals the JAX
package's exactly; the pyramids, their attributes and the block
reductions are equal bit for bit (``mode`` also on float cells with NaNs:
the port sorts and ranks runs where the reference calls ``np.unique`` a
cell).  Each case keeps the reference's own
oracle check (numpy, at its tolerances).  The JAX runs are shared through
a module-scoped fixture.
"""

import importlib
import json
import os
import signal

import numpy as np
import pytest

from cluster_tools_tpu.runtime import supervision as jsup
from cluster_tools_tpu_torch.runtime import supervision as psup


@pytest.fixture(autouse=True, scope="module")
def _restore_drain_handlers():
    """Both packages' executors arm a SIGTERM/SIGUSR1 drain handler in the
    main thread and keep it: after this file's last case, restore both
    signals, both packages' armed flags and their drain latches, so a later
    file in this worker (the reference's preempt test above all) finds them
    as they were (ROADMAP fact 19)."""
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGUSR1)}
    flags = [(mod, mod._drain_installed) for mod in (jsup, psup)]
    yield
    for sig, handler in saved.items():
        signal.signal(sig, handler)
    for mod, flag in flags:
        mod._drain_installed = flag
        mod.reset_drain()


PKG = {"jax": "cluster_tools_tpu", "port": "cluster_tools_tpu_torch"}


def _mod(side, name):
    return importlib.import_module(f"{PKG[side]}.{name}")


def _reader(side):
    return _mod(side, "utils.volume_utils").file_reader


def _run(side, root, module, cls_name, data, name, **params):
    """Write ``data`` into the side's zarr and run ``cls_name`` of its
    ``tasks.<module>`` with ``target="local"``; returns the zarr path."""
    config_dir = os.path.join(root, "config")
    os.makedirs(config_dir, exist_ok=True)
    with open(os.path.join(config_dir, "global.config"), "w") as f:
        json.dump({"block_shape": [16, 16, 16]}, f)
    path = os.path.join(root, f"{name}.zarr")
    _reader(side)(path).require_dataset(name, shape=data.shape, chunks=(16, 16, 16), dtype=str(data.dtype))[...] = data
    wf = getattr(_mod(side, f"tasks.{module}"), cls_name)(tmp_folder=os.path.join(root, "tmp"),
                                                          config_dir=config_dir, max_jobs=2, target="local",
                                                          input_path=path, input_key=name, block_shape=[16, 16, 16],
                                                          **params)
    assert _mod(side, "runtime.task").build([wf])
    return path


def _raw():
    return np.random.default_rng(5).normal(5.0, 2.0, size=(32, 32, 32)).astype(np.float32)


def _statistics(side, root):
    _run(side, root, "statistics", "DataStatisticsWorkflow", _raw(), "raw")
    with open(os.path.join(root, "tmp", "statistics.json")) as f:
        stats = json.load(f)
    return {k: np.float64(v) for k, v in stats.items()}


def _pyramid(data, prefix, factors):
    def run(side, root):
        path = _run(side, root, "downscaling", "DownscalingWorkflow", data, "raw", output_path=os.path.join(
            root, "raw.zarr"), output_key_prefix=prefix, scale_factors=factors, mode="mean")
        f = _reader(side)(path)
        out = {}
        for level in range(1, len(factors) + 1):
            ds = f[f"{prefix}/s{level}"]
            out[f"s{level}"] = ds[...]
            out[f"s{level}/downsamplingFactors"] = np.asarray(ds.attrs["downsamplingFactors"])
            out[f"s{level}/downscalingMode"] = np.asarray(ds.attrs["downscalingMode"])
        return out

    return run


def _reduce_modes(side, root):
    labels = np.random.default_rng(6).integers(0, 9, size=(8, 8, 8)).astype(np.uint64)
    reduce_block = _mod(side, "tasks.downscaling")._reduce_block
    return {"labels": labels, "nearest": reduce_block(labels, (2, 2, 2), "nearest"),
            "mode": reduce_block(labels, (2, 2, 2), "mode"), "max": reduce_block(labels, (2, 3, 2), "max"),
            "min": reduce_block(labels, (3, 2, 2), "min"), "mode_odd": reduce_block(labels[:7], (2, 2, 2), "mode"),
            "mode_nan": reduce_block(np.where(labels % 3 == 0, np.nan, labels).astype(np.float32), (2, 2, 2), "mode")}


CASES = {
    "statistics": _statistics,
    "pyramid": _pyramid(np.random.default_rng(7).random((32, 32, 32)).astype(np.float32), "ds",
                        [[2, 2, 2], [2, 2, 2]]),
    "reduce_modes": _reduce_modes,
    "mean_uint8": _pyramid(np.random.default_rng(8).integers(0, 255, (32, 32, 32)).astype(np.uint8), "ds8",
                           [[2, 2, 2]]),
}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's run of a case, once per module."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = CASES[case]("jax", str(tmp_path_factory.mktemp(f"jax-{case}")))
        return cache[case]

    return get


def _both(case, tmp_path, jax_run):
    got, want = CASES[case]("port", str(tmp_path)), jax_run(case)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)  # NaNs compare equal here
    return got


def test_statistics_workflow(tmp_path, jax_run):
    stats, data = _both("statistics", tmp_path, jax_run), _raw()
    assert stats["count"] == data.size
    np.testing.assert_allclose(stats["mean"], data.mean(), rtol=1e-6)
    np.testing.assert_allclose(stats["std"], data.std(), rtol=1e-5)
    np.testing.assert_allclose(stats["min"], data.min(), rtol=1e-6)
    np.testing.assert_allclose(stats["max"], data.max(), rtol=1e-6)


def test_downscaling_pyramid(tmp_path, jax_run):
    out = _both("pyramid", tmp_path, jax_run)
    data = np.random.default_rng(7).random((32, 32, 32)).astype(np.float32)
    assert out["s1"].shape == (16, 16, 16) and out["s2"].shape == (8, 8, 8)
    expect_s1 = data.reshape(16, 2, 16, 2, 16, 2).mean((1, 3, 5))
    np.testing.assert_allclose(out["s1"], expect_s1, rtol=1e-5)
    np.testing.assert_allclose(out["s2"], expect_s1.reshape(8, 2, 8, 2, 8, 2).mean((1, 3, 5)), rtol=1e-5)
    # the workflow rewrites each level's factors as cumulative
    assert out["s1/downsamplingFactors"].tolist() == [2, 2, 2]
    assert out["s2/downsamplingFactors"].tolist() == [4, 4, 4]


def test_downscaling_mode_nearest_labels(tmp_path, jax_run):
    out = _both("reduce_modes", tmp_path, jax_run)
    labels = out["labels"]
    np.testing.assert_array_equal(out["nearest"], labels[::2, ::2, ::2])
    assert out["mode"].shape == (4, 4, 4)
    # each output cell's value must occur in its source cell
    for i, j, k in [(0, 0, 0), (1, 2, 3), (3, 3, 3)]:
        assert out["mode"][i, j, k] in labels[2 * i: 2 * i + 2, 2 * j: 2 * j + 2, 2 * k: 2 * k + 2]


def test_downscaling_mean_preserves_integer_dtype(tmp_path, jax_run):
    """The pyramid keeps s0's dtype (uint8 raw stays uint8 through mean
    downscaling), rounding half to even as the reference does."""
    s1 = _both("mean_uint8", tmp_path, jax_run)["s1"]
    data = np.random.default_rng(8).integers(0, 255, (32, 32, 32)).astype(np.uint8)
    assert s1.dtype == np.uint8
    expect = np.round(data.astype(np.float64).reshape(16, 2, 16, 2, 16, 2).mean((1, 3, 5))).astype(np.uint8)
    np.testing.assert_array_equal(s1, expect)
