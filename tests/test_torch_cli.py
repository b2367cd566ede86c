"""The port's command line (``cli.py``) against the JAX package's:
``python -m cluster_tools_tpu_torch.cli run`` writes the same labels as
``python -m cluster_tools_tpu.cli run`` for the same run config
(connected components and the watershed on the CPU, ``"target":
"local"``), ``configs`` writes the same config files for every ported
workflow, ``report`` tabulates the same tasks, and ``run copy_volume`` in
process writes the same cast volume.  The registry keeps every
name of the reference's; an unported one is refused naming ROADMAP item 12
when it is resolved, and ``run`` defaults to the card.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.ndimage as ndi

from cluster_tools_tpu import cli as jcli
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
from cluster_tools_tpu_torch import cli as pcli
from cluster_tools_tpu_torch.utils.volume_utils import file_reader as p_reader

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": ("cluster_tools_tpu.cli", j_reader), "port": ("cluster_tools_tpu_torch.cli", p_reader)}


def _env():
    return dict(os.environ, PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                CT_TIER_MODE="cond", CT_FILL_MODE="capacity", CT_SEED_CCL="tiled")


def _cli(side, *args):
    return subprocess.run([sys.executable, "-m", SIDES[side][0], *args], cwd=REPO_ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)


def test_registry_keeps_every_reference_name():
    assert set(pcli.WORKFLOWS) == set(jcli.WORKFLOWS)
    assert set(pcli.PORTED) <= set(pcli.WORKFLOWS)
    for name in pcli.PORTED:
        cls = pcli._resolve(name)
        assert cls.__module__.startswith("cluster_tools_tpu_torch.")
        assert cls.__name__ == jcli.WORKFLOWS[name].split(":")[1]
    for name in sorted(set(pcli.WORKFLOWS) - set(pcli.PORTED)):
        with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
            pcli._resolve(name)
    with pytest.raises(SystemExit):
        pcli._resolve("definitely_not_a_workflow")


@pytest.mark.parametrize("name", sorted(pcli.PORTED))
def test_configs_equal_the_reference(tmp_path, name):
    files = {}
    for side, mod in (("jax", jcli), ("port", pcli)):
        out = str(tmp_path / side)
        with contextlib.redirect_stdout(io.StringIO()):
            assert mod.main(["configs", name, "--out", out]) == 0
        files[side] = {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}
    assert files["port"] == files["jax"] and "global.config" in files["port"]


def _setup(tmp_path, side, workflow):
    base = tmp_path / side
    os.makedirs(base / "cfg")
    data = str(base / "data.zarr")
    if workflow == "watershed":
        x = ndi.gaussian_filter(np.random.default_rng(0).random((32, 32, 32)), 2.0)
        vol = ((x - x.min()) / (x.max() - x.min())).astype(np.float32)
        key, block = "boundaries", [16, 16, 16]
        params = dict(block_shape=block, halo=[4, 4, 4], threshold=0.5, min_seed_distance=1.0)
    else:
        vol = (np.random.default_rng(0).random((16, 16, 16)) > 0.5).astype("float32")
        key, block = "mask", [8, 8, 8]
        params = dict(threshold=0.5)
    SIDES[side][1](data).require_dataset(key, shape=vol.shape, chunks=tuple(block), dtype="float32")[...] = vol
    with open(base / "cfg" / "global.config", "w") as f:
        json.dump({"block_shape": block}, f)
    run_cfg = dict(tmp_folder=str(base / "tmp"), config_dir=str(base / "cfg"), max_jobs=2, target="local",
                   params=dict(input_path=data, input_key=key, output_path=data, output_key="out", **params))
    with open(base / "run.json", "w") as f:
        json.dump(run_cfg, f)
    return str(base / "run.json"), data, str(base / "tmp"), vol.size


@pytest.mark.parametrize("workflow", ["connected_components", "watershed"])
def test_run_and_report_equal_the_reference(tmp_path, workflow):
    labels, tasks = {}, {}
    for side in SIDES:
        cfg, data, tmp, n_voxels = _setup(tmp_path, side, workflow)
        out = _cli(side, "run", workflow, "--config", cfg)
        assert out.returncode == 0 and "SUCCESS" in out.stdout, out.stderr[-3000:]
        labels[side] = np.asarray(p_reader(data)["out"][...])
        rep = _cli(side, "report", tmp, "--n-voxels", str(n_voxels))
        assert rep.returncode == 0, rep.stderr[-2000:]
        rows = rep.stdout.strip().splitlines()
        assert rows[0].split() == ["task", "runtime_s", "voxels/s"] and rows[-1].split()[0] == "TOTAL"
        tasks[side] = sorted(r.split()[0] for r in rows[1:-1])
    assert labels["port"].dtype == labels["jax"].dtype == np.uint64
    np.testing.assert_array_equal(labels["port"], labels["jax"])
    assert labels["port"].max() > 1
    assert tasks["port"] == tasks["jax"] and tasks["port"]


def test_run_defaults_to_the_card(tmp_path):
    """A run config that names no target runs on the card: without one the
    run raises the device error and writes no output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would use it")
    cfg, data, tmp, _ = _setup(tmp_path, "port", "connected_components")
    doc = json.load(open(cfg))
    del doc["target"]
    with open(cfg, "w") as f:
        json.dump(doc, f)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        pcli.main(["run", "connected_components", "--config", cfg])
    assert "out" not in os.listdir(data)


def test_run_copy_volume_on_the_cpu(tmp_path):
    """``run copy_volume`` (ported with the cluster targets) through the
    port's CLI on the CPU: a uint64 volume cast to uint32 (clipping) equals
    the JAX package's CLI run of the same config."""
    data = np.random.default_rng(1).integers(0, 2**34, (16, 16, 16)).astype(np.uint64)
    out = {}
    for side, mod in (("jax", jcli), ("port", pcli)):
        base = tmp_path / side
        os.makedirs(base / "cfg")
        path = str(base / "data.zarr")
        SIDES[side][1](path).require_dataset("big", shape=data.shape, chunks=(8, 8, 8), dtype="uint64")[...] = data
        with open(base / "cfg" / "global.config", "w") as f:
            json.dump({"block_shape": [8, 8, 8]}, f)
        with open(base / "run.json", "w") as f:
            json.dump(dict(tmp_folder=str(base / "tmp"), config_dir=str(base / "cfg"), max_jobs=2, target="local",
                           params=dict(input_path=path, input_key="big", output_path=path, output_key="small",
                                       dtype="uint32")), f)
        with contextlib.redirect_stdout(io.StringIO()) as said:
            assert mod.main(["run", "copy_volume", "--config", str(base / "run.json")]) == 0
        assert "SUCCESS" in said.getvalue()
        out[side] = np.asarray(SIDES[side][1](path)["small"][...])
    assert out["port"].dtype == np.uint32
    np.testing.assert_array_equal(out["port"], out["jax"])
    np.testing.assert_array_equal(out["port"], np.minimum(data, 2**32 - 1).astype(np.uint32))
