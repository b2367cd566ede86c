"""The rest of ``tasks/postprocess.py`` — connected components on a
segmentation, hole filling and the graph-watershed size filter — and the
CLI cases, against the JAX package's ``local`` runs with zero tolerance.

Every case of the reference's ``tests/test_postprocess_extended.py`` runs
on both packages on the same seeded numpy input: the outputs are equal bit
for bit, and each case keeps the reference's own oracle check (scipy).
The JAX runs are shared through a module-scoped fixture; the CLI cases
call both packages' ``cli.main`` in process.  A task for the card raises
without one.
"""

import contextlib
import importlib
import io
import json
import os
import signal

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from cluster_tools_tpu import cli as jcli
from cluster_tools_tpu.runtime import supervision as jsup
from cluster_tools_tpu_torch import cli as pcli
from cluster_tools_tpu_torch.runtime import supervision as psup

from .helpers import assert_labels_equivalent


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


def _workspace(root):
    config_dir = os.path.join(root, "config")
    os.makedirs(config_dir, exist_ok=True)
    with open(os.path.join(config_dir, "global.config"), "w") as f:
        json.dump({"block_shape": [16, 16, 16]}, f)
    return os.path.join(root, "tmp"), config_dir


def _dataset(side, root, name, data, chunks=(16, 16, 16)):
    path = os.path.join(root, f"{name}.zarr")
    _reader(side)(path).require_dataset(name, shape=data.shape, chunks=chunks, dtype=str(data.dtype))[...] = data
    return path


def _workflow(side, root, cls_name, **params):
    """Run ``cls_name`` of the side's ``tasks.postprocess`` with
    ``target="local"`` in a fresh workspace under ``root``."""
    tmp_folder, config_dir = _workspace(root)
    wf = getattr(_mod(side, "tasks.postprocess"), cls_name)(tmp_folder=tmp_folder, config_dir=config_dir,
                                                            max_jobs=4, target="local", block_shape=[16, 16, 16],
                                                            **params)
    assert _mod(side, "runtime.task").build([wf])


def _slabs():
    seg = np.zeros((32, 32, 32), np.uint64)
    # label 1: two disconnected slabs; label 2: one slab between them
    seg[:, :, 0:8] = 1
    seg[:, :, 12:20] = 2
    seg[:, :, 24:32] = 1
    return seg


def _cc_on_seg(seg, connectivity=None):
    def run(side, root):
        path = _dataset(side, root, "seg", seg)
        extra = {} if connectivity is None else {"connectivity": connectivity}
        _workflow(side, root, "ConnectedComponentsOnSegmentationWorkflow", input_path=path, input_key="seg",
                  output_path=path, output_key="cc", **extra)
        return {"cc": _reader(side)(path, "r")["cc"][...]}

    return run


def _holes():
    seg = np.zeros((24, 24, 24), np.uint64)
    seg[2:22, 2:22, 2:22] = 5
    seg[8:14, 8:14, 8:14] = 0      # internal cavity -> must fill with 5
    seg[2:22, 2:22, 18:22] = 7     # second object adjacent
    seg[10:12, 10:12, 19:21] = 0   # cavity inside 7 -> fill with 7
    return seg


def _fill_holes(side, root):
    path = _dataset(side, root, "seg", _holes())
    _workflow(side, root, "FillHolesWorkflow", input_path=path, input_key="seg", output_path=path,
              output_key="filled")
    tmp = os.path.join(root, "tmp")
    with np.load(os.path.join(tmp, "hole_assignments.npz")) as f:
        table = {k: f[k] for k in f.files}
    return {"filled": _reader(side)(path, "r")["filled"][...], **table}


def _graph_ws(side, root):
    shape = (16, 16, 32)
    seg = np.zeros(shape, np.uint64)
    seg[:, :, 0:14] = 1
    seg[:, :, 14:16] = 3     # small sliver between 1 and 2
    seg[:, :, 16:32] = 2
    # boundary map: the 3|1 interface is weak (low prob), 3|2 strong
    bmap = np.full(shape, 0.1, np.float32)
    bmap[:, :, 15:17] = 0.9
    p1 = _dataset(side, root, "seg", seg)
    p2 = _dataset(side, root, "bmap", bmap)
    _workflow(side, root, "GraphWatershedSizeFilterWorkflow", input_path=p1, input_key="seg", boundary_path=p2,
              boundary_key="bmap", output_path=p1, output_key="filtered", min_size=16 * 16 * 4)
    with np.load(os.path.join(root, "tmp", "graph_ws_assignments.npz")) as f:
        table = {k: f[k] for k in f.files}
    return {"filtered": _reader(side)(p1, "r")["filtered"][...], **table}


def _cli_mod(side):
    return {"jax": jcli, "port": pcli}[side]


def _cli_main(side, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = _cli_mod(side).main(list(argv))
    return rc, out.getvalue()


def _cli_run_and_report(side, root):
    mask = (np.random.default_rng(3).random((24, 24, 24)) > 0.6).astype(np.uint8)
    path = _dataset(side, root, "mask", mask)
    tmp_folder, config_dir = _workspace(root)
    run_cfg = {"tmp_folder": tmp_folder, "config_dir": config_dir, "max_jobs": 2, "target": "local",
               "params": {"input_path": path, "input_key": "mask", "output_path": path, "output_key": "labels",
                          "block_shape": [16, 16, 16]}}
    cfg_path = os.path.join(root, "run.json")
    with open(cfg_path, "w") as f:
        json.dump(run_cfg, f)
    rc, out = _cli_main(side, "run", "connected_components", "--config", cfg_path)
    assert rc == 0 and "SUCCESS" in out, out
    rc, rep = _cli_main(side, "report", tmp_folder)
    assert rc == 0 and "TOTAL" in rep
    rows = _mod(side, "utils.parse_utils").parse_runtimes(tmp_folder)
    return {"labels": _reader(side)(path, "r")["labels"][...], "mask": mask,
            "tasks": np.array(sorted(uid.split(".")[0] for uid in rows))}


def _configs(names):
    def run(side, root):
        files = {}
        for name in names:
            out = os.path.join(root, f"cfg_{name}")
            rc, _ = _cli_main(side, "configs", name, "--out", out)
            assert rc == 0, name
            for fn in sorted(os.listdir(out)):
                files[f"{name}/{fn}"] = np.frombuffer(open(os.path.join(out, fn), "rb").read(), np.uint8)
        return files

    return run


CASES = {
    "cc_on_segmentation": _cc_on_seg(_slabs()),
    "cc_on_segmentation_random": _cc_on_seg(np.random.default_rng(0).integers(0, 4, (24, 24, 24)).astype(np.uint64)),
    "cc_on_segmentation_full_connectivity": _cc_on_seg(
        np.random.default_rng(1).integers(0, 3, (32, 32, 32)).astype(np.uint64), connectivity=3),
    "fill_holes": _fill_holes,
    "graph_watershed_size_filter": _graph_ws,
    "cli_run_and_report": _cli_run_and_report,
    "cli_configs": _configs(["multicut"]),
    "cli_configs_every_workflow": _configs(sorted(pcli.PORTED)),
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
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


def cc_on_seg_oracle(seg, structure=None):
    out = np.zeros_like(seg)
    nxt = 1
    for k in np.unique(seg):
        if k == 0:
            continue
        cc, n = ndi.label(seg == k, structure=structure)
        for c in range(1, n + 1):
            out[cc == c] = nxt
            nxt += 1
    return out


@pytest.mark.parametrize("case", ["cc_on_segmentation", "cc_on_segmentation_random"])
def test_cc_on_segmentation(case, tmp_path, jax_run):
    got = _both(case, tmp_path, jax_run)["cc"]
    seg = _slabs() if case == "cc_on_segmentation" else \
        np.random.default_rng(0).integers(0, 4, (24, 24, 24)).astype(np.uint64)
    assert_labels_equivalent(got, cc_on_seg_oracle(seg))


def test_cc_on_segmentation_full_connectivity(tmp_path, jax_run):
    """Keyed cc at connectivity 3: same-segment voxels touching only
    diagonally (also across block corners) stay one part; different
    segments never merge."""
    got = _both("cc_on_segmentation_full_connectivity", tmp_path, jax_run)["cc"]
    seg = np.random.default_rng(1).integers(0, 3, (32, 32, 32)).astype(np.uint64)
    assert_labels_equivalent(got, cc_on_seg_oracle(seg, ndi.generate_binary_structure(3, 3)))


def test_fill_holes(tmp_path, jax_run):
    got = _both("fill_holes", tmp_path, jax_run)["filled"]
    want = _holes()
    want[8:14, 8:14, 8:14] = 5
    want[10:12, 10:12, 19:21] = 7
    np.testing.assert_array_equal(got, want)
    # true background (outside the objects, border-connected) stays 0
    assert (got[0] == 0).all()


def test_graph_watershed_size_filter(tmp_path, jax_run):
    got = _both("graph_watershed_size_filter", tmp_path, jax_run)["filtered"]
    # sliver absorbed into object 1 (the weak-boundary side)
    assert (got[:, :, 14:16] == 1).all()
    assert (got[:, :, 0:14] == 1).all()
    assert (got[:, :, 16:] == 2).all()


def test_cli_run_and_report(tmp_path, jax_run):
    """The CLI drives a workflow from a json config and reports runtimes."""
    got = _both("cli_run_and_report", tmp_path, jax_run)
    want, _ = ndi.label(got["mask"])
    assert_labels_equivalent(got["labels"], want.astype(np.uint64))
    assert "block_components" in got["tasks"]


def test_cli_configs(tmp_path, jax_run):
    files = _both("cli_configs", tmp_path, jax_run)
    assert "multicut/global.config" in files and "multicut/watershed.config" in files


def test_cli_configs_every_workflow(tmp_path, jax_run):
    """configs works for every ported workflow and writes the reference's
    files (a task-module workflow aggregates its module's task defaults);
    an unported name is refused naming its ROADMAP item."""
    files = _both("cli_configs_every_workflow", tmp_path, jax_run)
    for wf in pcli.PORTED:
        names = [k.split("/", 1)[1] for k in files if k.startswith(wf + "/")]
        assert "global.config" in names and len(names) >= 2 and "base.config" not in names, (wf, names)
    for wf in sorted(set(pcli.WORKFLOWS) - set(pcli.PORTED)):
        with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
            pcli.main(["configs", wf, "--out", str(tmp_path / f"cfg_{wf}")])
    assert sorted(set(pcli.WORKFLOWS) - set(pcli.PORTED)) == ["lifted_multicut", "mutex_watershed", "stitching"]


def test_gpu_tasks_raise_without_a_card(tmp_path):
    """A task or workflow for the card raises where there is none: the
    host-only steps too, and nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from cluster_tools_tpu_torch.tasks import postprocess, transformations

    tmp_folder, config_dir = _workspace(str(tmp_path))
    for cls in (postprocess.HoleVotesGPU, postprocess.GraphWatershedAssignmentsGPU,
                transformations.AffineTransformGPU):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            cls(tmp_folder=tmp_folder, config_dir=config_dir, input_path="x", input_key="y")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        postprocess.FillHolesWorkflow(tmp_folder=tmp_folder, config_dir=config_dir, input_path="x", input_key="y",
                                      output_path="x", output_key="z")
    assert not os.path.exists(os.path.join(tmp_folder, "fill_holes"))
