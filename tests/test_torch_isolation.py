"""The torch port stands alone: no module of ``cluster_tools_tpu_torch`` and
not ``chip_smoke.py`` imports JAX or the JAX package, importing the port
leaves JAX unloaded, and the port never drifts onto the CPU unasked."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "cluster_tools_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "cluster_tools_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def _import_every_port_module_and_assert(check: str):
    code = (
        "import sys, importlib, pkgutil\n"
        "import cluster_tools_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"{check}\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_importing_the_port_leaves_jax_unloaded():
    _import_every_port_module_and_assert(
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cluster_tools_tpu')]\n"
        "assert not bad, bad")


def test_importing_the_port_leaves_h5py_unloaded():
    """The card's machine has no h5py: the HDF5 container imports it only
    when a file is opened."""
    _import_every_port_module_and_assert("assert 'h5py' not in sys.modules")


def test_default_device_raises_without_a_gpu(monkeypatch):
    from cluster_tools_tpu_torch.ops.tile_ccl import label_components_tiled
    from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mask = torch.zeros((8, 8, 128), dtype=torch.bool)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        label_components_tiled(mask)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_ws_ccl_split()
    lab, ovf = label_components_tiled(mask, device="cpu")
    assert lab.device.type == "cpu" and not ovf


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """Without a card the smoke script exits non-zero and prints no result."""
    code = (
        "import runpy, sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        f"sys.argv = ['chip_smoke.py']\n"
        f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("module", ["parallel/mesh.py", "parallel/spmd.py", "parallel/halo.py", "parallel/reshard.py",
                                    "parallel/distributed_ccl.py", "parallel/distributed_edt.py",
                                    "parallel/pipeline.py", "parallel/split_pipeline.py", "parallel/multihost.py"])
def test_mesh_modules_are_checked(module):
    """The mesh slice's modules are among the files held above."""
    assert ROOT / "cluster_tools_tpu_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", ["models/__init__.py", "models/unet.py", "models/flax_import.py",
                                    "models/torch_import.py", "tasks/inference.py", "tasks/ilastik.py"])
def test_prediction_modules_are_checked(module):
    """The prediction slice's modules are among the files held above."""
    assert ROOT / "cluster_tools_tpu_torch" / module in PORT_FILES


def test_prediction_entry_points_default_to_the_card(monkeypatch, tmp_path):
    import numpy as np

    from cluster_tools_tpu_torch.ops.filters import gradient_magnitude, hessian_eigenvalues
    from cluster_tools_tpu_torch.tasks.ilastik import IlastikPredictionWorkflow
    from cluster_tools_tpu_torch.tasks.inference import InferenceWorkflow

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = np.zeros((8, 8, 8), np.float32)
    for wf in (InferenceWorkflow, IlastikPredictionWorkflow):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            wf(tmp_folder=str(tmp_path / "tmp"), config_dir=str(tmp_path))
    for fn in (gradient_magnitude, hessian_eigenvalues):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(vol, 1.0)
        assert fn(vol, 1.0, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("module", ["parallel/batch_shard.py", "parallel/block_pool.py", "parallel/device_pool.py"])
def test_sweep_plane_modules_are_checked(module):
    """The sweep plane's modules are among the files held above."""
    assert ROOT / "cluster_tools_tpu_torch" / module in PORT_FILES


def test_sweep_plane_entry_points_default_to_the_card(monkeypatch):
    import numpy as np

    from cluster_tools_tpu_torch.parallel.batch_shard import sharded_slab_sweep
    from cluster_tools_tpu_torch.runtime.executor import BlockwiseExecutor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = np.zeros((8, 4, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded_slab_sweep(vol, lambda x: x, extent=4, halo=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockwiseExecutor()
    out = sharded_slab_sweep(vol, lambda x: x, extent=4, halo=1, device="cpu")
    assert out.shape == (2, 6, 4, 4)


@pytest.mark.parametrize("module", ["parallel/reduce_tree.py", "parallel/mesh.py", "parallel/multihost.py",
                                    "ops/contraction.py", "tasks/fused.py", "tasks/multicut.py",
                                    "tasks/agglomerative_clustering.py"])
def test_reduce_tree_modules_are_checked(module):
    """The reduce tree's and the fused task's modules are among the files
    held above."""
    assert ROOT / "cluster_tools_tpu_torch" / module in PORT_FILES


def test_reduce_tree_entry_points_default_to_the_card(monkeypatch):
    import numpy as np

    from cluster_tools_tpu_torch.parallel.mesh import sibling_mesh, visible_shards
    from cluster_tools_tpu_torch.parallel.reduce_tree import sharded_solve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("CTT_MESH_SHARDS", raising=False)
    edges = np.array([[0, 1], [1, 2]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded_solve(3, edges, np.ones(2), np.array([0, 0, 1]), reduce_plane="packet")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sibling_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        visible_shards()
    labels, _ = sharded_solve(3, edges, np.ones(2), np.array([0, 0, 1]), reduce_plane="packet", device="cpu")
    assert len(set(labels.tolist())) == 1
    assert visible_shards("cpu") == 1


@pytest.mark.parametrize("module", ["native.py", "build.py", "ops/host.py", "ops/mws.py", "ops/unionfind.py",
                                    "ops/multicut.py", "ops/rag.py", "ops/contraction.py", "parallel/reduce_tree.py",
                                    "tasks/watershed.py"])
def test_host_rung_modules_are_checked(module):
    """The host C++ rung's bindings and callers are among the files held
    above, and the library's source is the port's own."""
    assert ROOT / "cluster_tools_tpu_torch" / module in PORT_FILES
    assert (ROOT / "cluster_tools_tpu_torch" / "csrc" / "ct_native.cpp").exists()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_names_no_path_under_native(path):
    """No port module builds a path to the JAX package's library or its
    source (``native/ct_native.cpp``, ``native/libct_native.so``): the port
    builds its own copy into ``.torch_ext/``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    consts = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    bad = [c for c in consts if "libct_native.so" in c or c.lstrip("./").startswith("native/")]
    assert not bad, f"{path.name} names {bad}"
