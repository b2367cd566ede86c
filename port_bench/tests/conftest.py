"""The benchmark's own tests: run with ``python -m pytest port_bench/tests``.

CPU tests run the harness, the drivers and the reference at small sizes;
tests marked ``gpu`` need a card and skip without one (decided inside the
test, never while a module is imported)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips with its reason where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


# every cell of BENCHMARK.json, and the driver its configuration names
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in DOC["workloads"]]
DRIVERS = {w["name"]: json.loads((ROOT / c["file"]).read_text())["driver"]
           for w in DOC["workloads"] for c in DOC["configs"] if c["name"] == w["config"]}
# a traffic mix at CPU size: fewer smoothing passes and one map in a pool
TINY_TRAFFIC = {"passes": 3, "pool": 1}


def make_tiny_root(tmp: Path) -> Path:
    """A checkout with ``BENCHMARK.json`` and a copy of ``port_bench/`` whose
    configurations take the CPU sizes of their own ``tiny`` key and whose
    traffic mixes are cut to :data:`TINY_TRAFFIC`."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp / "port_bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for p in (tmp / "port_bench" / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        p.write_text(json.dumps(_merge(cfg, cfg.get("tiny", {}))))
    for p in (tmp / "port_bench" / "traffic").glob("*.json"):
        traffic = json.loads(p.read_text())
        traffic.update({k: min(traffic[k], v) for k, v in TINY_TRAFFIC.items() if k in traffic})
        p.write_text(json.dumps(traffic))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
