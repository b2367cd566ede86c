"""The benchmark's loop: find a cell's files by name, set up, measure a
window, check what the window produced against the plain reference, and
assemble the result line.

Everything that belongs to one configuration, traffic mix, driver or
metric sits in a file of its own under ``port_bench/``, found by the name
``BENCHMARK.json`` gives it:

- ``configs/<file>``: the configuration (``file`` in ``BENCHMARK.json``);
  its ``driver`` key names the driver;
- ``traffic/<traffic>.json``: the mix's parameters;
- ``drivers/<driver>.py``: a ``Driver`` class (set-up, one unit of work,
  the readings of a traced run, the check);
- ``metrics/<metric>.py``: ``read(ctx)``, the metric's number or None.
"""

from __future__ import annotations

import importlib.util
import json
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cluster_tools_tpu")


class Spec:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path, doc: Optional[dict] = None):
        self.root = Path(root)
        self.doc = doc if doc is not None else json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / self.doc["paths"][0]

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: dict, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        metrics: those that list the cell, or list none and move a metric
        the cell reports."""
        e2e = [m for m in self.doc["end_to_end"] if "workloads" not in m or cell["name"] in m["workloads"]]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.doc["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in moved)]

    def reader(self, metric: str):
        return _load(self.bench / "metrics" / f"{metric}.py", f"port_bench_metric_{metric}").read

    def driver(self, name: str):
        return _load(self.bench / "drivers" / f"{name}.py", f"port_bench_driver_{name}").Driver


def _load(path: Path, mod_name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    if str(path.parent.parent) not in sys.path:
        sys.path.insert(0, str(path.parent.parent))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``cluster_tools_tpu_torch`` is not ``cluster_tools_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.splitlines()[0].strip())
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(spec: Spec, workload: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> Tuple[dict, List[Tuple[str, float, float]]]:
    """One run of one cell: ``(result line, checks)``.  ``t_start`` is the
    host clock at the process's start (set-up counts from it)."""
    import torch

    cell = spec.cell(workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    drv = spec.driver(config["driver"])(config, traffic, seed, device, trace)
    drv.setup()
    drv.sync()
    setup_s = time.perf_counter() - t_start

    units = failed = 0
    profile = {}
    profile_at = int(traffic.get("profile_after_units", 1))
    profile_n = int(traffic.get("profile_units", 1))
    drv.begin_window()
    t0 = time.perf_counter()
    while True:
        if trace and units == profile_at and not profile:
            from trace_tools import profile_units

            done = []

            def run_units():
                for k in range(profile_n):
                    done.append(drv.unit(units + k))

            profile = profile_units(run_units) or {"empty": True}
            failed += sum(bool(f) for f in done)
            units += len(done)
        else:
            failed += bool(drv.unit(units))
            units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    layers = drv.end_window()
    cards = drv.devices()
    peak = max(torch.cuda.max_memory_allocated(d) for d in cards) if cards[0].type == "cuda" else 0
    drv.release()
    checks = drv.check()

    ctx = dict(setup_s=setup_s, window_s=window_s, units=units, voxels=units * drv.voxels_per_unit,
               profile=profile, **layers)
    metrics = {}
    for m in spec.metrics(cell, trace):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cards[0].type == "cuda" else cards[0].type,
           "kind": torch.cuda.get_device_name(cards[0]) if cards[0].type == "cuda" else "cpu",
           "count": len(cards), "memory_peak_bytes": int(peak),
           "power_limit_w": power_limit_w() if cards[0].type == "cuda" else None}
    result = {"correct": all(v <= lim for _, v, lim in checks), "attempted": units, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and profile.get("busy_s"):
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        result["breakdown"] = {"device_ops": profile["device_ops"], "idle_gaps": profile["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result, checks


class Reservoir:
    """Keeps, for each key, one unit's output drawn uniformly from the seed
    among the units of that key (so no unit knows whether it is checked)."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed * 7919 + 17)
        self.kept: Dict[object, object] = {}
        self.seen: Dict[object, int] = {}

    def offer(self, key, value):
        """Keep ``value`` or not; returns what is dropped (the value
        replaced, or ``value`` itself), None when nothing is."""
        self.seen[key] = self.seen.get(key, 0) + 1
        if self._rng.random() * self.seen[key] < 1.0:
            dropped = self.kept.get(key)
            self.kept[key] = value
            return dropped
        return value
