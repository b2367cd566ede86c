"""The harness on the CPU: its files parse, a cell added as files is found
with no edit, nothing loads JAX, the work counts, the trace reduction, and
each cell run end to end at a small size."""

import ast
import json
import shutil
import time
from pathlib import Path

import pytest

import harness
import work_counts
from conftest import BENCH, CELLS, ROOT
from trace_tools import reduce_trace

# the keys the benchmark's contract gives BENCHMARK.json, no more and no fewer
CONTRACT_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.mark.parametrize("root", ["checkout", "at CPU sizes"])
def test_every_file_of_the_benchmark_parses(root, tiny_root):
    spec = harness.Spec(ROOT if root == "checkout" else tiny_root)
    assert set(spec.doc) == CONTRACT_KEYS
    for cell in spec.doc["workloads"]:
        cfg = spec.config(cell["config"])
        assert (BENCH / "drivers" / f"{cfg['driver']}.py").is_file()
        assert cfg["limits"] and all(v >= 0 for v in cfg["limits"].values())
        assert spec.traffic(cell["traffic"])["pool"] >= 1
        names = [m["name"] for m in spec.metrics(cell, False) + spec.metrics(cell, True)]
        assert "setup_s" in names and len(names) >= 3
        for name in names:
            assert callable(spec.reader(name))
    for m in spec.doc["per_layer"]:
        assert m["moves"] in {e["name"] for e in spec.doc["end_to_end"]}
        assert set(m["workloads"]) <= {w["name"] for w in spec.doc["workloads"]}


def test_a_cell_added_as_files_is_found_with_no_edit(tiny_root):
    bench = tiny_root / "port_bench"
    cfg = json.loads((bench / "configs" / "ws_cc_step_512.json").read_text())
    cfg["volume_shape"] = [32, 40, 40]
    (bench / "configs" / "ws_cc_step_small.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "pool1.rough.json").write_text(json.dumps({"pool": 1, "passes": 2}))
    (bench / "metrics" / "steps_in_window.py").write_text("def read(ctx):\n    return ctx['units']\n")
    doc = json.loads((tiny_root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "ws_cc_step_small", "source": "a test", "file": "port_bench/configs/ws_cc_step_small.json",
                           "reduced": [], "why": "a test"})
    doc["workloads"].append({"name": "ws_cc_step.small", "config": "ws_cc_step_small", "traffic": "pool1.rough",
                             "chips": 1, "why": "a test"})
    doc["end_to_end"][1]["workloads"].append("ws_cc_step.small")
    doc["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                             "source": "host_clock", "layer": "device", "moves": "step_voxels_per_s",
                             "workloads": ["ws_cc_step.small"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(doc))
    spec = harness.Spec(tiny_root)
    res, _ = harness.run_cell(spec, "ws_cc_step.small", 5, 0.5, True, "cpu", time.perf_counter())
    assert res["correct"] and res["attempted"] >= 1
    assert res["metrics"]["steps_in_window"]["value"] == res["attempted"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package_and_the_reference_not_the_port():
    forbidden = set(harness.FORBIDDEN)
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & forbidden, (path, tops & forbidden)
        if "reference" in path.parts:
            assert "cluster_tools_tpu_torch" not in tops, path


def test_the_module_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "cluster_tools_tpu_torch_probe", types.ModuleType("p"))
    assert "cluster_tools_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cluster_tools_tpu.probe", types.ModuleType("p"))
    assert "cluster_tools_tpu" in harness.forbidden_modules()


@pytest.mark.parametrize("name,shapes,live,want_bytes,want_ops", [
    ("tile_ccl", {"n": 1000, "itemsize": 1}, 0, 5000, 0.0),
    ("tile_ccl_doubling", {"n": 64, "itemsize": 4}, 0, 512, 0.0),
    ("tile_ws_propagate", {"n": 100, "itemsize": 4}, 0, 1200, 0.0),
    ("edt_cascade", {"n": 10, "itemsize": 4, "radius": 5}, 0, 80, 150 / work_counts.FP32_OPS_PER_S),
    ("apply_remap", {"n": 4096, "itemsize": 4, "slots": 128, "rows": 2}, 1,
     4096 * 8 + 128 * 8, 4 * 2048 / work_counts.INT32_OPS_PER_S),
])
def test_the_frozen_work_counts_against_hand_counts(name, shapes, live, want_bytes, want_ops):
    nbytes, t_ops = work_counts.call_work(name, shapes, live)
    assert nbytes == want_bytes and t_ops == pytest.approx(want_ops, rel=1e-12)
    assert work_counts.least_seconds(name, shapes, live) == max(want_bytes / 3.35e12, want_ops)


def test_the_reservoir_keeps_one_output_a_key_drawn_from_the_seed():
    picks = []
    for seed in range(200):
        r = harness.Reservoir(seed)
        dropped = [r.offer(i % 2, i) for i in range(10)]
        assert set(r.kept) == {0, 1} and r.seen == {0: 5, 1: 5}
        # everything offered is either kept or handed back exactly once
        assert sorted([d for d in dropped if d is not None] + list(r.kept.values())) == list(range(10))
        picks.append(r.kept[0])
    assert set(picks) == {0, 2, 4, 6, 8}
    assert harness.Reservoir(7).offer(0, "a") is None


def test_the_trace_reduction_unions_device_time_and_names_gaps():
    ms = 1_000_000
    events = [
        ("port_bench.window", False, -1, 1, 0, 100 * ms),
        ("step", False, -1, 1, 0, 100 * ms),
        ("host_wait", False, -1, 1, 40 * ms, 60 * ms),
        ("k1", True, 0, 0, 10 * ms, 30 * ms),
        ("k2", True, 0, 0, 20 * ms, 40 * ms),
        ("k1", True, 0, 0, 60 * ms, 90 * ms),
    ]
    got = reduce_trace(events)
    assert got["window_s"] == pytest.approx(0.1) and got["busy_s"] == pytest.approx(0.06)
    assert dict(got["device_ops"]) == pytest.approx({"k1": 0.05, "k2": 0.02})
    assert dict(got["idle_gaps"]) == pytest.approx({"step": 0.02, "host_wait": 0.02})


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_end_to_end_on_the_cpu(tiny_root, cell):
    spec = harness.Spec(tiny_root)
    res, checks = harness.run_cell(spec, cell, 2**33 + 7, 2.0, False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] >= 1
    # every limit of the configuration's file is held against a number the run compared
    assert set(spec.config(spec.cell(cell)["config"])["limits"]) <= {name for name, _, _ in checks}
    assert set(res["metrics"]) == {m["name"] for m in spec.metrics(spec.cell(cell), False)}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_a_checkout_without_the_program_or_a_card_prints_no_result(tmp_path):
    import subprocess
    import sys

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()


def test_kernel_names_lose_their_template_and_argument_lists():
    from trace_tools import short_name

    assert short_name("void at::native::k<128, 8>(int, float)") == "at::native::k"
    assert short_name("ct_tile_ccl_kernel(int const*)") == "ct_tile_ccl_kernel"
    assert short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
