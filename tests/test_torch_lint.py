"""The port's ctlint (``cluster_tools_tpu_torch/lint``) against the
reference's (``cluster_tools_tpu/lint``): the same findings on every shared
fixture and on a fake package tree of each, the port's own CT005 and CT003
forms on ``tests/lint_fixtures_torch/``, the reference's ``tests/test_lint.py``
cases on the port's files, and the port's default walk lint-clean (pure AST,
no device)."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from cluster_tools_tpu.lint import run_lint as ref_run_lint
from cluster_tools_tpu_torch.lint import RULES, collect_files, findings_to_json, run_lint
from cluster_tools_tpu_torch.lint.__main__ import default_paths
from cluster_tools_tpu_torch.lint.__main__ import main as lint_main

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(TESTS)
FIXDIR = os.path.join(TESTS, "lint_fixtures")
PORT_FIXDIR = os.path.join(TESTS, "lint_fixtures_torch")
PORT = os.path.join(REPO_ROOT, "cluster_tools_tpu_torch")

SHARED_FIXTURES = sorted(
    f for f in os.listdir(FIXDIR) if f.endswith(".py") and not f.startswith("ct005_")
)
ALL_RULES = sorted(RULES)


def fixture_path(fname):
    """The port's fixture where its rule differs (CT005), else the shared one."""
    port = os.path.join(PORT_FIXDIR, fname)
    return port if os.path.exists(port) else os.path.join(FIXDIR, fname)


def lint_fixture(fname, **kw):
    return run_lint([fixture_path(fname)], **kw)


def messages(findings, rule):
    return [f.message for f in findings if f.rule == rule]


def keyed(findings):
    return [(f.rule, f.line, f.col, f.message) for f in findings]


def marked_lines(path):
    """Lines of a port fixture marked ``# fires``: one finding each."""
    with open(path) as f:
        return sorted(i for i, line in enumerate(f.read().splitlines(), 1)
                      if line.rstrip().endswith("# fires"))


def port_file(*parts):
    return os.path.join(PORT, *parts)


def assert_passes_unsuppressed(paths, rule):
    for path in paths:
        findings, _ = run_lint([path])
        assert [f for f in findings if f.rule == rule] == [], path
        with open(path) as f:
            assert f"ctlint: disable={rule}" not in f.read(), path


@pytest.fixture(scope="module")
def smoke_lint_doc():
    """The port's default walk, once, as ``chip_smoke.py``'s "lint" phase
    runs it (the CLI with ``--json`` in a subprocess)."""
    sys.path.insert(0, REPO_ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO_ROOT)
    return chip_smoke.phase_lint("cpu")


# -- parity with the reference ------------------------------------------------


@pytest.mark.parametrize("fname", SHARED_FIXTURES)
def test_fixture_parity_with_reference(fname):
    path = os.path.join(FIXDIR, fname)
    ref, ref_stats = ref_run_lint([path])
    port, port_stats = run_lint([path])
    assert keyed(port) == keyed(ref)
    assert port_stats == ref_stats


HOOKS_SRC = (
    "def stage(injector):\n"
    "    injector.maybe_fail('h2d', 0)\n"
    "    injector.maybe_hang('hop', 0)\n"
    "    injector.maybe_fail('dispatch', 0)\n"
    "    injector.maybe_fail('io_raed', 0)\n"
)


def _fake_tree(root, faults_src):
    """The path-dependent fixtures under ``root/{runtime,io}/``, renamed so
    that only their place in the tree (not a fixture name) decides the
    clauses, with ``runtime/faults.py`` copied from a package."""
    for sub in ("runtime", "io"):
        os.makedirs(os.path.join(root, sub))
    shutil.copy(faults_src, os.path.join(root, "runtime", "faults.py"))
    shutil.copy(os.path.join(FIXDIR, "ct008_bad.py"), os.path.join(root, "runtime", "clocks.py"))
    shutil.copy(os.path.join(FIXDIR, "ct011_bad.py"), os.path.join(root, "runtime", "reader.py"))
    shutil.copy(os.path.join(FIXDIR, "ct011_bad.py"), os.path.join(root, "io", "reader.py"))
    shutil.copy(os.path.join(FIXDIR, "ct004_bad.py"), os.path.join(root, "io", "containers.py"))
    with open(os.path.join(root, "runtime", "hooks.py"), "w") as f:
        f.write(HOOKS_SRC)


def _tree_findings(lint, root):
    findings, stats = lint([root])
    out = sorted((f.rule, os.path.relpath(f.file, root), f.line, f.col, f.message) for f in findings)
    return out, stats


def test_path_dependent_clauses_map_one_to_one(tmp_path):
    """CT004's registry, CT008's runtime package and CT011's io package:
    each package's lint reports the same on its own tree, and treats the
    other package's tree as it treats a tree of no package."""
    trees = {}
    for name, faults in (("cluster_tools_tpu", os.path.join(REPO_ROOT, "cluster_tools_tpu", "runtime", "faults.py")),
                         ("cluster_tools_tpu_torch", port_file("runtime", "faults.py")),
                         ("neutral", port_file("runtime", "faults.py"))):
        trees[name] = str(tmp_path / name)
        _fake_tree(trees[name], faults)
    ref_own = _tree_findings(ref_run_lint, trees["cluster_tools_tpu"])
    port_own = _tree_findings(run_lint, trees["cluster_tools_tpu_torch"])
    assert port_own == ref_own
    rules = {r for r, *_ in port_own[0]}
    assert {"CT004", "CT008", "CT011"} <= rules
    own = port_own[0]
    # in its own tree: the registry knows the port's sites, runtime/ bans
    # direct clocks, and io/ may read raw
    unknown = [m.split(" passed to ")[0] for r, _, _, _, m in own if m.startswith("unknown fault site")]
    assert unknown == ["unknown fault site 'io_raed'"] * 2
    assert any(r == "CT008" and p == os.path.join("runtime", "clocks.py") and "time.time()" in m
               for r, p, _, _, m in own)
    assert not any(p == os.path.join("io", "reader.py") for _, p, _, _, _ in own)
    assert any(r == "CT011" and p == os.path.join("runtime", "reader.py") for r, p, _, _, _ in own)
    # each lint sees the other's package as no package at all
    assert _tree_findings(run_lint, trees["cluster_tools_tpu"]) == _tree_findings(run_lint, trees["neutral"])
    assert _tree_findings(ref_run_lint, trees["cluster_tools_tpu_torch"]) == \
        _tree_findings(ref_run_lint, trees["neutral"])
    neutral = _tree_findings(run_lint, trees["neutral"])[0]
    assert any(m.startswith("unknown fault site 'h2d'") for _, _, _, _, m in neutral)
    assert any(p == os.path.join("io", "reader.py") for _, p, _, _, _ in neutral)


def test_lint_is_pure_stdlib():
    """The lint imports only the standard library and itself: neither
    torch nor jax nor the reference package."""
    lint_dir = port_file("lint")
    for fname in sorted(os.listdir(lint_dir)):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(lint_dir, fname)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in sys.stdlib_module_names, (fname, name)


def test_ct005_kernel_entries_match_the_kernels_module():
    """The pinned hand-kernel entries (files outside the package) are the
    public functions of ``ops/kernels.py`` that launch a kernel."""
    from cluster_tools_tpu_torch.lint import rules
    from cluster_tools_tpu_torch.lint.core import LintModule

    inside = rules._kernel_entries(LintModule(port_file("ops", "watershed.py"), ""))
    assert inside == set(rules._DEFAULT_KERNEL_ENTRIES)
    outside = rules._kernel_entries(LintModule(os.path.join(REPO_ROOT, "chip_smoke.py"), ""))
    assert outside == set(rules._DEFAULT_KERNEL_ENTRIES)


# -- every rule fires on its fixture and stays quiet on the clean twin --------


@pytest.mark.parametrize("rule", ALL_RULES)
def test_rule_fires_on_bad_fixture(rule):
    findings, _ = lint_fixture(f"{rule.lower()}_bad.py")
    mine = [f for f in findings if f.rule == rule]
    assert mine, f"{rule} did not fire on its fixture"
    for f in mine:
        assert f.line > 0 and f.message


@pytest.mark.parametrize("rule", ALL_RULES)
def test_rule_quiet_on_clean_fixture(rule):
    findings, _ = lint_fixture(f"{rule.lower()}_clean.py")
    assert [f for f in findings if f.rule == rule] == []


def test_ct001_covers_all_three_call_forms():
    msgs = "\n".join(messages(lint_fixture("ct001_bad.py")[0], "CT001"))
    for form in ("map_blocks", "BlockwiseExecutor", "host_block_map"):
        assert form in msgs


def test_ct001_sharded_path_requires_sweep_mode_knob():
    assert any("['sweep_mode']" in m for m in messages(lint_fixture("ct001_bad.py")[0], "CT001"))


def test_ct001_device_plane_requires_device_pool_knob():
    assert any("['device_pool']" in m for m in messages(lint_fixture("ct001_bad.py")[0], "CT001"))


def test_ct001_sharded_solve_requires_knob_plumbing():
    msgs = messages(lint_fixture("ct001_bad.py")[0], "CT001")
    assert any("solve_with_reduce_tree" in m and "failures_path" in m and "solver_shards" in m for m in msgs)
    assert messages(lint_fixture("ct001_clean.py")[0], "CT001") == []


def test_ct003_finds_cycle_blocking_and_hot_io():
    msgs = messages(lint_fixture("ct003_bad.py")[0], "CT003")
    assert any("lock-order cycle" in m for m in msgs)
    assert any("time.sleep" in m for m in msgs)
    assert any("fut.result" in m for m in msgs)
    assert any("hot lock 'dispatch_lock'" in m for m in msgs)


def test_ct003_port_dispatch_lock_forms():
    """A blocking call and an IO call under each form the port takes a
    card's dispatch lock (called, a bound name, an element of a list or a
    tuple of them) and the device pool's lock (in a conditional), each
    reported; the reference sees none of the bound or subscript forms."""
    path = os.path.join(PORT_FIXDIR, "ct003_dispatch_bad.py")
    findings, _ = run_lint([path], select=["CT003"])
    assert sorted(f.line for f in findings) == marked_lines(path)
    msgs = [f.message for f in findings]
    for held in ("dispatch_lock", "lk", "shard_locks[...]", "card_locks[...]", "lock_for"):
        assert any(m.startswith("blocking call") and f"lock '{held}'" in m for m in msgs), held
        assert any(f"under hot lock '{held}'" in m for m in msgs), held
    ref, _ = ref_run_lint([path], select=["CT003"])
    assert not any("lk" in f.message or "locks[" in f.message for f in ref)
    clean = os.path.join(PORT_FIXDIR, "ct003_dispatch_clean.py")
    assert run_lint([clean], select=["CT003"])[0] == []


def test_ct003_scopes_reduce_tree_merge_queue(tmp_path):
    bad = tmp_path / "reduce_tree.py"
    bad.write_text(
        "import threading\n"
        "merge_lock = threading.Lock()\n"
        "def drain_queue(fut, results, gi):\n"
        "    with merge_lock:\n"
        "        results[gi] = fut.result()\n"
    )
    findings, _ = run_lint([str(bad)])
    assert any(f.rule == "CT003" and "fut.result" in f.message for f in findings)
    findings, _ = run_lint([port_file("parallel", "reduce_tree.py")])
    assert [f for f in findings if f.rule == "CT003"] == []


def test_ct003_executor_dispatch_locks_are_hot():
    """The port's executor takes its cards' dispatch locks as
    ``shard_locks[shard]``: an IO call planted under one is reported."""
    from cluster_tools_tpu_torch.lint.core import LintModule
    from cluster_tools_tpu_torch.lint.rules import ct003_lock_discipline

    path = port_file("runtime", "executor.py")
    with open(path) as f:
        src = f.read()
    anchor = "                        _sync(device)\n                        h2d_s = clock.end(discard=True)\n"
    assert src.count(anchor) == 1
    planted = src.replace(anchor, "                        open('/dev/null').read()\n" + anchor)
    found = ct003_lock_discipline(LintModule(path, planted))
    assert any("under hot lock 'shard_locks[...]'" in f.message for f in found)
    assert ct003_lock_discipline(LintModule(path, src)) == []


def test_ct004_typo_site_and_unhooked_boundary():
    msgs = messages(lint_fixture("ct004_bad.py")[0], "CT004")
    assert any("io_raed" in m for m in msgs)
    assert any("__setitem__" in m for m in msgs)


def test_ct005_timing_and_shard_randomness():
    """Each clause of the port's CT005 fires on its line: unsynchronized
    timings of an imported, a module-qualified and an aliased hand kernel
    and of a shard_map callable; global draws (torch, reseeding, legacy
    numpy, stdlib, in-place) in bodies passed by name, through partial and
    as a lambda."""
    path = os.path.join(PORT_FIXDIR, "ct005_bad.py")
    findings, _ = run_lint([path], select=["CT005"])
    assert sorted(f.line for f in findings) == marked_lines(path)
    msgs = [f.message for f in findings]
    for what in ("hand kernel 'tile_ccl'", "hand kernel 'K.edt_cascade'", "hand kernel 'remap'",
                 "shard_map callable 'fn'"):
        assert any(what in m and "without synchronization" in m for m in msgs), what
    for draw, body in (("torch.rand", "noisy_body"), ("torch.manual_seed", "reseeding_body"),
                       ("torch.randn_like", "reseeding_body"), ("np.random.rand", "legacy_numpy_body"),
                       ("random.random", "stdlib_body"), ("<tensor>.uniform_", "inplace_body"),
                       ("torch.randint", "<lambda:")):
        assert any(f"'{draw}' inside per-shard body '{body}" in m for m in msgs), draw
    assert run_lint([os.path.join(PORT_FIXDIR, "ct005_clean.py")], select=["CT005"])[0] == []


def test_ct005_drops_the_traced_clauses():
    """The reference's jit fixture is quiet under the port's CT005: it has
    no traced-branch, static-argument or trace-time impurity clause, and a
    jitted local function is no device work of the port."""
    findings, _ = run_lint([os.path.join(FIXDIR, "ct005_bad.py")], select=["CT005"])
    assert findings == []


def test_ct006_all_violation_classes():
    msgs = messages(lint_fixture("ct006_bad.py")[0], "CT006")
    assert any("bare 'except:'" in m for m in msgs)
    assert any("except BaseException" in m for m in msgs)
    assert any("os._exit" in m for m in msgs)
    assert any("REQUEUE_EXIT_CODE" in m for m in msgs)


def test_ct007_all_violation_classes():
    msgs = messages(lint_fixture("ct007_bad.py")[0], "CT007")
    assert any("misses spill wiring" in m for m in msgs)
    assert any("never passed to region_verifier" in m for m in msgs)
    assert any("not bound to a name" in m for m in msgs)
    device = [m for m in msgs if "device handoff publish" in m]
    assert any("'producer'" in m for m in device)
    assert sum("'failures_path'" in m for m in device) == 2
    assert any("['shape']" in m for m in msgs)


def test_ct007_real_declaring_tasks_pass_unsuppressed():
    assert_passes_unsuppressed([port_file("tasks", f) for f in ("watershed.py", "connected_components.py",
                                                                 "inference.py", "ilastik.py")], "CT007")


def test_ct009_all_violation_classes():
    msgs = messages(lint_fixture("ct009_bad.py")[0], "CT009")
    assert any("time.sleep" in m for m in msgs)
    assert any("fut.result" in m for m in msgs)
    assert any("storage IO 'json.dump'" in m for m in msgs)
    assert any("atomic_write_json" in m for m in msgs)
    assert any("request_context" in m and "task_context" in m for m in msgs)
    assert any("REQUEUE_EXIT_CODE" in m for m in msgs)


def test_ct009_service_modules_pass_unsuppressed():
    assert_passes_unsuppressed([port_file("runtime", "server.py"), port_file("runtime", "admission.py"),
                                port_file("serve.py")], "CT009")


def test_ct010_all_violation_classes():
    msgs = messages(lint_fixture("ct010_bad.py")[0], "CT010")
    assert any("raw open of the journal file" in m for m in msgs)
    assert any("raw 'write' on journal handle" in m for m in msgs)
    assert any("no os.fsync evidence" in m for m in msgs)
    assert any("while holding server lock" in m for m in msgs)


def test_ct010_journal_surface_passes_unsuppressed():
    assert_passes_unsuppressed([port_file("runtime", "journal.py"), port_file("runtime", "server.py"),
                                port_file("runtime", "admission.py"), port_file("serve.py")], "CT010")


def test_ct012_all_violation_classes():
    msgs = messages(lint_fixture("ct012_bad.py")[0], "CT012")
    assert any("time.sleep" in m for m in msgs)
    assert any("HTTP call 'http.client.HTTPConnection'" in m for m in msgs)
    assert any("HTTP call 'self._member_call'" in m for m in msgs)
    assert any("storage IO 'json.dump'" in m for m in msgs)
    assert any("raw open of a journal path" in m for m in msgs)
    assert any("outside a claim-holding scope" in m for m in msgs)
    assert any("REQUEUE_EXIT_CODE" in m for m in msgs)


def test_ct012_fleet_surface_passes_unsuppressed():
    assert_passes_unsuppressed([port_file("runtime", "fleet.py"), port_file("fleet.py")], "CT012")


def test_ct013_all_violation_classes():
    msgs = messages(lint_fixture("ct013_bad.py")[0], "CT013")
    for what in ("'HTTPConnection'", "'urlopen'", "'create_connection'", "'append_transition'",
                 "'flush_namespace'"):
        assert any(what in m for m in msgs), what


def test_ct013_grayfail_surface_passes_unsuppressed():
    assert_passes_unsuppressed([port_file("runtime", f) for f in ("netio.py", "server.py", "fleet.py", "journal.py")]
                               + [port_file("fleet.py")], "CT013")


def test_ct014_all_violation_classes():
    msgs = messages(lint_fixture("ct014_bad.py")[0], "CT014")
    assert any("'Popen' with no journal-plane" in m for m in msgs)
    assert any("'Popen' with no trace-plane" in m for m in msgs)
    assert any("'drain_emptiest' with no journal-plane" in m for m in msgs)
    assert any("'drain_emptiest' with no trace-plane" in m for m in msgs)
    assert any("process spawn / blocking wait 'subprocess.Popen'" in m for m in msgs)
    assert any("'proc.wait'" in m for m in msgs)
    assert any("'time.sleep'" in m for m in msgs)


def test_ct014_supervisor_surface_passes_unsuppressed():
    assert_passes_unsuppressed([port_file("fleet.py"), port_file("runtime", "fleet.py")], "CT014")


def test_ct015_all_violation_classes():
    msgs = messages(lint_fixture("ct015_bad.py")[0], "CT015")
    assert any("'_wait_npz'" in m for m in msgs)
    assert any("'solve_level'" in m for m in msgs)
    assert any("'collectives_supported'" in m for m in msgs)
    assert any("'silent_degrade' degrades to the packet plane" in m for m in msgs)


def test_ct015_reduce_plane_surface_passes_unsuppressed():
    assert_passes_unsuppressed([port_file("parallel", "reduce_tree.py"), port_file("parallel", "multihost.py")],
                               "CT015")


# -- suppressions, selection, schema, CLI -------------------------------------


def test_suppression_counts_not_reports():
    findings, stats = lint_fixture("ct002_suppressed.py")
    assert [f for f in findings if f.rule == "CT002"] == []
    assert stats["n_suppressed"] == 2


def test_rule_selection_and_unknown_rule():
    findings, _ = lint_fixture("ct006_bad.py", select=["CT002"])
    assert {f.rule for f in findings} <= {"CT002"}
    with pytest.raises(ValueError, match="unknown rule"):
        lint_fixture("ct006_bad.py", select=["CT999"])


def test_syntax_error_is_ct000(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    findings, _ = run_lint([str(bad)])
    assert {f.rule for f in findings} == {"CT000"}


def test_json_document_schema():
    findings, stats = lint_fixture("ct002_bad.py")
    doc = findings_to_json(findings, stats)
    assert doc["version"] == 1
    assert doc["n_files"] == 1
    assert doc["counts"]["CT002"] == len(findings)
    for f in doc["findings"]:
        assert set(f) == {"rule", "file", "line", "col", "message"}
        assert isinstance(f["line"], int) and f["rule"].startswith("CT")


def test_cli_exit_codes_and_json(capsys):
    rc = lint_main([os.path.join(FIXDIR, "ct002_bad.py"), "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and doc["counts"]["CT002"] >= 1
    assert lint_main([os.path.join(FIXDIR, "ct002_clean.py")]) == 0
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "CT003" in out and "CT005  Device work must be timed" in out
    assert lint_main(["--rules", "CT999"]) == 2


def test_failures_report_renders_lint_json(tmp_path):
    """The reference's report script renders the port's document as is."""
    findings, stats = lint_fixture("ct002_bad.py")
    doc_path = tmp_path / "lint.json"
    doc_path.write_text(json.dumps(findings_to_json(findings, stats)))
    proc = subprocess.run([sys.executable, os.path.join(REPO_ROOT, "scripts", "failures_report.py"),
                           "--lint", str(doc_path)], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1
    assert "CT002=3" in proc.stdout and "ct002_bad.py" in proc.stdout


# -- the port's clean gate ----------------------------------------------------


def test_default_walk_is_the_port():
    paths = default_paths()
    names = {os.path.relpath(p, REPO_ROOT) for p in paths}
    assert "cluster_tools_tpu_torch" in names and "chip_smoke.py" in names
    assert all(n == "cluster_tools_tpu_torch" or n == "chip_smoke.py"
               or (n.startswith(os.path.join("scripts", "torch_")) and n.endswith(".py")) for n in names)
    assert any(n.startswith(os.path.join("scripts", "torch_")) for n in names)


def test_repo_lints_clean(smoke_lint_doc):
    """The port's default walk satisfies every contract, through the
    smoke's "lint" phase (the CLI, exit 0)."""
    assert smoke_lint_doc["n_files"] > 80
    assert smoke_lint_doc["findings"] == [] and smoke_lint_doc["counts"] == {}


def test_every_suppression_says_why(smoke_lint_doc):
    """Each ``ctlint: disable`` in the default walk has a comment of its
    own on the lines just above it."""
    seen = 0
    for path in collect_files(default_paths()):
        if os.sep + "lint" + os.sep in path:
            continue  # the lint's own docstrings spell the directive
        with open(path) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if "ctlint: disable" not in line:
                continue
            seen += 1
            above = lines[i - 1].strip()
            assert above.startswith("#") and "ctlint" not in above, f"{path}:{i + 1}"
    assert seen == smoke_lint_doc["n_suppressed"]


def test_hardened_longtail_tasks_pass_ct001_unsuppressed():
    assert_passes_unsuppressed([port_file("tasks", f) for f in ("mutex_watershed.py", "thresholded_components.py")],
                               "CT001")


# -- the runtime contracts behind the lint's findings -------------------------


def test_dump_config_is_atomic(tmp_path):
    from cluster_tools_tpu_torch.utils.task_utils import dump_config

    path = tmp_path / "cfg" / "global.config"
    dump_config(str(path), {"b": 2, "a": 1})
    assert json.loads(path.read_text()) == {"a": 1, "b": 2}
    assert [p for p in os.listdir(path.parent) if ".tmp" in p] == []


def test_cli_maps_drain_to_requeue_exit(tmp_path, monkeypatch):
    from cluster_tools_tpu_torch import cli
    from cluster_tools_tpu_torch.runtime import task as task_mod
    from cluster_tools_tpu_torch.runtime.supervision import REQUEUE_EXIT_CODE, DrainInterrupt

    def draining_build(tasks, rerun=False):
        raise DrainInterrupt("received SIGTERM", [1, 2])

    monkeypatch.setattr(task_mod, "build", draining_build)
    cfg = tmp_path / "run.json"
    cfg.write_text(json.dumps({
        "tmp_folder": str(tmp_path / "tmp"), "config_dir": str(tmp_path / "tmp"), "target": "local",
        "params": {"input_path": "x", "input_key": "k", "output_path": "y", "output_key": "k"},
    }))
    assert cli.main(["run", "relabel", "--config", str(cfg)]) == REQUEUE_EXIT_CODE


def test_debug_reports_written_atomically(tmp_path, monkeypatch):
    from cluster_tools_tpu_torch.utils import function_utils as fu

    calls = []
    real_replace = os.replace

    def spy_replace(src, dst):
        calls.append(dst)
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", spy_replace)
    target = tmp_path / "statistics.json"
    fu.atomic_write_json(str(target), {"count": 1})
    assert str(target) in calls
    assert json.loads(target.read_text()) == {"count": 1}


def _host_task_cls():
    from cluster_tools_tpu_torch.runtime.task import BaseTask

    class T(BaseTask):
        task_name = "lint_hosttask"

        def __init__(self, *a, **kw):
            self.body = kw.pop("body")
            self.knobs = kw.pop("knobs", {})
            super().__init__(*a, **kw)

        def run_impl(self):
            return {"n": self.host_block_map(range(self.knobs.pop("n_blocks", 4)), self.body, **self.knobs)}

    return T


def test_host_block_map_retries_transient_failures(tmp_path):
    attempts = {}

    def flaky(block_id):
        attempts[block_id] = attempts.get(block_id, 0) + 1
        if block_id == 1 and attempts[block_id] == 1:
            raise OSError("transient storage hiccup")

    t = _host_task_cls()(str(tmp_path / "tmp"), "", max_jobs=2, body=flaky)
    t.run()
    assert attempts[1] == 2
    assert t.blocks_done() == [0, 1, 2, 3]
    assert not os.path.exists(t.failures_path)


def test_host_block_map_verify_retry_repairs(tmp_path):
    from cluster_tools_tpu_torch.utils.volume_utils import Blocking

    blocking = Blocking((4, 4, 4), (2, 2, 2))
    wrote, verified = [], {}

    def verify(block):
        n = verified.get(block.block_id, 0) + 1
        verified[block.block_id] = n
        if block.block_id == 2 and n == 1:
            raise RuntimeError("digest mismatch (corrupt chunk)")

    t = _host_task_cls()(str(tmp_path / "tmp"), "", max_jobs=1, body=wrote.append,
                         knobs={"n_blocks": 8, "store_verify_fn": verify, "blocking": blocking})
    t.run()
    assert wrote.count(2) == 2
    assert len(t.blocks_done()) == 8


def test_host_block_map_morton_schedule(tmp_path):
    from cluster_tools_tpu_torch.runtime.executor import morton_order
    from cluster_tools_tpu_torch.utils.volume_utils import Blocking

    blocking = Blocking((4, 4, 4), (2, 2, 2))
    order = []
    t = _host_task_cls()(str(tmp_path / "tmp"), "", max_jobs=1, body=order.append,
                         knobs={"n_blocks": 8, "blocking": blocking})
    t.run()
    assert order == [int(b.block_id) for b in morton_order([blocking.get_block(i) for i in range(8)])]
