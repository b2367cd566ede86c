"""The port's cluster targets (``runtime/cluster.py``,
``runtime/cluster_runner.py``) against the JAX package's, on the CPU.

- The reference's ``tests/test_cluster_target.py`` case for case: stub
  ``sbatch``/``squeue``/``scancel`` (``tests/helpers.py::stub_slurm_bins``)
  and ``bsub``/``bjobs`` run each job as a detached local process, so the
  submission, supervision and result machinery is real.  The port's jobs
  are torch processes; their outputs are held bit for bit against the JAX
  package's in-process ``local`` run of the same task.
  ``ThresholdedComponentsWorkflow`` with the size filter runs on ``lsf``
  here (``tests/test_torch_ingest_tasks.py`` runs it on ``slurm``).
- The supervisor (the reference's ``tests/test_supervision.py:580-747``
  and ``tests/test_degradation.py:490-553``): a scripted fake scheduler
  drives both packages' ``supervise_job`` through the same scenario — a
  job the scheduler claims runs but that never heartbeats, a dead
  heartbeat pid, a job that vanishes, the resubmission budget running
  out, a ``job_loss`` fault, a preempted job requeued under its own
  budget and that budget running out.  Each leaves the same
  ``supervisor.log`` lines and ``failures.json`` records in both packages
  (the seconds and pids a run measures masked).
"""

import json
import os
import re
import socket
import stat
import subprocess
import sys
import time

import numpy as np
import pytest
import scipy.ndimage as ndi

import cluster_tools_tpu.runtime.cluster as jcluster
from cluster_tools_tpu.runtime import faults as jfaults
from cluster_tools_tpu.runtime import supervision as jsupervision
from cluster_tools_tpu.runtime.task import build as jbuild
from cluster_tools_tpu.tasks import thresholded_components as jtc
from cluster_tools_tpu.utils.volume_utils import file_reader as j_reader
import cluster_tools_tpu_torch.runtime.cluster as pcluster
from cluster_tools_tpu_torch.runtime import faults as pfaults
from cluster_tools_tpu_torch.runtime import supervision as psupervision
from cluster_tools_tpu_torch.runtime.task import build, get_task_cls
from cluster_tools_tpu_torch.tasks import thresholded_components as tc
from cluster_tools_tpu_torch.utils import function_utils as fu
from cluster_tools_tpu_torch.utils.volume_utils import file_reader

from .helpers import stub_slurm_bins

SIDES = {"port": (pcluster, pfaults, psupervision), "jax": (jcluster, jfaults, jsupervision)}


@pytest.fixture(autouse=True)
def _fresh_faults():
    for f in (pfaults, jfaults):
        f.configure(None)
    yield
    for f in (pfaults, jfaults):
        f.configure(None)


@pytest.fixture
def workspace(tmp_path):
    tmp_folder = str(tmp_path / "tmp")
    config_dir = str(tmp_path / "config")
    os.makedirs(config_dir, exist_ok=True)
    with open(os.path.join(config_dir, "global.config"), "w") as f:
        json.dump({"block_shape": [16, 16, 16]}, f)
    return tmp_folder, config_dir, str(tmp_path)


def _write_stub(path, body):
    with open(path, "w") as f:
        f.write("#!/bin/bash\n" + body)
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)


@pytest.fixture
def fake_slurm(tmp_path, monkeypatch):
    """Stub sbatch/squeue/scancel: sbatch launches the script detached and
    prints its pid as the job id; squeue prints a row while it lives."""
    bindir = stub_slurm_bins(str(tmp_path / "fakebin"))
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    return bindir


@pytest.fixture
def fake_lsf(tmp_path, monkeypatch):
    """Stub bsub/bjobs: bsub reads the script from stdin, launches it
    detached, and prints 'Job <pid> is ...'; bjobs prints a RUN row while
    the process lives and 'is not found' after."""
    bindir = tmp_path / "fakebin_lsf"
    bindir.mkdir()
    _write_stub(
        str(bindir / "bsub"),
        "script=$(mktemp)\ncat > \"$script\"\n"
        "out=/dev/null\n"
        'prev=""\n'
        'for a in "$@"; do if [ "$prev" = "-o" ]; then out="$a"; fi; '
        'prev="$a"; done\n'
        'setsid bash "$script" > "$out" 2>&1 &\n'
        'echo "Job <$!> is submitted to default queue."\n',
    )
    _write_stub(
        str(bindir / "bjobs"),
        'pid="${@: -1}"\n'
        'if kill -0 "$pid" 2>/dev/null; then\n'
        '  echo "$pid user RUN normal host1 host2 jobname"\n'
        "else\n"
        '  echo "Job <$pid> is not found" >&2\n'
        "  exit 255\n"
        "fi\n",
    )
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    return str(bindir)


# fast polling: the stubs run on the local filesystem, no NFS lag to wait out
FAST = dict(poll_interval_s=0.2, submit_timeout_s=240, result_grace_s=2.0)


def _raw(root, name, data):
    paths = {}
    for side, reader in (("port", file_reader), ("jax", j_reader)):
        paths[side] = os.path.join(root, f"{name}_{side}.zarr")
        reader(paths[side]).require_dataset("raw", shape=data.shape, chunks=(16, 16, 16),
                                            dtype="float32")[...] = data
    return paths


def _jax_threshold(root, config_dir, path):
    t = jtc.ThresholdLocal(tmp_folder=os.path.join(root, "jtmp"), config_dir=config_dir, max_jobs=2,
                           input_path=path, input_key="raw", output_path=path, output_key="mask", threshold=0.5,
                           block_shape=[16, 16, 16])
    assert jbuild([t])
    return np.asarray(j_reader(path)["mask"][:])


@pytest.mark.parametrize("flavor", ["lsf", "slurm"])
def test_threshold_task_on_cluster_target(rng, workspace, request, flavor):
    """A real task class runs via target='slurm' / 'lsf': spec + batch
    script are written, the (stub) scheduler executes the port's runner
    remotely, the submitter polls to completion; the mask equals the JAX
    package's local run.  LSF: bsub takes the script on stdin, bjobs rows
    are parsed, 'is not found' means finished.  The chunk IO ran in the
    worker process, which recorded its own io_metrics delta."""
    request.getfixturevalue(f"fake_{flavor}")
    tmp_folder, config_dir, root = workspace
    data = rng.random((24, 24, 24)).astype(np.float32)
    paths = _raw(root, "cl", data)
    cls = get_task_cls(tc, "Threshold", flavor)
    assert cls.target == flavor and issubclass(cls, tc.ThresholdLocal)
    assert cls.__name__ == {"lsf": "ThresholdLSF", "slurm": "ThresholdSlurm"}[flavor]
    t = cls(tmp_folder=tmp_folder, config_dir=config_dir, max_jobs=2, input_path=paths["port"], input_key="raw",
            output_path=paths["port"], output_key="mask", threshold=0.5, block_shape=[16, 16, 16], **FAST)
    assert build([t])
    got = np.asarray(file_reader(paths["port"])["mask"][:])
    np.testing.assert_array_equal(got, _jax_threshold(root, config_dir, paths["jax"]))
    np.testing.assert_array_equal(got, (data > 0.5).astype(np.uint8))
    cdir = os.path.join(tmp_folder, "cluster")
    scripts = [s for s in os.listdir(cdir) if s.endswith(".sh")]
    assert scripts == [f"{t.uid}.sh"]
    with open(os.path.join(cdir, scripts[0])) as fh:
        script = fh.read()
    assert "cluster_tools_tpu_torch.runtime.cluster_runner" in script and "CTT_HANDOFF=0" in script
    assert json.load(open(os.path.join(cdir, f"{t.uid}.spec.json")))["cls"] == "ThresholdLocal"
    io_doc = json.load(open(fu.io_metrics_path(tmp_folder)))
    worker = io_doc["tasks"][t.uid]
    assert worker["misses"] > 0 or worker["direct_reads"] > 0


def test_cluster_remote_failure_surfaces(workspace, fake_slurm):
    """A remote crash must fail the task with the remote error, not hang
    or succeed silently."""
    tmp_folder, config_dir, root = workspace
    cls = get_task_cls(tc, "Threshold", "slurm")
    t = cls(tmp_folder=tmp_folder, config_dir=config_dir, max_jobs=1,
            input_path=os.path.join(root, "missing.zarr"),  # the remote will crash
            input_key="raw", output_path=os.path.join(root, "out.zarr"), output_key="mask", threshold=0.5,
            block_shape=[16, 16, 16], **FAST)
    assert not build([t])
    result = json.load(open(os.path.join(tmp_folder, "cluster", f"{t.uid}.result.json")))
    assert result["ok"] is False and "Traceback" in result["traceback"]


def test_thresholded_components_workflow_on_lsf_equals_reference(workspace, fake_lsf):
    """Threshold -> cc -> size filter with every task an LSF job: equal
    to the JAX package's in-process local run bit for bit."""
    tmp_folder, config_dir, root = workspace
    vol = ndi.gaussian_filter(np.random.default_rng(3).random((32, 32, 32)), 1.5).astype(np.float32)
    thr = float(np.quantile(vol, 0.55))
    paths = _raw(root, "tcw", vol)
    common = dict(config_dir=config_dir, max_jobs=2, input_key="raw", output_key="labels", threshold=thr,
                  min_size=10, block_shape=[16, 16, 16])
    from cluster_tools_tpu_torch.tasks.thresholded_components import ThresholdedComponentsWorkflow

    with open(os.path.join(config_dir, "global.config"), "w") as f:
        json.dump(dict({"block_shape": [16, 16, 16]}, **FAST), f)
    wf = ThresholdedComponentsWorkflow(tmp_folder=tmp_folder, target="lsf", input_path=paths["port"],
                                       output_path=paths["port"], **common)
    assert build([wf])
    jwf = jtc.ThresholdedComponentsWorkflow(tmp_folder=os.path.join(root, "jtmp"), target="local",
                                            input_path=paths["jax"], output_path=paths["jax"], **common)
    assert jbuild([jwf])
    got = np.asarray(file_reader(paths["port"])["labels"][:])
    np.testing.assert_array_equal(got, np.asarray(j_reader(paths["jax"])["labels"][:]))
    assert got.max() > 1
    jobs = [s for s in os.listdir(os.path.join(tmp_folder, "cluster")) if s.endswith(".result.json")]
    assert len(jobs) >= 8  # every task of the chain ran as a job


@pytest.mark.parametrize("side", ["port", "jax"])
def test_is_running_tristate(side, monkeypatch):
    """Probe semantics: running row -> True, clean empty -> False, purged
    job ('Invalid job id' after MinJobAge) -> False, any other nonzero
    exit -> None (unknown)."""
    cl = SIDES[side][0]

    def with_probe(stdout, stderr, rc, fn):
        class R:
            pass
        R.stdout, R.stderr, R.returncode = stdout, stderr, rc
        monkeypatch.setattr(cl.subprocess, "run", lambda *a, **k: R())
        return fn()

    s = cl.SlurmSubmitter()
    assert with_probe("123 RUNNING\n", "", 0, lambda: s.is_running("123")) is True
    assert with_probe("", "", 0, lambda: s.is_running("123")) is False
    assert with_probe("", "slurm_load_jobs error: Invalid job id specified\n", 1,
                      lambda: s.is_running("123")) is False
    assert with_probe("", "socket timed out\n", 1, lambda: s.is_running("123")) is None
    b = cl.LSFSubmitter()
    assert with_probe("123  user  RUN  q  h1 h2 jn\n", "", 0, lambda: b.is_running("123")) is True
    assert with_probe("123  user  DONE  q  h1 h2 jn\n", "", 0, lambda: b.is_running("123")) is False
    assert with_probe("", "Job <123> is not found\n", 255, lambda: b.is_running("123")) is False
    assert with_probe("", "lsf comm failure\n", 255, lambda: b.is_running("123")) is None


def test_spec_serialization_rejects_unserializable():
    """Numpy params coerce to plain values; arbitrary objects fail at
    SUBMIT time with a clear error, not stringified on the remote node."""
    doc = {"t": np.float32(0.5), "n": np.int64(3), "a": np.arange(2)}
    assert json.dumps(doc, default=pcluster._spec_default) == json.dumps(doc, default=jcluster._spec_default)
    assert json.loads(json.dumps(doc, default=pcluster._spec_default)) == {"t": 0.5, "n": 3, "a": [0, 1]}
    with pytest.raises(TypeError, match="not JSON-serializable"):
        json.dumps({"bad": object()}, default=pcluster._spec_default)


def test_submitter_command_lines(monkeypatch):
    """The sbatch/bsub command construction equals the reference's: the
    resource knobs map to the scheduler's flags."""
    cmds = {}
    cfg = {"partition": "gpu", "time_limit": 90, "mem_limit": 8, "qos": "hi"}
    for side in SIDES:
        cl = SIDES[side][0]

        def fake_run(cmd, _side=side, **kw):
            cmds.setdefault(_side, []).append(cmd)

            class R:
                stdout = "123\n" if cmd[0] == "sbatch" else "Job <77> is submitted to queue <q>.\n"
                stderr = ""
                returncode = 0
            return R()

        monkeypatch.setattr(cl.subprocess, "run", fake_run)
        assert cl.SlurmSubmitter().submit("/x/job.sh", "job", "/x/out", cfg) == "123"
        script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers.py")
        assert cl.LSFSubmitter().submit(script, "job", "/x/out", cfg) == "77"
    assert cmds["port"] == cmds["jax"]
    cmd = cmds["port"][0]
    assert cmd[:2] == ["sbatch", "--parsable"] and cmd[-1] == "/x/job.sh"
    assert cmd[cmd.index("-p") + 1] == "gpu" and cmd[cmd.index("-t") + 1] == "90"
    assert cmd[cmd.index("--mem") + 1] == "8192M" and cmd[cmd.index("--qos") + 1] == "hi"
    assert cmds["port"][1][:3] == ["bsub", "-J", "job"]


def test_workflow_accepts_cluster_target(workspace):
    """WorkflowBase accepts target='slurm'/'lsf' and asks for no device;
    an unknown target is refused."""
    from cluster_tools_tpu_torch.tasks.thresholded_components import ThresholdedComponentsWorkflow

    tmp_folder, config_dir, root = workspace
    kw = dict(tmp_folder=tmp_folder, config_dir=config_dir, max_jobs=1, input_path="/nonexistent",
              input_key="raw", output_path="/nonexistent", output_key="out", threshold=0.5, assignment_key="a")
    for flavor in ("slurm", "lsf"):
        wf = ThresholdedComponentsWorkflow(target=flavor, **kw)
        assert wf.target == flavor
        (cc,) = wf.requires()
        assert cc.target == flavor
    with pytest.raises(ValueError, match="unknown target"):
        ThresholdedComponentsWorkflow(target="pbs", **kw)


# -- the supervisor: lost jobs, resubmission, preemption ------------------------------------------


class _ScriptedSubmitter:
    """Fake scheduler: each submit() runs the next scripted behavior;
    is_running reports what the script says (the scheduler can lie)."""

    flavor = "scripted"

    def __init__(self, behaviors):
        self.behaviors = list(behaviors)
        self.submits = 0
        self.cancelled = []
        self._running = {}

    def submit(self, script_path, job_name, out_path, cfg):
        b = self.behaviors[min(self.submits, len(self.behaviors) - 1)]
        self.submits += 1
        job_id = f"j{self.submits}"
        self._running[job_id] = b.get("running", True)
        if b.get("action"):
            b["action"]()
        return job_id

    def is_running(self, job_id):
        return self._running.get(job_id, False)

    def cancel(self, job_id):
        self.cancelled.append(job_id)


UID = "task.abcd1234"
SUP_CFG = {"poll_interval_s": 0.05, "result_grace_s": 0.2, "heartbeat_timeout_s": 0.4,
           "heartbeat_interval_s": 0.05, "max_resubmits": 2, "submit_timeout_s": 60}


def _write_result(path):
    with open(path, "w") as f:
        json.dump({"ok": True, "result": {}}, f)


def _write_requeue_marker(cl, tmp_folder):
    rq = cl.requeue_marker_path(tmp_folder, UID)
    with open(rq + ".t", "w") as f:
        json.dump({"preempted": True, "reason": "received SIGTERM", "remaining_blocks": 3}, f)
    os.replace(rq + ".t", rq)


def _dead_worker(sv, tmp_folder, pid):
    fu.atomic_write_json(sv.heartbeat_path(tmp_folder, UID),
                         {"time": time.time(), "pid": pid, "host": socket.gethostname()})


_MEASURED = ((re.compile(r"\d+\.\d+s"), "<s>"), (re.compile(r"heartbeat pid \d+"), "heartbeat pid <pid>"))


def _mask(text):
    for pattern, repl in _MEASURED:
        text = pattern.sub(repl, text)
    return text


def _audit(tmp_folder):
    """The supervisor's audit trail with what each run measures masked
    (seconds on the clock, the dead worker's pid): supervisor.log's lines
    without their timestamps and failures.json's records."""
    with open(os.path.join(tmp_folder, "cluster", "supervisor.log")) as f:
        log = [_mask(line.split(" ", 1)[1]) for line in f.read().splitlines()]
    recs = json.load(open(os.path.join(tmp_folder, "failures.json")))["records"]
    for r in recs:
        if r.get("error"):
            r["error"] = _mask(r["error"])
    return log, recs


def _scenario(name, cl, sv, tmp_folder):
    """(behaviors, cfg extras, expected exception) of one scenario."""
    result = os.path.join(tmp_folder, "result.json")
    if name == "lost":
        def good_job():
            sv.write_heartbeat(tmp_folder, UID)
            _write_result(result)
        return [{"running": True}, {"running": True, "action": good_job}], {}, None
    if name == "dead_pid":
        dead = subprocess.Popen(["true"])
        dead.wait()
        return ([{"running": True, "action": lambda: _dead_worker(sv, tmp_folder, dead.pid)},
                 {"running": True, "action": lambda: _write_result(result)}],
                {"heartbeat_timeout_s": 300}, None)
    if name == "vanished":
        return [{"running": False}, {"running": True, "action": lambda: _write_result(result)}], {}, None
    if name == "gives_up":
        return [{"running": True}], {"max_resubmits": 1}, "giving up"
    if name == "job_loss":
        return [{"running": True, "action": lambda: _write_result(result)}], {}, None
    if name == "preempt":
        return ([{"running": False, "action": lambda: _write_requeue_marker(cl, tmp_folder)},
                 {"running": True, "action": lambda: _write_result(result)}],
                {"heartbeat_timeout_s": 0, "result_grace_s": 0.1, "max_resubmits": 0,
                 "max_preempt_resubmits": 2}, None)
    if name == "preempt_exhausted":
        return ([{"running": False, "action": lambda: _write_requeue_marker(cl, tmp_folder)}],
                {"heartbeat_timeout_s": 0, "result_grace_s": 0.1, "max_resubmits": 5,
                 "max_preempt_resubmits": 1}, "preempted")
    raise AssertionError(name)


def _supervise_both(tmp_path, name):
    """Run one scenario through each package's ``supervise_job``; returns
    per side (sup or the exception, elapsed s, submitter, audit trail)."""
    out = {}
    for side, (cl, faults_mod, sv) in SIDES.items():
        tmp_folder = str(tmp_path / side / "tmp")
        os.makedirs(tmp_folder, exist_ok=True)
        behaviors, extra, raises = _scenario(name, cl, sv, tmp_folder)
        if name == "job_loss":
            faults_mod.configure({"faults": [{"site": "submit", "kind": "job_loss", "fail_attempts": 1}]})
        sub = _ScriptedSubmitter(behaviors)
        t0 = time.monotonic()
        if raises:
            with pytest.raises(RuntimeError, match=raises) as ei:
                cl.supervise_job(sub, script_path="/dev/null", job_name=UID,
                                 out_path=os.path.join(tmp_folder, "job.out"),
                                 result_path=os.path.join(tmp_folder, "result.json"), tmp_folder=tmp_folder,
                                 uid=UID, cfg=dict(SUP_CFG, **extra), logger=None)
            sup = ei.value
        else:
            sup = cl.supervise_job(sub, script_path="/dev/null", job_name=UID,
                                   out_path=os.path.join(tmp_folder, "job.out"),
                                   result_path=os.path.join(tmp_folder, "result.json"), tmp_folder=tmp_folder,
                                   uid=UID, cfg=dict(SUP_CFG, **extra), logger=None)
        faults_mod.configure(None)
        out[side] = (sup, time.monotonic() - t0, sub, _audit(tmp_folder))
    assert out["port"][3] == out["jax"][3], "supervisor.log / failures.json differ from the reference's"
    return out


def test_supervisor_resubmits_scheduler_lost_job(tmp_path):
    """The scheduler claims the job runs forever but nothing heartbeats:
    the supervisor declares it lost after heartbeat_timeout_s and
    resubmits — WITHOUT waiting out submit_timeout_s — and the
    resubmission's result completes the task; the loss is in
    supervisor.log and failures.json, as in the reference."""
    sup, elapsed, sub, (log, recs) = _supervise_both(tmp_path, "lost")["port"]
    assert sup["resubmits"] == 1 and sub.submits == 2 and sup["job_ids"] == ["j1", "j2"]
    assert "j1" in sub.cancelled and elapsed < 10.0
    assert "declared lost" in log[0] and "resubmitting (1/2)" in log[0]
    rec = next(r for r in recs if r["task"] == UID)
    assert rec["sites"]["job_loss"] == 1 and rec["resolved"]


def test_supervisor_dead_pid_detected_fast(tmp_path):
    """A fresh heartbeat whose pid is dead on this host is a loss signal
    even before the staleness timeout."""
    sup, elapsed, _, (log, _) = _supervise_both(tmp_path, "dead_pid")["port"]
    assert sup["resubmits"] == 1 and elapsed < 10.0
    assert "is dead" in log[0]


def test_supervisor_vanished_job_resubmitted(tmp_path):
    """A job that leaves the queue without a result is resubmitted after
    the result grace, not raised at the first occurrence."""
    sup, _, sub, (log, _) = _supervise_both(tmp_path, "vanished")["port"]
    assert sup["resubmits"] == 1 and sub.submits == 2
    assert "left the queue without a result file" in log[0]


def test_supervisor_gives_up_after_max_resubmits(tmp_path):
    err, _, sub, (log, recs) = _supervise_both(tmp_path, "gives_up")["port"]
    assert "giving up" in str(err) and sub.submits == 2  # original + 1 resubmission
    assert "exhausted, giving up" in log[-1]
    assert [r["resolved"] for r in recs if r["task"] == UID] == [False]


def test_supervisor_job_loss_injection_end_to_end(tmp_path):
    """The job_loss fault class: the first submission is swallowed (the
    fake scheduler never sees it), heartbeat supervision finds it and the
    resubmission — a real submit — completes."""
    sup, _, sub, (_, recs) = _supervise_both(tmp_path, "job_loss")["port"]
    assert sup["resubmits"] == 1 and sub.submits == 1
    assert sup["job_ids"][0] == f"lost:{UID}:0"
    rec = next(r for r in recs if r["task"] == UID)
    assert rec["job_ids"] == sup["job_ids"] and rec["resolved"]


def test_supervisor_requeues_preempted_job_without_burning_loss_budget(tmp_path):
    sup, _, _, (log, recs) = _supervise_both(tmp_path, "preempt")["port"]
    assert sup["preempt_resubmits"] == 1 and sup["resubmits"] == 0
    pre = [r for r in recs if r.get("resolution") == "requeued:preempt"]
    assert pre and pre[-1]["resolved"] and pre[-1]["sites"] == {"preempt": 1}
    assert pre[-1]["task"] == f"{UID}.preempt"
    assert "preempted" in log[0] and "requeueing (1/2)" in log[0]


def test_supervisor_preempt_budget_exhausted(tmp_path):
    err, _, sub, (log, _) = _supervise_both(tmp_path, "preempt_exhausted")["port"]
    assert "preempted" in str(err)
    assert sub.submits == 2  # original + exactly max_preempt_resubmits
    assert "max_preempt_resubmits=1 exhausted" in log[-1]


def test_runner_leaves_requeue_marker_and_exit_114_on_drain(tmp_path):
    """The node entry point under a preemption: the drain latch flips
    before any block runs, the runner writes the requeue marker (no
    result) with the reference's keys and exits 114."""
    root = str(tmp_path)
    data = np.zeros((16, 16, 16), np.float32)
    path = os.path.join(root, "d.zarr")
    file_reader(path).require_dataset("raw", shape=data.shape, chunks=(16, 16, 16), dtype="float32")[...] = data
    tmp_folder = os.path.join(root, "tmp")
    cdir = pcluster.cluster_dir(tmp_folder)
    spec = {"module": "cluster_tools_tpu_torch.tasks.thresholded_components", "cls": "ThresholdLocal",
            "tmp_folder": tmp_folder, "config_dir": root, "max_jobs": 1,
            "params": {"input_path": path, "input_key": "raw", "output_path": path, "output_key": "m",
                       "block_shape": [16, 16, 16]},
            "result_path": os.path.join(cdir, f"{UID}.result.json"), "uid": UID, "heartbeat_interval_s": 0.1,
            "requeue_path": pcluster.requeue_marker_path(tmp_folder, UID)}
    spec_path = os.path.join(cdir, f"{UID}.spec.json")
    fu.atomic_write_json(spec_path, spec)
    code = ("import sys; from cluster_tools_tpu_torch.runtime import supervision as s; "
            "from cluster_tools_tpu_torch.runtime import cluster_runner as r; "
            "s.request_drain('received SIGTERM'); sys.exit(r.main(sys.argv[1]))")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env.pop("CTT_FAULTS", None)
    out = subprocess.run([sys.executable, "-c", code, spec_path], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == psupervision.REQUEUE_EXIT_CODE == 114, out.stderr[-2000:]
    assert not os.path.exists(spec["result_path"])
    marker = json.load(open(spec["requeue_path"]))
    assert marker["preempted"] is True and marker["reason"] == "received SIGTERM"
    assert set(marker) == {"preempted", "reason", "remaining_blocks", "time", "host", "pid"}
    assert psupervision.read_heartbeat(tmp_folder, UID)["pid"] == marker["pid"]
