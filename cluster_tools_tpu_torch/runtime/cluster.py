"""Cluster-scheduler targets: ``target='slurm'`` / ``target='lsf'``.

Port (a copy) of ``cluster_tools_tpu/runtime/cluster.py``: the same
submitters, supervisor, spec and script layout and the same files under
``<tmp_folder>/cluster/`` (``<uid>.spec.json``, ``<uid>.sh``,
``<uid>.out``, ``<uid>.result.json``, ``<uid>.requeue.json``,
``supervisor.log``) and heartbeats (``<tmp_folder>/heartbeats/<uid>.json``),
so either package's tools read the other's runs.  The batch script execs
``python -m cluster_tools_tpu_torch.runtime.cluster_runner``.

The reference ran every task as cluster jobs: per-job scripts submitted
with ``sbatch``/``bsub``, progress tracked through block markers on the
shared filesystem.  This framework schedules *compute* onto the device,
so its cluster backend exists for the ingest side: IO-heavy host tasks
(copy_volume, downscaling, ingest conversions) running on a cluster node
that feeds the device host.  As in the reference, :func:`make_cluster_task`
wraps a task's ``<Op>Local`` class, so a cluster job runs on the node's
CPU (the Local variant's target names the CPU); the compute stays on the
card through ``target="gpu"``.

Design differences from the reference's original cluster_tools, on purpose:

- The unit of submission is the TASK, not per-block job arrays: blocks
  already parallelize inside one process (batches + IO threads), so one
  node per task keeps the scheduler interaction minimal while the
  manifests + block markers keep the same resume grain.
- The submitting process stays the DAG owner: ``build()`` resolves
  dependencies and writes success manifests; the remote job only executes
  ``run_impl`` via :mod:`.cluster_runner` and reports its result in a
  JSON file.  A shared filesystem between submitter and nodes is assumed.

Scheduler interaction is isolated in :class:`SlurmSubmitter` /
:class:`LSFSubmitter` (submit + liveness probe), so tests drive the full
machinery with stub ``sbatch``/``squeue`` executables and no cluster.

Config keys (per-task JSON, matching the reference's slurm knobs):
``partition``, ``time_limit`` (minutes), ``mem_limit`` (GB), ``qos``,
``poll_interval_s``, ``submit_timeout_s``, ``result_grace_s`` (wait for
the result file after the job leaves the queue — NFS cache lag),
``probe_failure_grace_s`` (continuous scheduler-unreachable stretch
tolerated before declaring the job gone).

Supervision: the poll loop is a *supervisor*.  Jobs heartbeat into
``tmp_folder/heartbeats/<uid>.json`` (the batch script writes the first
beat before Python even starts, the remote runner every
``heartbeat_interval_s`` after); the supervisor declares a job **lost** —
and resubmits it, up to ``max_resubmits`` times, without waiting out
``submit_timeout_s`` — when any of these hold:

- the scheduler stops listing it and no result file appears within
  ``result_grace_s`` (crashed / preempted without trace),
- its heartbeat file has not *changed* for ``heartbeat_timeout_s`` while
  the scheduler still claims it runs (the classic *lost array task*: the
  scheduler lies, the node is gone).  Staleness is judged by content
  change observed on the supervisor's own clock, so worker clock skew
  cannot fake a loss.  Must exceed worst-case queue wait + worker
  startup; ``0`` disables heartbeat supervision,
- the heartbeat's pid is dead on this host (same-host stub/test setups:
  instant detection).

Every loss is appended to ``cluster/supervisor.log`` and recorded in the
run's ``failures.json`` (fault class ``job_loss``, job id, resolution).

Preemption: a gracefully drained job (SIGTERM → drain latch →
``DrainInterrupt``) leaves a *requeue marker* (``cluster/<uid>.requeue.json``)
instead of a result and exits with ``REQUEUE_EXIT_CODE``.  The supervisor,
finding the marker when the job leaves the queue, resubmits under a
**separate** ``max_preempt_resubmits`` budget — an eviction is the
scheduler doing its job, and must not burn the failure-retry budget that
guards against genuinely broken jobs.  Each preemption is recorded in
``failures.json`` with ``sites: {preempt: n}`` and
``resolution: "requeued:preempt"``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import time
from typing import Any, Dict, Optional

from ..utils import function_utils as fu
from . import faults as faults_mod
from . import trace as trace_mod
from .supervision import heartbeat_path, pid_alive, read_heartbeat


class ClusterSubmitter:
    """Submit a job script and probe whether the job still runs."""

    flavor = "abstract"

    def submit(self, script_path: str, job_name: str, out_path: str,
               cfg: Dict[str, Any]) -> str:
        raise NotImplementedError

    def is_running(self, job_id: str) -> Optional[bool]:
        """True = queued/running, False = gone from the queue, None =
        probe failed (scheduler hiccup — status unknown)."""
        raise NotImplementedError

    def cancel(self, job_id: str) -> None:
        """Best-effort kill — failure paths must not leave a zombie job
        racing a resubmission on the same uid-keyed paths."""
        raise NotImplementedError


class SlurmSubmitter(ClusterSubmitter):
    flavor = "slurm"

    def submit(self, script_path, job_name, out_path, cfg):
        cmd = ["sbatch", "--parsable", "-J", job_name, "-o", out_path]
        if cfg.get("partition"):
            cmd += ["-p", str(cfg["partition"])]
        if cfg.get("time_limit"):
            cmd += ["-t", str(int(cfg["time_limit"]))]
        if cfg.get("mem_limit"):
            cmd += ["--mem", f"{int(float(cfg['mem_limit']) * 1024)}M"]
        if cfg.get("qos"):
            cmd += ["--qos", str(cfg["qos"])]
        cmd.append(script_path)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"sbatch failed (exit {proc.returncode}): "
                f"{proc.stderr.strip() or proc.stdout.strip()}"
            )
        # --parsable prints "<jobid>[;cluster]"
        return proc.stdout.strip().split(";")[0].strip()

    def is_running(self, job_id):
        # squeue exits 0 with no rows once the job left the queue, but
        # after MinJobAge it exits nonzero with "Invalid job id" — that is
        # a definite finish, while any other nonzero exit is a scheduler
        # hiccup with the status unknown
        probe = subprocess.run(
            ["squeue", "-h", "-j", job_id], capture_output=True, text=True
        )
        if probe.returncode != 0:
            blob = probe.stdout + probe.stderr
            if "Invalid job id" in blob:
                return False
            return None
        return bool(probe.stdout.strip())

    def cancel(self, job_id):
        subprocess.run(["scancel", job_id], capture_output=True, text=True)


class LSFSubmitter(ClusterSubmitter):
    flavor = "lsf"

    def submit(self, script_path, job_name, out_path, cfg):
        cmd = ["bsub", "-J", job_name, "-o", out_path]
        if cfg.get("partition"):
            cmd += ["-q", str(cfg["partition"])]
        if cfg.get("time_limit"):
            cmd += ["-W", str(int(cfg["time_limit"]))]
        if cfg.get("mem_limit"):
            mb = int(float(cfg["mem_limit"]) * 1024)
            cmd += ["-M", str(mb)]
        with open(script_path) as f:
            proc = subprocess.run(cmd, stdin=f, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"bsub failed (exit {proc.returncode}): "
                f"{proc.stderr.strip() or proc.stdout.strip()}"
            )
        out = proc.stdout
        # "Job <123> is submitted to ..."
        try:
            return out.split("<", 1)[1].split(">", 1)[0]
        except IndexError:
            raise RuntimeError(f"cannot parse bsub output: {out!r}")

    def is_running(self, job_id):
        probe = subprocess.run(
            ["bjobs", "-noheader", job_id], capture_output=True, text=True
        )
        blob = probe.stdout + probe.stderr
        if "is not found" in blob:  # purged from history: definite finish
            return False
        if probe.returncode != 0:
            return None
        line = probe.stdout.strip()
        return bool(line) and (" DONE " not in line and " EXIT " not in line)

    def cancel(self, job_id):
        subprocess.run(["bkill", job_id], capture_output=True, text=True)


_SUBMITTERS = {"slurm": SlurmSubmitter, "lsf": LSFSubmitter}


def submit_with_retries(
    submitter: ClusterSubmitter,
    script_path: str,
    job_name: str,
    out_path: str,
    cfg: Dict[str, Any],
    logger=None,
) -> str:
    """Submit, retrying transient scheduler failures (slurmctld restarts,
    comm timeouts — the submit-side twin of the probe-failure grace) with
    capped exponential backoff + jitter.

    Config keys: ``submit_retries`` (default 3), ``submit_backoff_s``
    (base, default 2), ``submit_backoff_max_s`` (cap, default 30).
    """
    retries = int(cfg.get("submit_retries", 3))
    base = float(cfg.get("submit_backoff_s", 2.0))
    cap = float(cfg.get("submit_backoff_max_s", 30.0))
    for attempt in range(retries + 1):
        try:
            faults_mod.get_injector().maybe_fail("submit")
            return submitter.submit(script_path, job_name, out_path, cfg)
        except FileNotFoundError:
            # sbatch/bsub not on PATH: a configuration error, not an
            # outage — retrying only delays the real message
            raise
        except Exception as e:
            if attempt >= retries:
                raise
            delay = fu.backoff_delay(attempt, base, cap)
            if logger is not None:
                logger.warning(
                    f"{submitter.flavor} submit failed (attempt "
                    f"{attempt + 1}/{retries + 1}): {e}; retrying in "
                    f"{delay:.1f}s"
                )
            time.sleep(delay)


def supervisor_log_path(tmp_folder: str) -> str:
    return os.path.join(cluster_dir(tmp_folder), "supervisor.log")


def requeue_marker_path(tmp_folder: str, uid: str) -> str:
    """Where a gracefully-preempted job leaves its requeue marker
    (``runtime/cluster_runner.py``) for the supervisor to find."""
    return os.path.join(cluster_dir(tmp_folder), f"{uid}.requeue.json")


def _sup_log(tmp_folder: str, msg: str) -> None:
    """Append one line to the run's supervisor log (the resubmission audit
    trail)."""
    import datetime

    try:
        with open(supervisor_log_path(tmp_folder), "a") as f:
            f.write(f"{datetime.datetime.now().isoformat()} {msg}\n")
    except OSError:
        pass


def supervise_job(
    submitter: ClusterSubmitter,
    *,
    script_path: str,
    job_name: str,
    out_path: str,
    result_path: str,
    tmp_folder: str,
    uid: str,
    cfg: Dict[str, Any],
    logger=None,
    flavor: Optional[str] = None,
) -> Dict[str, Any]:
    """Submit a job and supervise it to a result file, resubmitting lost
    jobs (module docstring).  Returns ``{"job_id", "resubmits", "job_ids"}``
    once ``result_path`` exists; raises when the job is lost more than
    ``max_resubmits`` times or exceeds ``submit_timeout_s``.

    The ``job_loss`` fault class hooks in here: a swallowed submission gets
    a fabricated job id the "scheduler" reports as running forever, so only
    the heartbeat checks can find it — exactly the failure the supervisor
    exists for.
    """
    flavor = flavor or submitter.flavor
    injector = faults_mod.get_injector()
    poll = float(cfg.get("poll_interval_s", 5.0))
    timeout = cfg.get("submit_timeout_s")
    grace = float(cfg.get("result_grace_s", 60.0))
    probe_grace = float(cfg.get("probe_failure_grace_s", 600.0))
    hb_timeout = float(cfg.get("heartbeat_timeout_s") or 0.0)
    max_resubmits = int(cfg.get("max_resubmits", 2))
    max_preempt_resubmits = int(cfg.get("max_preempt_resubmits", 3))
    host = socket.gethostname()
    rq_path = requeue_marker_path(tmp_folder, uid)
    job_ids: list = []
    resubmits = 0
    preempt_resubmits = 0
    # heartbeat liveness is judged by CHANGE observed on the supervisor's
    # own clock, never by the timestamps inside the beat: worker nodes'
    # clocks skew, and a worker behind the supervisor would otherwise have
    # every beat discarded as stale and the healthy job declared lost
    hb_seen: Dict[str, Any] = {"raw": None, "at": 0.0}

    def _submit():
        # snapshot the heartbeat BEFORE submitting: anything the new job
        # writes afterwards registers as a change of this attempt's.
        # A leftover requeue marker must go too — only a marker written by
        # THIS attempt may count as its preemption.
        try:
            os.unlink(rq_path)
        except OSError:
            pass
        submit_t = trace_mod.walltime()
        hb_seen["raw"] = read_heartbeat(tmp_folder, uid)
        hb_seen["at"] = submit_t
        if injector.lose_job():
            job_id = f"lost:{uid}:{len(job_ids)}"
        else:
            job_id = submit_with_retries(
                submitter, script_path, job_name, out_path, cfg, logger
            )
        job_ids.append(job_id)
        return job_id, submit_t

    def _probe(job_id):
        if job_id.startswith("lost:"):
            return True  # the scheduler claims it runs; only heartbeats know
        return submitter.is_running(job_id)

    def _cancel(job_id):
        if not job_id.startswith("lost:"):
            submitter.cancel(job_id)

    def _record_loss(job_id, reason, resolved):
        fu.record_failures(
            fu.failures_path(tmp_folder),
            uid,
            [{
                "block_id": None,
                "sites": {"job_loss": resubmits},
                "error": reason,
                "quarantined": False,
                "resolved": resolved,
                "job_id": job_id,
                # full submission history: records merge by (task, block),
                # so the final resolved record must still name the lost ids
                "job_ids": list(job_ids),
            }],
        )

    def _record_preempt(job_id, reason, resolved):
        # keyed separately from the job_loss record ((task, block_id)
        # merging would otherwise have evictions and losses overwrite each
        # other): preemptions use the task's ".preempt" sub-key
        fu.record_failures(
            fu.failures_path(tmp_folder),
            f"{uid}.preempt",
            [{
                "block_id": None,
                "sites": {"preempt": preempt_resubmits},
                "error": reason,
                "quarantined": False,
                "resolved": resolved,
                "resolution": "requeued:preempt",
                "job_id": job_id,
                "job_ids": list(job_ids),
            }],
        )

    job_id, submit_t = _submit()
    if logger is not None:
        logger.info(f"{flavor} job {job_id} submitted ({script_path})")
    t0 = trace_mod.walltime()
    unknown_since = None
    while not os.path.exists(result_path):
        now = trace_mod.walltime()
        if timeout and now - t0 > float(timeout):
            _cancel(job_id)
            raise RuntimeError(
                f"{flavor} job {job_id} exceeded submit_timeout_s="
                f"{timeout} (job cancelled); see {out_path}"
            )
        running = _probe(job_id)
        unknown_since = (unknown_since or now) if running is None else None
        probe_exhausted = (
            unknown_since is not None and now - unknown_since > probe_grace
        )

        lost = None
        hb = read_heartbeat(tmp_folder, uid)
        if hb != hb_seen["raw"]:
            # the beat's CONTENT changed since we last looked: something is
            # alive out there, clocked on OUR side (skew-immune).  A beat
            # left by a previous, cancelled incarnation never changes, so
            # it cannot keep a lost resubmission looking alive.
            hb_seen["raw"] = hb
            hb_seen["at"] = now
        last_alive = hb_seen["at"]
        beat_this_attempt = hb is not None and last_alive > submit_t
        if (
            beat_this_attempt
            and hb.get("host") == host
            and hb.get("pid") is not None
            and not pid_alive(hb["pid"])
        ):
            lost = f"heartbeat pid {hb['pid']} on {host} is dead"
        if (
            lost is None
            and hb_timeout
            and running is not False
            and now - last_alive > hb_timeout
        ):
            lost = (
                f"no live heartbeat for {now - last_alive:.1f}s "
                f"(heartbeat_timeout_s={hb_timeout:g}) while the scheduler "
                f"reports the job as {'running' if running else 'unknown'}"
            )
        if running is False or probe_exhausted:
            # job left the queue (or scheduler unreachable too long): give
            # the result file an NFS-lag grace window before declaring loss
            t_gone = trace_mod.walltime()
            while (trace_mod.walltime() - t_gone < grace
                   and not os.path.exists(result_path)):
                time.sleep(min(poll, 2.0))
            if os.path.exists(result_path):
                break
            lost = (
                "job left the queue without a result file"
                if running is False
                else f"scheduler unreachable for {probe_grace:.0f}s "
                     "and no result file"
            )

        if lost:
            rq = fu.read_json_if_valid(rq_path)
            if rq is not None:
                # not a loss: the job drained gracefully for a preemption
                # and asked to be requeued.  Separate budget — an eviction
                # is the scheduler doing its job, not a broken task.
                _cancel(job_id)
                if preempt_resubmits >= max_preempt_resubmits:
                    _sup_log(
                        tmp_folder,
                        f"{uid}: job {job_id} preempted again; "
                        f"max_preempt_resubmits={max_preempt_resubmits} "
                        "exhausted, giving up",
                    )
                    raise RuntimeError(
                        f"{flavor} job for {uid} was preempted "
                        f"{preempt_resubmits + 1} times "
                        f"(max_preempt_resubmits={max_preempt_resubmits}) — "
                        "giving up; the partial progress is markered and a "
                        "re-run resumes at block grain"
                    )
                preempt_resubmits += 1
                msg = (
                    f"{uid}: job {job_id} preempted "
                    f"({rq.get('reason', 'drained')}, "
                    f"{rq.get('remaining_blocks', '?')} block(s) left); "
                    f"requeueing ({preempt_resubmits}/{max_preempt_resubmits})"
                )
                if logger is not None:
                    logger.warning(msg)
                _sup_log(tmp_folder, msg)
                _record_preempt(job_id, rq.get("reason"), resolved=False)
                unknown_since = None
                job_id, submit_t = _submit()
                if logger is not None:
                    logger.info(
                        f"{flavor} job {job_id} requeued after preemption"
                    )
                continue
            _cancel(job_id)  # a zombie must not race the resubmission
            if resubmits >= max_resubmits:
                tail = ""
                try:
                    with open(out_path) as f:
                        tail = f.read()[-2000:]
                except OSError:
                    pass
                _sup_log(
                    tmp_folder,
                    f"{uid}: job {job_id} lost ({lost}); "
                    f"max_resubmits={max_resubmits} exhausted, giving up",
                )
                raise RuntimeError(
                    f"{flavor} job for {uid} lost ({lost}) after "
                    f"{resubmits} resubmission(s) — giving up.  "
                    f"Job output tail:\n{tail}"
                )
            resubmits += 1
            msg = (
                f"{uid}: job {job_id} declared lost ({lost}); "
                f"resubmitting ({resubmits}/{max_resubmits})"
            )
            if logger is not None:
                logger.warning(msg)
            _sup_log(tmp_folder, msg)
            _record_loss(job_id, lost, resolved=False)
            unknown_since = None
            job_id, submit_t = _submit()
            if logger is not None:
                logger.info(f"{flavor} job {job_id} resubmitted")
            continue
        time.sleep(poll)

    if resubmits:
        _record_loss(job_id, None, resolved=True)
        _sup_log(
            tmp_folder,
            f"{uid}: job {job_id} delivered a result after {resubmits} "
            f"resubmission(s)",
        )
    if preempt_resubmits:
        _record_preempt(job_id, None, resolved=True)
        _sup_log(
            tmp_folder,
            f"{uid}: job {job_id} delivered a result after "
            f"{preempt_resubmits} preemption requeue(s)",
        )
    return {
        "job_id": job_id,
        "resubmits": resubmits,
        "preempt_resubmits": preempt_resubmits,
        "job_ids": job_ids,
    }


def _spec_default(obj):
    """Numpy scalars/arrays become their Python equivalents; anything else
    fails AT SUBMIT TIME instead of reaching the remote node stringified."""
    item = getattr(obj, "item", None)
    if item is not None and getattr(obj, "ndim", 1) == 0:
        return item()
    tolist = getattr(obj, "tolist", None)
    if tolist is not None:
        return tolist()
    raise TypeError(
        f"task param of type {type(obj).__name__} is not JSON-serializable; "
        "cluster targets re-execute the task from a JSON spec, so params "
        "must be plain Python / numpy values"
    )


def cluster_dir(tmp_folder: str) -> str:
    d = os.path.join(tmp_folder, "cluster")
    os.makedirs(d, exist_ok=True)
    return d


def make_cluster_task(local_cls, flavor: str):
    """Wrap an ``<Op>Local`` class into a submitting ``<Op>Slurm``/``LSF``.

    The wrapper's ``run_impl`` serializes the task spec, submits a batch
    script that re-executes the LOCAL variant remotely
    (:mod:`.cluster_runner`), polls the scheduler plus the result file,
    and returns the remote result — so manifests, markers, logs, and
    resume behave exactly as for a local run.
    """
    submitter_cls = _SUBMITTERS[flavor]

    def run_impl(self):
        cfg = self.get_config()
        cdir = cluster_dir(self.tmp_folder)
        spec = {
            "module": local_cls.__module__,
            "cls": local_cls.__name__,
            "tmp_folder": self.tmp_folder,
            "config_dir": self.config_dir,
            "max_jobs": self.max_jobs,
            "params": self.params,
            "result_path": os.path.join(cdir, f"{self.uid}.result.json"),
            # liveness: the remote runner heartbeats under this uid so the
            # supervisor below can tell a lost job from a slow one
            "uid": self.uid,
            "heartbeat_interval_s": float(cfg.get("heartbeat_interval_s", 5.0)),
            # graceful preemption: a drained job leaves this marker instead
            # of a result, and the supervisor requeues it
            "requeue_path": requeue_marker_path(self.tmp_folder, self.uid),
        }
        spec_path = os.path.join(cdir, f"{self.uid}.spec.json")
        # atomic: the spec is read by the remote worker over the
        # shared filesystem; it must never observe a torn document
        fu.atomic_write_json(spec_path, spec, default=_spec_default)
        script_path = os.path.join(cdir, f"{self.uid}.sh")
        out_path = os.path.join(cdir, f"{self.uid}.out")
        # the remote interpreter must find this package regardless of the
        # job's working directory (the reference wrote shebang/env lines
        # into its job scripts for the same reason)
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        hb_path = heartbeat_path(self.tmp_folder, self.uid)
        # unified tracing plane: a traced submitter
        # hands the worker the run's shard directory through the
        # environment, so the remote process's spans land on the SAME
        # merged timeline (the env value both enables tracing and pins the
        # directory)
        trace_export = ""
        if trace_mod.enabled():
            trace_dir = trace_mod.trace_dir() or os.path.join(
                self.tmp_folder, trace_mod.TRACE_DIRNAME
            )
            trace_export = f"export CTT_TRACE={trace_dir}\n"
        with open(script_path, "w") as f:
            f.write(
                "#!/bin/bash\n"
                f"export PYTHONPATH={pkg_root}:$PYTHONPATH\n"
                # no in-memory handoffs across a host boundary: the worker
                # process's memory dies before the submitter-side consumer
                # runs, so its intermediate outputs must hit storage
                "export CTT_HANDOFF=0\n"
                f"{trace_export}"
                # boot heartbeat from the shell, BEFORE the interpreter
                # starts: the supervisor's staleness clock must not count
                # queue exit -> first Python beat (slow torch imports) as
                # dead air.  exec keeps the pid, so the pid stays valid.
                f"mkdir -p {os.path.dirname(hb_path)}\n"
                'printf \'{"time": %s, "pid": %s, "host": "%s"}\' '
                '"$(date +%s)" "$$" "$(hostname)" '
                f"> {hb_path}.boot && mv {hb_path}.boot {hb_path}\n"
                f"exec {fu.python_executable()} -m "
                f"cluster_tools_tpu_torch.runtime.cluster_runner {spec_path}\n"
            )
        os.chmod(script_path, 0o755)
        # a retry must not consume the previous attempt's result (nor its
        # heartbeat: a stale beat would mask a lost resubmission)
        for stale in (spec["result_path"], hb_path):
            try:
                os.unlink(stale)
            except OSError:
                pass

        submitter = submitter_cls()
        sup = supervise_job(
            submitter,
            script_path=script_path,
            job_name=self.uid,
            out_path=out_path,
            result_path=spec["result_path"],
            tmp_folder=self.tmp_folder,
            uid=self.uid,
            cfg=cfg,
            logger=self.logger,
            flavor=flavor,
        )
        with open(spec["result_path"]) as f:
            remote = json.load(f)
        if not remote.get("ok"):
            raise RuntimeError(
                f"{flavor} job {sup['job_id']} failed remotely: "
                f"{remote.get('error', 'unknown error')}"
            )
        result = remote.get("result") or {}
        if sup["resubmits"]:
            result["supervisor"] = {
                "resubmits": sup["resubmits"],
                "job_ids": sup["job_ids"],
            }
        return result

    return type(
        local_cls.__name__.replace("Local", flavor.upper() if flavor == "lsf"
                                   else flavor.capitalize()),
        (local_cls,),
        {"target": flavor, "run_impl": run_impl},
    )
