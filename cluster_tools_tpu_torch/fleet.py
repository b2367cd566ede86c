"""Fleet-mode CLI entry: a supervised serving fleet — one supervisor
process owning a gateway subprocess and M pipeline-server subprocesses.

Port (a copy) of ``cluster_tools_tpu/fleet.py``.  Usage (docs/SERVING.md
"Fleet" / "Supervision")::

    python -m cluster_tools_tpu_torch.fleet --base-dir /srv/fleet \\
        [--members 2] [--port 0] [--config fleet.json]
    python -m cluster_tools_tpu_torch.fleet --status /srv/fleet
    python -m cluster_tools_tpu_torch.fleet --drain /srv/fleet [--member m0]

Members run ``python -m cluster_tools_tpu_torch.serve``; their requests run
on the card unless the payload names ``"target": "local"`` (the CPU).  The
reference's ``--tpu`` flag only skipped a JAX platform pin on its members
and has no counterpart here.  ``members.json``, ``supervisor_state.json``
and ``lifecycle.log`` (the journal's CRC framing) keep the reference's
bytes and keys, so ``scripts/progress.py`` renders the port's supervisor
view.

The supervisor (this process) closes the serving fleet's last
single-point-of-failure loops:

* **Crash-only gateway** — the gateway runs as its own subprocess (the
  hidden ``--gateway-child`` mode) watched with the same heartbeat/pid
  machinery members get.  A dead or wedged gateway is SIGKILLed and
  restarted under a crash-loop budget; the restarted incarnation rebuilds
  routes/affinity/adoption state cold from member truth on disk
  (``FleetGateway._rebuild_from_disk``), re-binds the same port, and
  bumps the incarnation counter in ``fleet_state.json``.  Clients riding
  ``submit(retry_s=...)`` / ``wait(across_restarts=True)`` never observe
  a lost acknowledged request across the restart.

* **Closed-loop member lifecycle** — the reaper's decision table
  (:func:`classify_member_exit`): rc 114 = drained (expected, retire),
  rc 115 = fenced (the journal was adopted by a survivor; the old dir IS
  the adoption record, so capacity respawns on a *fresh* base dir),
  anything else = crash (exponential-backoff respawn on the same dir
  under the adoption-claim protocol — the supervisor never fights an
  in-flight adoption, and a member that got adopted while backing off
  comes back on a fresh dir instead).  A lineage over the respawn budget
  is quarantined (``quarantined:member_crash_loop``).

* **Backlog-driven scaling** — sustained queue/breaker pressure grows
  the fleet up to ``max_members``; sustained idleness drains the
  emptiest member down to ``min_members``.  Every decision is HELD while
  any adoption, drain, respawn, or boot is in flight.

Every respawn/restart/scale decision is one typed record in the
supervisor's lifecycle ledger (``lifecycle.log``) AND one trace instant,
and is rendered by ``scripts/progress.py`` from ``supervisor_state.json``.

``--config`` names a JSON document: ``{"members": N, "gateway": {...},
"server": {...}, "supervisor": {poll_s, gateway_stale_s,
gateway_max_restarts, member_max_respawns, respawn_backoff_s,
respawn_backoff_max_s, min_members, max_members, scale_up_backlog,
scale_sustain_s, scale_idle_s}}``.

SIGTERM drains the whole fleet through the standard protocol: gateway
child and every member exit ``REQUEUE_EXIT_CODE`` (114) and so does this
process, so rolling restarts ride the same requeue protocol as every
other preempted job.  ``--status`` prints the gateway's ``/status``
document and exits with its ``rc``.  ``--drain`` SIGTERMs the emptiest
member (scale-down).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

from .runtime import journal as journal_mod
from .runtime import netio
from .runtime import trace as trace_mod
from .runtime.fleet import (
    FLEET_STATE_FILENAME,
    GATEWAY_UID,
    FleetGateway,
    acquire_adoption_claim,
    read_adoption_claim,
    release_adoption_claim,
)
from .runtime.server import ENDPOINT_FILENAME
from .runtime.supervision import (
    FENCED_EXIT_CODE,
    REQUEUE_EXIT_CODE,
    DrainInterrupt,
    HeartbeatWriter,
    drain_reason,
    drain_requested,
    install_drain_handler,
    read_heartbeat,
)
from .utils import function_utils as fu

#: durable fleet membership — written by the supervisor, read by every
#: gateway incarnation at boot (a restarted gateway must know members
#: added after the fleet booted)
MEMBERS_FILENAME = "members.json"
#: the supervisor's operator view (scripts/progress.py renders it)
SUPERVISOR_STATE_FILENAME = "supervisor_state.json"
#: the supervisor's decision ledger: typed lifecycle records under the
#: journal's CRC/fsync framing (NOT a request journal — adoption rules
#: do not apply to it)
LIFECYCLE_LOG_FILENAME = "lifecycle.log"
SUPERVISOR_UID = "supervisor"

# -- typed lifecycle records (the decision ledger's vocabulary) ---------------
GATEWAY_START = "gateway_start"
GATEWAY_RESTART = "gateway_restart"
GATEWAY_QUARANTINED = "gateway_quarantined"
MEMBER_SPAWN = "member_spawn"
MEMBER_RESPAWN = "member_respawn"
MEMBER_CRASHED = "member_crashed"
MEMBER_ADOPTED = "member_adopted"
MEMBER_DRAINED = "member_drained"
MEMBER_FENCED = "member_fenced"
MEMBER_QUARANTINED = "member_quarantined"
SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"

QUARANTINE_MEMBER = "quarantined:member_crash_loop"
QUARANTINE_GATEWAY = "quarantined:gateway_crash_loop"


def classify_member_exit(rc: int) -> str:
    """The reaper's decision table (docs/SERVING.md "Supervision"):
    what one member exit code means for the fleet's capacity.

    * ``"drained"`` (rc 114) — the standard requeue exit: expected
      during fleet drain and after a scale-down/operator drain; the
      member is retired, never respawned.
    * ``"fenced"`` (rc 115) — a survivor adopted this member's journal
      while it was wedged.  The old base dir is the adoption record;
      capacity respawns on a FRESH dir, the old dir is never reused.
    * ``"crashed"`` (anything else, signals included) — respawn with
      exponential backoff on the same dir under the adoption-claim
      protocol, unless the gateway's failover adopts it first.
    """
    if rc == REQUEUE_EXIT_CODE:
        return "drained"
    if rc == FENCED_EXIT_CODE:
        return "fenced"
    return "crashed"


def split_generation(name: str) -> tuple:
    """``"m0" -> ("m0", 0)``, ``"m0-r2" -> ("m0", 2)``: a respawned
    member's fresh-dir name carries its lineage + generation, so crash
    budgets follow the lineage, not the dir."""
    stem, sep, tail = name.rpartition("-r")
    if sep and stem and tail.isdigit():
        return stem, int(tail)
    return name, 0


def fresh_member_name(name: str) -> str:
    """The next fresh-dir name in a lineage: ``m0 -> m0-r1 -> m0-r2``."""
    lineage, gen = split_generation(name)
    return f"{lineage}-r{gen + 1}"


def _load_fleet_config(path):
    if not path:
        return {}
    with open(path) as f:
        return json.load(f)


class FleetSupervisor:
    """The fleet's outermost loop: spawn members + the gateway child,
    then watch, heal, and scale until drained.  Single-threaded on
    purpose — every spawn/reap/scale decision happens on one thread, so
    there is no lock for a slow subprocess call to wedge."""

    def __init__(self, base_dir: str, n_members: int, port: int = 0,
                 cfg: Optional[Dict[str, Any]] = None,
                 config_path: Optional[str] = None):
        self.base_dir = os.path.abspath(base_dir)
        os.makedirs(self.base_dir, exist_ok=True)
        self.cfg = dict(cfg or {})
        self.config_path = config_path
        gw = dict(self.cfg.get("gateway") or {})
        self.health_interval_s = max(
            0.05, float(gw.get("health_interval_s", 1.0))
        )
        self.member_stale_s = max(0.1, float(gw.get("member_stale_s", 6.0)))
        self.max_member_queue = max(1, int(gw.get("max_member_queue", 64)))
        sup = dict(self.cfg.get("supervisor") or {})
        self.poll_s = max(0.05, float(sup.get("poll_s", 0.5)))
        self.gateway_stale_s = max(
            1.0, float(sup.get("gateway_stale_s", 8.0))
        )
        self.gateway_max_restarts = max(
            1, int(sup.get("gateway_max_restarts", 5))
        )
        self.gateway_backoff_s = max(
            0.0, float(sup.get("gateway_backoff_s", 0.5))
        )
        self.member_max_respawns = max(
            1, int(sup.get("member_max_respawns", 5))
        )
        # default crash backoff sits past the gateway's own detection +
        # adoption window: when survivors exist, adoption (which strands
        # nothing) should win the race over a same-dir respawn
        self.respawn_backoff_s = max(0.2, float(sup.get(
            "respawn_backoff_s",
            2.0 * self.member_stale_s + 2.0 * self.health_interval_s,
        )))
        self.respawn_backoff_max_s = max(
            self.respawn_backoff_s,
            float(sup.get("respawn_backoff_max_s", 30.0)),
        )
        self.min_members = max(1, int(sup.get("min_members", n_members)))
        self.max_members = max(
            self.min_members, int(sup.get("max_members", n_members + 2))
        )
        self.scale_up_backlog = float(sup.get(
            "scale_up_backlog", 0.8 * self.max_member_queue
        ))
        self.scale_sustain_s = float(sup.get("scale_sustain_s", 5.0))
        self.scale_idle_s = float(sup.get("scale_idle_s", 30.0))
        self.member_root = os.path.join(self.base_dir, "members")
        self.server_cfg_path: Optional[str] = None
        if self.cfg.get("server"):
            self.server_cfg_path = os.path.join(
                self.base_dir, "member_config.json"
            )
            fu.atomic_write_json(self.server_cfg_path, self.cfg["server"])
        #: name -> member record; this dict is the supervisor's truth
        #: about the PROCESSES (the gateway's fleet_state.json is the
        #: truth about routing/health)
        self.members: Dict[str, Dict[str, Any]] = {}
        self.gateway_proc: Optional[subprocess.Popen] = None
        self.gateway_pid: Optional[int] = None
        self.gateway_port = int(port)
        self.gateway_restarts = 0
        self.gateway_started_at: Optional[float] = None
        self.gateway_booted = False
        self.gateway_failed = False
        self.last_scale = {
            "decision": "none", "reason": "boot",
            "time": trace_mod.walltime(),
        }
        self._pressure_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        #: same-dir respawn claims held until the fresh server's endpoint
        #: names its pid (a late survivor must not adopt a booting journal)
        self._pending_release: List[Dict[str, Any]] = []
        self._ledger: Optional[journal_mod.Journal] = None
        self._heartbeat: Optional[HeartbeatWriter] = None
        # a supervisor restarted over an existing fleet dir continues the
        # incarnation sequence, never reuses one
        prior = fu.read_json_if_valid(
            os.path.join(self.base_dir, SUPERVISOR_STATE_FILENAME)
        ) or {}
        self.incarnation = int(
            (prior.get("gateway") or {}).get("incarnation") or 0
        )

    # -- the decision ledger ----------------------------------------------
    def _journal_decision(self, typ: str, member: str, **fields) -> None:
        """Every supervisor decision is one typed record in the
        lifecycle ledger AND one trace instant: the
        respawn/scale history is replayable from disk and attributable
        on the trace timeline."""
        fields = {k: v for k, v in fields.items() if v is not None}
        try:
            self._ledger.append_transition(typ, member, **fields)
        except Exception:
            pass  # the ledger is attribution; a full disk must not kill us
        trace_mod.instant(f"fleet.{typ}", member=member, **fields)

    # -- spawning ----------------------------------------------------------
    def _spawn_member(self, name: str, mdir: str,
                      record: str = MEMBER_SPAWN, **fields) -> Any:
        """Start one member server subprocess; journals the decision
        (``record``) before returning.  Used at boot, for respawns, and
        for scale-up."""
        os.makedirs(mdir, exist_ok=True)
        cmd = [
            sys.executable, "-m", "cluster_tools_tpu_torch.serve",
            "--base-dir", mdir,
        ]
        if self.server_cfg_path:
            cmd += ["--config", self.server_cfg_path]
        proc = subprocess.Popen(cmd)
        m = self.members.setdefault(name, {
            "name": name, "base_dir": mdir, "respawns": 0,
            "registered": False, "last_rc": None, "drain_requested": False,
        })
        m.update(
            proc=proc, pid=proc.pid, state="running",
            spawned_at=time.monotonic(), backoff_until=None,
        )
        self._journal_decision(
            record, name, pid=proc.pid, dir=os.path.basename(mdir),
            **fields,
        )
        return proc

    def _spawn_gateway(self, reason: str) -> Any:
        """Start (or restart) the gateway child.  The incarnation is
        bumped and durably recorded BEFORE the child boots — a
        supervisor crash between spawn and state write must never let
        two gateway lives share an epoch."""
        self.incarnation += 1
        self._write_state()
        cmd = [
            sys.executable, "-m", "cluster_tools_tpu_torch.fleet",
            "--gateway-child", "--base-dir", self.base_dir,
            "--port", str(self.gateway_port),
            "--incarnation", str(self.incarnation),
        ]
        if self.config_path:
            cmd += ["--config", self.config_path]
        proc = subprocess.Popen(cmd)
        self.gateway_proc = proc
        self.gateway_pid = proc.pid
        self.gateway_booted = False
        self.gateway_started_at = time.monotonic()
        self._journal_decision(
            GATEWAY_START if reason == "boot" else GATEWAY_RESTART,
            "gateway", pid=proc.pid, incarnation=self.incarnation,
            reason=reason,
        )
        return proc

    def _write_members_file(self) -> None:
        """Durable membership for gateway (re)boots.  Fenced/adopted old
        dirs stay listed — they are the adoption records a cold gateway
        rebuilds ``adopted_by`` from; only retired (scaled-down) members
        leave the roster."""
        docs = [
            {"name": n, "base_dir": m["base_dir"]}
            for n, m in self.members.items() if m["state"] != "retired"
        ]
        fu.atomic_write_json(
            os.path.join(self.base_dir, MEMBERS_FILENAME),
            {"version": 1, "members": docs},
        )

    # -- gateway plane -----------------------------------------------------
    def _gateway_call(self, method: str, path: str,
                      body=None) -> tuple:
        try:
            return netio.http_json_call(
                "127.0.0.1", int(self.gateway_port), method, path, body,
                timeout_s=5.0, site="net_member", member="gateway",
            )
        except (OSError, ValueError):
            return 0, {}

    def _tick_gateway(self) -> None:
        proc = self.gateway_proc
        if proc is None or self.gateway_failed:
            return
        rc = proc.poll()
        now = time.monotonic()
        if rc is None and not self.gateway_booted:
            doc = fu.read_json_if_valid(
                os.path.join(self.base_dir, ENDPOINT_FILENAME)
            ) or {}
            if doc.get("pid") == proc.pid and doc.get("role") == "gateway":
                self.gateway_booted = True
                self.gateway_port = int(doc.get("port") or
                                        self.gateway_port)
                print(
                    f"fleet gateway on {doc.get('host')}:{doc.get('port')}"
                    f" (base_dir={self.base_dir}, incarnation="
                    f"{self.incarnation})",
                    flush=True,
                )
            elif now - (self.gateway_started_at or now) > 120.0:
                rc = self._kill_gateway()  # never bound: wedged at boot
            else:
                return
        wedged = False
        if rc is None and self.gateway_booted:
            hb = read_heartbeat(self.base_dir, GATEWAY_UID) or {}
            age = None
            if hb.get("time") is not None:
                age = max(0.0, trace_mod.walltime() - float(hb["time"]))
            # only this incarnation's silence counts: right after a
            # restart the file still carries the predecessor's last pulse
            uptime = now - (self.gateway_started_at or now)
            if (age is None or age > self.gateway_stale_s) and (
                uptime > self.gateway_stale_s
            ):
                wedged = True
        if rc is None and not wedged:
            return
        reason = (
            "wedged:heartbeat_stale" if rc is None else f"exit_rc_{rc}"
        )
        if rc is None:
            rc = self._kill_gateway()
        if drain_requested():
            return  # the drain path owns shutdown now
        self.gateway_restarts += 1
        if self.gateway_restarts > self.gateway_max_restarts:
            self.gateway_failed = True
            self._journal_decision(
                GATEWAY_QUARANTINED, "gateway",
                restarts=self.gateway_restarts, reason=reason,
            )
            try:
                fu.record_failures(
                    fu.failures_path(self.base_dir),
                    "fleet.supervisor",
                    [{
                        "block_id": "gateway:crash_loop",
                        "sites": {"failover": 1},
                        "error": (
                            f"gateway crash loop: {self.gateway_restarts} "
                            f"restarts (last: {reason})"
                        ),
                        "quarantined": True,
                        "resolved": False,
                        "resolution": QUARANTINE_GATEWAY,
                    }],
                )
            except Exception:
                pass
            print(
                f"gateway crash loop ({self.gateway_restarts} restarts); "
                "quarantining the fleet", file=sys.stderr, flush=True,
            )
            return
        backoff = min(
            10.0, self.gateway_backoff_s * (2 ** (self.gateway_restarts - 1))
        )
        if backoff:
            time.sleep(backoff)
        print(
            f"gateway died ({reason}); restarting as incarnation "
            f"{self.incarnation + 1}",
            flush=True,
        )
        self._spawn_gateway(reason)

    def _kill_gateway(self) -> Optional[int]:
        """Crash-only discipline: a wedged gateway is SIGKILLed, never
        pleaded with — its replacement rebuilds from disk."""
        proc = self.gateway_proc
        if proc is None:
            return None
        try:
            proc.kill()
        except OSError:
            pass
        try:
            return proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            return None

    # -- member plane ------------------------------------------------------
    def _tick_members(self) -> None:
        """Reap exits and run the decision table
        (:func:`classify_member_exit`) on each one."""
        for name, m in list(self.members.items()):
            proc = m.get("proc")
            if proc is None or m["state"] != "running":
                continue
            rc = proc.poll()
            if rc is None:
                continue
            m["last_rc"] = rc
            verdict = classify_member_exit(rc)
            if verdict == "drained":
                m["state"] = "drained"
                self._journal_decision(
                    MEMBER_DRAINED, name, rc=rc,
                    scale_down=bool(m.get("drain_requested")) or None,
                )
                print(f"member {name} drained (rc {rc}); retiring",
                      flush=True)
                self._retire_member(name)
            elif verdict == "fenced":
                m["state"] = "fenced"
                self._journal_decision(MEMBER_FENCED, name, rc=rc)
                print(
                    f"member {name} exited FENCED (rc {rc}): journal "
                    "adopted by a survivor; respawning capacity on a "
                    "fresh dir",
                    flush=True,
                )
                m["respawns"] += 1
                self._replace_on_fresh_dir(name)
            else:
                attempts = int(m["respawns"])
                if attempts >= self.member_max_respawns:
                    self._quarantine_member(name, rc)
                    continue
                delay = min(
                    self.respawn_backoff_max_s,
                    self.respawn_backoff_s * (2 ** attempts),
                )
                m["state"] = "backoff"
                m["backoff_until"] = time.monotonic() + delay
                self._journal_decision(
                    MEMBER_CRASHED, name, rc=rc,
                    respawn_in_s=round(delay, 3),
                )
                print(
                    f"member {name} crashed (rc {rc}); respawn in "
                    f"{delay:.1f}s (attempt {attempts + 1}/"
                    f"{self.member_max_respawns})",
                    flush=True,
                )

    def _quarantine_member(self, name: str, rc: int) -> None:
        m = self.members[name]
        m["state"] = "quarantined"
        self._journal_decision(
            MEMBER_QUARANTINED, name, rc=rc, respawns=m["respawns"],
        )
        try:
            fu.record_failures(
                fu.failures_path(self.base_dir),
                "fleet.supervisor",
                [{
                    "block_id": f"member:{name}:crash_loop",
                    "sites": {"failover": 1},
                    "error": (
                        f"member {name} crash loop: {m['respawns']} "
                        f"respawns exhausted (last rc {rc})"
                    ),
                    "quarantined": True,
                    "resolved": False,
                    "resolution": QUARANTINE_MEMBER,
                    "member": name,
                }],
            )
        except Exception:
            pass
        print(
            f"member {name} quarantined after {m['respawns']} respawns "
            f"(last rc {rc}): {QUARANTINE_MEMBER}",
            file=sys.stderr, flush=True,
        )

    def _replace_on_fresh_dir(self, name: str) -> None:
        """Capacity back after an adoption: the old dir is the adoption
        record (rc-115 discipline: never reused), the lineage continues
        on a fresh dir under the same crash budget."""
        m = self.members[name]
        if m["respawns"] > self.member_max_respawns:
            self._quarantine_member(name, int(m.get("last_rc") or 0))
            return
        new_name = fresh_member_name(name)
        while new_name in self.members:
            new_name = fresh_member_name(new_name)
        new_dir = os.path.join(self.member_root, new_name)
        self._spawn_member(
            new_name, new_dir, record=MEMBER_RESPAWN,
            fresh_dir=True, replaces=name, attempt=m["respawns"],
        )
        self.members[new_name]["respawns"] = m["respawns"]
        self._write_members_file()

    def _respawn_pending(self) -> None:
        """Crashed members past their backoff.  The supervisor never
        fights the gateway's failover: an already-adopted member comes
        back on a fresh dir, a claim in flight postpones, and the
        same-dir path only runs once a live gateway has had a full
        detection window and still nobody claimed the journal."""
        now = time.monotonic()
        for name, m in list(self.members.items()):
            if m["state"] != "backoff" or now < (m.get("backoff_until")
                                                 or 0.0):
                continue
            fs = self._fleet_state() or {}
            view = (fs.get("members") or {}).get(name) or {}
            if view.get("adopted_by"):
                # the gateway won the race: old dir = adoption record
                self._journal_decision(
                    MEMBER_ADOPTED, name, adopter=view["adopted_by"],
                )
                m["respawns"] += 1
                m["state"] = "adopted"
                self._replace_on_fresh_dir(name)
                continue
            if read_adoption_claim(m["base_dir"]) is not None:
                m["backoff_until"] = now + self.health_interval_s
                continue
            gw_uptime = now - (self.gateway_started_at or now)
            gateway_settled = (
                self.gateway_booted
                and self.gateway_proc is not None
                and self.gateway_proc.poll() is None
                and gw_uptime > (
                    self.member_stale_s + 3.0 * self.health_interval_s
                )
            )
            if not gateway_settled:
                m["backoff_until"] = now + self.health_interval_s
                continue
            claim = acquire_adoption_claim(
                m["base_dir"], by=f"respawn:{name}", pid=os.getpid(),
            )
            if claim is None:
                m["backoff_until"] = now + self.health_interval_s
                continue
            # fence the dead incarnation before its successor boots,
            # same as the gateway's own respawn path
            journal_mod.mint_fence(m["base_dir"], by=f"respawn:{name}")
            m["respawns"] += 1
            self._spawn_member(
                name, m["base_dir"], record=MEMBER_RESPAWN,
                fresh_dir=False, attempt=m["respawns"],
                rc=m.get("last_rc"),
            )
            self._pending_release.append({
                "name": name, "claim": claim, "deadline": now + 120.0,
            })

    def _release_pending(self) -> None:
        """Release same-dir respawn claims once the fresh server's
        endpoint names its pid (it owns its journal again) — or on
        boot failure/timeout, so adoption can take over."""
        for rec in list(self._pending_release):
            m = self.members.get(rec["name"])
            if m is None:
                self._pending_release.remove(rec)
                continue
            proc = m.get("proc")
            doc = fu.read_json_if_valid(
                os.path.join(m["base_dir"], ENDPOINT_FILENAME)
            ) or {}
            booted = proc is not None and doc.get("pid") == proc.pid
            died = proc is not None and proc.poll() is not None
            if booted or died or time.monotonic() > rec["deadline"]:
                release_adoption_claim(m["base_dir"], rec["claim"])
                self._pending_release.remove(rec)

    def _tick_registration(self) -> None:
        """Tell the gateway about members it did not boot with
        (fresh-dir respawns, scale-ups).  Best-effort every tick: a
        gateway that was down catches up here, or at its next cold boot
        from ``members.json``."""
        if not self.gateway_booted:
            return
        for name, m in self.members.items():
            if m.get("registered") or m["state"] not in ("running",):
                continue
            status, doc = self._gateway_call(
                "POST", "/members",
                {"op": "add", "name": name, "base_dir": m["base_dir"]},
            )
            if status == 200 or (
                status == 409 and doc.get("error") == "member_exists"
            ):
                m["registered"] = True

    def _retire_member(self, name: str) -> None:
        """A drained member leaves the roster: retired from the gateway
        table (so scale-down can never trigger a noise adoption of its
        journal) and from ``members.json``."""
        m = self.members[name]
        m["state"] = "retired"
        self._gateway_call(
            "POST", "/members", {"op": "retire", "name": name},
        )
        self._write_members_file()

    # -- scaling -----------------------------------------------------------
    def _note_scale(self, decision: str, reason: str) -> None:
        if (self.last_scale.get("decision") == decision
                and self.last_scale.get("reason") == reason):
            return
        self.last_scale = {
            "decision": decision, "reason": reason,
            "time": trace_mod.walltime(),
        }

    def _fleet_state(self) -> Optional[Dict[str, Any]]:
        """The gateway's view, only if fresh — a stale file (gateway
        down) must not drive scale decisions."""
        fs = fu.read_json_if_valid(
            os.path.join(self.base_dir, FLEET_STATE_FILENAME)
        )
        if not fs:
            return None
        age = trace_mod.walltime() - float(fs.get("time") or 0)
        if age > 5.0 * self.health_interval_s + 5.0:
            return None
        return fs

    def _tick_scaling(self) -> None:
        """Backlog-driven scaling, chaos-proof by construction: HOLD
        whenever any adoption, drain, respawn, or boot is in flight —
        a scale decision never fights the lifecycle machinery."""
        now = time.monotonic()
        fs = self._fleet_state()
        if fs is None or not self.gateway_booted:
            self._note_scale("hold", "gateway not ready")
            self._pressure_since = self._idle_since = None
            return
        members_view = fs.get("members") or {}
        live = [
            v for v in members_view.values()
            if v.get("alive") and not v.get("draining")
            and not v.get("adopted_by")
        ]
        dead_unadopted = list(fs.get("dead_unadopted") or [])
        draining = [
            n for n, v in members_view.items() if v.get("draining")
        ]
        pending = [
            n for n, m in self.members.items()
            if m["state"] == "backoff"
            or (m["state"] == "running"
                and not (members_view.get(n) or {}).get("alive"))
        ]
        if dead_unadopted or draining or pending or self._pending_release:
            self._note_scale(
                "hold",
                f"lifecycle in flight (dead={len(dead_unadopted)} "
                f"draining={len(draining)} booting_or_backoff="
                f"{len(pending)})",
            )
            self._pressure_since = self._idle_since = None
            return
        backlog = sum(
            int(v.get("queued") or 0) + int(v.get("inflight") or 0)
            for v in live
        )
        # only LIVE members' breakers are pressure: a dead-and-adopted
        # member's breaker stays open forever, and its capacity was
        # already replaced by the fresh-dir respawn — counting it would
        # scale up once per sustain window until max_members
        breakers_open = sum(
            1 for v in live
            if ((v.get("breaker") or {}).get("state") == "open")
        )
        per_member = backlog / max(1, len(live))
        if (per_member >= self.scale_up_backlog or breakers_open) and (
            len(live) < self.max_members
        ):
            self._idle_since = None
            if self._pressure_since is None:
                self._pressure_since = now
                self._note_scale(
                    "hold",
                    f"pressure building (backlog={backlog} "
                    f"breakers_open={breakers_open})",
                )
                return
            if now - self._pressure_since < self.scale_sustain_s:
                return
            self._pressure_since = None
            idx = 0
            while f"s{idx}" in self.members:
                idx += 1
            name = f"s{idx}"
            self._journal_decision(
                SCALE_UP, name, backlog=backlog,
                per_member=round(per_member, 2),
                breakers_open=breakers_open, live=len(live),
            )
            self._spawn_member(
                name, os.path.join(self.member_root, name),
                record=MEMBER_SPAWN, scale_up=True,
            )
            self._write_members_file()
            self._note_scale(
                "scale_up",
                f"sustained backlog {backlog} over {len(live)} members",
            )
            return
        if backlog == 0 and len(live) > self.min_members:
            self._pressure_since = None
            if self._idle_since is None:
                self._idle_since = now
                return
            if now - self._idle_since < self.scale_idle_s:
                return
            self._idle_since = None
            status, doc = self._gateway_call("POST", "/drain", {})
            if status == 200 and doc.get("member"):
                target = str(doc["member"])
                tm = self.members.get(target)
                if tm is not None:
                    tm["drain_requested"] = True
                self._journal_decision(
                    SCALE_DOWN, target, live=len(live),
                    idle_s=round(self.scale_idle_s, 1),
                )
                self._note_scale(
                    "scale_down",
                    f"idle {self.scale_idle_s:.0f}s with {len(live)} "
                    "members",
                )
            return
        self._pressure_since = self._idle_since = None
        self._note_scale("hold", "steady")

    # -- operator view -----------------------------------------------------
    def _state_doc(self) -> Dict[str, Any]:
        now = time.monotonic()
        gw_proc = self.gateway_proc
        hb = read_heartbeat(self.base_dir, GATEWAY_UID) or {}
        hb_age = None
        if hb.get("time") is not None:
            hb_age = max(0.0, trace_mod.walltime() - float(hb["time"]))
        members = {}
        for n, m in self.members.items():
            backoff_remaining = None
            if m["state"] == "backoff" and m.get("backoff_until"):
                backoff_remaining = max(0.0, m["backoff_until"] - now)
            members[n] = {
                "base_dir": m["base_dir"],
                "pid": m.get("pid"),
                "state": m["state"],
                "respawns": int(m["respawns"]),
                "last_rc": m.get("last_rc"),
                "backoff_remaining_s": (
                    round(backoff_remaining, 3)
                    if backoff_remaining is not None else None
                ),
                "quarantined": m["state"] == "quarantined",
            }
        crash_loops = sorted(
            n for n, m in self.members.items()
            if m["state"] == "quarantined"
        )
        return {
            "version": 1,
            "role": "supervisor",
            "uid": SUPERVISOR_UID,
            "pid": os.getpid(),
            "hostname": socket.gethostname(),
            "time": trace_mod.walltime(),
            "base_dir": self.base_dir,
            "gateway": {
                "pid": self.gateway_pid,
                "incarnation": self.incarnation,
                "alive": bool(gw_proc is not None
                              and gw_proc.poll() is None),
                "booted": self.gateway_booted,
                "restarts": self.gateway_restarts,
                "port": self.gateway_port,
                "heartbeat_age_s": (
                    round(hb_age, 3) if hb_age is not None else None
                ),
                "quarantined": self.gateway_failed,
            },
            "members": members,
            "scale": dict(self.last_scale),
            "crash_loops": crash_loops,
            "gateway_crash_loop": self.gateway_failed,
        }

    def _write_state(self) -> None:
        try:
            fu.atomic_write_json(
                os.path.join(self.base_dir, SUPERVISOR_STATE_FILENAME),
                self._state_doc(),
            )
        except OSError:
            pass  # best-effort; the supervisor outlives a full disk

    # -- boot + drain ------------------------------------------------------
    def _wait_members_boot(self, deadline_s: float = 120.0) -> bool:
        """Wait for each member's endpoint file to name its CURRENT pid
        (a stale file from a previous incarnation must not fake a live
        boot)."""
        deadline = time.monotonic() + deadline_s
        for name, m in self.members.items():
            while True:
                doc = fu.read_json_if_valid(
                    os.path.join(m["base_dir"], ENDPOINT_FILENAME)
                )
                proc = m["proc"]
                if doc and doc.get("pid") == proc.pid:
                    break
                if proc.poll() is not None:
                    print(
                        f"member {name} died during boot "
                        f"(rc {proc.returncode})", file=sys.stderr,
                    )
                    return False
                if time.monotonic() > deadline:
                    print(f"member {name} did not bind in time",
                          file=sys.stderr)
                    return False
                time.sleep(0.1)
        return True

    def _drain_all(self) -> None:
        """The standard protocol fleet-wide: SIGTERM the gateway child
        (exits 114), then every live member (each drains at its safe
        boundaries and exits 114)."""
        proc = self.gateway_proc
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                rc = proc.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            print(f"gateway exited rc {rc}", flush=True)
        for name, m in self.members.items():
            p = m.get("proc")
            if p is not None and p.poll() is None:
                p.terminate()
        for name, m in self.members.items():
            p = m.get("proc")
            if p is None:
                continue
            try:
                rc = p.wait(timeout=60.0)
            except subprocess.TimeoutExpired:
                p.kill()
                rc = p.wait()
            print(f"member {name} exited rc {rc}", flush=True)
        self._write_state()

    def run(self) -> int:
        install_drain_handler()
        self._ledger = journal_mod.Journal(
            os.path.join(self.base_dir, LIFECYCLE_LOG_FILENAME)
        )
        self._ledger.recover()
        self._heartbeat = HeartbeatWriter(
            self.base_dir, SUPERVISOR_UID, interval_s=2.0
        ).start()
        try:
            for m in list(self.members.values()):
                self._spawn_member(m["name"], m["base_dir"])
                m["registered"] = True  # the gateway boots with them
            self._write_members_file()
            if not self._wait_members_boot():
                self._drain_all()
                return 1
            self._spawn_gateway("boot")
            while not drain_requested():
                if self.gateway_failed:
                    self._drain_all()
                    return 1
                self._tick_gateway()
                self._tick_members()
                self._respawn_pending()
                self._release_pending()
                self._tick_registration()
                self._tick_scaling()
                self._write_state()
                time.sleep(self.poll_s)
            self._drain_all()
            print(
                f"DRAINED ({drain_reason() or 'drain requested'}); "
                f"exiting {REQUEUE_EXIT_CODE} for requeue",
                flush=True,
            )
            return REQUEUE_EXIT_CODE
        finally:
            if self._heartbeat is not None:
                self._heartbeat.stop()
            if self._ledger is not None:
                self._ledger.close()

    def seed_members(self, n_members: int) -> None:
        """Register the boot-time roster (``members/m0..mN``) without
        spawning yet — :meth:`run` spawns them."""
        for i in range(n_members):
            name = f"m{i}"
            mdir = os.path.join(self.member_root, name)
            os.makedirs(mdir, exist_ok=True)
            self.members[name] = {
                "name": name, "base_dir": mdir, "proc": None, "pid": None,
                "state": "running", "respawns": 0, "registered": True,
                "last_rc": None, "backoff_until": None,
                "drain_requested": False,
            }


# -- CLI ----------------------------------------------------------------------


def cmd_status(base_dir: str) -> int:
    from .runtime.server import ServeClient

    client = ServeClient.from_endpoint_file(base_dir)
    doc = client.status()
    print(json.dumps(doc, indent=2))
    return int(doc.get("rc") or 0)


def cmd_drain(base_dir: str, member=None) -> int:
    from .runtime.server import ServeClient

    client = ServeClient.from_endpoint_file(base_dir)
    status, doc = client._call(
        "POST", "/drain", {"member": member} if member else {},
    )
    print(json.dumps(doc, indent=2))
    return 0 if status == 200 else 1


def _run_gateway_child(args) -> int:
    """The hidden ``--gateway-child`` entry: the gateway as its OWN
    crash-only process.  Membership comes from ``members.json`` (so a
    restarted incarnation knows members added mid-run), state comes
    from :meth:`FleetGateway._rebuild_from_disk`, and ``spawn`` is None
    — respawns are the supervisor's job now."""
    base_dir = os.path.abspath(args.base_dir)
    cfg = _load_fleet_config(args.config)
    gw_cfg = dict(cfg.get("gateway") or {})
    doc = fu.read_json_if_valid(
        os.path.join(base_dir, MEMBERS_FILENAME)
    ) or {}
    member_dirs = [
        str(m["base_dir"]) for m in (doc.get("members") or [])
        if m.get("base_dir")
    ]
    if not member_dirs:
        print("gateway-child: empty or missing members.json",
              file=sys.stderr)
        return 1
    install_drain_handler()
    gateway = FleetGateway(
        base_dir=base_dir,
        member_dirs=member_dirs,
        port=args.port,
        affinity=bool(gw_cfg.get("affinity", True)),
        health_interval_s=float(gw_cfg.get("health_interval_s", 1.0)),
        member_stale_s=float(gw_cfg.get("member_stale_s", 6.0)),
        max_member_queue=int(gw_cfg.get("max_member_queue", 64)),
        call_timeout_s=float(gw_cfg.get("call_timeout_s", 10.0)),
        failover=str(gw_cfg.get("failover", "adopt")),
        spawn=None,
        breaker_threshold=int(gw_cfg.get("breaker_threshold", 2)),
        breaker_cooldown_s=float(gw_cfg.get("breaker_cooldown_s", 2.0)),
        hedge=bool(gw_cfg.get("hedge", True)),
        hedge_min_delay_s=float(gw_cfg.get("hedge_min_delay_s", 0.05)),
        hedge_max_delay_s=float(gw_cfg.get("hedge_max_delay_s", 2.0)),
        incarnation=int(args.incarnation),
    )
    gateway.start()
    try:
        gateway.serve_until_drained()
    except DrainInterrupt as e:
        # a drained gateway is a requeue, not a crash
        print(
            f"gateway DRAINED ({e.reason}); exiting {REQUEUE_EXIT_CODE}",
            flush=True,
        )
        return REQUEUE_EXIT_CODE
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cluster_tools_tpu_torch.fleet",
        description="supervised serving fleet: supervisor + gateway + M "
                    "pipeline servers (docs/SERVING.md \"Fleet\")",
    )
    p.add_argument("--base-dir", required=False,
                   help="fleet scratch dir (gateway state + members/mN "
                        "server dirs)")
    p.add_argument("--members", type=int, default=None,
                   help="number of member servers to spawn (default 2)")
    p.add_argument("--port", type=int, default=0,
                   help="gateway bind port (default 0 = ephemeral, see "
                        "server.json)")
    p.add_argument("--config", default=None,
                   help="fleet config json: members/gateway/server/"
                        "supervisor keys")
    p.add_argument("--status", metavar="BASE_DIR", default=None,
                   help="print a running gateway's /status and exit with "
                        "its rc")
    p.add_argument("--drain", metavar="BASE_DIR", default=None,
                   help="SIGTERM the emptiest member of a running fleet "
                        "(scale-down; rc 114 on the member)")
    p.add_argument("--member", default=None,
                   help="with --drain: the member to drain instead of "
                        "the emptiest")
    p.add_argument("--gateway-child", action="store_true",
                   help=argparse.SUPPRESS)  # internal: supervisor's child
    p.add_argument("--incarnation", type=int, default=1,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.status:
        return cmd_status(args.status)
    if args.drain:
        return cmd_drain(args.drain, member=args.member)
    if not args.base_dir:
        p.error("--base-dir is required (unless --status/--drain)")
    if args.gateway_child:
        return _run_gateway_child(args)

    cfg = _load_fleet_config(args.config)
    n_members = int(
        args.members if args.members is not None
        else cfg.get("members", 2)
    )
    if n_members < 1:
        p.error("--members must be >= 1")
    supervisor = FleetSupervisor(
        args.base_dir, n_members, port=args.port, cfg=cfg,
        config_path=args.config,
    )
    supervisor.seed_members(n_members)
    return supervisor.run()


if __name__ == "__main__":
    sys.exit(main())
