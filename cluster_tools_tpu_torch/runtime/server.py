"""Service mode: a resident, multi-tenant pipeline server (docs/SERVING.md).

Port of ``cluster_tools_tpu/runtime/server.py`` with the same names, HTTP
routes, journal records and state files, adapted in four places: a payload
that names no ``target`` runs on ``"gpu"`` (the card; it fails with the
device error where there is none, never on the CPU); workflow names resolve
through :data:`..cli.WORKFLOWS`, which resolves every name of the
reference's, and a submission that raises ``NotImplementedError`` answers
HTTP 501 ``not_ported`` (no ported workflow raises it today);
``program_cache_size`` and the ``programs`` block are kept for configs
written for the reference but hold nothing (see
:meth:`PipelineServer.program_cache_stats`); and a request's record
carries ``kernel_launches``, the hand-kernel launches counted under it,
when there were any.  Journal adoption
(:meth:`PipelineServer.adopt_journal`, ``POST /adopt``) is the reference's,
so a port server adopts a journal the JAX package's server wrote and the
reverse (``runtime/fleet.py``).

The batch CLI pays the cold tax on every invocation — the decompressed-
chunk cache and in-memory handoffs die with the process.
:class:`PipelineServer` is the resident owner those assets were waiting
for: one long-lived process that accepts concurrent workflow requests (the
existing task DAGs — watershed, connected_components, multicut, inference)
over a local HTTP endpoint, executes them on a small worker pool, and
keeps every process-wide cache warm across requests.

Admission is per-tenant (``runtime/admission.py``): quotas on queue depth,
concurrent workflows, and bytes in flight, deficit-round-robin dispatch
between tenants, queue deadlines, and typed backpressure errors — every
rejection is recorded in the server's ``failures.json`` (resolution
``rejected:*``), so admission failures are attributed like any other
fault.  Each request runs under an ambient request context: handoff
identities are namespaced by request id (two concurrent requests over the
same dataset paths can never resolve each other's intermediates), the
executor caps its inflight byte budget at the tenant's share, and a
``task.run``-shaped trace span brackets the whole request so a
``CTT_TRACE=<dir>``-pinned server lands every request's spans on one
resident-process timeline.

The operational surface is the planes the runtime already ships:

- **Drain**: SIGTERM flips the drain latch — admission stops,
  in-flight requests drain at their safe block/task boundaries (markers +
  manifests flushed), queued ones stay recorded for resubmission, and the
  entry point exits ``REQUEUE_EXIT_CODE`` (114) so rolling restarts ride
  the same protocol as every other preempted job.
- **Status**: ``GET /status`` returns the machine-readable run report
  (the ``failures_report.py --json`` document over the server's base
  directory) plus live per-tenant admission stats; its ``rc`` field
  preserves the report's exit-code semantics (1 on unresolved failures /
  torn manifests).
- **Progress**: the server heartbeats (``heartbeats/server.json``) and
  maintains ``server_state.json`` next to its ``failures.json``;
  ``scripts/progress.py`` renders per-tenant queue depth / in-flight /
  completed alongside the block-marker view (``make progress`` against a
  live server).

Resident-owner handoff policy (docs/PERFORMANCE.md "Task-graph fusion"):
``memory_handoffs`` defaults ON for the in-process workflows the server
owns (cluster targets stay off — their memory dies with the remote job).
When a request completes, its live *dataset* handoffs are written back to
storage (the client-visible durability contract) and every entry of its
namespace is released, so a resident process never accretes dead request
state and rejected/failed requests leave no orphaned handoff entries.

Durability (docs/SERVING.md "Durability"): every request lifecycle
transition is an fsync'd, CRC-framed record in the submission journal
(``runtime/journal.py``) written *before* the state is acknowledged over
HTTP, and :meth:`PipelineServer.start` replays the journal before binding
the endpoint — completed requests answer duplicate resubmits idempotently
from their recorded results, acknowledged-but-incomplete requests are
re-enqueued with their original tenant/payload and resume at block grain,
tenant admission counters are reconstructed, and a request whose replay
keeps crashing the server is quarantined (``quarantined:crash_loop``)
after ``max_replay_attempts`` instead of wedging the restart loop.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import socket
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from ..utils import function_utils as fu
from ..utils import task_utils as tu
from . import admission as admission_mod
from . import faults as faults_mod
from . import handoff as handoff_mod
from . import journal as journal_mod
from . import netio
from . import scrub as scrub_mod
from . import trace as trace_mod
from .supervision import (
    DrainInterrupt,
    HeartbeatWriter,
    drain_reason,
    drain_requested,
)

SERVER_UID = "server"
STATE_FILENAME = "server_state.json"
ENDPOINT_FILENAME = "server.json"

#: the crash-loop quarantine resolution recorded in failures.json when a
#: replayed request has crashed the server ``max_replay_attempts`` times
QUARANTINE_CRASH_LOOP = "quarantined:crash_loop"

#: failures.json resolution recorded when this member discovers it was
#: fenced — declared dead and adopted away while wedged (docs/SERVING.md
#: "Gray failures").  The member self-drains and exits
#: ``FENCED_EXIT_CODE`` without another journal byte or store write.
FENCED_RESOLUTION = "fenced:adopted_away"

#: completed/terminal request records kept in memory (oldest pruned)
_MAX_RECORDS = 512

_CLUSTER_TARGETS = ("slurm", "lsf")

#: where a payload names no target: the card (the reference's is "local")
DEFAULT_TARGET = "gpu"

#: the typed HTTP error (501) of a refused, not yet ported workflow name
NOT_PORTED = "not_ported"

#: request-record states the journal's terminal record types map to
_JOURNAL_TERMINAL = {"done": journal_mod.COMPLETED,
                     "failed": journal_mod.FAILED,
                     "drained": journal_mod.DRAINED}


def _payload_fingerprint(payload: Dict[str, Any]) -> str:
    """Canonical digest of a submission payload: a resubmit with the SAME
    fingerprint under a live/terminal id is the client's retry of an
    acknowledged request (answered idempotently), a different one is a
    real id collision (``rejected:duplicate``)."""
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]


def _resolve_workflow(name: str):
    """A workflow class from the CLI registry (:data:`..cli.WORKFLOWS`) or
    an explicit ``module:Class`` spec."""
    from ..cli import WORKFLOWS, resolve_spec

    spec = WORKFLOWS.get(name, name)
    if ":" not in spec:
        raise ValueError(
            f"unknown workflow {name!r}; known: {sorted(WORKFLOWS)} "
            "(or pass an explicit 'module:Class' spec)"
        )
    return resolve_spec(spec)


class PipelineServer:
    """The resident server: admission controller + worker pool + HTTP
    endpoint + state/heartbeat files.  See the module docstring for the
    architecture and docs/SERVING.md for the operator guide."""

    def __init__(
        self,
        base_dir: str,
        tenants: Optional[Dict[str, Dict[str, Any]]] = None,
        default_quota: Optional[Dict[str, Any]] = None,
        max_workers: int = 2,
        default_est_bytes: int = 0,
        default_max_jobs: int = 2,
        host: str = "127.0.0.1",
        port: int = 0,
        journal: bool = True,
        max_replay_attempts: int = 3,
        program_cache_size: Optional[int] = None,
        scrub: Optional[Dict[str, Any]] = None,
        journal_rotate_bytes: Optional[int] = None,
    ):
        self.base_dir = os.path.abspath(base_dir)
        os.makedirs(self.base_dir, exist_ok=True)
        self.failures_path = fu.failures_path(self.base_dir)
        self.default_est_bytes = int(default_est_bytes)
        self.default_max_jobs = int(default_max_jobs)
        self.max_workers = max(1, int(max_workers))
        self.max_replay_attempts = max(1, int(max_replay_attempts))
        #: boot-time journal size guard (docs/SERVING.md "Durability"):
        #: past this many bytes a clean boot snapshots live state into a
        #: fresh segment and archives the old one as journal.log.old.
        #: Coerced here so a malformed config value fails loudly at
        #: construction, not inside the boot's best-effort rotation.
        self.journal_rotate_bytes = (
            None if journal_rotate_bytes is None
            else int(journal_rotate_bytes)
        )
        # the resident scrubber (docs/SERVING.md "Self-healing"): walks
        # digest sidecars of the products this server owns, verifies a
        # budgeted number of bytes per interval, repairs from lineage.
        # Config: {"enabled", "interval_s", "bytes_per_interval",
        # "roots"}; default on with the module's modest budget.
        scrub_cfg = dict(scrub or {})
        scrub_roots = [self.base_dir] + list(scrub_cfg.pop("roots", []) or [])
        self.scrubber: Optional[scrub_mod.Scrubber] = scrub_mod.Scrubber(
            base_dir=self.base_dir,
            roots=scrub_roots,
            **scrub_cfg,
        )
        # the durable submission journal (docs/SERVING.md "Durability");
        # off only for embedders that explicitly opt out of the ack
        # contract (tests of the pre-journal paths)
        self._journal: Optional[journal_mod.Journal] = (
            journal_mod.Journal(journal_mod.journal_path(self.base_dir))
            if journal else None
        )
        #: replay outcome of the LAST start(): rendered by /healthz,
        #: server_state.json, and scripts/progress.py
        self._replay_stats = {"replayed": 0, "reenqueued": 0,
                              "quarantined": 0}
        quotas = {
            name: admission_mod.TenantQuota.from_config(doc)
            for name, doc in (tenants or {}).items()
        }
        self.controller = admission_mod.AdmissionController(
            quotas=quotas,
            default_quota=admission_mod.TenantQuota.from_config(default_quota),
            on_reject=self._on_reject,
        )
        self._requests: "Dict[str, Dict[str, Any]]" = {}
        self._requests_lock = threading.Lock()
        #: fencing (docs/SERVING.md "Gray failures"): armed in start(),
        #: re-validated before every journal append + handoff flush; set
        #: once a higher epoch is discovered — the self-drain trigger
        self._fence_guard: Optional[journal_mod.FenceGuard] = None
        self._fenced_exc: Optional[journal_mod.Fenced] = None
        self._reject_seq = 0
        self._order: List[str] = []  # insertion order, for pruning
        #: journal adoptions this incarnation performed (fleet failover;
        #: docs/SERVING.md "Fleet") — surfaced in server_state.json
        self._adoptions: List[Dict[str, Any]] = []
        self._workers: List[threading.Thread] = []
        self._stop = threading.Event()
        self._heartbeat: Optional[HeartbeatWriter] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self.host = host
        self.port = int(port)
        self.started_at = trace_mod.walltime()
        # program_cache_size is accepted so a config written for the
        # reference loads; see program_cache_stats

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "PipelineServer":
        """Recover + replay the submission journal, then bind the
        endpoint and start workers + heartbeat, and write the endpoint
        file clients discover the port from.  Replay runs BEFORE the
        bind on purpose: a client reconnecting across the restart can
        never observe a window where an acknowledged request is
        missing."""
        if trace_mod.enabled():
            # one resident-process timeline: every request's spans land in
            # the server's trace dir (an operator CTT_TRACE=<dir> pin
            # targeting the same place is equivalent and also sticks)
            trace_mod.set_trace_dir(
                os.path.join(self.base_dir, trace_mod.TRACE_DIRNAME)
            )
        # fence ownership (docs/SERVING.md "Gray failures"): boot owning
        # whatever epoch is current — a respawned member adopts the epoch
        # its respawn minted.  From here every journal append and handoff
        # flush re-validates the epoch (one cached stat); a higher one
        # means a survivor adopted this journal and we must self-drain.
        self._fence_guard = journal_mod.FenceGuard(self.base_dir)
        if self._journal is not None:
            self._journal.fence_guard = self._fence_guard
        self._recover_journal()
        self._httpd = ThreadingHTTPServer(
            (self.host, self.port), _RequestHandler
        )
        self._httpd.pipeline = self  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-http",
            daemon=True,
        )
        self._http_thread.start()
        self._heartbeat = HeartbeatWriter(
            self.base_dir, SERVER_UID, interval_s=2.0
        ).start()
        if self.scrubber is not None:
            self.scrubber.start()
        for i in range(self.max_workers):
            t = threading.Thread(
                target=self._worker_loop, name=f"serve-worker-{i}",
                daemon=True,
            )
            t.start()
            self._workers.append(t)
        fu.atomic_write_json(
            os.path.join(self.base_dir, ENDPOINT_FILENAME),
            {
                "host": self.host,
                "port": self.port,
                "pid": os.getpid(),
                "hostname": socket.gethostname(),
                "time": trace_mod.walltime(),
            },
        )
        self._write_state()
        return self

    def serve_until_drained(self, poll_s: float = 0.2) -> None:
        """Block until the drain latch flips (SIGTERM/SIGUSR1), then drain:
        stop admission AND dispatch, let in-flight requests finish at
        their safe boundaries, flush state, and raise
        :class:`DrainInterrupt` for the entry point to map to
        ``REQUEUE_EXIT_CODE`` (docs/ANALYSIS.md CT006/CT009).  The caller
        must have installed the drain handler
        (:func:`~.supervision.install_drain_handler`)."""
        while not drain_requested():
            if self._fenced_exc is not None:
                # adopted away while wedged (docs/SERVING.md "Gray
                # failures"): stop answering, bounded-join the workers
                # (an in-flight request hits the fence at its next
                # journal append or flush and unwinds), and exit
                # FENCED_EXIT_CODE — never rc 114: a supervisor must not
                # respawn us onto a journal a survivor now owns
                self._stop.set()
                self.controller.begin_drain()
                for t in self._workers:
                    t.join(timeout=10.0)
                self._write_state()
                self._teardown()
                raise self._fenced_exc
            time.sleep(poll_s)
        self.controller.begin_drain()
        for t in self._workers:
            t.join()
        self._write_state()
        self._teardown()
        raise DrainInterrupt(
            drain_reason() or "drain requested",
        )

    def stop(self) -> None:
        """Cooperative shutdown for embedders/tests: stop dispatching,
        wait for workers, tear the endpoint down.  No drain semantics —
        use :meth:`serve_until_drained` for the SIGTERM protocol."""
        self.controller.begin_drain()
        self._stop.set()
        for t in self._workers:
            t.join(timeout=60.0)
        self._write_state()
        self._teardown()

    def _teardown(self) -> None:
        if self.scrubber is not None:
            self.scrubber.stop()
        if self._heartbeat is not None:
            self._heartbeat.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._journal is not None:
            self._journal.close()

    def program_cache_stats(self) -> None:
        """Always None: eager torch builds no program per shape, and
        ``build.py`` loads the hand kernels once per process."""
        return None

    # -- journal + replay (docs/SERVING.md "Durability") -------------------
    def _journal_append(self, typ: str, request_id: str,
                        **fields: Any) -> None:
        """One lifecycle transition into the journal (fsync'd; a no-op
        with the journal off).  Never called under the admission/request
        locks — an fsync is a disk round trip (ctlint CT010).  Raises
        :class:`~.journal.Fenced` — with the
        record UNWRITTEN and the self-drain armed — when a survivor has
        adopted this journal (fence check under the journal lock)."""
        if self._journal is not None:
            try:
                self._journal.append_transition(typ, request_id, **fields)
            except journal_mod.Fenced as e:
                self._note_fenced(e)
                raise

    def _note_fenced(self, exc: journal_mod.Fenced) -> None:
        """First fence discovery wins: record ``fenced:adopted_away`` in
        failures.json, stop admission, and arm the self-drain (the serve
        loop exits ``FENCED_EXIT_CODE``).  Idempotent — every later
        fenced append re-raises without re-recording."""
        with self._requests_lock:
            if self._fenced_exc is not None:
                return
            self._fenced_exc = exc
        fu.log(
            f"server {self.base_dir}: FENCED — epoch {exc.own_epoch} "
            f"superseded by {exc.current_epoch} "
            f"({exc.minted_by or 'unknown'}); self-draining without "
            "another journal byte or store write"
        )
        try:
            fu.record_failures(
                self.failures_path,
                "server.fleet",
                [{
                    "block_id": f"fenced:{os.getpid()}",
                    "sites": {"fence": 1},
                    "error": str(exc),
                    "quarantined": False,
                    # resolved on the quarantine precedent: the fence DID
                    # its job — the record is the operator's pointer to
                    # the zombie incarnation, not an open problem
                    "resolved": True,
                    "resolution": FENCED_RESOLUTION,
                    "own_epoch": exc.own_epoch,
                    "fence_epoch": exc.current_epoch,
                    "minted_by": exc.minted_by,
                }],
            )
        except Exception:
            pass  # attribution is best-effort; the fence stands
        trace_mod.instant(
            "server.fenced", own_epoch=exc.own_epoch,
            fence_epoch=exc.current_epoch, by=exc.minted_by or "",
        )
        self.controller.begin_drain()
        self._write_state()

    @property
    def fenced(self) -> bool:
        return self._fenced_exc is not None

    def journal_health(self) -> Optional[Dict[str, Any]]:
        """The journal block of ``/healthz`` / ``server_state.json``:
        append/fsync stats, the replay outcome of this incarnation, and
        the live replay backlog (re-enqueued requests not yet
        terminal)."""
        if self._journal is None:
            return None
        doc = self._journal.health()
        doc.update(self._replay_stats)
        with self._requests_lock:
            doc["replay_backlog"] = sum(
                1 for rec in self._requests.values()
                if rec.get("replayed")
                and rec.get("state") in ("queued", "running")
            )
        return doc

    def _recover_journal(self) -> None:
        """Replay the journal into the restarted server: terminal
        requests become idempotently-answerable records, acknowledged-
        but-incomplete ones re-enter the queue with their original
        payload (resuming at block grain through the ordinary marker /
        handoff-invalidation machinery), tenant counters are
        reconstructed, and crash-looping requests are quarantined."""
        if self._journal is None:
            return
        records = self._journal.recover()
        folded = journal_mod.fold(records)
        inj = faults_mod.get_injector()
        counts: Dict[str, Dict[str, int]] = {}
        for rid, ent in folded.items():
            tenant = ent["tenant"]
            c = counts.setdefault(tenant, {
                "submitted": 0, "dispatched": 0, "completed": 0,
                "rejected": 0,
            })
            state = ent["state"]
            if state == journal_mod.REJECTED:
                # typed rejections are terminal AND replaceable — no
                # record is rebuilt, the id stays free for a resubmit.
                # A rejected entry WITH a payload was accepted first
                # (deadline expiry after admission), so its submitted
                # count is restored too.
                c["rejected"] += 1
                if ent.get("payload") is not None:
                    c["submitted"] += 1
                continue
            if state in (journal_mod.COMPLETED, journal_mod.FAILED,
                         journal_mod.QUARANTINED):
                c["submitted"] += 1
                c["dispatched"] += ent["attempts"]
                if state == journal_mod.COMPLETED:
                    c["completed"] += 1
                rec = dict(ent.get("record") or {})
                rec.setdefault("request_id", rid)
                rec.setdefault("tenant", tenant)
                rec.setdefault("state", {
                    journal_mod.COMPLETED: "done",
                    journal_mod.FAILED: "failed",
                    journal_mod.QUARANTINED: "quarantined",
                }[state])
                rec.setdefault("fingerprint", ent.get("fingerprint"))
                rec["replayed"] = True
                with self._requests_lock:
                    self._requests[rid] = rec
                    self._order.append(rid)
                    self._prune_locked()
                self._replay_stats["replayed"] += 1
                continue
            # acknowledged but incomplete (accepted/dispatched/drained):
            # the 200 was a durable promise — finish it, unless finishing
            # it is what keeps killing the server
            if ent["attempts"] >= self.max_replay_attempts:
                c["submitted"] += 1
                c["dispatched"] += ent["attempts"]
                self._quarantine_crash_loop(ent)
                continue
            # prior crashed attempts stay on the tenant's dispatched
            # count; submit() below restores the submitted count
            c["dispatched"] += ent["attempts"]
            self._reenqueue_replayed(ent)
            # chaos coverage: dying mid-replay must be recoverable — the
            # journal is unchanged by re-enqueueing, so the next boot
            # folds to the same decision
            inj.kill_point("journal_replay")
        for tenant, c in counts.items():
            if any(c.values()):
                self.controller.restore_counts(tenant, **c)
        # boot-time size guard (docs/SERVING.md "Durability"): a clean
        # boot past the threshold snapshots the folded live state into a
        # fresh segment and archives the old one — unbounded journal
        # growth stops here (full compaction stays future work)
        try:
            # terminal snapshots beyond the in-memory record cap cannot
            # be answered idempotently anyway — prune them with rotation
            self._journal.maybe_rotate(folded, self.journal_rotate_bytes,
                                       keep_terminal=_MAX_RECORDS)
        except Exception:
            pass  # rotation is an optimization; the boot must not fail
        self._write_state()

    def _reenqueue_replayed(self, ent: Dict[str, Any]) -> None:
        rid = ent["request_id"]
        payload = dict(ent.get("payload") or {})
        request = admission_mod.Request(
            tenant=ent["tenant"],
            request_id=rid,
            est_bytes=int(payload.get("est_bytes")
                          or self.default_est_bytes),
            # the original deadline_s bounded queue time in the dead
            # incarnation; the replayed promise is completion, so it is
            # not re-armed (docs/SERVING.md "Durability")
            deadline_s=None,
            payload=payload,
        )
        rec = {
            "request_id": rid,
            "tenant": ent["tenant"],
            "workflow": str(payload.get("workflow")),
            "state": "queued",
            "replayed": True,
            "attempts": int(ent["attempts"]),
            "fingerprint": ent.get("fingerprint"),
            "submitted": trace_mod.walltime(),
            "queue_span": trace_mod.begin(
                "server.queue", request=rid, tenant=ent["tenant"],
                replayed=True,
            ),
            "tmp_folder": self._tmp_folder(payload, rid),
        }
        with self._requests_lock:
            self._requests[rid] = rec
            self._order = [r for r in self._order if r != rid]
            self._order.append(rid)
        # admitted=True: the dead incarnation already charged this
        # request against the tenant's quota when it acknowledged it;
        # replay never re-litigates (or rejects) its own promise — the
        # admitted path enqueues unconditionally
        self.controller.submit(request, admitted=True)
        self._replay_stats["reenqueued"] += 1
        trace_mod.instant(
            "server.replay", request=rid, tenant=ent["tenant"],
            attempts=int(ent["attempts"]),
        )

    def _quarantine_crash_loop(self, ent: Dict[str, Any]) -> None:
        """Crash-loop defense: a replayed request whose dispatch has
        crashed the server ``max_replay_attempts`` times is quarantined —
        journaled, attributed in ``failures.json`` as
        ``quarantined:crash_loop``, and answered idempotently as
        ``quarantined`` from then on — instead of wedging the server in a
        replay loop."""
        rid = ent["request_id"]
        tenant = ent["tenant"]
        payload = ent.get("payload") or {}
        error = (
            f"request crashed the server {ent['attempts']} time(s); "
            f"quarantined after max_replay_attempts="
            f"{self.max_replay_attempts}"
        )
        rec = {
            "request_id": rid,
            "tenant": tenant,
            "workflow": str(payload.get("workflow")),
            "state": "quarantined",
            "code": QUARANTINE_CRASH_LOOP,
            "attempts": int(ent["attempts"]),
            "fingerprint": ent.get("fingerprint"),
            "replayed": True,
            "error": error,
            "finished": trace_mod.walltime(),
        }
        self._journal_append(
            journal_mod.QUARANTINED, rid, tenant=tenant, record=rec,
        )
        with self._requests_lock:
            self._requests[rid] = rec
            self._order = [r for r in self._order if r != rid]
            self._order.append(rid)
        try:
            fu.record_failures(
                self.failures_path,
                f"server.{tenant}",
                [{
                    "block_id": f"request:{rid}",
                    "sites": {"journal_replay": int(ent["attempts"])},
                    "error": error,
                    "quarantined": True,
                    # resolved on the rejection precedent: the quarantine
                    # IS the resolution — the server defended itself; the
                    # record is the operator's pointer to the poison
                    "resolved": True,
                    "resolution": QUARANTINE_CRASH_LOOP,
                    "tenant": tenant,
                    "request": rid,
                }],
            )
        except Exception:
            pass  # attribution is best-effort; the quarantine stands
        trace_mod.instant(
            "server.quarantine", request=rid, tenant=tenant,
            code=QUARANTINE_CRASH_LOOP,
        )
        self._replay_stats["quarantined"] += 1

    # -- fleet failover ----------------------------------------------------
    def adopt_journal(self, peer_base_dir: str) -> Dict[str, Any]:
        """Journal handoff (docs/SERVING.md "Fleet"): fold a dead peer's
        journal into this server through the ordinary replay machinery —
        terminal requests become idempotently-answerable records,
        acknowledged-but-incomplete ones re-enter this server's queue and
        finish bit-identically, crash-loopers are quarantined.  Gated on
        the exclusive adoption claim (``runtime/fleet.py``): the claim
        file in the peer's base dir must name THIS pid, so exactly one of
        N would-be adopters can ever get here.  Each
        adopted lifecycle is re-journaled HERE before it is enqueued, so
        the adopter crashing mid-adoption loses nothing — its own boot
        replay finishes the inherited promises."""
        from . import fleet as fleet_mod  # lazy: fleet imports server

        peer = os.path.abspath(peer_base_dir)
        if peer == self.base_dir:
            raise fleet_mod.AdoptionRefused(
                f"refusing self-adoption of {peer!r}"
            )
        records = fleet_mod.read_peer_journal(peer, pid=os.getpid())
        folded = journal_mod.fold(records)
        counts: Dict[str, Dict[str, int]] = {}
        stats = {"peer": peer, "completed": 0, "reenqueued": 0,
                 "quarantined": 0, "skipped": 0}
        for rid, ent in folded.items():
            tenant = ent["tenant"]
            state = ent["state"]
            with self._requests_lock:
                known = rid in self._requests
            if known or state == journal_mod.REJECTED:
                # already ours (a client retry raced the failover onto
                # this member) or terminal-and-replaceable: nothing to
                # inherit — idempotency answers the former, the id stays
                # free for the latter
                stats["skipped"] += 1
                continue
            c = counts.setdefault(tenant, {
                "submitted": 0, "dispatched": 0, "completed": 0,
                "rejected": 0,
            })
            # durability first: the inherited lifecycle goes into OUR
            # journal (never under a lock) before any in-memory state, so
            # a crash mid-adoption replays to the same decision
            if self._journal is not None:
                for rec_doc in journal_mod.snapshot_records(ent):
                    self._journal.append(rec_doc)
            if state in (journal_mod.COMPLETED, journal_mod.FAILED,
                         journal_mod.QUARANTINED):
                c["submitted"] += 1
                c["dispatched"] += ent["attempts"]
                if state == journal_mod.COMPLETED:
                    c["completed"] += 1
                rec = dict(ent.get("record") or {})
                rec.setdefault("request_id", rid)
                rec.setdefault("tenant", tenant)
                rec.setdefault("state", {
                    journal_mod.COMPLETED: "done",
                    journal_mod.FAILED: "failed",
                    journal_mod.QUARANTINED: "quarantined",
                }[state])
                rec.setdefault("fingerprint", ent.get("fingerprint"))
                rec["replayed"] = True
                rec["adopted_from"] = peer
                with self._requests_lock:
                    self._requests[rid] = rec
                    self._order.append(rid)
                    self._prune_locked()
                stats["completed"] += 1
                continue
            if ent["attempts"] >= self.max_replay_attempts:
                c["submitted"] += 1
                c["dispatched"] += ent["attempts"]
                self._quarantine_crash_loop(ent)
                stats["quarantined"] += 1
                continue
            c["dispatched"] += ent["attempts"]
            self._reenqueue_replayed(ent)
            with self._requests_lock:
                rec = self._requests.get(rid)
                if rec is not None:
                    rec["adopted_from"] = peer
            stats["reenqueued"] += 1
        for tenant, c in counts.items():
            if any(c.values()):
                self.controller.restore_counts(tenant, **c)
        event = {
            "time": trace_mod.walltime(),
            "peer": peer,
            "completed": stats["completed"],
            "reenqueued": stats["reenqueued"],
            "quarantined": stats["quarantined"],
            "skipped": stats["skipped"],
        }
        with self._requests_lock:
            self._adoptions.append(event)
            del self._adoptions[:-16]
        try:
            fu.record_failures(
                self.failures_path,
                "server.fleet",
                [{
                    "block_id": (
                        f"adopt:{os.path.basename(peer.rstrip(os.sep))}"
                        f":{os.getpid()}"
                    ),
                    "sites": {"adopt": 1},
                    "error": f"adopted journal of dead peer {peer}",
                    "quarantined": False,
                    "resolved": True,
                    "resolution": fleet_mod.ADOPTION_RESOLUTION,
                    "peer": peer,
                }],
            )
        except Exception:
            pass  # attribution is best-effort; the adoption stands
        trace_mod.instant(
            "server.adopt", peer=peer, completed=stats["completed"],
            reenqueued=stats["reenqueued"],
            quarantined=stats["quarantined"],
        )
        self._write_state()
        return stats

    # -- submission --------------------------------------------------------
    def _idempotent_doc(self, request_id: str,
                        rec: Dict[str, Any]) -> Dict[str, Any]:
        """The answer to a resubmit of an acknowledged id with the same
        payload: the recorded state (for completed requests, straight
        from the journal-recovered result) — the 200 was a durable
        promise, a retry never re-runs or bounces."""
        doc = {
            "request_id": request_id,
            "state": rec.get("state"),
            "idempotent": True,
        }
        for k in ("run_s", "total_s", "code"):
            if rec.get(k) is not None:
                doc[k] = rec.get(k)
        return doc

    def _reject_duplicate(self, tenant: str, request_id: str):
        detail = (
            f"request_id {request_id!r} already submitted with a "
            "different payload"
        )
        # attributed like every other rejection; request=None because the
        # live record under this id belongs to the ORIGINAL submission
        # and must not be flipped to rejected
        self.controller._reject(
            None, tenant, admission_mod.REJECT_DUPLICATE, detail
        )
        raise admission_mod.AdmissionError(
            admission_mod.REJECT_DUPLICATE, tenant, detail
        )

    def submit(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Admit one workflow request; returns ``{"request_id", "state"}``
        or raises :class:`~.admission.AdmissionError` with a typed
        backpressure code.

        Submission is idempotent per ``(request_id, payload)``: a
        resubmit of a live, completed, or quarantined id with the same
        payload fingerprint is the client's retry of an acknowledged
        request and answers from the record; the same id with a
        DIFFERENT payload is a collision (``rejected:duplicate``).  A
        rejected/failed/drained record stays replaceable — the typed
        backpressure protocol is back-off-and-resubmit the same id.
        """
        tenant = str(payload.get("tenant") or "default")
        request_id = str(payload.get("request_id") or f"{tenant}-{uuid.uuid4().hex[:12]}")
        workflow = payload.get("workflow")
        if not workflow:
            raise ValueError("request payload needs a 'workflow' name")
        _resolve_workflow(str(workflow))  # fail fast on unknown workflows
        fingerprint = _payload_fingerprint(payload)
        with self._requests_lock:
            existing = self._requests.get(request_id)
            held = existing is not None and existing.get("state") in (
                "queued", "running", "done", "quarantined",
            )
            same = held and existing.get("fingerprint") == fingerprint
            snapshot = dict(existing) if held else None
        if held:
            if same:
                return self._idempotent_doc(request_id, snapshot)
            self._reject_duplicate(tenant, request_id)
        # seeded per-tenant admission faults (kind='reject' at site
        # 'admit', runtime/faults.py): chaos proves a rejected request
        # leaves no partial state behind — checked BEFORE any directory,
        # record, or journal entry for the request exists (the rejection
        # itself is journaled through _on_reject)
        if faults_mod.get_injector().maybe_reject(tenant):
            code = admission_mod.REJECT_FAULT
            self.controller._reject(
                admission_mod.Request(tenant=tenant, request_id=request_id),
                tenant, code, "injected admit fault",
            )
            raise admission_mod.AdmissionError(
                code, tenant, "injected admit fault"
            )
        request = admission_mod.Request(
            tenant=tenant,
            request_id=request_id,
            est_bytes=int(payload.get("est_bytes")
                          or self.default_est_bytes),
            deadline_s=payload.get("deadline_s"),
            payload=payload,
        )
        rec = {
            "request_id": request_id,
            "tenant": tenant,
            "workflow": str(workflow),
            "state": "queued",
            "fingerprint": fingerprint,
            "submitted": trace_mod.walltime(),
            "queue_span": trace_mod.begin(
                "server.queue", request=request_id, tenant=tenant
            ),
            "tmp_folder": self._tmp_folder(payload, request_id),
        }
        with self._requests_lock:
            # duplicate re-check + insert under ONE acquisition: two
            # racing submits with the same id must not both insert; the
            # loser of the race answers from the winner's record (same
            # fingerprint) or bounces (different payload)
            existing = self._requests.get(request_id)
            duplicate = existing is not None and existing.get("state") in (
                "queued", "running", "done", "quarantined",
            )
            if not duplicate:
                if existing is not None:
                    self._order = [r for r in self._order if r != request_id]
                self._requests[request_id] = rec
                self._order.append(request_id)
                self._prune_locked()
            else:
                snapshot = dict(existing)
        if duplicate:
            if snapshot.get("fingerprint") == fingerprint:
                return self._idempotent_doc(request_id, snapshot)
            self._reject_duplicate(tenant, request_id)
        # durable acknowledgement: the accepted record is fsync'd AFTER
        # winning the id under the lock (a racing same-id submit with a
        # different payload must not smuggle its payload into the journal
        # for replay to resurrect) and strictly BEFORE the HTTP 200 — an
        # acknowledgement always has a record behind it.  A crash in the
        # insert-to-append window loses a request no client was ever
        # acked for.
        self._journal_append(
            journal_mod.ACCEPTED, request_id, tenant=tenant,
            payload=payload, fingerprint=fingerprint,
        )
        try:
            self.controller.submit(request)
        except admission_mod.AdmissionError as e:
            with self._requests_lock:
                rec["state"] = "rejected"
                rec["code"] = e.code
                rec["error"] = e.detail
            self._write_state()
            raise
        self._write_state()
        return {"request_id": request_id, "state": "queued"}

    def _tmp_folder(self, payload: Dict[str, Any], request_id: str) -> str:
        cfg = payload.get("config") or {}
        return os.path.abspath(
            cfg.get("tmp_folder")
            or os.path.join(self.base_dir, "requests", request_id)
        )

    def _prune_locked(self) -> None:
        while len(self._order) > _MAX_RECORDS:
            victim = None
            for rid in self._order:
                if self._requests.get(rid, {}).get("state") not in (
                    "queued", "running",
                ):
                    victim = rid
                    break
            if victim is None:
                break
            self._order.remove(victim)
            self._requests.pop(victim, None)

    # -- rejection attribution --------------------------------------------
    def _on_reject(self, request, tenant, code, detail) -> None:
        """Called by the admission controller for every rejection (never
        under its lock): journal the lifecycle transition, attribute it in
        the server's failures.json, and update the request record when one
        exists (deadline expiries)."""
        request_id = getattr(request, "request_id", None)
        if request_id is not None:
            # the rejection is a lifecycle end: journaled before the state
            # flip is observable, so a restart answers this id's fate from
            # the journal instead of replaying a request nobody admitted.
            # request=None rejections (duplicates) carry no id and do not
            # touch the original submission's journal lifecycle.
            self._journal_append(
                journal_mod.REJECTED, request_id, tenant=tenant, code=code,
            )
        if request_id is not None:
            with self._requests_lock:
                rec = self._requests.get(request_id)
                if rec is not None and rec["state"] in ("queued", "running"):
                    rec["state"] = "rejected"
                    rec["code"] = code
                    rec["error"] = detail
        # every rejection is its own attributable unit: record_failures
        # keys records by (task, block_id), so a shared key would make a
        # tenant's later rejections silently replace earlier ones (incl.
        # across a restart — the rejection history is the point)
        with self._requests_lock:
            self._reject_seq += 1
            seq = self._reject_seq
        try:
            fu.record_failures(
                self.failures_path,
                f"server.{tenant}",
                [{
                    "block_id": (
                        f"admit:{request_id or tenant}:{os.getpid()}:{seq}"
                    ),
                    "sites": {"admit": 1},
                    "error": detail or None,
                    "quarantined": False,
                    "resolved": True,
                    "resolution": code,
                    "tenant": tenant,
                    "request": request_id,
                }],
            )
        except Exception:
            pass  # attribution is best-effort; the rejection already stands
        trace_mod.instant(
            "server.reject", tenant=tenant, code=code,
            request=request_id or "",
        )
        self._write_state()

    # -- execution ---------------------------------------------------------
    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            if drain_requested():
                # SIGTERM: make sure admission/dispatch latch and stop
                # claiming queued requests; the in-flight ones (other
                # workers) drain at their own safe boundaries
                self.controller.begin_drain()
            request = self.controller.next_request(timeout=0.2)
            if request is None:
                if self.controller.draining():
                    return
                continue
            state = None
            try:
                state = self._execute(request)
            finally:
                # failed/drained requests release their claims but must not
                # count as completed in the tenant stats
                self.controller.release(request, completed=state == "done")
                self._write_state()

    def _execute(self, request: admission_mod.Request) -> None:
        from .task import build

        payload = request.payload or {}
        rid = request.request_id
        with self._requests_lock:
            rec = self._requests.get(rid) or {"request_id": rid}
            attempt = int(rec.get("attempts") or 0) + 1
            rec["attempts"] = attempt
        # the dispatch transition is journaled BEFORE the workflow runs: a
        # crash mid-run leaves a dispatched record behind, and the count
        # of those records is the crash-loop budget replay enforces
        # (max_replay_attempts -> quarantined:crash_loop)
        self._journal_append(
            journal_mod.DISPATCHED, rid, tenant=request.tenant,
            attempt=attempt,
        )
        with self._requests_lock:
            rec["state"] = "running"
            qspan = rec.pop("queue_span", None)
            rec["queued_s"] = round(qspan.end(), 6) if qspan is not None else None
        self._write_state()
        run_span = trace_mod.begin(
            "server.request", request=rid, tenant=request.tenant,
            workflow=str(payload.get("workflow")),
        )
        state, error = "failed", None
        try:
            # the ambient request context: handoff namespacing + the
            # executor's tenant byte cap; the task_context puts the whole
            # request on the resident timeline (docs/ANALYSIS.md CT009)
            with admission_mod.request_context(
                request.tenant, rid, byte_cap=request.byte_cap
            ):
                with trace_mod.task_context(
                    f"request.{rid}", tenant=request.tenant
                ):
                    wf = self._instantiate(payload, rid)
                    ok = build([wf], rerun=bool(payload.get("rerun")))
                    if ok:
                        # fence gate on the OTHER write plane: a fenced
                        # member must not store another byte either —
                        # the adopter re-runs this request and flushes
                        # its own bit-identical copy (ctlint CT013)
                        if self._fence_guard is not None:
                            self._fence_guard.check()
                        # client-visible durability: live dataset handoffs
                        # are written back before the request reports done
                        handoff_mod.flush_namespace(rid)
                    state = "done" if ok else "failed"
        except DrainInterrupt as e:
            # graceful preemption mid-request: markers/manifests are
            # flushed — the resubmitted request resumes at block grain
            state, error = "drained", str(e)
        except journal_mod.Fenced as e:
            # adopted away mid-run: the survivor re-runs this request
            # from its adopted journal copy — record NOTHING here
            self._note_fenced(e)
            state, error = "fenced", str(e)
        except Exception:
            error = fu.cap_traceback(traceback.format_exc())
        finally:
            # drop the request's namespace: a resident process must not
            # accrete dead request state (memory-only intermediates died
            # with the request; datasets were flushed above on success)
            handoff_mod.release_request(rid)
        run_s = run_span.end(error=state != "done")
        from ..ops.kernels import pop_request_launches

        launches = pop_request_launches(rid)
        terminal = {
            "request_id": rid,
            "tenant": request.tenant,
            "workflow": str(payload.get("workflow")),
            "state": state,
            "queued_s": rec.get("queued_s"),
            "run_s": round(run_s, 6),
            "total_s": round((rec.get("queued_s") or 0.0) + run_s, 6),
            "finished": trace_mod.walltime(),
            "fingerprint": rec.get("fingerprint"),
            "tmp_folder": rec.get("tmp_folder"),
        }
        if error:
            terminal["error"] = error
        if launches:
            # the port's addition: the hand kernels this request launched
            terminal["kernel_launches"] = launches
        # terminal transition journaled BEFORE the state flip becomes
        # observable: done -> the idempotent-answer record a restart
        # serves; drained -> re-enqueued on replay (the drain protocol's
        # queued-work-survives contract now holds server-side).  A fenced
        # request journals NOTHING — the adopter owns its lifecycle now —
        # and a fence discovered AT this append likewise unwinds with the
        # record unwritten (Journal.append checks under its lock).
        if state != "fenced":
            try:
                self._journal_append(
                    _JOURNAL_TERMINAL.get(state, journal_mod.FAILED), rid,
                    tenant=request.tenant, record=terminal,
                )
            except journal_mod.Fenced as e:
                state, error = "fenced", str(e)
                terminal["state"] = state
                terminal["error"] = error
        with self._requests_lock:
            rec.update(
                {k: v for k, v in terminal.items() if k != "request_id"}
            )
        return state

    def _instantiate(self, payload: Dict[str, Any], request_id: str):
        from .executor import target_device

        cls = _resolve_workflow(str(payload.get("workflow")))
        cfg = payload.get("config") or {}
        tmp_folder = self._tmp_folder(payload, request_id)
        target = str(cfg.get("target", DEFAULT_TARGET))
        # resolved before the build, so a request for the card on a host
        # without one fails with the device error in its record
        target_device(target)
        config_dir = self._materialize_config(cfg, tmp_folder, target)
        return cls(
            tmp_folder=tmp_folder,
            config_dir=config_dir,
            max_jobs=int(cfg.get("max_jobs", self.default_max_jobs)),
            target=target,
            **(cfg.get("params") or {}),
        )

    def _materialize_config(self, cfg: Dict[str, Any], tmp_folder: str,
                            target: str) -> str:
        """The request's effective config_dir: the caller's base configs
        (if any) overlaid with the request's ``global_config`` and the
        resident-owner defaults — ``memory_handoffs`` ON for in-process
        targets (``local`` and ``gpu``); cluster targets stay off because
        their memory dies with the remote job.  An explicit caller value
        always wins."""
        out_dir = os.path.join(tmp_folder, "server_config")
        os.makedirs(out_dir, exist_ok=True)
        base = cfg.get("config_dir")
        doc: Dict[str, Any] = {}
        if base and os.path.isdir(base):
            for fname in sorted(os.listdir(base)):
                if not fname.endswith(".config"):
                    continue
                if fname == "global.config":
                    doc.update(tu.load_config(os.path.join(base, fname)))
                else:
                    shutil.copy(
                        os.path.join(base, fname),
                        os.path.join(out_dir, fname),
                    )
        doc.update(cfg.get("global_config") or {})
        if target not in _CLUSTER_TARGETS:
            doc.setdefault("memory_handoffs", True)
        tu.dump_config(os.path.join(out_dir, "global.config"), doc)
        return out_dir

    # -- introspection -----------------------------------------------------
    def request_record(self, request_id: str) -> Optional[Dict[str, Any]]:
        with self._requests_lock:
            rec = self._requests.get(request_id)
            if rec is None:
                return None
            return {k: v for k, v in rec.items() if k != "queue_span"}

    def _state_doc(self) -> Dict[str, Any]:
        journal = self.journal_health()
        # fence pulse (docs/SERVING.md "Gray failures") — outside the
        # request lock: current() may stat/re-read the fence file
        fence = None
        if self._fence_guard is not None:
            fence = {
                "own_epoch": self._fence_guard.own_epoch,
                "current_epoch": self._fence_guard.current(),
                "fenced": self.fenced,
            }
        with self._requests_lock:
            requests = {
                rid: {
                    k: rec.get(k)
                    for k in ("tenant", "workflow", "state", "queued_s",
                              "run_s", "total_s", "code", "replayed",
                              "attempts")
                    if rec.get(k) is not None
                }
                for rid, rec in self._requests.items()
            }
            adoptions = list(self._adoptions)
        return {
            "version": 1,
            "uid": SERVER_UID,
            "pid": os.getpid(),
            "hostname": socket.gethostname(),
            "host": self.host,
            "port": self.port,
            "time": trace_mod.walltime(),
            "started": self.started_at,
            "draining": self.controller.draining() or drain_requested(),
            "tenants": self.controller.snapshot(),
            "requests": requests,
            # the resident caches' pulse: chaos asserts live_entries goes
            # back to 0 once every request is terminal (no orphaned
            # handoff state), and operators see what "warm" is worth
            "handoffs": {
                "live_entries": handoff_mod.live_entries(),
                "live_bytes": int(handoff_mod.live_bytes()),
            },
            # the durable-journal pulse (docs/SERVING.md "Durability"):
            # fsync freshness, journal growth, and what this incarnation's
            # replay recovered / re-enqueued / quarantined
            "journal": journal,
            # fleet failover (docs/SERVING.md "Fleet"): dead peers whose
            # journals this incarnation adopted
            "adoptions": adoptions,
            # fencing (docs/SERVING.md "Gray failures"): the epoch this
            # incarnation owns vs. the minted one; fenced=true means a
            # survivor adopted this journal and we are self-draining
            "fence": fence,
            # the reference's server-scoped compiled-program cache: kept
            # for the document's keys, always None here
            "programs": self.program_cache_stats(),
            # the self-healing plane's pulse (docs/SERVING.md
            # "Self-healing"): scrub position/coverage/findings plus the
            # verifying-reader and lineage-repair counters
            "scrub": (
                self.scrubber.stats()
                if self.scrubber is not None else None
            ),
        }

    def _write_state(self) -> None:
        """Atomically refresh ``server_state.json`` — the file
        ``scripts/progress.py`` renders the per-tenant view from.  Never
        called under the admission lock (docs/ANALYSIS.md CT009);
        best-effort, the server must outlive a full disk."""
        try:
            fu.atomic_write_json(
                os.path.join(self.base_dir, STATE_FILENAME), self._state_doc()
            )
        except OSError:
            pass

    def status(self) -> Dict[str, Any]:
        """The ``/status`` document: the machine-readable run report
        (``failures_report.py --json`` over the server's base dir, lint
        pass skipped — it is a static repo property, not run state) plus
        the live server/tenant stats.  ``rc`` preserves the report's
        exit-code semantics: 1 on unresolved failures or a torn
        manifest."""
        report = self._json_report()
        failures = (report or {}).get("failures") or {}
        rc = 1 if (failures.get("error") or failures.get("n_unresolved")) else 0
        return {"server": self._state_doc(), "report": report, "rc": rc}

    def _json_report(self) -> Optional[Dict[str, Any]]:
        try:
            report_mod = _load_failures_report()
            if report_mod is not None:
                return report_mod.build_json_report(
                    self.base_dir, with_lint=False
                )
        except Exception:
            pass
        # minimal fallback (scripts/ not shipped next to the package):
        # same rc-relevant fields, straight from failures.json
        doc = fu.read_json_if_valid(self.failures_path)
        records = (doc or {}).get("records", [])
        error = None
        if doc is None and os.path.exists(self.failures_path):
            error = "torn failures manifest"
        return {
            "version": 1,
            "tmp_folder": self.base_dir,
            "failures": {
                "error": error,
                "n_records": len(records),
                "n_unresolved": sum(
                    1 for r in records if not r.get("resolved")
                ),
            },
        }


def _load_failures_report():
    """``scripts/failures_report.py`` as a module, located relative to the
    package checkout (None when not present — installed without scripts)."""
    import importlib.util

    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(os.path.dirname(pkg_dir), "scripts",
                        "failures_report.py")
    if not os.path.isfile(path):
        return None
    spec = importlib.util.spec_from_file_location("_ctt_failures_report", path)
    if spec is None or spec.loader is None:
        return None
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- HTTP plumbing ------------------------------------------------------------


class _RequestHandler(BaseHTTPRequestHandler):
    """Minimal JSON-over-HTTP surface: POST /submit, GET /status,
    GET /request/<id>, GET /healthz.  Local-endpoint only by default
    (the server binds 127.0.0.1)."""

    server_version = "ctt-serve/1"

    @property
    def pipeline(self) -> PipelineServer:
        return self.server.pipeline  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # quiet: the state file is the log
        pass

    def _reply(self, code: int, doc: Dict[str, Any]) -> None:
        body = json.dumps(doc).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.rstrip("/")
        if path not in ("/submit", "/adopt"):
            self._reply(404, {"error": "not_found"})
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, OSError) as e:
            self._reply(400, {"error": "bad_request", "detail": str(e)})
            return
        if path == "/adopt":
            # fleet failover (docs/SERVING.md "Fleet"): adopt a dead
            # peer's journal — only with the exclusive claim in hand
            from . import fleet as fleet_mod  # lazy: fleet imports server

            try:
                self._reply(200, self.pipeline.adopt_journal(
                    str(payload.get("base_dir") or "")
                ))
            except fleet_mod.AdoptionRefused as e:
                self._reply(409, {
                    "error": "adoption_refused", "detail": str(e),
                })
            except (ValueError, KeyError, OSError) as e:
                self._reply(400, {"error": "bad_request", "detail": str(e)})
            return
        try:
            self._reply(200, self.pipeline.submit(payload))
        except journal_mod.Fenced as e:
            # the acceptance was NOT journaled (and so never promised):
            # typed 503 — the client retries and the gateway, which has
            # already routed traffic off this member, places it elsewhere
            self._reply(503, {
                "error": FENCED_RESOLUTION, "detail": str(e),
            })
        except admission_mod.AdmissionError as e:
            http = 503 if e.code == admission_mod.REJECT_DRAINING else 429
            self._reply(http, {
                "error": e.code, "tenant": e.tenant, "detail": e.detail,
            })
        except NotImplementedError as e:
            # what the port does not do: refused, naming it
            self._reply(501, {"error": NOT_PORTED, "detail": str(e)})
        except (ValueError, KeyError) as e:
            self._reply(400, {"error": "bad_request", "detail": str(e)})

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.rstrip("/")
        if path == "/healthz":
            self._reply(200, {
                "ok": True,
                "draining": self.pipeline.controller.draining()
                or drain_requested(),
                # fenced = a survivor owns this journal; the member is
                # exiting and must not be routed to
                "fenced": self.pipeline.fenced,
                # journal health (docs/SERVING.md "Durability"): last
                # fsync age, journal bytes, and the replay backlog — a
                # liveness probe that can also see the ack contract rot
                "journal": self.pipeline.journal_health(),
                # the reference's program-cache pulse; always None here
                "programs": self.pipeline.program_cache_stats(),
                # the self-healing plane (docs/SERVING.md "Self-healing"):
                # scrub coverage + corruption found/repaired at rest and
                # at read — rot surfacing here is an SLO breach in waiting
                "scrub": (
                    self.pipeline.scrubber.stats()
                    if self.pipeline.scrubber is not None else None
                ),
            })
        elif path == "/status":
            self._reply(200, self.pipeline.status())
        elif path.startswith("/request/"):
            rec = self.pipeline.request_record(path[len("/request/"):])
            if rec is None:
                self._reply(404, {"error": "unknown_request"})
            else:
                self._reply(200, rec)
        else:
            self._reply(404, {"error": "not_found"})


# -- client -------------------------------------------------------------------


class ServeRejected(RuntimeError):
    """Client-side view of a typed admission rejection."""

    def __init__(self, code: str, detail: str = "", http_status: int = 429):
        self.code = code
        self.detail = detail
        self.http_status = http_status
        super().__init__(f"{code} (http {http_status}): {detail}")


#: rejection codes a durable client may retry with backoff: the restart
#: window (503), transient quota pressure, and the gateway's fleet-level
#: backpressure (no placeable member — the failover window — or every
#: member over its queue cap; both clear on their own).  byte_quota /
#: duplicate / fault are NOT retryable-by-default — resubmitting them
#: verbatim can never succeed (oversize, collision) or is the chaos
#: seed's to count.
RETRYABLE_REJECTS = (
    admission_mod.REJECT_DRAINING,
    admission_mod.REJECT_QUEUE,
    admission_mod.REJECT_FLEET_NO_MEMBER,
    admission_mod.REJECT_FLEET_BACKLOG,
    # every placeable member behind an open circuit breaker — clears on
    # the half-open probe (docs/SERVING.md "Gray failures")
    admission_mod.REJECT_FLEET_BREAKER,
    # fenced member answered directly (never through the gateway, which
    # routes off it): the acceptance was not journaled, resubmit lands
    # on the survivor
    FENCED_RESOLUTION,
)


class ServeClient:
    """Stdlib HTTP client for the serve endpoint (tests, the load
    generator, operator scripts).

    Constructed via :meth:`from_endpoint_file`, the client can survive a
    server restart: connection-level failures (the server is dead or
    binding) are retried with capped backoff while the endpoint file is
    re-read — a restarted server binds a fresh ephemeral port, and the
    durable submission journal (docs/SERVING.md "Durability") guarantees
    the requests it acknowledged are still there to poll.  Typed
    ``rejected:*`` codes are honored: only :data:`RETRYABLE_REJECTS`
    (draining / queue pressure) are retried by :meth:`submit` when given
    a retry budget; everything else raises immediately."""

    def __init__(self, host: str, port: int, timeout_s: float = 30.0,
                 base_dir: Optional[str] = None):
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self.base_dir = base_dir

    @classmethod
    def from_endpoint_file(cls, base_dir: str,
                           timeout_s: float = 30.0) -> "ServeClient":
        doc = fu.read_json_if_valid(
            os.path.join(base_dir, ENDPOINT_FILENAME)
        )
        if not doc:
            raise FileNotFoundError(
                f"no server endpoint file under {base_dir!r}"
            )
        return cls(doc["host"], doc["port"], timeout_s=timeout_s,
                   base_dir=base_dir)

    def _refresh_endpoint(self) -> None:
        """Re-read the endpoint file (when known): a restarted server
        writes a fresh host/port there before serving."""
        if not self.base_dir:
            return
        doc = fu.read_json_if_valid(
            os.path.join(self.base_dir, ENDPOINT_FILENAME)
        )
        if doc and doc.get("host") and doc.get("port"):
            self.host = doc["host"]
            self.port = int(doc["port"])

    def _call_once(self, method: str, path: str,
                   body: Optional[Dict[str, Any]] = None,
                   member: Optional[str] = None) -> tuple:
        # one deadline-bounded exchange through the shared serve-plane
        # doorway (fault site net_client; ``member`` carries the tenant
        # for targeted client-side faults)
        return netio.http_json_call(
            self.host, self.port, method, path, body,
            timeout_s=self.timeout_s, site="net_client", member=member,
        )

    def _call(self, method: str, path: str,
              body: Optional[Dict[str, Any]] = None,
              retry_s: Optional[float] = None,
              member: Optional[str] = None) -> tuple:
        """One HTTP call; with a ``retry_s`` budget, connection-level
        failures (refused / reset / timed out — the restart window) are
        retried with capped backoff, re-reading the endpoint file between
        attempts (:func:`netio.retry_connection` — the loop the gateway
        shares).  HTTP-level answers are never retried here — the typed
        rejection codes are the caller's protocol."""
        return netio.retry_connection(
            lambda: self._call_once(method, path, body, member=member),
            retry_s,
            on_retry=self._refresh_endpoint,
        )

    def submit(self, retry_s: Optional[float] = None,
               **payload) -> Dict[str, Any]:
        """POST /submit.  With a ``retry_s`` budget the submit also rides
        typed backpressure: :data:`RETRYABLE_REJECTS` (draining — the
        rolling-restart window — and queue pressure) back off and
        resubmit the SAME payload; submission is idempotent per
        ``(request_id, payload)`` server-side, so an ambiguous
        connection drop is safely resubmitted too."""
        deadline = (
            None if not retry_s else time.monotonic() + float(retry_s)
        )
        attempt = 0
        while True:
            # the connection-retry budget is what REMAINS of the caller's
            # budget, not a fresh retry_s per loop — otherwise a late
            # rejection re-arms the full window and blocks ~2x as long
            remaining = (
                None if deadline is None
                else max(0.1, deadline - time.monotonic())
            )
            status, doc = self._call(
                "POST", "/submit", payload, retry_s=remaining,
                member=str(payload.get("tenant") or "") or None,
            )
            if status == 200:
                return doc
            code = str(doc.get("error"))
            if (
                deadline is None
                or code not in RETRYABLE_REJECTS
                or time.monotonic() >= deadline
            ):
                raise ServeRejected(
                    code, str(doc.get("detail") or ""), http_status=status,
                )
            time.sleep(fu.backoff_delay(attempt, 0.05, 2.0))
            attempt += 1

    def status(self) -> Dict[str, Any]:
        return self._call("GET", "/status")[1]

    def healthz(self) -> Dict[str, Any]:
        return self._call("GET", "/healthz")[1]

    def request(self, request_id: str,
                retry_s: Optional[float] = None) -> Optional[Dict[str, Any]]:
        status, doc = self._call(
            "GET", f"/request/{request_id}", retry_s=retry_s
        )
        return None if status == 404 else doc

    def wait(self, request_id: str, timeout_s: float = 120.0,
             poll_s: float = 0.05,
             across_restarts: bool = False) -> Dict[str, Any]:
        """Poll until the request reaches a terminal state; returns its
        record.  Raises TimeoutError when it stays live past
        ``timeout_s``.  With ``across_restarts`` (needs a ``base_dir``
        endpoint file), polls ride out server restarts AND fleet
        failovers: connection failures retry against the re-read endpoint
        until the deadline, and a state-less answer — the gateway's typed
        failover-window document (``rejected:fleet_no_member``: the
        routed member is dead and its journal not yet adopted) — is
        treated as transient with capped backoff, because the adoption
        protocol (docs/SERVING.md "Fleet") means the record WILL come
        back, served by a different member, with zero resubmission."""
        deadline = time.monotonic() + timeout_s
        attempt = 0
        while True:
            remaining = deadline - time.monotonic()
            rec = self.request(
                request_id,
                retry_s=max(0.1, remaining) if across_restarts else None,
            )
            if (
                across_restarts
                and rec is not None
                and rec.get("state") is None
            ):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"request {request_id} unresolved after "
                        f"{timeout_s:g}s: {rec.get('error')!r}"
                    )
                time.sleep(fu.backoff_delay(attempt, poll_s, 1.0))
                attempt += 1
                self._refresh_endpoint()
                continue
            if rec is not None and rec.get("state") not in (
                "queued", "running",
            ):
                return rec
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"request {request_id} still "
                    f"{(rec or {}).get('state')!r} after {timeout_s:g}s"
                )
            time.sleep(poll_s)
