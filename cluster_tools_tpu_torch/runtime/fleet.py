"""Serving fleet: a gateway/router + journal-handoff failover.

Port (a copy) of ``cluster_tools_tpu/runtime/fleet.py``: the same adoption
claim (``adoption.claim``, its keys and its O_CREAT|O_EXCL protocol), the
same ``fleet_state.json`` document and the same HTTP routes, so either
package's gateway can adopt a member directory that the other package's
server wrote, and ``scripts/progress.py`` renders either's fleet view.

:class:`FleetGateway` is a lightweight stdlib-HTTP router fronting M
:class:`~.server.PipelineServer` processes.

**Placement** is tenant-affine: a tenant sticks to the member that served
it last, so the member's decompressed-chunk cache and resident
device/handoff state keep paying.  When the affine member is dead,
draining, or over its queue cap, placement falls back to the
least-queue-depth member — safe because submission is idempotent per
``(request_id, payload-fingerprint)`` on every member, so a client retry
that lands on a different member can never double-run an acknowledged
request.  When NO member is placeable the gateway answers with its own
typed backpressure (:data:`~.admission.REJECT_FLEET_NO_MEMBER` → 503,
:data:`~.admission.REJECT_FLEET_BACKLOG` → 429), attributed in the
gateway's ``failures.json`` like every member-side rejection.

**Failover** is a journal handoff.  The gateway health-checks members
(``/healthz`` + heartbeat freshness + pid liveness); when one dies, the
journal under its base dir is already a complete, fsync'd record of every
acknowledged request — precisely the primitive that turns single-server
crash-recovery into cross-server failover.  A surviving member *adopts*
the dead member's journal: the gateway takes an exclusive **adoption
claim** (an ``O_CREAT|O_EXCL`` claim file in the dead member's base dir,
``fu.file_lock`` style with a dead-pid stale-break — exactly one of N
contenders can ever win), then POSTs ``/adopt`` to the adopter, which
folds the peer's journal through the ordinary boot-replay machinery:
completed requests become idempotently-answerable records, acknowledged-
but-incomplete ones re-enter the adopter's queue with their original
tenant/payload and finish bit-identically, with ZERO client resubmission.
The claim file stays behind as the adoption record, so no second server
can ever adopt the same journal (:func:`read_peer_journal` is the only
sanctioned read of a peer's journal, and it refuses without the claim).
With no survivor, a ``spawn`` callback (the fleet CLI wires one) restarts
a member on the dead base dir instead, and plain boot replay does the
rest.

**Gray-failure defense**: the dead-member story above only covers members
that are *gone*.  A member that is alive-but-wedged (SIGSTOP, GC pause,
wedged disk) answers nothing yet trips no pid-death check, and a member
*falsely* declared dead can wake after a survivor adopted its journal.
Three layers close that class: every outbound HTTP exchange goes through
:mod:`.netio` with an explicit deadline (and the
``net_delay``/``net_drop``/``net_wedge`` fault shim); a per-member
:class:`CircuitBreaker` counts consecutive connection-level failures and
shifts traffic off a wedged member within ~one request deadline (typed
:data:`~.admission.REJECT_FLEET_BREAKER` while open, half-open trial after
the cooldown), with **hedged submission** re-routing an idempotent request
to a second member after a p99-derived delay; and every adoption **mints
a fence epoch** (:func:`~.journal.mint_fence`, under the exclusive claim,
*before* the journal scan) so a SIGCONT'd zombie's next journal append or
handoff flush raises :class:`~.journal.Fenced` instead of forking the
truth — split-brain is structurally impossible, not merely improbable.

**Lock discipline**: ``_placement_lock`` guards pure bookkeeping — the
member table, the tenant-affinity map, the request-route table, counters.
Every HTTP call, health probe, journal read, and state-file write happens
outside it; one slow member probed under the placement lock would
head-of-line block every submit.

**Scale hooks**: ``fleet_state.json`` (rendered by ``scripts/progress.py``)
aggregates per-member queue depth / replay backlog / scrub pressure from
each member's ``server_state.json``, and :meth:`FleetGateway.
drain_emptiest` SIGTERMs the emptiest member (→ rc 114) for scale-down.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import threading
import time
import uuid
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import function_utils as fu
from . import admission as admission_mod
from . import journal as journal_mod
from . import netio
from . import trace as trace_mod
from .server import ENDPOINT_FILENAME, SERVER_UID, STATE_FILENAME
from .supervision import (
    DrainInterrupt,
    HeartbeatWriter,
    drain_reason,
    drain_requested,
    pid_alive,
    read_heartbeat,
)

GATEWAY_UID = "gateway"

#: the gateway's operator-facing state file (scripts/progress.py fleet view)
FLEET_STATE_FILENAME = "fleet_state.json"

#: the exclusive adoption claim in a dead member's base dir.  Present =
#: this journal's failover fate is decided (an adopter finished it, or a
#: respawn is booting on it); absent = the journal is still its owner's.
CLAIM_FILENAME = "adoption.claim"

#: failures.json resolution recorded for a completed journal adoption
ADOPTION_RESOLUTION = "adopted:journal"

#: adoption events kept in fleet_state.json (oldest dropped)
_MAX_ADOPTION_EVENTS = 64

#: request-id -> member routes kept in memory (oldest pruned; a pruned
#: route degrades to the broadcast lookup, never to a lost answer)
_MAX_ROUTES = 4096


class AdoptionRefused(RuntimeError):
    """A journal adoption that must not proceed: no claim, a claim held
    by someone else, or a self-adoption.  Mapped to HTTP 409 by the
    member's ``/adopt`` handler."""


# -- the adoption claim protocol ----------------------------------------------
#
# Exactly-once semantics, not mutual exclusion: fu.file_lock waits and
# eventually *steals* from a live holder (its callers guard best-effort
# bookkeeping), but two servers replaying one journal would double-run
# acknowledged work — so a live holder is NEVER stolen from here.  Only a
# claim whose recorded holder pid is provably dead on this host is broken
# (atomic rename first: one of N contenders wins the rename, so two can
# never both break the same claim and then break each other's).


def adoption_claim_path(base_dir: str) -> str:
    return os.path.join(os.path.abspath(base_dir), CLAIM_FILENAME)


def read_adoption_claim(base_dir: str) -> Optional[Dict[str, Any]]:
    """The current claim document, or None (unclaimed / torn)."""
    return fu.read_json_if_valid(adoption_claim_path(base_dir))


def acquire_adoption_claim(base_dir: str, by: str,
                           pid: int) -> Optional[Dict[str, Any]]:
    """Try to claim ``base_dir``'s journal for adoption by ``(by, pid)``.

    Returns the claim document on success, None when another holder has
    it (no waiting, no stealing from the living — double adoption is a
    correctness bug, not a liveness problem).  A claim whose holder pid
    is dead on this host is stale-broken and re-contended.
    """
    path = adoption_claim_path(base_dir)
    doc = {
        "by": str(by),
        "pid": int(pid),
        "host": socket.gethostname(),
        "time": trace_mod.walltime(),
        "token": uuid.uuid4().hex,
    }
    payload = json.dumps(doc, sort_keys=True).encode()
    for _ in range(16):  # bounded: each lap is a create attempt or a break
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            held = fu.read_json_if_valid(path)
            if held is None:
                # mid-write or torn: give the writer one beat, re-read;
                # still unreadable -> err on the side of NOT adopting
                time.sleep(0.01)
                held = fu.read_json_if_valid(path)
                if held is None and os.path.exists(path):
                    return None
                if held is None:
                    continue  # holder released between exists and read
            if (
                held.get("host") == socket.gethostname()
                and not pid_alive(held.get("pid", -1))
            ):
                # stale-break on a dead holder: rename first, so exactly
                # one of N contenders wins the break (fu.file_lock idiom)
                grave = f"{path}.stale.{os.getpid()}.{threading.get_ident()}"
                try:
                    os.rename(path, grave)
                    os.unlink(grave)
                except OSError:
                    pass  # another contender broke it first; re-contend
                continue
            return None  # a live holder owns this journal's fate
        try:
            os.write(fd, payload)
            os.fsync(fd)
        finally:
            os.close(fd)
        return doc
    return None


def release_adoption_claim(base_dir: str,
                           doc: Optional[Dict[str, Any]]) -> None:
    """Withdraw OUR claim (adoption attempt failed / respawn finished
    booting).  Token-checked like ``fu.file_lock``'s release: a holder
    whose stale claim was broken must not remove the new holder's claim.
    A claim that *consummated* an adoption is never released — it stays
    behind as the adoption record."""
    path = adoption_claim_path(base_dir)
    cur = fu.read_json_if_valid(path)
    if cur is not None and doc is not None \
            and cur.get("token") == doc.get("token"):
        try:
            os.unlink(path)
        except OSError:
            pass


def verify_adoption_claim(peer_base_dir: str, pid: Optional[int] = None,
                          by: Optional[str] = None) -> Dict[str, Any]:
    """The adopter-side gate: raise :class:`AdoptionRefused` unless a
    claim exists on ``peer_base_dir`` and (when given) names this
    ``pid``/``by`` on this host.  Servers call this before touching a
    peer's journal, so a stray ``/adopt`` (or a second would-be adopter
    racing the winner) can never read a journal it does not own."""
    doc = read_adoption_claim(peer_base_dir)
    if doc is None:
        raise AdoptionRefused(
            f"no adoption claim under {peer_base_dir!r}; "
            "acquire_adoption_claim first"
        )
    if pid is not None and (
        int(doc.get("pid") or -1) != int(pid)
        or doc.get("host") != socket.gethostname()
    ):
        raise AdoptionRefused(
            f"adoption claim on {peer_base_dir!r} is held by "
            f"{doc.get('by')!r} (pid {doc.get('pid')} on "
            f"{doc.get('host')}), not pid {pid} on this host"
        )
    if by is not None and doc.get("by") != by:
        raise AdoptionRefused(
            f"adoption claim on {peer_base_dir!r} names "
            f"{doc.get('by')!r}, not {by!r}"
        )
    return doc


def read_peer_journal(peer_base_dir: str, pid: Optional[int] = None,
                      by: Optional[str] = None) -> List[Dict[str, Any]]:
    """The ONLY sanctioned read of a peer's journal:
    verifies the adoption claim, then scans read-only.  Never
    ``Journal.recover()`` on a peer — recover opens for append and
    truncates torn tails, and the dead member's journal must stay
    byte-identical for post-mortems; a torn tail was never acknowledged,
    so ``scan``'s intact prefix is the whole promise."""
    verify_adoption_claim(peer_base_dir, pid=pid, by=by)
    records, _, _ = journal_mod.scan(journal_mod.journal_path(peer_base_dir))
    return records


# -- circuit breaker ----------------------------------------------------------


class CircuitBreaker:
    """Per-member circuit breaker (docs/SERVING.md "Gray failures").

    Counts CONSECUTIVE connection-level failures — timeouts, resets,
    refusals, from data calls and health probes alike — and opens at
    ``threshold``, taking the member out of placement within roughly one
    request deadline (heartbeat staleness needs ``member_stale_s``; a
    wedged-but-alive member never goes pid-dead at all).  After
    ``cooldown_s`` the breaker half-opens: exactly ONE trial call is
    admitted; its success closes the breaker, its failure re-opens and
    restarts the cooldown.  Any success anywhere (including a health
    probe) closes — the member is demonstrably answering again.

    Bookkeeping only, under its own tiny lock; the caller does the IO and
    reports outcomes via :meth:`record` (never IO under a lock).
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, threshold: int = 2, cooldown_s: float = 2.0):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = max(0.05, float(cooldown_s))
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.last_transition = time.monotonic()
        self.opened_total = 0
        self._trial_inflight = False

    def _transition(self, state: str) -> None:
        if state != self.state:
            self.state = state
            self.last_transition = time.monotonic()
            if state == self.OPEN:
                self.opened_total += 1

    def allow(self) -> bool:
        """Data-path gate: True in CLOSED; past the cooldown the caller
        takes the single half-open trial slot (and MUST then
        :meth:`record` the outcome to free it)."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                if time.monotonic() - self.last_transition \
                        < self.cooldown_s:
                    return False
                self._transition(self.HALF_OPEN)
                self._trial_inflight = True
                return True
            # HALF_OPEN: one trial at a time
            if self._trial_inflight:
                return False
            self._trial_inflight = True
            return True

    def record(self, ok: bool) -> None:
        """Report one call's connection-level outcome (HTTP answers of
        any status count as ``ok`` — the member is responsive)."""
        with self._lock:
            self._trial_inflight = False
            if ok:
                self.consecutive_failures = 0
                self._transition(self.CLOSED)
            else:
                self.consecutive_failures += 1
                if self.state == self.HALF_OPEN \
                        or self.consecutive_failures >= self.threshold:
                    self._transition(self.OPEN)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self.state,
                "consecutive_failures": int(self.consecutive_failures),
                "since_transition_s": round(
                    time.monotonic() - self.last_transition, 3
                ),
                "opened_total": int(self.opened_total),
            }


# -- the gateway --------------------------------------------------------------


class FleetGateway:
    """The fleet's router: tenant-affinity placement with least-queue
    fallback, member health tracking, journal-handoff failover, typed
    gateway backpressure, and the ``fleet_state.json`` operator view.
    See the module docstring and docs/SERVING.md "Fleet".

    Knobs: ``affinity`` (tenant stickiness on/off), ``health_interval_s``
    (probe cadence), ``member_stale_s`` (heartbeat age past which an
    unreachable member is declared dead), ``max_member_queue`` (per-member
    queued+inflight cap before placement skips it), ``failover``
    (``"adopt"`` = surviving member adopts the journal; ``"respawn"`` =
    always restart on the dead base dir via ``spawn``), ``spawn`` (the
    no-survivor fallback: ``spawn(name, base_dir) -> pid|None``),
    ``breaker_threshold`` / ``breaker_cooldown_s`` (consecutive
    connection failures before a member's circuit opens / seconds before
    the half-open trial), ``hedge`` + ``hedge_min_delay_s`` /
    ``hedge_max_delay_s`` (idempotent-submit hedging and the clamp on
    its p99-derived trigger delay).
    """

    def __init__(
        self,
        base_dir: str,
        member_dirs: List[str],
        host: str = "127.0.0.1",
        port: int = 0,
        affinity: bool = True,
        health_interval_s: float = 1.0,
        member_stale_s: float = 6.0,
        max_member_queue: int = 64,
        call_timeout_s: float = 10.0,
        failover: str = "adopt",
        spawn: Optional[Callable[[str, str], Optional[int]]] = None,
        breaker_threshold: int = 2,
        breaker_cooldown_s: float = 2.0,
        hedge: bool = True,
        hedge_min_delay_s: float = 0.05,
        hedge_max_delay_s: float = 2.0,
        incarnation: int = 1,
    ):
        self.base_dir = os.path.abspath(base_dir)
        os.makedirs(self.base_dir, exist_ok=True)
        self.failures_path = fu.failures_path(self.base_dir)
        self.host = host
        self.port = int(port)
        self.affinity = bool(affinity)
        self.health_interval_s = max(0.05, float(health_interval_s))
        self.member_stale_s = max(0.1, float(member_stale_s))
        self.max_member_queue = max(1, int(max_member_queue))
        self.call_timeout_s = float(call_timeout_s)
        if failover not in ("adopt", "respawn"):
            raise ValueError(f"unknown failover policy {failover!r}")
        self.failover = failover
        self._spawn = spawn
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.breaker_cooldown_s = max(0.05, float(breaker_cooldown_s))
        self.hedge = bool(hedge)
        self.hedge_min_delay_s = max(0.0, float(hedge_min_delay_s))
        self.hedge_max_delay_s = max(
            self.hedge_min_delay_s, float(hedge_max_delay_s)
        )
        #: which gateway life this is — the supervisor bumps it on every
        #: restart, so "incarnation increments exactly once per kill" is
        #: externally checkable from fleet_state.json
        self.incarnation = max(1, int(incarnation))
        self.started_at = trace_mod.walltime()
        #: pure-bookkeeping lock: member table, affinity
        #: map, route table, counters — never any IO under it
        self._placement_lock = threading.Lock()
        self._members: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        for i, d in enumerate(member_dirs):
            d = os.path.abspath(d)
            name = os.path.basename(d.rstrip(os.sep)) or f"m{i}"
            if name in self._members:
                name = f"{name}-{i}"
            self._members[name] = {
                "name": name, "base_dir": d, "host": None, "port": 0,
                "pid": None, "hostname": None, "alive": False,
                "ever_alive": False, "dead": False, "draining": False,
                "adopted_by": None, "queued": 0, "inflight": 0,
                "replay_backlog": 0, "scrub": None, "heartbeat_age_s": None,
            }
        if not self._members:
            raise ValueError("a fleet needs at least one member dir")
        self._breakers: Dict[str, CircuitBreaker] = {
            n: CircuitBreaker(self.breaker_threshold,
                              self.breaker_cooldown_s)
            for n in self._members
        }
        #: recent successful submit latencies (s) — the hedge delay is
        #: their p99, clamped to [hedge_min_delay_s, hedge_max_delay_s]
        self._submit_latencies: deque = deque(maxlen=128)
        self._hedge_stats = {
            "launched": 0, "won_primary": 0, "won_secondary": 0,
        }
        self._affinity_map: Dict[str, str] = {}
        self._affinity_hits = 0
        self._affinity_misses = 0
        self._affinity_cold = 0
        self._routes: "OrderedDict[str, str]" = OrderedDict()
        self._rejections: Dict[str, int] = {}
        self._adoptions: List[Dict[str, Any]] = []
        self._adopting: set = set()
        self._reject_seq = 0
        self._draining = False
        self._stop = threading.Event()
        self._heartbeat: Optional[HeartbeatWriter] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._health_thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FleetGateway":
        """One synchronous member sweep (so the first submit already sees
        live members), then bind, start the health loop + heartbeat, and
        write the endpoint file — the same ``server.json`` contract as a
        member, so ``ServeClient.from_endpoint_file(gateway_dir)`` routes
        through the gateway unchanged.

        A restarted gateway (the supervisor's crash-only contract) calls
        :meth:`_rebuild_from_disk` first: routes, affinity, adoption
        bookkeeping, and the dead-member grace all come back from what is
        durably on disk, so incarnation N+1 serves exactly what N
        acknowledged."""
        self._rebuild_from_disk()
        self._check_members()
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          _GatewayHandler)
        self._httpd.gateway = self  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-http", daemon=True,
        )
        self._http_thread.start()
        self._heartbeat = HeartbeatWriter(
            self.base_dir, GATEWAY_UID, interval_s=2.0
        ).start()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="fleet-health", daemon=True,
        )
        self._health_thread.start()
        fu.atomic_write_json(
            os.path.join(self.base_dir, ENDPOINT_FILENAME),
            {
                "host": self.host,
                "port": self.port,
                "pid": os.getpid(),
                "hostname": socket.gethostname(),
                "time": trace_mod.walltime(),
                "role": "gateway",
                "incarnation": self.incarnation,
            },
        )
        self._write_state()
        return self

    def _rebuild_from_disk(self) -> None:
        """Cold-start state rebuild (docs/SERVING.md "Supervision"): the
        gateway is crash-only, so everything it routes by must be
        recoverable from member truth — endpoint files, each member's
        ``server_state.json``, and the adoption claims.  The previous
        incarnation's ``fleet_state.json`` is a HINT at most (it breaks
        affinity ties); a stale or torn copy is never trusted over what
        the members themselves say.

        Rebuilt here: ``ever_alive`` (a member with an endpoint file has
        booted once, so its death is detectable — without this a
        restarted gateway would wait out the cold-boot grace and never
        adopt an already-dead member), ``adopted_by`` (consumed adoption
        claims whose ``by`` names a peer, not a ``respawn:`` holder),
        the tenant-affinity map, and the request route table."""
        with self._placement_lock:
            snaps = [(n, m["base_dir"]) for n, m in self._members.items()]
        names = {n for n, _ in snaps}
        hint = fu.read_json_if_valid(
            os.path.join(self.base_dir, FLEET_STATE_FILENAME)
        ) or {}
        hint_aff = dict(((hint.get("affinity") or {}).get("map") or {}))
        # all file IO outside the placement lock
        ever: set = set()
        adopted: Dict[str, str] = {}
        tenant_seen: Dict[str, List[Tuple[int, str]]] = {}
        routes_terminal: List[Tuple[str, str]] = []
        routes_open: List[Tuple[str, str]] = []
        for name, base in snaps:
            if fu.read_json_if_valid(
                os.path.join(base, ENDPOINT_FILENAME)
            ) is not None:
                ever.add(name)
            claim = read_adoption_claim(base)
            by = str((claim or {}).get("by") or "")
            if by and not by.startswith("respawn:") and by != name:
                adopted[name] = by
            state = fu.read_json_if_valid(
                os.path.join(base, STATE_FILENAME)
            ) or {}
            for tenant, t in (state.get("tenants") or {}).items():
                if int(t.get("submitted") or 0) > 0:
                    tenant_seen.setdefault(tenant, []).append(
                        (int(t["submitted"]), name)
                    )
            for rid, rec in (state.get("requests") or {}).items():
                if rec.get("state") in journal_mod.TERMINAL_TYPES or (
                    rec.get("state") == journal_mod.DRAINED
                ):
                    routes_terminal.append((rid, name))
                else:
                    routes_open.append((rid, name))

        def owner(name: str) -> str:
            # follow the adoption chain so rebuilt routes/affinity point
            # at whoever holds the journal now
            hops = 0
            while name in adopted and hops < len(names) + 1:
                name = adopted[name]
                hops += 1
            return name

        affinity: Dict[str, str] = {}
        for tenant, cands in tenant_seen.items():
            hinted = hint_aff.get(tenant)
            if hinted in {owner(n) for _, n in cands}:
                affinity[tenant] = hinted  # hint breaks the tie, no more
            else:
                cands.sort(key=lambda c: (-c[0], c[1]))
                affinity[tenant] = owner(cands[0][1])
        with self._placement_lock:
            for name in names:
                m = self._members.get(name)
                if m is None:
                    continue
                if name in ever:
                    m["ever_alive"] = True
                if name in adopted:
                    m["adopted_by"] = adopted[name]
            for tenant, name in affinity.items():
                if name in self._members:
                    self._affinity_map.setdefault(tenant, name)
            # terminal routes first: the FIFO route-table trim evicts
            # oldest-inserted, so open requests survive the cap
            for rid, name in routes_terminal + routes_open:
                name = owner(name)
                if name in self._members:
                    self._routes[rid] = name
            while len(self._routes) > _MAX_ROUTES:
                self._routes.popitem(last=False)

    # -- membership (the supervisor's scale/respawn hooks) -----------------
    def add_member(self, name: str, base_dir: str) -> Optional[Dict]:
        """Register a new member (scale-up, or respawned capacity on a
        fresh dir).  The dir may be empty — the member is "starting"
        until its first healthy probe, so registration never trips a
        spurious adoption.  Returns the member doc, or None when the
        name is taken."""
        base_dir = os.path.abspath(base_dir)
        os.makedirs(base_dir, exist_ok=True)
        with self._placement_lock:
            if name in self._members:
                return None
            self._members[name] = {
                "name": name, "base_dir": base_dir, "host": None,
                "port": 0, "pid": None, "hostname": None, "alive": False,
                "ever_alive": False, "dead": False, "draining": False,
                "adopted_by": None, "queued": 0, "inflight": 0,
                "replay_backlog": 0, "scrub": None, "heartbeat_age_s": None,
            }
            self._breakers[name] = CircuitBreaker(
                self.breaker_threshold, self.breaker_cooldown_s
            )
            doc = dict(self._members[name])
        trace_mod.instant("fleet.member_added", member=name)
        self._write_state()
        return doc

    def retire_member(self, name: str) -> bool:
        """Drop a member from the table: scale-down after its drain, or
        an adopted-away dir whose capacity respawned elsewhere.  Refused
        for a live, unadopted, undraining member — capacity never
        vanishes silently.  The tenant re-places on next submit; routes
        to an adopted journal were already remapped at adoption time."""
        with self._placement_lock:
            m = self._members.get(name)
            if m is None:
                return False
            if m["alive"] and not m["draining"] and not m.get("adopted_by"):
                return False
            del self._members[name]
            self._breakers.pop(name, None)
            self._adopting.discard(name)
            for tenant, o in list(self._affinity_map.items()):
                if o == name:
                    del self._affinity_map[tenant]
            for rid, o in list(self._routes.items()):
                if o == name:
                    del self._routes[rid]
        trace_mod.instant("fleet.member_retired", member=name)
        self._write_state()
        return True

    def serve_until_drained(self, poll_s: float = 0.2) -> None:
        """Block until the drain latch flips (SIGTERM/SIGUSR1), then stop
        routing and raise :class:`DrainInterrupt` for the entry point to
        map to ``REQUEUE_EXIT_CODE`` — the fleet CLI drains the members
        behind the same signal (docs/SERVING.md "Fleet")."""
        while not drain_requested():
            time.sleep(poll_s)
        self._draining = True
        self._write_state()
        self._teardown()
        raise DrainInterrupt(drain_reason() or "drain requested")

    def stop(self) -> None:
        """Cooperative shutdown for embedders/tests (no drain
        semantics)."""
        self._draining = True
        self._write_state()
        self._teardown()

    def _teardown(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(
                timeout=2 * self.health_interval_s + 5.0
            )
        if self._heartbeat is not None:
            self._heartbeat.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()

    # -- member HTTP (never under the placement lock) ----------------------
    def _breaker_for(self, name: Optional[str]) -> Optional[CircuitBreaker]:
        if not name:
            return None
        with self._placement_lock:
            br = self._breakers.get(name)
            if br is None:
                br = self._breakers[name] = CircuitBreaker(
                    self.breaker_threshold, self.breaker_cooldown_s
                )
        return br

    def _member_call(self, member: Dict[str, Any], method: str, path: str,
                     body: Optional[Dict[str, Any]] = None,
                     timeout_s: Optional[float] = None,
                     site: str = "net_member") -> Tuple[int, Dict]:
        """One deadline-bounded exchange with a member via :mod:`.netio`
        (fault sites ``net_member`` / ``net_probe``), reporting the
        connection-level outcome to the member's circuit breaker — any
        HTTP answer counts as responsive, only timeouts/resets/refusals
        count against it."""
        name = member.get("name")
        br = self._breaker_for(name)
        try:
            status, doc = netio.http_json_call(
                member["host"], int(member["port"]), method, path, body,
                timeout_s=float(timeout_s if timeout_s is not None
                                else self.call_timeout_s),
                site=site, member=name,
            )
        except (OSError, ValueError):
            if br is not None:
                br.record(False)
            raise
        if br is not None:
            br.record(True)
        return status, doc

    # -- health ------------------------------------------------------------
    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_interval_s):
            try:
                self._check_members()
            except Exception:
                pass  # the health loop must outlive one flaky probe

    def _check_members(self) -> None:
        with self._placement_lock:
            names = list(self._members)
        newly_dead = []
        for name in names:
            with self._placement_lock:
                snap = dict(self._members[name])
            update = self._probe_member(snap)  # all IO outside the lock
            with self._placement_lock:
                m = self._members.get(name)
                if m is None:
                    continue
                m.update(update)
                if (
                    m["dead"] and m.get("adopted_by") is None
                    and name not in self._adopting
                ):
                    newly_dead.append(name)
        for name in newly_dead:
            self._failover(name)
        self._write_state()

    def _probe_member(self, m: Dict[str, Any]) -> Dict[str, Any]:
        """One member's health snapshot: endpoint + /healthz + heartbeat
        age + pid liveness + the queue/replay/scrub pressure from its
        ``server_state.json``.  Dead = unreachable AND (pid provably dead,
        or heartbeat stale past ``member_stale_s``) — a member that has
        simply not booted yet (never seen alive) is "starting", not dead,
        so a slow cold boot never triggers a spurious adoption."""
        base = m["base_dir"]
        ep = fu.read_json_if_valid(
            os.path.join(base, ENDPOINT_FILENAME)
        ) or {}
        host = ep.get("host") or m.get("host")
        port = int(ep.get("port") or m.get("port") or 0)
        pid = ep.get("pid") or m.get("pid")
        hostname = ep.get("hostname") or m.get("hostname")
        ok, health = False, {}
        if host and port:
            try:
                status, health = self._member_call(
                    {"name": m.get("name"), "host": host, "port": port},
                    "GET", "/healthz",
                    timeout_s=min(2.0, max(0.2, self.member_stale_s / 2)),
                    site="net_probe",
                )
                ok = status == 200
            except (OSError, ValueError):
                ok = False
        hb = read_heartbeat(base, SERVER_UID) or {}
        hb_age = None
        if hb.get("time") is not None:
            hb_age = max(0.0, trace_mod.walltime() - float(hb["time"]))
        state = fu.read_json_if_valid(os.path.join(base, STATE_FILENAME))
        state = state or {}
        queued = inflight = 0
        for t in (state.get("tenants") or {}).values():
            queued += int(t.get("queued") or 0)
            inflight += int(t.get("inflight") or 0)
        journal = state.get("journal") or {}
        sc = state.get("scrub") or {}
        pid_dead = bool(
            pid
            and hostname == socket.gethostname()
            and int(pid) != os.getpid()
            and not pid_alive(pid)
        )
        hb_stale = hb_age is None or hb_age > self.member_stale_s
        ever = bool(m.get("ever_alive")) or ok
        return {
            "host": host, "port": port, "pid": pid, "hostname": hostname,
            "alive": ok,
            "ever_alive": ever,
            "dead": (not ok) and ever and (pid_dead or hb_stale),
            "draining": (
                bool(health.get("draining")) if ok else m.get("draining")
            ),
            "queued": queued,
            "inflight": inflight,
            "replay_backlog": int(journal.get("replay_backlog") or 0),
            "scrub": (
                {k: sc.get(k) for k in ("passes", "found_corrupt",
                                        "repaired", "unrepairable")}
                if sc else None
            ),
            "heartbeat_age_s": (
                round(hb_age, 3) if hb_age is not None else None
            ),
        }

    # -- failover ----------------------------------------------------------
    def _failover(self, name: str) -> None:
        """One dead member's journal handoff: claim exclusively, then let
        the least-loaded survivor adopt (or respawn when there is none).
        Re-entered by every health tick until the member is adopted, so a
        failed attempt (adopter crashed mid-adopt, claim released) is
        retried instead of abandoned."""
        with self._placement_lock:
            m = self._members.get(name)
            if (
                m is None or m.get("adopted_by") is not None
                or name in self._adopting
            ):
                return
            self._adopting.add(name)
            dead = dict(m)
            survivors = [
                dict(x) for x in self._members.values()
                if x["name"] != name and x["alive"] and not x["draining"]
                and x.get("adopted_by") is None
            ]
        try:
            if self.failover == "respawn" or not survivors:
                self._respawn_failover(dead)
                return
            adopter = min(
                survivors,
                key=lambda x: (x["queued"] + x["inflight"], x["name"]),
            )
            claim = acquire_adoption_claim(
                dead["base_dir"], by=adopter["name"], pid=adopter["pid"],
            )
            if claim is None:
                # someone else (a racing gateway / a respawn) owns this
                # journal's fate; never double-adopt
                trace_mod.instant(
                    "fleet.adopt_contended", member=name,
                )
                return
            # fence FIRST, scan after: minting a higher epoch under the
            # exclusive claim means the old incarnation — even one merely
            # wedged, not dead — can never append another journal byte or
            # flush another store (Journal.append and the server's flush
            # path re-check the epoch and raise Fenced).  The adopter's
            # journal scan below therefore reads the complete, FINAL
            # record of the member's promises: split-brain is closed
            # before any peer byte is read.
            fence_epoch = journal_mod.mint_fence(
                dead["base_dir"], by=f"adopt:{adopter['name']}",
            )
            try:
                status, doc = self._member_call(
                    adopter, "POST", "/adopt",
                    {"base_dir": dead["base_dir"]},
                )
            except (OSError, ValueError):
                status, doc = 0, {}
            if status != 200:
                # adoption did not happen: withdraw so the next tick (or
                # another contender) can retry against a clean slate
                release_adoption_claim(dead["base_dir"], claim)
                return
            event = {
                "time": trace_mod.walltime(),
                "kind": "adopt",
                "member": name,
                "adopter": adopter["name"],
                "fence_epoch": fence_epoch,
                "completed": int(doc.get("completed") or 0),
                "reenqueued": int(doc.get("reenqueued") or 0),
                "quarantined": int(doc.get("quarantined") or 0),
            }
            with self._placement_lock:
                dm = self._members.get(name)
                if dm is not None:
                    dm["adopted_by"] = adopter["name"]
                for rid, owner in list(self._routes.items()):
                    if owner == name:
                        self._routes[rid] = adopter["name"]
                for tenant, owner in list(self._affinity_map.items()):
                    if owner == name:
                        self._affinity_map[tenant] = adopter["name"]
                self._adoptions.append(event)
                del self._adoptions[:-_MAX_ADOPTION_EVENTS]
                self._reject_seq += 1
                seq = self._reject_seq
            trace_mod.instant(
                "fleet.adopt", member=name, adopter=adopter["name"],
                reenqueued=event["reenqueued"], completed=event["completed"],
                fence_epoch=fence_epoch,
            )
            try:
                fu.record_failures(
                    self.failures_path,
                    "fleet.failover",
                    [{
                        "block_id": f"adopt:{name}:{seq}",
                        "sites": {"failover": 1},
                        "error": (
                            f"member {name} died; journal adopted by "
                            f"{adopter['name']}"
                        ),
                        "quarantined": False,
                        "resolved": True,
                        "resolution": ADOPTION_RESOLUTION,
                        "member": name,
                        "adopter": adopter["name"],
                    }],
                )
            except Exception:
                pass  # attribution is best-effort; the adoption stands
            self._write_state()
        finally:
            self._adopting.discard(name)

    def _respawn_failover(self, dead: Dict[str, Any]) -> None:
        """No survivor (or ``failover='respawn'``): restart a server on
        the dead base dir — its own boot replay finishes the acknowledged
        work.  The claim is held across the spawn so a late-arriving
        survivor cannot adopt a journal a fresh server is booting on, and
        released after (the new incarnation owns its journal again)."""
        if self._spawn is None:
            return
        name = dead["name"]
        claim = acquire_adoption_claim(
            dead["base_dir"], by=f"respawn:{name}", pid=os.getpid(),
        )
        if claim is None:
            return
        # fence the old incarnation before the new one boots: a wedged
        # predecessor waking mid-respawn must not interleave appends with
        # its successor.  The fresh server reads the bumped epoch at boot
        # and owns the journal under it.
        fence_epoch = journal_mod.mint_fence(
            dead["base_dir"], by=f"respawn:{name}",
        )
        try:
            pid = self._spawn(name, dead["base_dir"])
        finally:
            release_adoption_claim(dead["base_dir"], claim)
        if pid is None:
            return
        event = {
            "time": trace_mod.walltime(),
            "kind": "respawn",
            "member": name,
            "pid": int(pid),
            "fence_epoch": fence_epoch,
        }
        with self._placement_lock:
            m = self._members.get(name)
            if m is not None:
                m["pid"] = int(pid)
                m["dead"] = False
                m["ever_alive"] = False  # re-arm the cold-boot grace
            self._adoptions.append(event)
            del self._adoptions[:-_MAX_ADOPTION_EVENTS]
            self._reject_seq += 1
            seq = self._reject_seq
        trace_mod.instant("fleet.respawn", member=name, pid=int(pid))
        try:
            fu.record_failures(
                self.failures_path,
                "fleet.respawn",
                [{
                    "block_id": f"respawn:{name}:{seq}",
                    "sites": {"failover": 1},
                    "error": (
                        f"member {name} died with no adoptable survivor; "
                        f"respawned on its own dir as pid {int(pid)}"
                    ),
                    "quarantined": False,
                    "resolved": True,
                    "resolution": "respawned:own_journal",
                    "member": name,
                }],
            )
        except Exception:
            pass  # attribution is best-effort; the respawn stands
        self._write_state()

    # -- placement ---------------------------------------------------------
    def _place(self, tenant: str, exclude=()) -> Tuple[
            Optional[Dict[str, Any]], Optional[str], bool]:
        """Pick a member for one submission: the tenant's affine member
        when placeable (warm caches pay), else least queue depth (and the
        affinity map follows — the tenant sticks to wherever it lands).
        Returns ``(member, reject_code, affinity_hit)``.  Pure
        bookkeeping under the placement lock."""
        with self._placement_lock:
            usable = [
                m for m in self._members.values()
                if m["alive"] and not m["draining"]
                and m.get("adopted_by") is None
                and m["name"] not in exclude
            ]
            if not usable:
                return None, admission_mod.REJECT_FLEET_NO_MEMBER, False
            placeable = [
                m for m in usable
                if m["queued"] + m["inflight"] < self.max_member_queue
            ]
            if not placeable:
                return None, admission_mod.REJECT_FLEET_BACKLOG, False
            want = (
                self._affinity_map.get(tenant) if self.affinity else None
            )
            target, hit = None, False
            for m in placeable:
                if m["name"] == want:
                    target, hit = m, True
                    break
            if target is None:
                target = min(
                    placeable,
                    key=lambda m: (m["queued"] + m["inflight"], m["name"]),
                )
            if self.affinity:
                self._affinity_map[tenant] = target["name"]
            if hit:
                self._affinity_hits += 1
            elif want is None:
                # a first-touch tenant has no affine member to hit — that
                # is a cold pin, not a miss.  Counting it as a miss let
                # new-tenant probe bursts drag hit_rate down without any
                # affinity ever being broken.
                self._affinity_cold += 1
            else:
                self._affinity_misses += 1
            return dict(target), None, hit

    def _hedge_delay(self) -> float:
        """The hedge trigger: p99 of recent successful submit latencies,
        clamped to [hedge_min_delay_s, hedge_max_delay_s] — too few
        samples and the max applies (hedge rarely until the tail is
        known)."""
        with self._placement_lock:
            lats = sorted(self._submit_latencies)
        if len(lats) >= 8:
            delay = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
        else:
            delay = self.hedge_max_delay_s
        return min(self.hedge_max_delay_s,
                   max(self.hedge_min_delay_s, delay))

    def _submit_hedged(
        self, member: Dict[str, Any], payload: Dict[str, Any],
        tenant: str, tried: set,
    ) -> Tuple[int, Dict[str, Any], str]:
        """One placement's submit with a hedge: the primary call runs in
        a helper thread; past the p99-derived delay with no answer, the
        same request is re-routed to a second member, and the first 200
        wins.  Safe ONLY for requests carrying an explicit ``request_id``
        (the caller gates on that): every member dedupes on
        ``(request_id, payload-fingerprint)``, and an adopted journal
        skips already-known ids, so the loser is answered idempotently,
        never double-run.  Returns ``(status, doc, via_member_name)`` or
        raises the connection error when neither side answered."""
        box: Dict[str, Any] = {}
        done = threading.Event()

        def call_primary() -> None:
            try:
                box["res"] = self._member_call(
                    member, "POST", "/submit", payload,
                )
            except (OSError, ValueError) as e:
                box["err"] = e
            finally:
                done.set()

        threading.Thread(
            target=call_primary, name="fleet-hedge-primary", daemon=True,
        ).start()
        if done.wait(self._hedge_delay()):
            if "res" in box:
                st, doc = box["res"]
                return st, doc, member["name"]
            raise box["err"]
        # the primary is past p99 with no answer — the wedge signature.
        second, _code, _hit = self._place(
            tenant, exclude=set(tried) | {member["name"]},
        )
        if second is not None:
            br = self._breaker_for(second["name"])
            if br is not None and not br.allow():
                second = None
        if second is None:
            # nowhere to hedge: wait out the primary's own deadline
            done.wait(self.call_timeout_s + 1.0)
            if "res" in box:
                st, doc = box["res"]
                return st, doc, member["name"]
            raise box.get("err") or TimeoutError(
                f"{member['name']}: no answer within the deadline"
            )
        with self._placement_lock:
            self._hedge_stats["launched"] += 1
        trace_mod.instant(
            "fleet.hedge", tenant=tenant, primary=member["name"],
            secondary=second["name"],
        )
        try:
            st2, doc2 = self._member_call(
                second, "POST", "/submit", payload,
            )
        except (OSError, ValueError):
            st2, doc2 = None, None
        if st2 == 200:
            with self._placement_lock:
                self._hedge_stats["won_secondary"] += 1
            return st2, doc2, second["name"]
        # the secondary could not win either — fall back to the primary
        done.wait(self.call_timeout_s + 1.0)
        if "res" in box:
            st, doc = box["res"]
            with self._placement_lock:
                self._hedge_stats["won_primary"] += 1
            return st, doc, member["name"]
        if st2 is not None:
            return st2, doc2, second["name"]  # the typed answer we have
        raise box.get("err") or TimeoutError(
            f"{member['name']}: no answer within the deadline"
        )

    def submit(self, payload: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """Route one submission: place, forward, record the route.  A
        member behind an OPEN circuit breaker is skipped without a call
        (all skipped → typed ``rejected:fleet_breaker_open``); a member
        that drops the connection mid-submit is marked suspect and the
        next member tried (idempotency makes the ambiguous retry safe);
        a request with an explicit ``request_id`` is hedged to a second
        member past the p99 delay; typed member rejections pass through
        verbatim; when no member is placeable the gateway's own typed
        backpressure answers (``rejected:fleet_*``)."""
        tenant = str(payload.get("tenant") or "default")
        if self._draining or drain_requested():
            return self._reject(
                tenant, admission_mod.REJECT_DRAINING, "gateway draining",
            )
        hedgeable = bool(self.hedge and payload.get("request_id"))
        tried: set = set()
        last_err = ""
        breaker_blocked = False
        with self._placement_lock:
            n_members = len(self._members)
        for _ in range(n_members):
            member, code, _hit = self._place(tenant, exclude=tried)
            if member is None:
                if breaker_blocked \
                        and code == admission_mod.REJECT_FLEET_NO_MEMBER:
                    code = admission_mod.REJECT_FLEET_BREAKER
                return self._reject(
                    tenant, code,
                    last_err or ("circuit breaker open"
                                 if breaker_blocked else ""),
                )
            br = self._breaker_for(member["name"])
            if br is not None and not br.allow():
                tried.add(member["name"])
                breaker_blocked = True
                continue
            t0 = time.monotonic()
            try:
                if hedgeable:
                    status, doc, via = self._submit_hedged(
                        member, payload, tenant, tried,
                    )
                else:
                    status, doc = self._member_call(
                        member, "POST", "/submit", payload,
                    )
                    via = member["name"]
            except (OSError, ValueError) as e:
                tried.add(member["name"])
                last_err = f"{member['name']}: {e}"
                with self._placement_lock:
                    live = self._members.get(member["name"])
                    if live is not None:
                        live["alive"] = False  # suspect; health confirms
                continue
            if status == 200 and doc.get("request_id"):
                rid = str(doc["request_id"])
                with self._placement_lock:
                    self._submit_latencies.append(time.monotonic() - t0)
                    self._routes[rid] = via
                    while len(self._routes) > _MAX_ROUTES:
                        self._routes.popitem(last=False)
                    live = self._members.get(via)
                    if live is not None:
                        # provisional until the next probe refreshes it:
                        # keeps least-queue placement honest in bursts
                        live["queued"] += 1
                doc = dict(doc)
                doc["member"] = via
                return status, doc
            return status, doc  # the member's typed answer, verbatim
        if breaker_blocked and not last_err:
            return self._reject(
                tenant, admission_mod.REJECT_FLEET_BREAKER,
                "every placeable member behind an open breaker",
            )
        return self._reject(
            tenant, admission_mod.REJECT_FLEET_NO_MEMBER,
            f"every member unreachable; last: {last_err}",
        )

    def _reject(self, tenant: str, code: str,
                detail: str = "") -> Tuple[int, Dict[str, Any]]:
        """Typed gateway backpressure, attributed exactly like a member's
        rejection (failures.json + trace instant), outside all locks."""
        with self._placement_lock:
            self._reject_seq += 1
            seq = self._reject_seq
            self._rejections[code] = self._rejections.get(code, 0) + 1
        try:
            fu.record_failures(
                self.failures_path,
                f"fleet.{tenant}",
                [{
                    "block_id": f"route:{tenant}:{os.getpid()}:{seq}",
                    "sites": {"route": 1},
                    "error": detail or None,
                    "quarantined": False,
                    "resolved": True,
                    "resolution": code,
                    "tenant": tenant,
                }],
            )
        except Exception:
            pass  # attribution is best-effort; the rejection stands
        trace_mod.instant("fleet.reject", tenant=tenant, code=code)
        self._write_state()
        http = 503 if code in (
            admission_mod.REJECT_DRAINING,
            admission_mod.REJECT_FLEET_NO_MEMBER,
            admission_mod.REJECT_FLEET_BREAKER,
        ) else 429
        return http, {"error": code, "tenant": tenant, "detail": detail}

    # -- lookup ------------------------------------------------------------
    def lookup(self, request_id: str) -> Tuple[int, Dict[str, Any]]:
        """Find a request's record: the routed owner first (post-failover
        routes already point at the adopter), then every live member (a
        gateway restart loses the route table, the broadcast does not
        lose answers).  A known owner that nobody can answer for is the
        failover window: a typed 503 the client's ``wait`` backs off on,
        never a terminal-looking document."""
        with self._placement_lock:
            owner = self._routes.get(request_id)
            members = [dict(m) for m in self._members.values()]
        ordered = [m for m in members if m["name"] == owner]
        ordered += [
            m for m in members
            if m["alive"] and m["name"] != owner
        ]
        seen_answer = False
        for m in ordered:
            if not (m["alive"] or m["name"] == owner):
                continue
            try:
                status, doc = self._member_call(
                    m, "GET", f"/request/{request_id}",
                )
            except (OSError, ValueError):
                continue
            if status == 200:
                return 200, doc
            seen_answer = True
        if owner is not None and not seen_answer:
            return 503, {
                "error": admission_mod.REJECT_FLEET_NO_MEMBER,
                "request_id": request_id,
                "detail": (
                    f"owner {owner} unreachable; journal adoption pending"
                ),
            }
        return 404, {"error": "unknown_request"}

    # -- drain policy ------------------------------------------------------
    def drain_emptiest(
        self, member: Optional[str] = None,
    ) -> Optional[Dict[str, Any]]:
        """The scale-down hook: SIGTERM the emptiest live member (or the
        named one) so it drains through the standard protocol — in-flight
        work finishes, queued work stays journaled, the process exits
        ``REQUEUE_EXIT_CODE`` (114).  Returns the chosen member, or None
        when nothing is drainable."""
        with self._placement_lock:
            candidates = [
                dict(m) for m in self._members.values()
                if m["alive"] and not m["draining"]
                and m.get("adopted_by") is None
                and (member is None or m["name"] == member)
            ]
            if not candidates:
                return None
            target = min(
                candidates,
                key=lambda m: (m["queued"] + m["inflight"], m["name"]),
            )
            live = self._members.get(target["name"])
            if live is not None:
                live["draining"] = True
        pid = target.get("pid")
        delivered = False
        if (
            pid and int(pid) != os.getpid()
            and target.get("hostname") == socket.gethostname()
        ):
            try:
                os.kill(int(pid), signal.SIGTERM)
                delivered = True
            except OSError:
                delivered = False
        trace_mod.instant(
            "fleet.drain", member=target["name"],
            pid=int(pid) if pid else 0,
        )
        try:
            fu.record_failures(
                self.failures_path,
                "fleet.drain",
                [{
                    "block_id": f"drain:{target['name']}",
                    "sites": {},
                    "error": (
                        f"member {target['name']} drained (scale-down)"
                    ),
                    "quarantined": False,
                    "resolved": True,
                    "resolution": "drained:scale_down",
                    "member": target["name"],
                }],
            )
        except Exception:
            pass  # attribution is best-effort; the drain stands
        self._write_state()
        return {
            "member": target["name"],
            "pid": pid,
            "signalled": delivered,
        }

    # -- introspection -----------------------------------------------------
    def _state_doc(self) -> Dict[str, Any]:
        with self._placement_lock:
            members = {
                n: {
                    k: m.get(k)
                    for k in ("base_dir", "host", "port", "pid", "hostname",
                              "alive", "ever_alive", "dead", "draining",
                              "adopted_by", "queued", "inflight",
                              "replay_backlog", "scrub", "heartbeat_age_s")
                }
                for n, m in self._members.items()
            }
            hits, misses = self._affinity_hits, self._affinity_misses
            cold_pins = self._affinity_cold
            affinity_map = dict(self._affinity_map)
            adoptions = list(self._adoptions)
            rejections = dict(self._rejections)
            n_routes = len(self._routes)
            breakers = dict(self._breakers)
            hedge_stats = dict(self._hedge_stats)
        # breaker snapshots + fence epochs OUTSIDE the placement lock:
        # each breaker has its own lock, and the fence read is file IO
        for n, m in members.items():
            br = breakers.get(n)
            m["breaker"] = br.snapshot() if br is not None else None
            m["fence_epoch"] = int(
                journal_mod.read_fence(m["base_dir"])["epoch"]
            )
        total = hits + misses
        return {
            "version": 1,
            "role": "gateway",
            "uid": GATEWAY_UID,
            "incarnation": self.incarnation,
            "pid": os.getpid(),
            "hostname": socket.gethostname(),
            "host": self.host,
            "port": self.port,
            "time": trace_mod.walltime(),
            "started": self.started_at,
            "draining": self._draining or drain_requested(),
            "failover": self.failover,
            "members": members,
            "affinity": {
                "enabled": self.affinity,
                "hits": hits,
                "misses": misses,
                # first-ever placements: no affinity existed to hit or
                # break, reported separately so probe-tenant bursts don't
                # pollute hit_rate's denominator
                "cold_pins": cold_pins,
                "hit_rate": round(hits / total, 4) if total else None,
                "map": affinity_map,
            },
            "routes": n_routes,
            "rejections": rejections,
            "adoptions": adoptions,
            "hedge": {
                "enabled": self.hedge,
                "delay_s": round(self._hedge_delay(), 4),
                **{k: int(v) for k, v in hedge_stats.items()},
            },
            "dead_unadopted": sorted(
                n for n, m in members.items()
                if m.get("dead") and not m.get("adopted_by")
            ),
        }

    def _write_state(self) -> None:
        """Atomically refresh ``fleet_state.json`` — the file the
        ``scripts/progress.py`` fleet view renders.  Best-effort; the
        gateway must outlive a full disk."""
        try:
            fu.atomic_write_json(
                os.path.join(self.base_dir, FLEET_STATE_FILENAME),
                self._state_doc(),
            )
        except OSError:
            pass

    def status(self) -> Dict[str, Any]:
        """The ``/status`` document: the fleet state plus an ``rc`` that
        preserves the operator contract — 1 when a member is dead and
        unadopted (acknowledged requests are stranded until the failover
        completes)."""
        doc = self._state_doc()
        return {"fleet": doc, "rc": 1 if doc["dead_unadopted"] else 0}

    def healthz(self) -> Dict[str, Any]:
        doc = self._state_doc()
        return {
            "ok": True,
            "role": "gateway",
            "incarnation": doc["incarnation"],
            "draining": doc["draining"],
            "members": {
                n: {
                    k: m.get(k)
                    for k in ("alive", "dead", "draining", "adopted_by",
                              "queued", "inflight", "replay_backlog",
                              "breaker", "fence_epoch")
                }
                for n, m in doc["members"].items()
            },
            "affinity": doc["affinity"],
            "dead_unadopted": doc["dead_unadopted"],
        }


# -- HTTP plumbing ------------------------------------------------------------


class _GatewayHandler(BaseHTTPRequestHandler):
    """The gateway's JSON-over-HTTP surface, a superset-shape of the
    member handler so existing clients work unchanged: POST /submit,
    GET /status, GET /request/<id>, GET /healthz, plus the fleet-only
    POST /drain (the scale-down hook) and POST /members (the
    supervisor's add/retire membership hooks)."""

    server_version = "ctt-fleet/1"

    @property
    def gateway(self) -> FleetGateway:
        return self.server.gateway  # type: ignore[attr-defined]

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
        try:
            length = int(self.headers.get("Content-Length") or 0)
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, OSError) as e:
            self._reply(400, {"error": "bad_request", "detail": str(e)})
            return
        if path == "/submit":
            status, doc = self.gateway.submit(payload)
            self._reply(status, doc)
        elif path == "/drain":
            doc = self.gateway.drain_emptiest(payload.get("member"))
            if doc is None:
                self._reply(409, {"error": "no_drainable_member"})
            else:
                self._reply(200, doc)
        elif path == "/members":
            # the supervisor's membership hooks: register respawned /
            # scaled-up capacity, retire drained or adopted-away dirs
            op = payload.get("op")
            name = str(payload.get("name") or "")
            if op == "add" and name and payload.get("base_dir"):
                doc = self.gateway.add_member(
                    name, str(payload["base_dir"])
                )
                if doc is None:
                    self._reply(409, {"error": "member_exists"})
                else:
                    self._reply(200, {"member": name, "added": True})
            elif op == "retire" and name:
                if self.gateway.retire_member(name):
                    self._reply(200, {"member": name, "retired": True})
                else:
                    self._reply(409, {"error": "not_retirable"})
            else:
                self._reply(400, {"error": "bad_member_op"})
        else:
            self._reply(404, {"error": "not_found"})

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.rstrip("/")
        if path == "/healthz":
            self._reply(200, self.gateway.healthz())
        elif path == "/status":
            self._reply(200, self.gateway.status())
        elif path.startswith("/request/"):
            status, doc = self.gateway.lookup(path[len("/request/"):])
            self._reply(status, doc)
        else:
            self._reply(404, {"error": "not_found"})
