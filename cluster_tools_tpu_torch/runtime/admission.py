"""Per-tenant admission control for the resident pipeline server.

Port (a copy) of ``cluster_tools_tpu/runtime/admission.py``: the same
reject codes, quotas, dispatch order and ``snapshot()`` fields, which
``scripts/progress.py`` reads from ``server_state.json``.

The batch runtime already rations *bytes*: the executor's admission gate
caps loaded-but-unstored batch bytes against a MemAvailable-derived budget.
Service mode (docs/SERVING.md) adds the missing dimension — *who* the bytes
belong to.  A resident server admits concurrent workflow requests from many
tenants against one process's caches and devices, so admission must be
per-tenant:

- **Quotas** (:class:`TenantQuota`): queue depth (how many requests a
  tenant may have waiting), in-flight workflows (how many may run at
  once), and bytes in flight (the sum of the running requests' declared
  ``est_bytes``).  A submission that cannot ever be admitted — queue full,
  or ``est_bytes`` exceeding the tenant's whole byte quota — is rejected
  *immediately* with a typed :class:`AdmissionError`, never silently
  queued to rot.
- **Deficit-round-robin dispatch** (:meth:`AdmissionController.
  next_request`): tenants are served in rotation, each accruing
  ``quantum`` credits per visit and paying a byte-derived cost per
  dispatched request, so an aggressor tenant flooding the queue cannot
  starve a well-behaved one — the fairness property the serve bench
  measures (``BENCH_r10.json``).
- **Deadlines**: a queued request whose ``deadline_s`` elapses before
  dispatch is rejected (``rejected:deadline``) instead of burning a worker
  on an answer nobody is waiting for.
- **Typed backpressure**: every rejection carries a machine-readable
  ``code`` (the :data:`REJECT_*` constants) that the HTTP layer maps to a
  429/503 and the server records in ``failures.json`` — admission failures
  are attributed like any other fault (``kind='reject'`` at site
  ``admit`` in ``runtime/faults.py`` injects them for chaos).

The module also owns the **ambient request context**
(:func:`request_context` / :func:`current_request`): a thread-local
``(tenant, request_id, byte_cap)`` the server opens around each request's
``build()``.  Downstream layers read it instead of plumbing a tenant
through every call site — the handoff registry namespaces identities by
``request_id`` (``runtime/handoff.py``) and the executor caps its
auto-derived inflight byte budget at the tenant's share
(``runtime/executor.py``).  ``host_block_map`` re-enters the context on
its worker threads (:func:`request_scope`), so block-grain artifact
publishes stay namespaced.

Lock discipline (docs/ANALYSIS.md CT009): ``_admission_lock`` guards pure
bookkeeping only — no storage IO, sleeps, or future waits ever run under
it; workers block on a (lock-free) event between dispatch scans and all
rejection *recording* happens after the lock is released.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

#: typed backpressure codes carried by :class:`AdmissionError` and recorded
#: as the rejection's ``resolution`` in failures.json
REJECT_QUEUE = "rejected:queue_depth"
REJECT_BYTES = "rejected:byte_quota"
REJECT_DEADLINE = "rejected:deadline"
REJECT_DRAINING = "rejected:draining"
REJECT_FAULT = "rejected:fault"
REJECT_DUPLICATE = "rejected:duplicate"
#: gateway-layer backpressure (runtime/fleet.py, docs/SERVING.md "Fleet"):
#: no placeable member at all (everyone dead/draining — the failover
#: window, HTTP 503) vs. every member over its queue cap (transient
#: fleet-wide pressure, HTTP 429).  Both are retry-with-backoff codes.
REJECT_FLEET_NO_MEMBER = "rejected:fleet_no_member"
REJECT_FLEET_BACKLOG = "rejected:fleet_backlog"
#: every otherwise-placeable member sits behind an OPEN circuit breaker
#: (consecutive timeouts/resets — a wedged member, not a dead one).  HTTP
#: 503, retry-with-backoff: the breaker half-opens after its cooldown
#: (docs/SERVING.md "Gray failures").
REJECT_FLEET_BREAKER = "rejected:fleet_breaker_open"

#: one DRR credit buys this many bytes of request cost (requests without a
#: size declaration cost exactly one credit)
BYTE_COST_UNIT = 64 << 20


class AdmissionError(RuntimeError):
    """A typed admission rejection: ``code`` is one of the ``REJECT_*``
    constants, ``tenant`` the quota owner it was charged against.  The
    server maps it to an HTTP 429 (quota/deadline/fault) or 503
    (draining) and records it in ``failures.json``."""

    def __init__(self, code: str, tenant: Optional[str], detail: str = ""):
        self.code = code
        self.tenant = tenant
        self.detail = detail
        msg = code if not detail else f"{code}: {detail}"
        if tenant is not None:
            msg = f"[tenant {tenant}] {msg}"
        super().__init__(msg)


@dataclass(frozen=True)
class TenantQuota:
    """Admission quotas for one tenant (docs/SERVING.md "Tenant quotas").

    ``max_queue_depth`` — queued (admitted, not yet running) requests;
    ``max_inflight`` — concurrently running workflows;
    ``max_bytes_in_flight`` — sum of running requests' ``est_bytes`` (a
    request declaring more than this alone is rejected outright);
    ``quantum`` — DRR credits accrued per scheduler visit (raise to give a
    tenant a larger share of dispatch bandwidth).
    """

    max_queue_depth: int = 16
    max_inflight: int = 2
    max_bytes_in_flight: int = 2 << 30
    quantum: float = 1.0

    @classmethod
    def from_config(cls, doc: Optional[Dict[str, Any]]) -> "TenantQuota":
        doc = dict(doc or {})
        known = {f for f in cls.__dataclass_fields__}  # noqa: C416
        return cls(**{k: v for k, v in doc.items() if k in known})


@dataclass
class Request:
    """One admitted (or rejected) workflow request, scheduler-visible
    fields only — the server keeps its own record of workflow payloads."""

    tenant: str
    request_id: str
    est_bytes: int = 0
    deadline_s: Optional[float] = None
    payload: Any = None
    enqueued_at: float = field(default_factory=time.monotonic)
    #: per-request executor byte cap, computed at dispatch (the tenant's
    #: byte quota split across its running requests); read by the executor
    #: through the ambient request context
    byte_cap: Optional[int] = None

    def cost(self) -> float:
        """DRR cost in credits: byte-proportional, floor one credit."""
        return max(1.0, float(self.est_bytes) / BYTE_COST_UNIT)

    def expired(self, now: Optional[float] = None) -> bool:
        if not self.deadline_s:
            return False
        now = time.monotonic() if now is None else now
        return (now - self.enqueued_at) > float(self.deadline_s)


class _TenantState:
    __slots__ = ("quota", "queue", "inflight", "bytes_in_flight", "deficit",
                 "submitted", "completed", "rejected", "dispatched")

    def __init__(self, quota: TenantQuota):
        self.quota = quota
        self.queue: deque = deque()
        self.inflight = 0
        self.bytes_in_flight = 0
        self.deficit = 0.0
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.dispatched = 0


class AdmissionController:
    """Thread-safe per-tenant admission + deficit-round-robin dispatch.

    ``on_reject(request_or_none, tenant, code, detail)`` is called for
    every rejection — including deadline expiries discovered at dispatch
    time — strictly *outside* ``_admission_lock`` (it may do storage IO).
    """

    def __init__(
        self,
        quotas: Optional[Dict[str, TenantQuota]] = None,
        default_quota: Optional[TenantQuota] = None,
        on_reject: Optional[Callable[..., None]] = None,
    ):
        self._admission_lock = threading.Lock()
        self._event = threading.Event()
        self._tenants: "OrderedDict[str, _TenantState]" = OrderedDict()
        self._default_quota = default_quota or TenantQuota()
        self._on_reject = on_reject
        self._draining = False
        self._rr: List[str] = []  # rotation order
        self._rr_next = 0
        for name, quota in (quotas or {}).items():
            self._tenant(name, register=True)
            self._tenants[name].quota = quota

    # -- internals (call under _admission_lock) ----------------------------
    def _tenant(self, name: str, register: bool = False) -> _TenantState:
        state = self._tenants.get(name)
        if state is None:
            state = _TenantState(self._default_quota)
            self._tenants[name] = state
            self._rr.append(name)
        return state

    # -- submission --------------------------------------------------------
    def submit(self, request: Request, admitted: bool = False) -> None:
        """Admit ``request`` into its tenant's queue or raise a typed
        :class:`AdmissionError`.  The injected ``reject`` fault (site
        ``admit``) is the caller's to check — it needs the tenant name
        before a Request even exists.

        ``admitted=True`` re-enters a request a previous server
        incarnation already acknowledged (journal replay,
        docs/SERVING.md "Durability"): the quota was charged when the
        durable 200 was issued, so the quota gates are not re-litigated —
        the request goes straight to its tenant's queue."""
        code = detail = None
        with self._admission_lock:
            state = self._tenant(request.tenant)
            if admitted:
                state.submitted += 1
                state.queue.append(request)
            elif self._draining:
                code, detail = REJECT_DRAINING, "server is draining"
            elif request.est_bytes > state.quota.max_bytes_in_flight:
                code = REJECT_BYTES
                detail = (
                    f"est_bytes {request.est_bytes} exceeds the tenant byte "
                    f"quota {state.quota.max_bytes_in_flight}"
                )
            elif len(state.queue) >= state.quota.max_queue_depth:
                code = REJECT_QUEUE
                detail = (
                    f"queue depth {len(state.queue)} at quota "
                    f"{state.quota.max_queue_depth}"
                )
            else:
                state.submitted += 1
                state.queue.append(request)
        if code is not None:
            self._reject(request, request.tenant, code, detail or "")
            raise AdmissionError(code, request.tenant, detail or "")
        self._event.set()

    def _reject(self, request, tenant, code, detail) -> None:
        with self._admission_lock:
            self._tenant(tenant).rejected += 1
        if self._on_reject is not None:
            try:
                self._on_reject(request, tenant, code, detail)
            except Exception:
                pass  # attribution is best-effort; the rejection stands

    # -- dispatch ----------------------------------------------------------
    def _try_dispatch(self) -> tuple:
        """One DRR scan under the lock: ``(request_or_None, expired)``.
        Visits every tenant once starting after the last-served one; a
        tenant with queued work accrues its quantum, and dispatches its
        head request when the deficit covers the cost AND its inflight /
        byte quotas have room.  Empty queues accrue nothing (classic DRR:
        only backlogged flows hold credit)."""
        expired: List[Request] = []
        with self._admission_lock:
            if self._draining:
                # drain latch: stop DISPATCH too — queued requests stay
                # queued (the restarted server's clients resubmit them);
                # only the already-running ones finish (docs/SERVING.md
                # "Lifecycle")
                return None, expired
            n = len(self._rr)
            now = time.monotonic()
            for off in range(n):
                name = self._rr[(self._rr_next + off) % n]
                state = self._tenants[name]
                # expired-deadline requests never dispatch; collect for
                # recording outside the lock
                while state.queue and state.queue[0].expired(now):
                    expired.append(state.queue.popleft())
                if not state.queue:
                    state.deficit = 0.0
                    continue
                state.deficit = min(
                    state.deficit + state.quota.quantum,
                    8 * max(state.quota.quantum, state.queue[0].cost()),
                )
                head = state.queue[0]
                if head.cost() > state.deficit:
                    continue
                if state.inflight >= state.quota.max_inflight:
                    continue
                if (state.bytes_in_flight + head.est_bytes
                        > state.quota.max_bytes_in_flight):
                    continue
                state.queue.popleft()
                state.deficit -= head.cost()
                state.inflight += 1
                state.dispatched += 1
                state.bytes_in_flight += head.est_bytes
                # the executor's tenant-tagged budget: this request's share
                # of the tenant's byte quota while its siblings run.
                # Work-conserving on purpose: earlier dispatches keep the
                # larger cap they started with (a lone request gets the
                # whole quota), so a tenant's LIVE caps can transiently sum
                # past the quota — admission still gates actual est_bytes
                # at the quota, and the executor additionally bounds its
                # budget by real host headroom.
                head.byte_cap = max(
                    1, state.quota.max_bytes_in_flight // state.inflight
                )
                self._rr_next = (self._rr_next + off + 1) % n
                return head, expired
        return None, expired

    def next_request(self, timeout: Optional[float] = None) -> Optional[Request]:
        """Dispatch the next runnable request (DRR order), waiting up to
        ``timeout`` seconds for one to become available.  Deadline-expired
        requests encountered on the way are rejected
        (``rejected:deadline``) through ``on_reject``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            request, expired = self._try_dispatch()
            for r in expired:
                self._reject(
                    r, r.tenant, REJECT_DEADLINE,
                    f"deadline_s={r.deadline_s:g} elapsed in queue",
                )
            if request is not None:
                return request
            if deadline is not None and time.monotonic() >= deadline:
                return None
            # wait OUTSIDE the admission lock for a submit/release to nudge
            self._event.wait(0.05)
            self._event.clear()

    def release(self, request: Request, completed: bool = True) -> None:
        """A dispatched request finished (any terminal state): return its
        inflight/byte claims to the tenant."""
        with self._admission_lock:
            state = self._tenant(request.tenant)
            state.inflight = max(0, state.inflight - 1)
            state.bytes_in_flight = max(
                0, state.bytes_in_flight - request.est_bytes
            )
            if completed:
                state.completed += 1
        self._event.set()

    def restore_counts(self, tenant: str, submitted: int = 0,
                       dispatched: int = 0, completed: int = 0,
                       rejected: int = 0) -> None:
        """Seed a tenant's lifetime counters from a journal replay
        (docs/SERVING.md "Durability").  Quota *state* (queue depth,
        inflight, bytes) rebuilds naturally as replayed requests re-enter
        through :meth:`submit`; the monotonic counters would otherwise
        reset to zero across a restart and lie to the operator view and
        the fairness accounting."""
        with self._admission_lock:
            state = self._tenant(tenant)
            state.submitted += int(submitted)
            state.dispatched += int(dispatched)
            state.completed += int(completed)
            state.rejected += int(rejected)

    # -- drain + introspection --------------------------------------------
    def begin_drain(self) -> None:
        """Stop admitting: subsequent submits are rejected
        ``rejected:draining``; queued requests stay queued (the restart
        resubmits them — docs/SERVING.md "Lifecycle")."""
        with self._admission_lock:
            self._draining = True
        self._event.set()

    def draining(self) -> bool:
        with self._admission_lock:
            return self._draining

    def idle(self) -> bool:
        """No request running anywhere (queued ones may remain)."""
        with self._admission_lock:
            return all(s.inflight == 0 for s in self._tenants.values())

    def queued(self) -> int:
        with self._admission_lock:
            return sum(len(s.queue) for s in self._tenants.values())

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant stats for the server state file / ``/status``."""
        with self._admission_lock:
            return {
                name: {
                    "queued": len(s.queue),
                    "inflight": s.inflight,
                    "bytes_in_flight": int(s.bytes_in_flight),
                    "submitted": s.submitted,
                    "dispatched": s.dispatched,
                    "completed": s.completed,
                    "rejected": s.rejected,
                    "quota": {
                        "max_queue_depth": s.quota.max_queue_depth,
                        "max_inflight": s.quota.max_inflight,
                        "max_bytes_in_flight": int(
                            s.quota.max_bytes_in_flight
                        ),
                        "quantum": s.quota.quantum,
                    },
                }
                for name, s in self._tenants.items()
            }


# -- ambient request context --------------------------------------------------
# Thread-local on purpose: one request's build() owns its worker thread, and
# the layers that read the context (handoff identity namespacing, executor
# byte caps) are called from that thread.  Pools spawned inside a request
# (host_block_map's IO workers) re-enter it via request_scope().


class RequestContext:
    __slots__ = ("tenant", "request_id", "byte_cap")

    def __init__(self, tenant: str, request_id: str,
                 byte_cap: Optional[int] = None):
        self.tenant = tenant
        self.request_id = request_id
        self.byte_cap = byte_cap


_tls = threading.local()


def current_request() -> Optional[RequestContext]:
    """The request context of THIS thread, or None outside service mode."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def request_context(tenant: str, request_id: str,
                    byte_cap: Optional[int] = None):
    """Open a request context on this thread (the server wraps each
    request's ``build()`` in one)."""
    prev = current_request()
    _tls.ctx = RequestContext(tenant, request_id, byte_cap)
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev


@contextlib.contextmanager
def request_scope(ctx: Optional[RequestContext]):
    """Re-enter a captured context on another thread (``host_block_map``
    worker pools); a None context is a no-op, so batch-mode callers pay
    nothing."""
    prev = current_request()
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


def ambient_byte_cap() -> Optional[int]:
    """The executor-facing view of the context: the running request's
    share of its tenant's byte quota (None outside service mode)."""
    ctx = current_request()
    return None if ctx is None else ctx.byte_cap
