"""The serve plane's one outbound-HTTP doorway (docs/SERVING.md "Gray
failures").

Port (a copy) of ``cluster_tools_tpu/runtime/netio.py``.

Every HTTP exchange the serving stack makes — the gateway's data-path
calls to members, the health loop's probes, and the client's calls to a
server or gateway — goes through :func:`http_json_call`, which enforces
the two properties gray-failure defense depends on:

- **an explicit deadline on every exchange** (``timeout_s`` is required;
  ctlint CT013 flags any ``HTTPConnection``/``urlopen`` in the package
  that bypasses this module without one).  A wedged far side — SIGSTOP,
  GC pause, dead disk under the accept queue — holds a connection open
  forever; only a wall-clock deadline turns that into a typed, countable
  failure the circuit breaker can act on.
- **the network fault shim** (``runtime/faults.py`` sites ``net_member``
  / ``net_probe`` / ``net_client``): the injector's verdict degrades the
  exchange before any bytes move — ``net_delay`` sleeps, ``net_drop``
  raises ``ConnectionResetError``, ``net_wedge`` blocks until the
  caller's own deadline fires and then raises ``TimeoutError`` — so
  chaos can wedge exactly one member of a fleet and prove the breaker,
  hedging, and fencing layers respond.

:func:`retry_connection` is the shared connection-level retry/backoff
loop the client and gateway previously half-duplicated: it retries ONLY
``OSError``/``ConnectionError`` (the restart/failover window), never
HTTP-level answers — typed rejection codes are the caller's protocol.
"""

from __future__ import annotations

import http.client
import json
import time
from typing import Any, Callable, Dict, Optional, Tuple

from ..utils import function_utils as fu
from . import faults as faults_mod


def http_json_call(
    host: str,
    port: int,
    method: str,
    path: str,
    body: Optional[Dict[str, Any]] = None,
    *,
    timeout_s: float,
    site: str = "net_client",
    member: Optional[str] = None,
) -> Tuple[int, Dict[str, Any]]:
    """One JSON-over-HTTP exchange with an explicit deadline.

    ``timeout_s`` is keyword-required on purpose: an unbounded serve-plane
    wait is exactly the gray failure this PR exists to kill.  ``site`` /
    ``member`` name the exchange for the fault shim (and ``member`` is
    the breaker's key on the gateway side).  Raises ``OSError`` subtypes
    for every connection-level failure — refused, reset, and the deadline
    firing — so callers classify with one ``except (OSError, ValueError)``.
    """
    timeout_s = float(timeout_s)
    verdict = faults_mod.get_injector().net_fault(site, member=member)
    if verdict is not None:
        kind, seconds = verdict
        if kind == "net_delay":
            # congestion / a GC pause on the far side: late, not lost
            time.sleep(seconds)
        elif kind == "net_drop":
            raise ConnectionResetError(
                f"injected net_drop at {site}"
                + (f" (member {member})" if member else "")
            )
        elif kind == "net_wedge":
            # an accepted connection that never answers: nothing moves
            # until the caller's own deadline fires — the sleep is capped
            # at that deadline so the model is exact and tests terminate
            time.sleep(min(seconds, timeout_s))
            raise TimeoutError(
                f"injected net_wedge at {site}"
                + (f" (member {member})" if member else "")
                + f": no answer within {timeout_s:g}s"
            )
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout_s)
    try:
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"} if data else {}
        conn.request(method, path, body=data, headers=headers)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def retry_connection(
    fn: Callable[[], Tuple[int, Dict[str, Any]]],
    retry_s: Optional[float],
    on_retry: Optional[Callable[[], None]] = None,
    base_s: float = 0.05,
    cap_s: float = 1.0,
) -> Tuple[int, Dict[str, Any]]:
    """Run ``fn`` (one :func:`http_json_call`-shaped exchange), retrying
    connection-level failures with capped backoff for up to ``retry_s``
    seconds.  ``on_retry`` runs between attempts (the client re-reads its
    endpoint file there — a restarted server binds a fresh port).  With
    no budget the first failure propagates; HTTP answers never retry."""
    deadline = None if not retry_s else time.monotonic() + float(retry_s)
    attempt = 0
    while True:
        try:
            return fn()
        except (OSError, ConnectionError):
            if deadline is None or time.monotonic() >= deadline:
                raise
            time.sleep(fu.backoff_delay(attempt, base_s, cap_s))
            attempt += 1
            if on_retry is not None:
                on_retry()
