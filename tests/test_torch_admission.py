"""The port's per-tenant admission (``runtime/admission.py``) against the JAX
package's: the same submissions to both controllers give the same dispatch
order, the same typed rejections and the same ``snapshot()``.

Each scenario is the counterpart of one of the reference's
``tests/test_serve.py:52-195`` (queue depth, oversized requests, the
inflight and byte quotas, the per-request byte cap, deadlines, drain, DRR
interleave and quantum weights, the ``admit`` reject fault), run on both
packages and compared event for event; the reference's own assertions are
then made on the port's events.  The ambient request context
(``request_context`` / ``request_scope`` / ``ambient_byte_cap``) is held the
same way.
"""

import threading
import time

import pytest

from cluster_tools_tpu.runtime import admission as jadm
from cluster_tools_tpu.runtime import faults as jfaults
from cluster_tools_tpu_torch.runtime import admission as padm
from cluster_tools_tpu_torch.runtime import faults as pfaults

SIDES = {"port": (padm, pfaults), "jax": (jadm, jfaults)}


@pytest.fixture(autouse=True)
def _fresh_faults():
    for f in (pfaults, jfaults):
        f.configure(None)
    yield
    for f in (pfaults, jfaults):
        f.configure(None)


class Recorder:
    """One side's controller plus an event log: every submit's outcome,
    every dispatch (tenant, id, byte cap) and every rejection callback."""

    def __init__(self, adm, **kw):
        self.adm = adm
        self.events = []
        self.ctl = adm.AdmissionController(
            on_reject=lambda r, t, code, detail: self.events.append(
                ("on_reject", getattr(r, "request_id", None), t, code)),
            **kw,
        )

    def submit(self, tenant, rid, est_bytes=0, deadline_s=None):
        try:
            self.ctl.submit(self.adm.Request(tenant=tenant, request_id=rid, est_bytes=est_bytes,
                                             deadline_s=deadline_s))
            self.events.append(("submit", rid, "ok"))
        except self.adm.AdmissionError as e:
            self.events.append(("submit", rid, e.code, e.tenant))

    def next(self, timeout=1.0):
        r = self.ctl.next_request(timeout=timeout)
        self.events.append(("dispatch", None if r is None else (r.tenant, r.request_id, r.byte_cap)))
        return r

    def release(self, r, completed=True):
        self.ctl.release(r, completed=completed)
        self.events.append(("release", r.request_id, completed))

    def snap(self):
        self.events.append(("snapshot", self.ctl.snapshot()))


def _quotas(adm, spec):
    return {name: adm.TenantQuota(**q) for name, q in spec.items()}


def scen_queue_depth(adm, faults):
    rec = Recorder(adm, quotas=_quotas(adm, {"t": dict(max_queue_depth=2)}))
    for rid in "abc":
        rec.submit("t", rid)
    rec.snap()
    return rec.events


def scen_oversized(adm, faults):
    rec = Recorder(adm, quotas=_quotas(adm, {"t": dict(max_bytes_in_flight=100)}))
    rec.submit("t", "big", est_bytes=101)
    rec.snap()
    return rec.events


def scen_inflight_and_bytes(adm, faults):
    rec = Recorder(adm, quotas=_quotas(adm, {"t": dict(max_inflight=1, max_bytes_in_flight=100)}))
    rec.submit("t", "a", est_bytes=60)
    rec.submit("t", "b", est_bytes=60)
    first = rec.next()
    rec.next(timeout=0.1)  # the inflight quota holds b back
    rec.release(first)
    second = rec.next()
    rec.release(second, completed=False)
    rec.snap()
    return rec.events


def scen_byte_cap(adm, faults):
    rec = Recorder(adm, quotas=_quotas(adm, {"t": dict(max_inflight=2, max_bytes_in_flight=1000)}))
    rec.submit("t", "a", est_bytes=10)
    rec.submit("t", "b", est_bytes=10)
    rec.next()
    rec.next()
    rec.snap()
    return rec.events


def scen_deadline(adm, faults):
    rec = Recorder(adm)
    rec.submit("t", "stale", deadline_s=0.01)
    rec.submit("t", "fresh")
    time.sleep(0.05)
    rec.next()
    rec.snap()
    return rec.events


def scen_drain(adm, faults):
    rec = Recorder(adm)
    rec.submit("t", "queued-before-drain")
    rec.ctl.begin_drain()
    rec.submit("t", "late")
    rec.next(timeout=0.1)
    rec.events.append(("queued", rec.ctl.queued(), rec.ctl.draining()))
    rec.snap()
    return rec.events


def scen_drr_interleave(adm, faults):
    rec = Recorder(adm, default_quota=adm.TenantQuota(max_inflight=100, max_queue_depth=100))
    for i in range(6):
        rec.submit("aggressor", f"agg-{i}")
    for i in range(3):
        rec.submit("good", f"good-{i}")
    for _ in range(6):
        rec.next()
    rec.snap()
    return rec.events


def scen_drr_quantum(adm, faults):
    cost2 = 2 * adm.BYTE_COST_UNIT
    q = dict(max_inflight=100, max_queue_depth=100, max_bytes_in_flight=1 << 40)
    rec = Recorder(adm, quotas=_quotas(adm, {"heavy": dict(q, quantum=2.0), "light": dict(q, quantum=1.0)}))
    for i in range(8):
        rec.submit("heavy", f"h{i}", est_bytes=cost2)
        rec.submit("light", f"l{i}", est_bytes=cost2)
    for _ in range(9):
        rec.next()
    rec.snap()
    return rec.events


def scen_reject_fault(adm, faults):
    faults.configure({"seed": 11, "faults": [{"site": "admit", "kind": "reject", "tenants": ["tenant-b"],
                                              "fail_attempts": 2}]})
    inj = faults.get_injector()
    events = [("maybe_reject", t, inj.maybe_reject(t)) for t in ("tenant-a", "tenant-b", "tenant-b", "tenant-b")]
    with pytest.raises(ValueError):
        faults.configure({"faults": [{"site": "load", "kind": "reject"}]})
    return events


def scen_restore_counts(adm, faults):
    rec = Recorder(adm, quotas=_quotas(adm, {"alice": dict(max_queue_depth=3)}))
    rec.ctl.restore_counts("alice", submitted=2, dispatched=3, completed=1, rejected=1)
    rec.ctl.restore_counts("bob", submitted=1)
    rec.ctl.submit(adm.Request(tenant="alice", request_id="re", payload={"x": 1}), admitted=True)
    rec.next()
    rec.snap()
    rec.events.append(("quota", adm.TenantQuota.from_config({"max_inflight": 3, "unknown": 1})))
    return rec.events


SCENARIOS = {
    "queue_depth": scen_queue_depth,
    "oversized": scen_oversized,
    "inflight_and_bytes": scen_inflight_and_bytes,
    "byte_cap": scen_byte_cap,
    "deadline": scen_deadline,
    "drain": scen_drain,
    "drr_interleave": scen_drr_interleave,
    "drr_quantum": scen_drr_quantum,
    "reject_fault": scen_reject_fault,
    "restore_counts": scen_restore_counts,
}


def _normal(events):
    """Quotas are dataclasses of two modules: compare their fields."""
    return [tuple(vars(x) if hasattr(x, "__dataclass_fields__") else x for x in e) for e in events]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_the_reference(name):
    got = {side: _normal(SCENARIOS[name](*mods)) for side, mods in SIDES.items()}
    assert got["port"] == got["jax"]
    ev = got["port"]
    R = padm
    # the reference's own assertions, on the port's events
    if name == "queue_depth":
        assert ("submit", "c", R.REJECT_QUEUE, "t") in ev
        assert ev[-1][1]["t"]["queued"] == 2 and ev[-1][1]["t"]["rejected"] == 1
    elif name == "oversized":
        assert ("submit", "big", R.REJECT_BYTES, "t") in ev and ev[-1][1]["t"]["queued"] == 0
    elif name == "inflight_and_bytes":
        assert [e[1] for e in ev if e[0] == "dispatch"] == [("t", "a", 100), None, ("t", "b", 100)]
        snap = ev[-1][1]["t"]
        assert snap["dispatched"] == 2 and snap["completed"] == 1
    elif name == "byte_cap":
        assert [e[1][2] for e in ev if e[0] == "dispatch"] == [1000, 500]
    elif name == "deadline":
        assert ("on_reject", "stale", "t", R.REJECT_DEADLINE) in ev
        assert ("dispatch", ("t", "fresh", 2 << 30)) in ev
        assert ev[-1][1]["t"]["rejected"] == 1
    elif name == "drain":
        assert ("submit", "late", R.REJECT_DRAINING, "t") in ev
        assert ("dispatch", None) in ev and ("queued", 1, True) in ev
    elif name == "drr_interleave":
        assert [e[1][0] for e in ev if e[0] == "dispatch"] == ["aggressor", "good"] * 3
    elif name == "drr_quantum":
        got_t = [e[1][0] for e in ev if e[0] == "dispatch"]
        assert got_t.count("heavy") == 6 and got_t.count("light") == 3
    elif name == "reject_fault":
        assert [e[2] for e in ev] == [False, True, True, False]
    elif name == "restore_counts":
        snap = ev[-2][1]
        assert snap["alice"]["submitted"] == 3 and snap["alice"]["dispatched"] == 4
        assert snap["bob"]["submitted"] == 1


def test_reject_codes_and_snapshot_fields_equal_the_reference():
    """``scripts/progress.py`` reads these from ``server_state.json``."""
    codes = {k: v for k, v in vars(padm).items() if k.startswith("REJECT_")}
    assert codes == {k: v for k, v in vars(jadm).items() if k.startswith("REJECT_")}
    assert padm.BYTE_COST_UNIT == jadm.BYTE_COST_UNIT
    snaps = []
    for adm in (padm, jadm):
        ctl = adm.AdmissionController(quotas={"a": adm.TenantQuota(max_inflight=1)})
        ctl.submit(adm.Request(tenant="a", request_id="x", est_bytes=5))
        snaps.append(ctl.snapshot())
    assert snaps[0] == snaps[1]
    assert set(snaps[0]["a"]) == {"queued", "inflight", "bytes_in_flight", "submitted", "dispatched",
                                  "completed", "rejected", "quota"}


@pytest.mark.parametrize("side", sorted(SIDES))
def test_request_scope_reenters_context_on_worker_thread(side):
    adm = SIDES[side][0]
    seen = {}
    assert adm.current_request() is None and adm.ambient_byte_cap() is None
    with adm.request_context("alice", "r9", byte_cap=123):
        ctx = adm.current_request()

        def worker():
            seen["before"] = adm.current_request()
            with adm.request_scope(ctx):
                seen["rid"] = adm.current_request().request_id
                seen["cap"] = adm.ambient_byte_cap()
            seen["after"] = adm.current_request()

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        with adm.request_scope(None):
            seen["none"] = adm.current_request()
        seen["restored"] = adm.current_request().request_id
    assert seen == {"before": None, "rid": "r9", "cap": 123, "after": None, "none": None, "restored": "r9"}
    assert adm.current_request() is None
