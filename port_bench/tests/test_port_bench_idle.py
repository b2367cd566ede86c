"""The idle-gap metrics of the workflow cell: each read from a hand-made
``ctx["profile"]`` on the CPU, and on the card one traced workflow unit of
the ``tiny`` configuration profiled with the program's spans mirrored into
the profile and without (``python -m pytest port_bench/tests -m gpu``)."""

import pytest

import harness
from conftest import ROOT

CELL = "ws_workflow.125x1250x1250"
NEW = ("idle_named_share.workflow", "idle_by.executor_load", "idle_by.executor_store", "idle_by.executor_wait")


def _readers():
    spec = harness.Spec(ROOT)
    return {name: spec.reader(name) for name in NEW}


def test_each_new_metric_reads_a_hand_made_profile():
    read = _readers()
    profile = {"busy_s": 6.0, "window_s": 10.0,
               "idle_gaps": [["executor.store", 1.5], ["executor.load", 0.8], ["no torch op on the host", 0.4],
                             ["chunk_cache.assemble", 0.2], ["executor.batch_wait", 0.5], ["executor.lock_wait", 0.25],
                             ["gaps under 10 us", 0.2], ["aten::copy_", 0.15]]}
    got = {name: read[name]({"profile": profile}) for name in NEW}
    assert got["idle_named_share.workflow"] == pytest.approx(100.0 * (1 - 0.6 / 4.0))
    # a chunk-cache span is never mirrored: its name, if some other profile
    # gave it, is not the load phase's
    assert got["idle_by.executor_load"] == pytest.approx(8.0)
    assert got["idle_by.executor_store"] == pytest.approx(15.0)
    assert got["idle_by.executor_wait"] == pytest.approx(7.5)


def test_a_missing_name_reads_zero_and_an_empty_profile_nothing():
    """A phase no gap names reads 0; where most of the idle time is named by
    no host event (the phases did not reach the profile) the phases' shares
    read nothing, not their best value; an empty profile reads nothing."""
    read = _readers()
    named = {"busy_s": 3.0, "window_s": 4.0, "idle_gaps": [["aten::copy_", 0.6], ["no torch op on the host", 0.4]]}
    assert read["idle_named_share.workflow"]({"profile": named}) == pytest.approx(60.0)
    for name in NEW[1:]:
        assert read[name]({"profile": named}) == 0.0
    unnamed = {"busy_s": 3.0, "window_s": 4.0, "idle_gaps": [["no torch op on the host", 0.99], ["cudaLaunchKernel", 0.01]]}
    assert read["idle_named_share.workflow"]({"profile": unnamed}) == pytest.approx(1.0)
    for name in NEW[1:]:
        assert read[name]({"profile": unnamed}) is None
    for ctx in ({"profile": {}}, {"profile": {"empty": True}}, {}):
        assert all(read[name](ctx) is None for name in NEW)


@pytest.mark.gpu
def test_the_mirror_names_the_idle_card_and_adds_no_device_time(card, tiny_root, monkeypatch):
    import trace_tools
    from cluster_tools_tpu_torch.runtime import trace

    spec = harness.Spec(tiny_root)
    cfg = spec.config(spec.cell(CELL)["config"])
    drv = spec.driver(cfg["driver"])(cfg, spec.traffic(spec.cell(CELL)["traffic"]), 2**31 + 77, "cuda", True)
    drv.setup()
    drv.begin_window()
    assert trace.thread_state_missing() is None
    raw = []
    events = trace_tools._events

    def keep(prof):
        raw.append(events(prof))
        return raw[-1]

    monkeypatch.setattr(trace_tools, "_events", keep)
    busy = {"on": [], "off": []}
    profiles = {}
    try:
        # five of each, in pairs whose order alternates: a tiny unit keeps
        # the card busy ~57 ms, so a median of three spreads by ~2%
        for k, mode in enumerate(("on", "off", "off", "on") * 2 + ("on", "off")):
            with monkeypatch.context() as m:
                if mode == "off":
                    m.setattr(trace, "_profiling", lambda: False)
                profiles[mode] = trace_tools.profile_units(lambda: drv.unit(k))
            busy[mode].append(profiles[mode]["busy_s"])
        # every name the program's tracer recorded, and what it mirrors them under
        span_names = {e["name"] for e in trace._get().snapshot_events()}
        span_names |= {trace.mirror_name(n) for n in span_names}
    finally:
        drv.end_window()
        drv.release()
    on_device = {name for evs in raw for name, dev, *_ in evs if dev}
    assert not on_device & span_names, on_device & span_names
    on, off = sorted(busy["on"])[2], sorted(busy["off"])[2]
    assert abs(on - off) <= 0.02 * off, busy
    named = [name for name, _ in profiles["on"]["idle_gaps"]]
    assert any(name.startswith("executor.") for name in named), named
