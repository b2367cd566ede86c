"""What a traced run records from the benchmark's own side of the calls:
CUDA events at the step's stage boundaries and around each kernel entry,
and a ``torch.profiler`` trace of a short steady part of the window, with
the reduction of that trace to busy time, idle gaps and device operations.

Nothing here changes what the program computes: the stage callback records
an event and does not synchronise, and the entry wrappers call the entry
they replace with the same arguments.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

PACKAGE = "cluster_tools_tpu_torch"
ENTRIES = ("tile_ccl", "tile_ws_propagate", "edt_cascade", "apply_remap")
WINDOW_MARK = "port_bench.window"
# idle gaps shorter than this are summed, not named
SHORT_GAP_NS = 10_000
HOST_LOOKBACK = 4000
PROFILER_OWN = ("Activity Buffer Request",)


class StageEvents:
    """``run_staged``'s callback: one CUDA event at the step's start and one
    after each stage, on the current stream of ``device``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.steps: List[List[Tuple[str, torch.cuda.Event]]] = []

    def _event(self) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def start(self) -> None:
        self.steps.append([("start", self._event())])

    def __call__(self, stage: str, *_outputs) -> None:
        self.steps[-1].append((stage, self._event()))

    def stage_ms(self) -> Dict[str, List[float]]:
        """Device ms of each stage, one entry a step (after a sync)."""
        torch.cuda.synchronize(self.device)
        out: Dict[str, List[float]] = defaultdict(list)
        for marks in self.steps:
            for (_, a), (name, b) in zip(marks, marks[1:]):
                out[name].append(a.elapsed_time(b))
            out["step"].append(marks[0][1].elapsed_time(marks[-1][1]))
        return dict(out)


class EntryEvents:
    """Wraps the kernel entries of ``ops/kernels.py`` wherever the port's
    loaded modules bound them: each call on a CUDA tensor is bracketed by
    two events and its work counts are kept (``calls``)."""

    def __init__(self):
        self.calls: List[dict] = []
        self.active = False
        self._patched: List[Tuple[object, str, object]] = []

    def _wrap(self, name: str, fn):
        def entry(*args, **kwargs):
            x = args[0]
            if not self.active or not isinstance(x, torch.Tensor) or x.device.type != "cuda":
                return fn(*args, **kwargs)
            stream = torch.cuda.current_stream(x.device)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record(stream)
            out = fn(*args, **kwargs)
            t1.record(stream)
            shapes = _shapes(name, args, kwargs)
            self.calls.append(dict(shapes, name=shapes.pop("name", name), start=t0, end=t1, device=x.device))
            return out

        entry.__wrapped__ = fn
        return entry

    def install(self) -> None:
        kernels = sys.modules.get(f"{PACKAGE}.ops.kernels")
        if kernels is None:
            return
        originals = {getattr(kernels, n): n for n in ENTRIES}
        wrappers = {fn: self._wrap(n, fn) for fn, n in originals.items()}
        for mod_name, mod in list(sys.modules.items()):
            if mod is None or not (mod_name == PACKAGE or mod_name.startswith(PACKAGE + ".")):
                continue
            for attr, value in list(vars(mod).items()):
                if callable(value) and value in wrappers:
                    setattr(mod, attr, wrappers[value])
                    self._patched.append((mod, attr, value))

    def uninstall(self) -> None:
        for mod, attr, value in reversed(self._patched):
            setattr(mod, attr, value)
        self._patched.clear()

    def totals(self) -> Optional[Tuple[float, float]]:
        """``(least seconds, measured seconds)`` summed over the calls,
        or None without a call."""
        from work_counts import least_seconds

        if not self.calls:
            return None
        for dev in {c["device"] for c in self.calls}:
            torch.cuda.synchronize(dev)
        least = measured = 0.0
        for c in self.calls:
            live = int(c.pop("live", 0)) if "live" in c else 0
            least += least_seconds(c["name"], c, live)
            measured += c["start"].elapsed_time(c["end"]) / 1e3
        return least, measured


def _shapes(name: str, args, kwargs) -> dict:
    """The arguments' sizes that the work counts read; ``live`` is a 0-d
    device tensor (read after the window, so no call waits for it)."""
    x = args[0]
    out = dict(n=x.numel(), itemsize=x.element_size())
    if name == "tile_ccl" and (kwargs.get("doubling") or (len(args) > 3 and args[3])):
        out["name"] = "tile_ccl_doubling"
    if name == "edt_cascade":
        axis = args[1] if len(args) > 1 else kwargs["axis"]
        radius = args[2] if len(args) > 2 else kwargs["radius"]
        out["radius"] = max(0, min(int(radius), x.shape[axis] - 1))
    if name == "apply_remap":
        old = args[1] if len(args) > 1 else kwargs["old_tbl"]
        new = args[2] if len(args) > 2 else kwargs["new_tbl"]
        out["slots"] = old.numel()
        out["rows"] = old.shape[0]
        out["live"] = (old != new).any(1).sum()
    return out


def profile_units(run_units) -> dict:
    """Run ``run_units()`` under ``torch.profiler`` and reduce the trace:
    ``busy_s`` (the union of device activity, averaged over the cards
    used), ``window_s``, the device operations by time and the idle gaps
    by what the host was doing.  Returns {} where the trace holds no
    device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_MARK):
            run_units()
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
    return reduce_trace(_events(prof))


def _events(prof) -> List[Tuple[str, bool, int, int, int, int]]:
    """``(name, on_device, device, thread, start_ns, end_ns)`` of every
    event of the profiler's trace."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        name = e.name()
        if name in PROFILER_OWN or (dev and name == WINDOW_MARK):
            # the profiler's own buffers, and the window's mark mirrored on
            # the device's timeline, are no work of the program
            continue
        start = int(e.start_ns())
        out.append((short_name(name), dev, int(e.device_index()), int(e.start_thread_id()), start,
                    start + int(e.duration_ns())))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    if name.startswith("void "):
        name = name[5:]
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return (name[:min(cut)] if cut else name).strip()


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def reduce_trace(events) -> dict:
    window = [(s, e) for name, dev, _, _, s, e in events if not dev and name == WINDOW_MARK]
    device = [(name, d, s, e) for name, dev, d, _, s, e in events if dev and e > s]
    if not window or not device:
        return {}
    w0, w1 = window[0]
    by_dev: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    op_s: Dict[str, float] = defaultdict(float)
    for name, d, s, e in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            by_dev[d].append((s, e))
            op_s[name] += (e - s) / 1e9
    if not by_dev:
        return {}
    busy_per_dev = {d: sum(b - a for a, b in _union(iv)) / 1e9 for d, iv in by_dev.items()}
    host = sorted(((s, e, name) for name, dev, _, _, s, e in events
                   if not dev and name != WINDOW_MARK and e > s), key=lambda t: t[0])
    starts = [s for s, _, _ in host]
    gap_s: Dict[str, float] = defaultdict(float)
    for d, iv in by_dev.items():
        merged = _union(iv)
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b - a >= SHORT_GAP_NS:
                gap_s[_host_doing(host, starts, (a + b) // 2)] += (b - a) / 1e9 / len(by_dev)
            elif b > a:
                gap_s[f"gaps under {SHORT_GAP_NS // 1000} us"] += (b - a) / 1e9 / len(by_dev)
    top = lambda m: [[k, v] for k, v in sorted(m.items(), key=lambda kv: -kv[1])[:10]]
    return dict(busy_s=sum(busy_per_dev.values()) / len(busy_per_dev), window_s=(w1 - w0) / 1e9,
                busy_by_device=busy_per_dev, device_ops=top(op_s), idle_gaps=top(gap_s))


def _host_doing(host, starts, t: int) -> str:
    """The innermost host event open at ``t`` (the shortest that covers it
    among the last ``HOST_LOOKBACK`` to start before it), or ``no torch op
    on the host`` (Python, numpy and waits record none)."""
    best = None
    hi = bisect.bisect_right(starts, t)
    for s, e, name in reversed(host[max(0, hi - HOST_LOOKBACK):hi]):
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "no torch op on the host"
