"""Across processes: ``torch.distributed`` wiring, the pod mesh, a launcher.

Port of ``cluster_tools_tpu/parallel/multihost.py``.  Every process runs
the same SPMD program; :func:`initialize` joins it to the others through a
TCP rendezvous, and :func:`pod_mesh` builds a mesh over every process's
shards (process-major), whose collectives cross processes through
:class:`~.spmd.ProcessComm`.  The bodies do not change.

The process-group backend is chosen, and logged, at :func:`initialize`:
NCCL only when every process has a card of its own; gloo when processes
share a card (NCCL refuses two ranks on one device) or run on the CPU.
Nothing switches backend on a failure.

:func:`launch_workers` runs an N-process pod on one machine (each worker
with ``devices_per_process`` shards) and kills every worker's process
group on timeout; :func:`cc_pod_demo` is its test body.
:func:`collectives_supported` probes, under a deadline, whether the pod can
run a collective (the reduce tree's worker group asks before it commits to
its collective plane).
"""

from __future__ import annotations

import datetime
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .mesh import Mesh, _pick_grid
from .spmd import DEFAULT_DEADLINE_S, ProcessComm

_ENV_COORD = "CT_MP_COORDINATOR"
_ENV_NPROC = "CT_MP_NUM_PROCESSES"
_ENV_PID = "CT_MP_PROCESS_ID"
_ENV_TARGET = "CT_MP_TARGET"
_ENV_SHARDS = "CT_MP_SHARDS"
_ENV_DEVICE = "CT_MP_DEVICE"

# this process's place in the pod, set by initialize()
_POD: Dict[str, object] = {}


def choose_backend(device: torch.device, num_processes: int) -> Tuple[str, str]:
    """``(backend, reason)`` for ``num_processes`` processes on ``device``."""
    if device.type == "cpu":
        return "gloo", "the processes run on the CPU"
    cards = torch.cuda.device_count()
    if cards >= num_processes:
        return "nccl", f"each of the {num_processes} processes has a card of its own ({cards} cards)"
    return "gloo", f"{num_processes} processes share {cards} card(s); NCCL refuses two ranks on one device"


def initialize(coordinator_address: str, num_processes: int, process_id: int, device=None) -> str:
    """Join this process into the pod; returns the backend
    (:func:`choose_backend`).  ``device``: the CPU or the card (``None``).
    With NCCL, process ``i`` takes card ``i``; with gloo on the card every
    process takes ``cuda:0`` and collectives stage through host memory.
    """
    import torch.distributed as dist

    dev = resolve_device(device)
    chosen, reason = choose_backend(dev, num_processes)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id if chosen == "nccl" else 0)
        torch.cuda.set_device(dev)
    print(f"[multihost] process {process_id}/{num_processes}: torch.distributed backend {chosen} ({reason}); "
          f"device {dev}", file=sys.stderr, flush=True)
    dist.init_process_group(chosen, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=DEFAULT_DEADLINE_S))
    _POD.update(device=dev, backend=chosen)
    return chosen


def pod_mesh(axis_names: Sequence[str] = ("dp", "sp"), grid: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over every shard of every process, process-major (the last,
    fastest axis stays within a process where it can), after
    :func:`initialize`; each process holds ``CT_MP_SHARDS`` (default 1)
    shards."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("pod_mesh needs initialize() first")
    world, rank = dist.get_world_size(), dist.get_rank()
    per = int(os.environ.get(_ENV_SHARDS, 1))
    n = world * per
    if grid is None:
        grid = _pick_grid(n, len(axis_names))
    if int(np.prod(grid)) != n:
        raise ValueError(f"grid {tuple(grid)} does not cover {n} shards")
    dev = _POD["device"]
    comm = ProcessComm(str(_POD["backend"]), rank, world)
    mesh = Mesh(grid, axis_names, [dev] * n, processes=[s // per for s in range(n)], process_index=rank,
                comm=comm)
    comm.attach(mesh)
    return mesh


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def collectives_supported(deadline_s: float = 30.0) -> Tuple[bool, str]:
    """Can this process run a cross-process collective?  ``(supported,
    reason)``.  One process (no process group) is trivially supported: its
    collectives are in-process rendezvous.  In a pod, one ``psum`` of ones
    over a 1-D mesh of every shard (the operation class the collective
    reduce plane runs) is probed on a thread with ``deadline_s`` of
    patience, so a wedged probe degrades instead of hanging.  Every process
    probes the same operation on the same backend, so all of them choose
    the same plane."""
    import threading

    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return True, "single-process runtime"
    out: Dict[str, object] = {}

    def _probe():
        try:
            from . import spmd
            from .mesh import SIBLING_AXIS

            mesh = pod_mesh(axis_names=(SIBLING_AXIS,))
            n = mesh.size
            total = spmd.shard_map(lambda x: spmd.psum(x, SIBLING_AXIS), mesh, spmd.P(SIBLING_AXIS), spmd.P(),
                                   name="collectives_probe")(torch.ones(n, dtype=torch.float32))
            ok = float(total.sum()) == float(n)
            out["result"] = (ok, "ok" if ok else "probe sum mismatch")
        except Exception as e:
            out["result"] = (False, f"{type(e).__name__}: {e}"[:200])

    t = threading.Thread(target=_probe, daemon=True)
    t.start()
    t.join(timeout=max(1.0, float(deadline_s)))
    if t.is_alive():
        return False, f"collective probe exceeded {deadline_s:g}s deadline"
    return out.get("result", (False, "probe thread died"))


def launch_workers(num_processes: int, target: str, devices_per_process: int = 1, timeout: float = 600.0,
                   extra_env: Optional[Dict[str, str]] = None, device=None) -> List[Tuple[int, str, str]]:
    """Run ``target`` (``"module:function"``) in ``num_processes`` local
    processes, each with ``devices_per_process`` shards on ``device`` (the
    card unless the caller names the CPU), joined through a rendezvous on a
    free localhost port.  Returns ``[(returncode, stdout, stderr), ...]``;
    on timeout every worker's process group is killed and a
    ``TimeoutError`` carries their partial output."""
    dev = resolve_device(device)
    coord = f"127.0.0.1:{free_port()}"
    # workers must import this package whatever their working directory
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    try:
        for pid in range(num_processes):
            env = dict(os.environ)
            env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
            env.update({_ENV_COORD: coord, _ENV_NPROC: str(num_processes), _ENV_PID: str(pid),
                        _ENV_TARGET: target, _ENV_SHARDS: str(devices_per_process), _ENV_DEVICE: dev.type})
            if extra_env:
                env.update(extra_env)
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "from cluster_tools_tpu_torch.parallel.multihost import worker_main; worker_main()"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True,
            ))
    except BaseException:
        _terminate_process_groups(procs, 0.0)
        raise
    return collect_workers(procs, timeout)


#: grace between SIGTERM and SIGKILL when tearing down timed-out workers
TERM_GRACE_S = 5.0


def _signal_process_group(p: subprocess.Popen, sig: int) -> None:
    """``sig`` to the worker's whole process group (workers lead their own
    session, so pgid == pid)."""
    try:
        os.killpg(p.pid, sig)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            p.send_signal(sig)
        except OSError:
            pass


def _terminate_process_groups(procs: List[subprocess.Popen], grace_s: float = TERM_GRACE_S) -> None:
    """SIGTERM, ``grace_s`` for all of them together, then SIGKILL to every
    group (also of workers whose leader already exited: a surviving
    grandchild would keep the output pipes open)."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        _signal_process_group(p, signal.SIGTERM)
    deadline = time.monotonic() + max(0.0, grace_s)
    while time.monotonic() < deadline and not all(p.poll() is not None for p in live):
        time.sleep(0.05)
    for p in procs:
        _signal_process_group(p, signal.SIGKILL)


def collect_workers(procs: List[subprocess.Popen], timeout: float) -> List[Tuple[int, str, str]]:
    """Wait for every worker; ``(returncode, stdout, stderr)`` each.  On
    timeout every worker's process group is terminated and a
    ``TimeoutError`` carries the tails of their output."""
    results = []
    deadline = time.monotonic() + timeout
    try:
        for i, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                _terminate_process_groups(procs, TERM_GRACE_S)
                tails = []
                for j, q in enumerate(procs):
                    try:
                        qo, qe = q.communicate(timeout=10.0)
                    except (subprocess.TimeoutExpired, ValueError):
                        qo, qe = "", ""
                    tails.append(f"-- worker {j} (rc={q.returncode}) --\nstdout tail:\n{(qo or '')[-800:]}\n"
                                 f"stderr tail:\n{(qe or '')[-800:]}")
                raise TimeoutError(f"multihost worker {i} exceeded timeout={timeout:g}s; killed all "
                                   f"{len(procs)} worker process group(s).  Partial output:\n" + "\n".join(tails))
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                _signal_process_group(p, signal.SIGKILL)
    return results


def worker_main() -> None:
    """Entry point of a :func:`launch_workers` process: join the pod from
    the environment, run the target, leave the pod."""
    import importlib

    import torch.distributed as dist

    from ..runtime import trace as trace_mod

    pid = int(os.environ[_ENV_PID])
    target = os.environ[_ENV_TARGET]
    initialize(os.environ[_ENV_COORD], int(os.environ[_ENV_NPROC]), pid, device=os.environ.get(_ENV_DEVICE, "cuda"))
    mod_name, fn_name = target.split(":")
    try:
        # the worker's lifetime span, on when the launcher exported
        # CTT_TRACE=<dir>; flushed on the failure path too
        with trace_mod.span("worker.main", worker=pid, target=target):
            getattr(importlib.import_module(mod_name), fn_name)()
    finally:
        try:
            trace_mod.flush()
        except Exception:
            pass
        dist.destroy_process_group()


def cc_pod_demo() -> None:
    """SPMD test body: the distributed CCL and the exact EDT across process
    cuts.  Every process holds z-slabs of one volume (generated identically
    in each); the labels are held against scipy's partition, a component
    must span the cut between the first two processes, and the EDT must
    equal scipy's.  Prints ``CC_POD_OK``."""
    import torch.distributed as dist
    from scipy import ndimage

    from .distributed_ccl import distributed_connected_components
    from .distributed_edt import distributed_distance_transform, distributed_distance_transform_squared

    mesh = pod_mesh(axis_names=("sp",))
    sp = mesh.size
    rng = np.random.default_rng(7)
    mask_np = rng.random((sp * 8, 24, 24)) > 0.35  # dense: components span cuts
    ours = distributed_connected_components(mask_np, mesh, sp_axis="sp").cpu().numpy()
    ref, nref = ndimage.label(mask_np)
    if (ours > 0).sum() != (ref > 0).sum():
        raise AssertionError("foreground differs from scipy's")
    fwd: dict = {}
    for o, r in zip(ours.ravel().tolist(), ref.ravel().tolist()):
        if o > 0 and fwd.setdefault(o, r) != r:
            raise AssertionError("a label spans two of scipy's components")
    if len(fwd) != nref:
        raise AssertionError(f"{len(fwd)} components, scipy {nref}")
    # the merge crossed a process boundary: a component spans the first cut
    per = sp // dist.get_world_size()
    slab = mask_np.shape[0] // sp * per
    cut_lo, cut_hi = ours[slab - 1], ours[slab]
    spans = set(cut_lo[cut_lo > 0].ravel()) & set(cut_hi[cut_hi > 0].ravel())
    if not spans:
        raise AssertionError("no component spans the process-boundary cut")

    # the all-to-all reshard crosses processes too (x divides by sp)
    emask_np = rng.random((sp * 4, 12, 8 * sp)) > 0.05
    emask_np[0, 0, 0] = False
    want = ndimage.distance_transform_edt(emask_np)
    dist_sq = distributed_distance_transform_squared(emask_np, mesh, sp_axis="sp").cpu().numpy()
    if not np.array_equal(dist_sq.astype(np.float64), np.round(want ** 2)):
        raise AssertionError("pod squared EDT differs from scipy's")
    d = distributed_distance_transform(emask_np, mesh, sp_axis="sp").cpu().numpy()
    if not np.allclose(d, want, rtol=1e-5, atol=1e-3):
        raise AssertionError("pod EDT deviates from scipy's")
    print(f"CC_POD_OK pid={dist.get_rank()} processes={dist.get_world_size()} devices={sp} "
          f"components={nref} spanning={len(spans)} edt_ok=1", flush=True)


#: environment variable naming the JSON job of :func:`ws_ccl_pod_demo`
ENV_DEMO = "CT_MP_DEMO"


def ws_ccl_pod_demo() -> None:
    """SPMD body: :func:`cc_pod_demo`, then the split ws+cc step z-sharded
    over the pod, then :func:`collectives_supported`.  ``CT_MP_DEMO``
    holds a JSON object: ``volume`` (an ``.npy`` batch), ``cfg`` (keywords
    of ``make_ws_ccl_split``) and ``out`` (an ``.npz`` that process 0
    writes with ``ws``, ``cc``, ``n_fg`` and ``overflow``).  Prints
    ``WS_CCL_POD_OK`` with the step's seconds (ended by a sync of this
    process's card), the bytes its collectives staged through host memory
    and the probe's answer, and a ``POD_COUNTERS`` line with the step's
    :data:`~.spmd.COUNTERS`."""
    import json

    import torch.distributed as dist

    from . import spmd
    from .split_pipeline import make_ws_ccl_split

    cc_pod_demo()
    job = json.loads(os.environ[ENV_DEMO])
    vol = np.load(job["volume"])
    mesh = pod_mesh(axis_names=("dp", "sp"), grid=(1, dist.get_world_size() * int(os.environ.get(_ENV_SHARDS, 1))))
    dev = _POD["device"]
    spmd.COUNTERS.reset()
    t0 = time.perf_counter()
    ws, cc, n_fg, overflow = make_ws_ccl_split(mesh, **job["cfg"])(vol)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    counters = spmd.COUNTERS.snapshot()
    staged = sum(c["bytes"] for kinds in counters.values() for kind, c in kinds.items() if kind == "host_staged")
    probe, why = collectives_supported(deadline_s=60.0)
    if dist.get_rank() == 0:
        np.savez(job["out"], ws=ws.cpu().numpy(), cc=cc.cpu().numpy(), n_fg=float(n_fg), overflow=overflow)
    print(f"WS_CCL_POD_OK pid={dist.get_rank()} processes={dist.get_world_size()} shards={mesh.size} "
          f"device={dev} backend={_POD['backend']} n_fg={float(n_fg):.0f} overflow={overflow} "
          f"step_s={step_s:.3f} host_staged_bytes={staged} collectives_supported={probe} ({why})", flush=True)
    print("POD_COUNTERS " + json.dumps(counters), flush=True)
