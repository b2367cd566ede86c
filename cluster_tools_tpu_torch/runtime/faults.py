"""Deterministic fault injection for chaos testing the execution layer.

Port (a copy) of ``cluster_tools_tpu/runtime/faults.py``: the same sites,
kinds, spec keys, ``CTT_FAULTS`` and ``_unit`` hash, so one JSON spec fires
at the same (site, block, attempt) in both packages.  The one change is
:meth:`FaultInjector.corrupt`, which maps over the port's output trees
(tuples, lists, dicts, numpy arrays and torch tensors) instead of a JAX
pytree; the executor applies it to a block's outputs once they are back on
the host as numpy, so ``_poison_leaf`` stays numpy.

Long-running multi-chip jobs make preemption, transient IO failure, and
corrupt kernel outputs the *common* case; this module is how we prove the
runtime survives them.  A :class:`FaultInjector` is configured from a JSON
document (programmatically via :func:`configure`, or across process
boundaries via the ``CTT_FAULTS`` environment variable — either inline JSON
or a path to a JSON file) and exposes three hook points that the executor,
task runtime, and container IO layer call at their failure-relevant sites:

- :meth:`FaultInjector.maybe_fail` — raise :class:`InjectedFault` at a load
  / store / io_read / io_write site (transient or persistent, depending on
  ``fail_attempts``),
- :meth:`FaultInjector.corrupt` — poison kernel outputs (NaN for float
  leaves; the NaN-cast garbage values for integer leaves), modelling a
  NaN/inf-producing kernel,
- :meth:`FaultInjector.kill_point` — ``os._exit`` at the N-th crossing of a
  named progress point (``block_done`` / ``task_done``), modelling
  preemption.  A latch file in ``state_dir`` makes the kill one-shot, so a
  resumed run with the *same* ``CTT_FAULTS`` does not die again,
- :meth:`FaultInjector.maybe_hang` — sleep ``seconds`` at a load / store /
  io_read / io_write site (``kind='hang'``), modelling a stuck kernel or a
  wedged filesystem call.  The executor's per-block deadline watchdog is
  what must notice,
- :meth:`FaultInjector.chunk_corrupt` — report that a stored region should
  be silently damaged (``kind='corrupt'``).  At site ``io_write`` the
  container layer bit-flips the chunk *after* recording the region's
  checksum sidecar; at site ``io_read`` it models at-rest bit rot noticed
  at read time — the stored bytes are flipped just before the read
  returns, sidecar untouched, so the verifying reader (``io/verified.py``)
  must detect it and the lineage repair path must heal it.  ``"mode":
  "sidecar"`` deletes the region's digest sidecar instead of flipping
  bytes, exercising the missing-sidecar policy (warn+adopt vs strict),
- :meth:`FaultInjector.lose_job` — swallow a scheduler submission
  (``kind='job_loss'``, site ``submit``): the submitter gets a job id, the
  scheduler keeps reporting it as running, but nothing ever executes —
  only heartbeat supervision (``runtime/cluster.py``) can find it,
- :meth:`FaultInjector.force_spill` — report that an in-memory handoff
  target (``kind='spill'``, site ``publish``; docs/PERFORMANCE.md
  "Task-graph fusion") must be written through to its storage spill path
  instead of living only in host RAM.  The handoff layer
  (``runtime/handoff.py``) queries this at every dataset acquire / array
  publish, so chaos can force the consumer-side fallback-to-storage path
  (and crash-resume from the spilled, checksummed copy) on demand,
- :meth:`FaultInjector.maybe_reject` — force a typed admission rejection
  (``kind='reject'``, site ``admit``; docs/SERVING.md) for a tenant's
  request at the service-mode admission gate (``runtime/server.py``), so
  chaos can prove rejected requests are attributed in ``failures.json``
  and leave no partial markers, manifests, or handoff entries behind.
  Targeted by tenant name (``"tenants": [...]``) instead of block,
- :meth:`FaultInjector.net_fault` — degrade an outbound serve-plane HTTP
  exchange (sites ``net_member`` / ``net_probe`` / ``net_client``; the
  shim in ``runtime/netio.py`` is the single call-through).  Three kinds
  model the gray-failure spectrum (docs/SERVING.md "Gray failures"):
  ``net_delay`` sleeps ``seconds`` before the exchange (congestion, a GC
  pause on the far side), ``net_drop`` raises ``ConnectionResetError``
  mid-exchange (refused/reset connections), and ``net_wedge`` holds the
  accepted connection open without ever answering — the caller's
  *explicit deadline* is the only thing that can save it, which is
  exactly what the gateway's circuit breaker and the CT013 timeout
  audit exist to prove.  Targetable per member/tenant via the
  ``"members"`` spec key,
- :meth:`FaultInjector.torn_append` — tear a submission-journal append
  (``kind='torn'``, site ``journal``; docs/SERVING.md "Durability"): a
  strict prefix of the frame reaches the disk and the process hard-exits
  mid-write (a torn tail only ever exists because its writer died), so
  chaos can prove the restarted reader truncates-and-warns instead of
  refusing to boot.  One-shot via the ``state_dir`` latch like kills;
  ``keep_fraction`` (default 0.5) sets how much of the frame survives.
  The journal's durability boundaries are also kill sites:
  ``journal_append`` (record durable, in-memory state not yet published)
  and ``journal_replay`` (mid-recovery) take ``kind='kill'`` faults.

Resource-exhaustion and preemption classes (docs/ROBUSTNESS.md "Graceful
degradation") ride the same hooks:

- ``kind='oom'`` (sites ``load`` / ``store`` / ``io_read`` / ``io_write`` /
  ``compute``) raises :class:`InjectedOOM` — a real ``MemoryError`` whose
  message carries ``RESOURCE_EXHAUSTED``, so it exercises the executor's
  *typed* resource classification, not a special-cased injection path.  An
  optional ``min_voxels`` gate makes the fault fire only for work units at
  least that large — the physical OOM model: full-size blocks fail, the
  degrade path's smaller sub-blocks fit,
- ``kind='enospc'`` (sites ``store`` / ``io_write``) raises
  :class:`InjectedENOSPC` — an ``OSError`` with ``errno=ENOSPC``, the
  shared-filesystem full condition,
- ``kind='preempt'`` (sites ``block_done`` / ``task_done``, ``after`` like
  kills) delivers a real ``SIGTERM`` to this process at the N-th crossing
  (one-shot via the same ``state_dir`` latch): the drain handler
  (``runtime/supervision.py``) must flip the latch and the runtime must
  drain + exit ``REQUEUE_EXIT_CODE`` instead of dying.

Config schema::

    {
      "seed": 7,                      # drives rate-based faults
      "state_dir": "/scratch/chaos",  # kill latches (required for kills)
      "faults": [
        # transient load failure: block 3 fails its first attempt
        {"site": "load", "kind": "error", "blocks": [3]},
        # persistent store failure: block 5 fails its first 4 attempts
        {"site": "store", "kind": "error", "blocks": [5], "fail_attempts": 4},
        # NaN-producing kernel on block 2 (first attempt only)
        {"site": "kernel", "kind": "nan", "blocks": [2]},
        # random 10% of io reads fail (seeded, deterministic per attempt)
        {"site": "io_read", "kind": "error", "rate": 0.1,
         "fail_attempts": 1000000},
        # hung block: the first load of block 4 sleeps 2 s (past any
        # sub-second block_deadline_s), only in watershed tasks
        {"site": "load", "kind": "hang", "blocks": [4], "seconds": 2.0,
         "tasks": ["watershed"]},
        # silent corruption: block 2's first chunk write is bit-flipped on
        # disk after the checksum sidecar is recorded
        {"site": "io_write", "kind": "corrupt", "blocks": [2]},
        # at-rest rot, noticed at read: block 2's stored bytes are flipped
        # right before its first read returns (sidecar intact) — the
        # verifying reader must raise corrupt:<site>, lineage repair heals
        {"site": "io_read", "kind": "corrupt", "blocks": [2]},
        # sidecar loss: block 2's digest sidecar is deleted at its first
        # read — the per-store missing-sidecar policy decides (adopt/strict)
        {"site": "io_read", "kind": "corrupt", "blocks": [2],
         "mode": "sidecar"},
        # lost scheduler job: the first submission is swallowed
        {"site": "submit", "kind": "job_loss", "fail_attempts": 1},
        # preemption: exit hard at the 3rd completed block
        {"site": "block_done", "kind": "kill", "after": 3},
        # host/device OOM: loads of >= 4096-voxel work units fail (smaller
        # split sub-blocks pass) for the first 1e6 attempts
        {"site": "load", "kind": "oom", "min_voxels": 4096,
         "fail_attempts": 1000000},
        # full filesystem: block 2's first two store attempts hit ENOSPC
        {"site": "store", "kind": "enospc", "blocks": [2],
         "fail_attempts": 2},
        # graceful preemption: a real SIGTERM at the 5th completed block
        {"site": "block_done", "kind": "preempt", "after": 5},
        # forced handoff spill: every in-memory handoff target of watershed
        # tasks is written through to its storage spill path (set
        # fail_attempts high — the hook counts one attempt per publish)
        {"site": "publish", "kind": "spill", "fail_attempts": 1000000,
         "tasks": ["watershed"]},
        # service mode: tenant-b's first 2 submissions to the resident
        # server are rejected with a typed backpressure error
        {"site": "admit", "kind": "reject", "tenants": ["tenant-b"],
         "fail_attempts": 2},
        # durable journal: the 3rd journal append is torn — half the frame
        # lands, the process dies; replay must truncate-and-warn
        {"site": "journal", "kind": "torn", "after": 3,
         "keep_fraction": 0.5},
        # gray failure: member m1 wedges — the gateway's first 4 calls to
        # it are accepted but never answered (the request deadline fires,
        # the breaker opens within one timeout)
        {"site": "net_member", "kind": "net_wedge", "members": ["m1"],
         "fail_attempts": 4, "seconds": 30.0},
        # flaky network: 20% of client submissions see a connection reset
        {"site": "net_client", "kind": "net_drop", "rate": 0.2,
         "fail_attempts": 1000000},
        # slow path: every health probe of m0 is delayed 0.5 s
        {"site": "net_probe", "kind": "net_delay", "members": ["m0"],
         "seconds": 0.5, "fail_attempts": 1000000}
      ]
    }

Attempt counting is per ``(site, block, fault)`` and in-memory: the N-th
call of a hook for a given block is the N-th attempt, so ``fail_attempts``
models transient (1–2) versus persistent (> the executor's retry budget)
failures, and retries/quarantine re-attempts eventually pass.  Rate-based
faults hash ``(seed, site, block, attempt)`` so they are reproducible
without shared state.

Targeting: ``blocks`` gates on the executor's block id — call sites that
don't know it (the container IO layer) inherit it from the executor through
:func:`block_context` (thread-local, set around every per-block load/store).
``tasks`` gates on the running task's uid prefix (:func:`set_current_task`,
process-global — one task runs at a time per process), so one fault spec can
target ``watershed`` blocks without also firing in ``graph``.
"""

from __future__ import annotations

import contextlib
import errno as errno_mod
import json
import os
import signal
import threading
import time
import zlib
from typing import Any, Dict, Optional

import numpy as np

#: Exit code used by kill faults — chaos tests assert on it to distinguish
#: an injected kill from a genuine crash.
KILL_EXIT_CODE = 113

ENV_VAR = "CTT_FAULTS"

#: "solve" is the sharded-global-solve site (parallel/reduce_tree.py): an
#: error there models a lost reduce hop or a dying solver worker — the
#: entry point must degrade to the single-host solve (resolution
#: "degraded:unsharded_solve").  Inside a reduce-tree worker the same hook
#: (block-targeted by worker id) escalates to a real SIGKILL, so chaos can
#: kill one worker of the group and prove the driver's fallback.
#: "hop" is the collective reduce plane's exchange site
#: (parallel/reduce_tree.py, docs/PERFORMANCE.md "Collective reduce
#: plane"): an error there models a failed device collective (init
#: refused, a peer dropping out of the gather), a hang a wedged
#: interconnect hop — either must degrade the level to the filesystem
#: packet plane (resolution "degraded:packet_plane") with bit-identical
#: labels.
_ERROR_SITES = ("load", "store", "io_read", "io_write", "submit", "task",
                "solve", "hop")
#: "journal_append" / "journal_replay" are the durable-journal boundaries
#: (runtime/journal.py, docs/SERVING.md "Durability"): a kill at the
#: former models dying after the fsync'd ack record but before the
#: in-memory state is published; at the latter, dying mid-recovery —
#: either way the restarted replay must reconstruct every acknowledged
#: request.
_KILL_SITES = ("block_done", "task_done", "journal_append",
               "journal_replay")
#: "journal" is the torn-append site (kind='torn'): the submission
#: journal's write is cut mid-frame and the process dies, leaving the
#: torn tail the reader must truncate-and-warn past.
_TORN_SITES = ("journal",)
#: "dispatch" is the batch-grain site of the sharded sweep (one compiled
#: program per Morton batch, docs/PERFORMANCE.md "Sharded sweeps"): an oom
#: there models the whole sharded program exceeding device memory, a hang a
#: wedged device stalling it — either must fall the batch back to per-block
#: execution (resolution "degraded:unsharded"), which this site exercises.
#: Ragged paged batches (docs/PERFORMANCE.md "Ragged sweeps") — mixed-shape
#: main batches AND the degrade ladder's sub-block batches — dispatch
#: through the same site, so the same faults prove their fallback.
#: "hop" hangs model a wedged collective on the reduce plane — the hop
#: deadline must fire and degrade the solve to the packet plane.
_HANG_SITES = ("load", "store", "io_read", "io_write", "dispatch", "hop")
#: silent-corruption sites (kind='corrupt'): at ``io_write`` the flip lands
#: after the write's sidecar is recorded; at ``io_read`` the stored bytes
#: rot just before the read returns (at-rest damage surfacing at the read
#: site, the verifying reader's to catch).  ``mode='sidecar'`` deletes the
#: region's digest sidecar instead — the missing-sidecar-policy drill.
_CORRUPT_SITES = ("io_write", "io_read")
_CORRUPT_MODES = ("flip", "sidecar")
#: "h2d" is the device-pool staging site (parallel/device_pool.py): an oom
#: there models the resident HBM page pool failing to hold a batch's pages
#: — the stage must ride the degrade ladder (evict + retry, then per-batch
#: host staging, resolution "degraded:host_staged").  "publish" doubles as
#: an oom site for the DEVICE handoff rung (runtime/handoff.py): an oom at
#: a device-array publish must fall the payload back to the host memory
#: rung with the same attribution, bit-identically.
_OOM_SITES = ("load", "store", "io_read", "io_write", "compute", "dispatch",
              "h2d", "publish")
_ENOSPC_SITES = ("store", "io_write")
#: "publish" is the handoff-layer site (runtime/handoff.py): the moment a
#: task declares an in-memory target for a dataset or artifact.  A spill
#: fault there forces the write-through to the storage spill path, so chaos
#: can prove consumers fall back to the stored (checksummed) copy and that
#: crash-resume consumes it bit-identically.
_SPILL_SITES = ("publish",)
#: "admit" is the service-mode admission site (runtime/server.py): the
#: moment a tenant's request asks to be queued.  A ``reject`` fault there
#: forces a typed admission rejection (``rejected:fault``), so chaos can
#: prove a rejected request is attributed in failures.json and leaves no
#: partial markers, manifests, or handoff entries behind.  Targeting is by
#: *tenant* (the ``tenants`` spec key), not block — admission has no
#: blocks.
_REJECT_SITES = ("admit",)
#: serve-plane network sites (runtime/netio.py, docs/SERVING.md "Gray
#: failures"): ``net_member`` is the gateway's data-path call to a member
#: (submit/lookup/adopt), ``net_probe`` the health loop's /healthz probe,
#: ``net_client`` the ServeClient's call to a server or gateway.  The
#: net_* kinds fire here: ``net_delay`` (latency), ``net_drop``
#: (reset/refused), ``net_wedge`` (accepted, never answered — only an
#: explicit deadline notices).
_NET_SITES = ("net_member", "net_probe", "net_client")
#: maybe_fail kinds: all raise at the same hook, with their own exception
#: types so the executor's *typed* classification is what gets exercised
_FAIL_KINDS = ("error", "oom", "enospc")


# -- fault-targeting context --------------------------------------------------
# Block ids are thread-local (the executor's IO pool works many blocks at
# once); the current task is process-global (build() runs one task at a
# time per process, and the remote cluster runner is single-task anyway).

_tls = threading.local()
_current_task: Optional[str] = None


@contextlib.contextmanager
def block_context(block_id: Optional[int]):
    """Tag this thread's container-level IO with a block id, so io_read /
    io_write faults (and checksum corruption) can target blocks even though
    the storage layer never sees one."""
    prev = getattr(_tls, "block_id", None)
    _tls.block_id = block_id
    try:
        yield
    finally:
        _tls.block_id = prev


def current_block_id() -> Optional[int]:
    return getattr(_tls, "block_id", None)


def set_current_task(name: Optional[str]) -> None:
    global _current_task
    _current_task = name


def current_task() -> Optional[str]:
    return _current_task


class InjectedFault(RuntimeError):
    """The exception raised by ``kind='error'`` faults."""

    def __init__(self, site: str, block_id: Optional[int], attempt: int):
        self.site = site
        self.block_id = block_id
        self.attempt = attempt
        super().__init__(
            f"injected {site} fault"
            + (f" on block {block_id}" if block_id is not None else "")
            + f" (attempt {attempt})"
        )


class InjectedOOM(MemoryError):
    """``kind='oom'``: a real MemoryError (message mentions
    RESOURCE_EXHAUSTED, like an XLA allocator failure) so the executor's
    typed resource classification — not injection special-casing — routes
    it to the degrade policy."""

    def __init__(self, site: str, block_id: Optional[int], attempt: int):
        self.site = site
        self.block_id = block_id
        self.attempt = attempt
        super().__init__(
            f"injected RESOURCE_EXHAUSTED (oom) at {site}"
            + (f" on block {block_id}" if block_id is not None else "")
            + f" (attempt {attempt})"
        )


class InjectedENOSPC(OSError):
    """``kind='enospc'``: an OSError carrying ``errno=ENOSPC`` — the
    shared-filesystem full condition, classified by errno like the real
    thing."""

    def __init__(self, site: str, block_id: Optional[int], attempt: int):
        self.site = site
        self.block_id = block_id
        self.attempt = attempt
        super().__init__(
            errno_mod.ENOSPC,
            f"injected ENOSPC at {site}"
            + (f" on block {block_id}" if block_id is not None else "")
            + f" (attempt {attempt}): no space left on device",
        )


def _poison_leaf(a):
    """Model a NaN-producing kernel: float leaves become NaN; integer
    leaves get the value a NaN cast yields (INT_MIN for signed, max for
    unsigned) — the garbage that reaches storage when nobody validates."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return np.full_like(a, np.nan)
    if a.dtype.kind == "i":
        return np.full_like(a, np.iinfo(a.dtype).min)
    if a.dtype.kind == "u":
        return np.full_like(a, np.iinfo(a.dtype).max)
    return a


def _map_leaves(fn, tree):
    """``fn`` over the array leaves of an output tree (tuples, lists and
    dicts recurse; None stays None).  A torch tensor leaf is poisoned as
    numpy and comes back as a tensor on its own device."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    import torch

    if isinstance(tree, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(fn(tree.detach().cpu().numpy()))).to(tree.device)
    return fn(tree)


class FaultInjector:
    """Seeded, deterministic fault injector.  With no faults configured
    every hook is a cheap no-op, so the hooks stay permanently wired into
    the production paths."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = dict(config or {})
        self.seed = int(config.get("seed", 0))
        self.state_dir = config.get("state_dir")
        self.specs = [dict(s) for s in config.get("faults", [])]
        self.enabled = bool(self.specs)
        self._counts: Dict[tuple, int] = {}
        self._lock = threading.Lock()
        for spec in self.specs:
            kind = spec.get("kind")
            site = spec.get("site")
            if kind in ("kill", "preempt"):
                if site not in _KILL_SITES:
                    raise ValueError(
                        f"{kind} fault site must be one of {_KILL_SITES}, "
                        f"got {site!r}"
                    )
                if not self.state_dir:
                    raise ValueError(
                        f"{kind} faults require 'state_dir' (the one-shot "
                        "latch must survive the process they interrupt)"
                    )
            elif kind == "nan":
                if site != "kernel":
                    raise ValueError("nan faults only apply to site='kernel'")
            elif kind == "error":
                if site not in _ERROR_SITES:
                    raise ValueError(
                        f"error fault site must be one of {_ERROR_SITES}, "
                        f"got {site!r}"
                    )
            elif kind == "oom":
                if site not in _OOM_SITES:
                    raise ValueError(
                        f"oom fault site must be one of {_OOM_SITES}, "
                        f"got {site!r}"
                    )
            elif kind == "enospc":
                if site not in _ENOSPC_SITES:
                    raise ValueError(
                        f"enospc fault site must be one of {_ENOSPC_SITES}, "
                        f"got {site!r}"
                    )
            elif kind == "spill":
                if site not in _SPILL_SITES:
                    raise ValueError(
                        f"spill fault site must be one of {_SPILL_SITES}, "
                        f"got {site!r}"
                    )
            elif kind == "reject":
                if site not in _REJECT_SITES:
                    raise ValueError(
                        f"reject fault site must be one of {_REJECT_SITES}, "
                        f"got {site!r}"
                    )
            elif kind == "torn":
                if site not in _TORN_SITES:
                    raise ValueError(
                        f"torn fault site must be one of {_TORN_SITES}, "
                        f"got {site!r}"
                    )
                if not self.state_dir:
                    raise ValueError(
                        "torn faults require 'state_dir' (the torn write "
                        "kills the process; the latch keeps the restarted "
                        "journal from re-tearing)"
                    )
            elif kind == "hang":
                if site not in _HANG_SITES:
                    raise ValueError(
                        f"hang fault site must be one of {_HANG_SITES}, "
                        f"got {site!r}"
                    )
            elif kind == "corrupt":
                if site not in _CORRUPT_SITES:
                    raise ValueError(
                        f"corrupt fault site must be one of {_CORRUPT_SITES} "
                        f"(write-time flip vs at-rest rot at read), got "
                        f"{site!r}"
                    )
                if spec.get("mode", "flip") not in _CORRUPT_MODES:
                    raise ValueError(
                        f"corrupt fault mode must be one of {_CORRUPT_MODES},"
                        f" got {spec.get('mode')!r}"
                    )
            elif kind in ("net_delay", "net_drop", "net_wedge"):
                if site not in _NET_SITES:
                    raise ValueError(
                        f"{kind} fault site must be one of {_NET_SITES}, "
                        f"got {site!r}"
                    )
            elif kind == "job_loss":
                if site != "submit":
                    raise ValueError(
                        "job_loss faults only apply to site='submit'"
                    )
            else:
                raise ValueError(f"unknown fault kind {kind!r}")
        if self.state_dir:
            os.makedirs(self.state_dir, exist_ok=True)

    # -- internals ---------------------------------------------------------
    def _unit(self, *parts) -> float:
        key = ":".join(str(p) for p in (self.seed,) + parts)
        return zlib.crc32(key.encode()) / 0xFFFFFFFF

    def _next_attempt(self, site, block_id, idx) -> int:
        with self._lock:
            key = (site, block_id, idx)
            attempt = self._counts.get(key, 0) + 1
            self._counts[key] = attempt
            return attempt

    def _active(
        self, idx, spec, site, block_id, kind, voxels=None
    ) -> Optional[int]:
        """Attempt number if this spec fires for (site, block), else None.
        Calling this *counts* an attempt for matching specs.  ``min_voxels``
        gates on the caller-reported work-unit size (resource faults: big
        blocks fail, split sub-blocks fit) — unsized calls never match a
        sized spec."""
        if spec.get("kind") != kind or spec.get("site") != site:
            return None
        blocks = spec.get("blocks")
        if blocks is not None:
            if block_id is None or int(block_id) not in {int(b) for b in blocks}:
                return None
        tasks = spec.get("tasks")
        if tasks is not None:
            cur = current_task() or ""
            if not any(cur.startswith(str(t)) for t in tasks):
                return None
        min_voxels = spec.get("min_voxels")
        if min_voxels is not None:
            if voxels is None or int(voxels) < int(min_voxels):
                return None
        attempt = self._next_attempt(site, block_id, idx)
        if attempt > int(spec.get("fail_attempts", 1)):
            return None
        rate = spec.get("rate")
        if rate is not None and self._unit(site, block_id, attempt) >= float(rate):
            return None
        return attempt

    # -- hook points ---------------------------------------------------------
    def maybe_fail(
        self,
        site: str,
        block_id: Optional[int] = None,
        voxels: Optional[int] = None,
    ) -> None:
        """Raise :class:`InjectedFault` / :class:`InjectedOOM` /
        :class:`InjectedENOSPC` if an error / oom / enospc fault fires here.
        ``voxels`` is the caller's work-unit size, used by the ``min_voxels``
        gate of resource faults."""
        if not self.enabled:
            return
        for idx, spec in enumerate(self.specs):
            kind = spec.get("kind")
            if kind not in _FAIL_KINDS:
                continue
            attempt = self._active(idx, spec, site, block_id, kind, voxels)
            if attempt is None:
                continue
            if kind == "oom":
                raise InjectedOOM(site, block_id, attempt)
            if kind == "enospc":
                raise InjectedENOSPC(site, block_id, attempt)
            raise InjectedFault(site, block_id, attempt)

    def corrupt(self, site: str, block_id: Optional[int], tree):
        """Return ``tree`` with every array leaf poisoned if a nan fault
        fires here, else ``tree`` unchanged."""
        if not self.enabled:
            return tree
        for idx, spec in enumerate(self.specs):
            if self._active(idx, spec, site, block_id, "nan") is not None:
                return _map_leaves(_poison_leaf, tree)
        return tree

    def maybe_hang(self, site: str, block_id: Optional[int] = None) -> None:
        """Sleep ``seconds`` (default 1.0) if a hang fault fires here —
        modelling a stuck kernel / wedged IO call that only a wall-clock
        deadline can notice.  The sleep is finite so test runs terminate;
        the watchdog must have declared the block hung long before it ends."""
        if not self.enabled:
            return
        for idx, spec in enumerate(self.specs):
            attempt = self._active(idx, spec, site, block_id, "hang")
            if attempt is not None:
                time.sleep(float(spec.get("seconds", 1.0)))

    def chunk_corrupt(
        self, site: str, block_id: Optional[int] = None
    ) -> Optional[str]:
        """Corruption mode for a stored region at this site, or None.
        ``"flip"`` (truthy, the default — existing boolean callers keep
        working): silently bit-flip the stored bytes, sidecar untouched.
        ``"sidecar"``: delete the region's digest sidecar instead, so the
        missing-sidecar policy (``io/verified.py``) is what gets tested.
        At ``io_write`` the damage lands after the write; at ``io_read``
        it models at-rest rot surfacing at the read site."""
        if not self.enabled:
            return None
        for idx, spec in enumerate(self.specs):
            if self._active(idx, spec, site, block_id, "corrupt") is not None:
                return str(spec.get("mode", "flip"))
        return None

    def force_spill(self) -> bool:
        """True if an in-memory handoff target being declared right now
        (site ``publish``) must be written through to its storage spill
        path (``kind='spill'``).  The attempt counter ticks once per
        publish, so ``fail_attempts`` bounds how many targets spill; use a
        large value to force every handoff of a run.  ``tasks`` gates on
        the producing task's uid prefix as usual."""
        if not self.enabled:
            return False
        for idx, spec in enumerate(self.specs):
            if self._active(idx, spec, "publish", None, "spill") is not None:
                return True
        return False

    def maybe_reject(self, tenant: Optional[str] = None) -> bool:
        """True if this admission (site ``admit``, kind ``reject``) must
        be rejected with a typed backpressure error — the service mode's
        seeded per-tenant admission failure (docs/SERVING.md).  The
        ``tenants`` spec key gates on the submitting tenant's name (no
        key: every tenant); attempts count per ``(site, tenant)``, so
        ``fail_attempts`` bounds how many of one tenant's submissions are
        rejected and ``rate`` draws a seeded per-attempt coin."""
        if not self.enabled:
            return False
        for idx, spec in enumerate(self.specs):
            if spec.get("kind") != "reject" or spec.get("site") != "admit":
                continue
            tenants = spec.get("tenants")
            if tenants is not None:
                if tenant is None or str(tenant) not in {
                    str(t) for t in tenants
                }:
                    continue
            attempt = self._next_attempt("admit", tenant, idx)
            if attempt > int(spec.get("fail_attempts", 1)):
                continue
            rate = spec.get("rate")
            if rate is not None and self._unit(
                "admit", tenant, attempt
            ) >= float(rate):
                continue
            return True
        return False

    def net_fault(
        self, site: str, member: Optional[str] = None
    ) -> Optional[tuple]:
        """``(kind, seconds)`` if a net fault fires for this outbound HTTP
        exchange (sites ``net_member`` / ``net_probe`` / ``net_client``),
        else None.  The ``members`` spec key gates on the far side's name
        (a fleet member or, for ``net_client``, a tenant; no key: every
        exchange at the site); attempts count per ``(site, member)``, so
        ``fail_attempts`` bounds how many exchanges degrade and ``rate``
        draws a seeded per-attempt coin.  The shim (``runtime/netio.py``)
        acts on the verdict: ``net_delay`` sleeps ``seconds`` then
        proceeds, ``net_drop`` raises ``ConnectionResetError``,
        ``net_wedge`` blocks until the caller's deadline fires."""
        if not self.enabled:
            return None
        for idx, spec in enumerate(self.specs):
            kind = spec.get("kind")
            if kind not in ("net_delay", "net_drop", "net_wedge") \
                    or spec.get("site") != site:
                continue
            members = spec.get("members")
            if members is not None:
                if member is None or str(member) not in {
                    str(m) for m in members
                }:
                    continue
            attempt = self._next_attempt(site, member, idx)
            if attempt > int(spec.get("fail_attempts", 1)):
                continue
            rate = spec.get("rate")
            if rate is not None and self._unit(
                site, member, attempt
            ) >= float(rate):
                continue
            return (kind, float(spec.get("seconds", 1.0)))
        return None

    def torn_append(self) -> Optional[float]:
        """Fraction of the current journal frame to keep if a ``torn``
        fault (site ``journal``) fires on this append, else None.  The
        journal writes that prefix, fsyncs it, and calls
        :func:`hard_exit` — a torn tail only ever exists because its
        writer died mid-append, so the fault models exactly that.
        One-shot across restarts via the ``state_dir`` latch (the
        resumed server's journal must not re-tear); ``after`` picks the
        N-th append like kill faults."""
        if not self.enabled:
            return None
        for idx, spec in enumerate(self.specs):
            if spec.get("kind") != "torn" or spec.get("site") != "journal":
                continue
            count = self._next_attempt("journal", None, idx)
            if count != int(spec.get("after", 1)):
                continue
            latch = os.path.join(self.state_dir, f"torn_{idx}.done")
            if os.path.exists(latch):
                continue
            tmp = latch + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write("journal")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, latch)
            return float(spec.get("keep_fraction", 0.5))
        return None

    def lose_job(self) -> bool:
        """True if this scheduler submission should be swallowed: the caller
        fabricates a job id the scheduler will keep reporting as running,
        and nothing ever executes — heartbeat supervision must find it."""
        if not self.enabled:
            return False
        for idx, spec in enumerate(self.specs):
            if self._active(idx, spec, "submit", None, "job_loss") is not None:
                return True
        return False

    def kill_point(self, site: str) -> None:
        """Act at the configured crossing of ``site``: ``kind='kill'``
        hard-exits (``os._exit``), ``kind='preempt'`` delivers a real
        SIGTERM to this process (the drain handler must turn it into a
        graceful drain + requeue exit).  One-shot per fault via a latch
        file in ``state_dir``."""
        if not self.enabled:
            return
        for idx, spec in enumerate(self.specs):
            kind = spec.get("kind")
            if kind not in ("kill", "preempt") or spec.get("site") != site:
                continue
            count = self._next_attempt(site, None, idx)
            if count != int(spec.get("after", 1)):
                continue
            latch = os.path.join(self.state_dir, f"kill_{idx}.done")
            if os.path.exists(latch):
                continue
            # latch first (atomically), then act: the resumed run must not
            # re-fire even if the exit races other threads
            tmp = latch + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(site)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, latch)
            if kind == "preempt":
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                os._exit(KILL_EXIT_CODE)


def hard_exit() -> None:
    """``os._exit(KILL_EXIT_CODE)`` — the injector's crash primitive,
    shared by kill faults and the journal's torn-append path.  Lives here
    because CT006 allows ``os._exit`` only in this module: everywhere
    else it would skip the drain protocol's flushes."""
    os._exit(KILL_EXIT_CODE)


# -- module-level singleton ---------------------------------------------------

_injector: Optional[FaultInjector] = None
_singleton_lock = threading.Lock()


def _load_env_config() -> Dict[str, Any]:
    raw = os.environ.get(ENV_VAR, "").strip()
    if not raw:
        return {}
    if raw.startswith("{"):
        return json.loads(raw)
    with open(raw) as f:
        return json.load(f)


def get_injector() -> FaultInjector:
    """The process-wide injector; configured lazily from ``CTT_FAULTS``."""
    global _injector
    if _injector is None:
        with _singleton_lock:
            if _injector is None:
                _injector = FaultInjector(_load_env_config())
    return _injector


def configure(config: Optional[Dict[str, Any]]) -> FaultInjector:
    """Install an injector programmatically (tests); pass None to disable."""
    global _injector
    with _singleton_lock:
        _injector = FaultInjector(config)
    return _injector


def reset() -> None:
    """Drop the installed injector; the next ``get_injector`` re-reads the
    environment."""
    global _injector
    with _singleton_lock:
        _injector = None
