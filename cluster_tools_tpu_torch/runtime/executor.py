"""Blockwise executor: a per-block kernel over a list of blocks, with
prefetching IO, retries, a failure manifest and the hardening of the
reference (hung-block watchdog, speculation, degrade-and-split, post-store
verification, drain).

Port of ``cluster_tools_tpu/runtime/executor.py::BlockwiseExecutor.map_blocks``
over ``n_devices`` shards, dealt round-robin over the cards (the
reference's mesh of devices; several shards may share a card).  Two sweep
shapes, bit-identical to each other:

- **per block** (``sweep_mode="per_block"``): ``load_fn(block)`` on an IO
  thread pool, ``prefetch`` batches of ``n_devices * device_batch`` blocks
  ahead; each block's inputs to its shard's device (the blocks of a batch
  dealt over the shards in lane order) and ``kernel(*inputs)`` there, one
  block a call; the outputs back to numpy, ``check_finite`` and
  ``validate_fn``; ``store_fn(block, outputs)`` on the IO pool, then
  ``on_block_done``.
- **sharded** (``"sharded"``, and ``"auto"`` once the mesh has two shards
  or the sweep fills one batch of ``sharded_batch`` blocks, as in the
  reference): a Morton batch splits into ``n_devices`` equal sub-batches
  in lane order, as the reference's ``batched_shard_map`` splits it; each
  shard's sub-batch goes to its device as one stacked copy and runs as one
  call of :func:`~..parallel.batch_shard.batched_sweep` (the kernel's
  lane-batched form, ``kernel.batched``, when it has one; else each lane
  in turn), with one sync and one copy back; the outputs are gathered in
  lane order.  The cards run their shards from one thread each (also
  when every shard sits on one card), so a host sync in
  one card's torch glue does not stall another; the shards of one card run
  in turn.  A partial or mixed-shape batch packs through the ragged paged
  pool (:mod:`..parallel.block_pool`, ``ragged``): its page pools go to
  every card, staged through that card's device-resident page pool
  (:mod:`..parallel.device_pool`, ``device_pool``) when that is on, and
  its page tables and valid extents split with the lanes.

Failures, as in the reference (the fault injector's ``load``, ``compute``,
``dispatch``, ``store`` and ``kernel`` sites sit where the reference's do,
so one ``CTT_FAULTS`` spec gives the same ``failures.json`` records in both
packages).  Loads and stores retry with capped exponential backoff; a
resource error (OOM, ENOSPC) is not retried at the same size.  A block
whose load, kernel, validation or store still fails is quarantined and
re-run once, alone, after the sweep.  A sharded batch whose call fails
(site ``dispatch``, once a batch; or an error on any shard) quarantines
all its blocks, which the quarantine pass runs one by one through the
same kernel (``degraded:unsharded``); a device OOM first evicts the
resident arenas of the card that failed.  A resource-
starved block first waits up to ``degrade_wait_s`` for headroom
(``degraded:backpressure``); with ``splittable`` it is then re-run as
halo-correct sub-blocks down to ``min_block_shape`` (``degraded:split``).
Sub-blocks never enter a stacked batch: the port runs them one a call (the
reference packs a split parent's sub-blocks into ragged batches on the
sharded path; the records are the same).  ``block_deadline_s`` arms a
watchdog: a load, compute or store past the deadline is recorded ``hung``
and quarantined, and a speculative duplicate of the block runs alone on the
device; the first result wins and a later one must agree bit for bit
(:class:`~.supervision.FirstWins`).  ``store_verify_fn``
(:func:`region_verifier`) re-reads each stored region against its digest
sidecar, so a corruption is re-stored (retry) or recomputed (quarantine),
and registers the block's lineage for repair.  A drain (SIGTERM/SIGUSR1)
stops claiming batches and raises :class:`~.supervision.DrainInterrupt`
once the running work is stored.  Every failure lands in
``failures.json``; a RuntimeError names every block still failed at the
end.  A kernel error is never answered by running another implementation.

Device work and threads: every call of the kernel on a card, the
primary's and a speculative duplicate's, of this executor or another,
holds that card's dispatch lock (:func:`dispatch_lock`, one a card for the
process) and ends with a device sync, so their stream work is ordered and
a duplicate's outputs are on the host before the digest compare.  A block
that runs alone (quarantine, speculation, sub-blocks, a lineage
recompute) runs on the first shard's device.  An injected hang fires before the lock,
so a duplicate never queues behind it.  The spans are the reference's
(``executor.sweep``/``load``/``h2d``/``dispatch``/``d2h``/``store``/
``batch_wait``/``speculate``), with two differences: a sharded batch has
one ``executor.dispatch`` (and ``h2d``, ``d2h``) span a shard that ran,
each with its ``shard``; and in what they time: the
port's ``executor.dispatch`` span ends after that sync, so it carries the
device time, and ``executor.d2h`` is the copy back alone (the reference's
dispatch ends at the asynchronous launch and its ``d2h`` waits for the
device).  The port adds ``executor.lock_wait`` (a wait for a card's
dispatch lock or its device page pool's lock; the copy's clock leaves it
out) and ``executor.store.verify`` (the re-read against the digest); a
task's ``load_fn``/``store_fn`` may add its own steps inside a phase
(``executor.load.read``, ``executor.store.write``).  Every phase span
records its thread's CPU and, while a profiler records, is mirrored into
it; a task submitted to the sweep's pools runs under its submitter's
thread state then, so the workers' torch ops land in the profile too
(:mod:`.trace`).

``load_fn`` may return futures (anything with ``.result()``, such as
``read_async`` through :func:`~..io.prefetch.async_loader`): a batch's
reads are all issued before any is resolved, so its chunk reads are in
flight together.  The first attempt resolves the issued futures; a retry
calls ``load_fn`` again.

The admission gate (the reference's ``map_blocks``
``inflight_byte_budget``): the bytes of blocks loaded but not yet stored
are capped at ``inflight_byte_budget`` (None: a quarter of MemAvailable
at the sweep's start, less the decompressed-chunk cache's budget while the
cache is on and less the live in-memory handoff bytes, each floored at a
quarter of it; 0: off).  Before each call to the device
the dispatch thread drains pending stores while the budget is short or
host memory (below ``MEM_HEADROOM_FRACTION`` available) or the disk under
the failure manifest (below ``DISK_HEADROOM_FRACTION`` free) runs low;
low host memory first flushes completed handoffs to storage
(:func:`~.handoff.spill_for_headroom`).
"""

from __future__ import annotations

import contextlib
import errno
import itertools
import os
import threading
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import card_key, resolve_device
from ..io import chunk_cache as chunk_cache_mod
from ..io.containers import ChunkCorruptionError
from ..parallel import block_pool as block_pool_mod
from ..parallel import device_pool as device_pool_mod
from ..parallel.batch_shard import (batched_sweep, concat_lanes, ragged_sweep, resolve_sharded_batch, shard_lanes,
                                    use_sharded_sweep)
from ..parallel.mesh import TARGET_DEVICES, backend_devices
from ..utils import function_utils as fu
from ..utils.volume_utils import Block
from . import admission as admission_mod
from . import faults as faults_mod
from . import handoff as handoff_mod
from . import trace as trace_mod
from .supervision import (DrainInterrupt, FirstWins, Watchdog, array_digest, disk_free_fraction, drain_reason,
                          drain_requested, host_mem_available_bytes, host_mem_available_fraction,
                          install_drain_handler)

# the admission gate's floors: host memory available, and disk free under
# the failure manifest, as fractions of their totals
MEM_HEADROOM_FRACTION = 0.05
DISK_HEADROOM_FRACTION = 0.02


def target_device(target: str) -> torch.device:
    """``local`` -> the CPU, ``gpu`` -> the card (raises without one)."""
    if target not in TARGET_DEVICES:
        raise ValueError(f"unknown target {target!r}, expected one of {sorted(TARGET_DEVICES)}")
    return resolve_device(TARGET_DEVICES[target])


# process-wide dispatch counters, as the reference's: a task's share is
# the delta of two snapshots (it lands in the task's io_metrics.json)
_METRICS_LOCK = threading.Lock()
_DISPATCH_COUNTERS: Dict[str, float] = {
    "batches_dispatched": 0, "blocks_dispatched": 0, "dispatch_wait_s": 0.0, "sweep_s": 0.0,
    "ragged_batches": 0, "lanes_padded": 0, "pages_in_use": 0,
}


def dispatch_snapshot() -> Dict[str, float]:
    """Current process-wide dispatch counters (monotonic; diff two
    snapshots with :func:`dispatch_delta` to attribute a task's share)."""
    with _METRICS_LOCK:
        return dict(_DISPATCH_COUNTERS)


def dispatch_delta(snapshot: Dict[str, float]) -> Dict[str, float]:
    """Counter movement since ``snapshot`` (same keys)."""
    cur = dispatch_snapshot()
    return {k: cur[k] - snapshot.get(k, 0) for k in cur}


def _record_dispatch_metrics(counts: Dict[str, float], sweep_s: float) -> None:
    """Add one sweep's counts (its summary's keys) and its wall."""
    with _METRICS_LOCK:
        for k in _DISPATCH_COUNTERS:
            _DISPATCH_COUNTERS[k] += sweep_s if k == "sweep_s" else counts.get(k, 0)


_DISPATCH_LOCKS: Dict[str, threading.RLock] = {}
_DISPATCH_LOCKS_GUARD = threading.Lock()


def dispatch_lock(device) -> threading.RLock:
    """The dispatch lock of ``device``'s card, one for the whole process:
    every kernel call on that card (a shard's sub-batch, a block, a
    duplicate, a sub-block, of any executor) holds it, so the card's
    stream work is ordered."""
    key = card_key(device)
    with _DISPATCH_LOCKS_GUARD:
        return _DISPATCH_LOCKS.setdefault(key, threading.RLock())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _on_card(device: torch.device):
    """``device`` as the current card while a shard's work runs (tensors a
    kernel makes on ``"cuda"`` land on its shard's card)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def morton_order(blocks: Sequence[Block]) -> List[Block]:
    """Reorder ``blocks`` along a Morton (Z-order) curve of the block grid,
    so consecutive blocks share boundary chunks.  Grid positions are
    recovered from the blocks' ``begin`` (per-axis rank of the distinct
    values), so ROI- and parity-filtered lists order correctly."""
    blocks = list(blocks)
    if len(blocks) < 3:
        return blocks
    nd = len(blocks[0].begin)
    rank = []
    for ax in range(nd):
        values = sorted({int(b.begin[ax]) for b in blocks})
        rank.append({v: i for i, v in enumerate(values)})
    nbits = max(1, max(len(r) - 1 for r in rank).bit_length())

    def code(b: Block) -> int:
        c = 0
        for bit in range(nbits):
            for ax in range(nd):
                c |= ((rank[ax][int(b.begin[ax])] >> bit) & 1) << (bit * nd + ax)
        return c

    return sorted(blocks, key=code)


def _leaves(out) -> List[np.ndarray]:
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    if isinstance(out, dict):
        return [leaf for o in out.values() for leaf in _leaves(o)]
    return [np.asarray(out)]


def _to_numpy(out):
    """A kernel's output tree (tensors, bools, numbers) as numpy arrays."""
    if isinstance(out, (tuple, list)):
        return type(out)(_to_numpy(o) for o in out)
    if isinstance(out, dict):
        return {k: _to_numpy(v) for k, v in out.items()}
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


def check_finite_outputs(block: Block, out) -> Optional[str]:
    """Any non-finite value in a float output is a corrupt kernel output."""
    for a in _leaves(out):
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            return "non-finite values (NaN/inf) in kernel output"
    return None


def validate_labels(block: Block, out) -> Optional[str]:
    """Negative (signed) or saturated (unsigned) labels are the integer
    shadows of a corrupt kernel."""
    for a in _leaves(out):
        if a.size == 0:
            continue
        if a.dtype.kind == "i" and int(a.min()) < 0:
            return "negative label values (corrupt kernel output)"
        if a.dtype.kind == "u" and bool((a == np.iinfo(a.dtype).max).any()):
            return "saturated label values (corrupt kernel output)"
    return None


_DISK_FULL_ERRNOS = (errno.ENOSPC, errno.EDQUOT)


def classify_resource_error(exc: BaseException) -> Optional[str]:
    """``"oom"`` / ``"enospc"`` when ``exc`` (or anything on its cause or
    context chain) is a resource exhaustion: ``MemoryError``,
    ``torch.OutOfMemoryError``, a ``RuntimeError`` naming
    ``RESOURCE_EXHAUSTED``, or an ``OSError`` with ENOSPC/EDQUOT.  Else None."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, (MemoryError, torch.OutOfMemoryError)):
            return "oom"
        if isinstance(exc, OSError) and exc.errno in _DISK_FULL_ERRNOS:
            return "enospc"
        if isinstance(exc, RuntimeError) and "RESOURCE_EXHAUSTED" in str(exc):
            return "oom"
        exc = exc.__cause__ or exc.__context__
    return None


def sweep_config(cfg) -> Dict[str, Any]:
    """The ``map_blocks`` knobs a blockwise task takes from its config, as
    the reference's tasks pass them; each call site adds its own
    ``store_verify_fn`` and ``splittable``."""
    return dict(
        schedule=str(cfg.get("block_schedule") or "morton"),
        sweep_mode=str(cfg.get("sweep_mode") or "auto"),
        sharded_batch=cfg.get("sharded_batch"),
        ragged=str(cfg.get("ragged") or "auto"),
        device_pool=str(cfg.get("device_pool") or "auto"),
        device_pool_bytes=cfg.get("device_pool_bytes"),
        block_deadline_s=cfg.get("block_deadline_s"),
        watchdog_period_s=cfg.get("watchdog_period_s"),
        degrade_wait_s=float(cfg.get("degrade_wait_s", 5.0)),
        inflight_byte_budget=cfg.get("inflight_byte_budget"),
    )


def _tree_nbytes(out) -> int:
    return sum(int(a.nbytes) for a in _leaves(out))


def _lane(out, j: int, crop=None):
    """Lane ``j`` of a stacked numpy output tree (``crop(j, leaf)`` crops a
    ragged lane back to its valid extent)."""
    if isinstance(out, (tuple, list)):
        return type(out)(_lane(o, j, crop) for o in out)
    if isinstance(out, dict):
        return {k: _lane(v, j, crop) for k, v in out.items()}
    leaf = out[j]
    return crop(j, leaf) if crop is not None else leaf


class SubBlock(Block):
    """A degrade-split fragment of a parent block (same ``block_id``).
    Load and store callbacks that pad to one batch shape can detect these
    (:func:`is_sub_block`) and size buffers per block: sub-blocks never
    enter a stacked batch."""


def is_sub_block(block: Block) -> bool:
    return isinstance(block, SubBlock)


def split_block(block: Block, halo: Optional[Sequence[int]] = None,
                min_shape: Optional[Sequence[int]] = None) -> Optional[List[Block]]:
    """Split ``block``'s inner region into up to 2^d halo-correct
    sub-blocks (each axis halved where both halves stay >= ``min_shape``).

    Sub-blocks keep the parent's ``block_id`` and get outer boxes of
    ``sub_inner ± halo`` clamped to the parent's outer box.  ``halo``
    defaults to the parent's own per-axis halo (the larger of its two
    sides).  Returns None when no axis can split."""
    nd = len(block.begin)
    if halo is None:
        halo = tuple(max(b - ob, oe - e) for b, ob, e, oe in zip(block.begin, block.outer_begin, block.end,
                                                                  block.outer_end))
    halo = tuple(int(h) for h in halo)
    min_shape = tuple(max(1, int(m)) for m in (min_shape or (1,) * nd))
    axes_intervals = []
    any_cut = False
    for ax in range(nd):
        lo, hi = block.begin[ax], block.end[ax]
        half = (hi - lo) // 2
        if half >= min_shape[ax] and (hi - lo) - half >= min_shape[ax]:
            axes_intervals.append([(lo, lo + half), (lo + half, hi)])
            any_cut = True
        else:
            axes_intervals.append([(lo, hi)])
    if not any_cut:
        return None
    subs = []
    for combo in itertools.product(*axes_intervals):
        begin = tuple(c[0] for c in combo)
        end = tuple(c[1] for c in combo)
        outer_begin = tuple(max(ob, b - h) for ob, b, h in zip(block.outer_begin, begin, halo))
        outer_end = tuple(min(oe, e + h) for oe, e, h in zip(block.outer_end, end, halo))
        subs.append(SubBlock(block.block_id, begin, end, outer_begin, outer_end))
    return subs


def region_verifier(dataset, bb_of: Optional[Callable[[Block], Any]] = None) -> Optional[Callable[[Block], None]]:
    """A ``store_verify_fn`` for :meth:`BlockwiseExecutor.map_blocks` from a
    dataset with digest sidecars: read the block's stored region back and
    raise :class:`~..io.containers.ChunkCorruptionError` if it no longer
    matches.  None for datasets without sidecars (HDF5), so call sites
    wire it unconditionally.  Wiring one also marks the dataset a product
    store (:func:`~..io.verified.mark_product`), and the callable carries
    ``.dataset`` and ``.bb_of`` so the executor registers each verified
    block's lineage (:mod:`.repair`)."""
    verify = getattr(dataset, "verify_region", None)
    if verify is None:
        return None
    from ..io import verified as verified_mod

    verified_mod.mark_product(dataset)
    if bb_of is None:
        bb_of = lambda block: block.bb  # noqa: E731

    def store_verify(block: Block) -> None:
        verify(bb_of(block))

    store_verify.dataset = dataset
    store_verify.bb_of = bb_of
    return store_verify


class BlockwiseExecutor:
    """Run a per-block kernel over blocks on the shards of ``target``.

    ``n_devices`` shards (``None``: :func:`~..parallel.mesh.visible_shards`,
    the number of cards or ``CTT_MESH_SHARDS``), dealt round-robin over the
    cards (:func:`~..parallel.mesh.backend_devices`); ``devices`` holds one
    device per shard and ``batch_size`` is ``n_devices * device_batch``, as
    in the reference.  ``load_fn(block)`` returns the kernel's input arrays
    (numpy, already padded to one shape) or futures of them;
    ``kernel(*tensors)`` gets them as tensors on a shard's device and
    returns a tensor or a tuple of tensors and flags; ``store_fn(block,
    outputs)`` persists one block's outputs as numpy.
    """

    def __init__(self, target: str = "gpu", n_devices: Optional[int] = None, device_batch: int = 1,
                 io_threads: int = 8, max_retries: int = 2, backoff_base: float = 0.05,
                 backoff_max: float = 5.0):
        self.target = target
        self.devices: List[torch.device] = backend_devices(target, n_devices)
        self.n_devices = len(self.devices)
        # the shard that runs the calls of one block alone (quarantine,
        # speculation, sub-blocks, lineage recompute)
        self.device = self.devices[0]
        self.device_batch = max(1, int(device_batch))
        self.batch_size = self.n_devices * self.device_batch
        self.io_threads = max(1, int(io_threads))
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)

    @classmethod
    def for_task(cls, target: str, cfg, max_jobs: int) -> "BlockwiseExecutor":
        """The executor a task's config asks for (``device_batch``,
        ``io_threads`` or ``max_jobs``, ``io_retries``, ``io_backoff_s``)."""
        return cls(target=target, device_batch=int(cfg.get("device_batch", 1)),
                   io_threads=int(cfg.get("io_threads") or max(1, max_jobs)),
                   max_retries=int(cfg.get("io_retries", 2)), backoff_base=float(cfg.get("io_backoff_s", 0.05)))

    def _backoff(self, attempt: int) -> float:
        return fu.backoff_delay(attempt, self.backoff_base, self.backoff_max)

    def _io_with_retries(self, site: str, block: Block, fn: Callable,
                         on_error: Optional[Callable[[Exception], None]] = None):
        """``fn`` with the fault hooks of ``site`` and retries:
        ``(value, attempts, traceback or None, resource class or None)``.
        A resource error (OOM, ENOSPC) ends the retries at once: the
        degrade ladder owns it.  ``on_error`` sees each caught error."""
        injector = faults_mod.get_injector()
        voxels = int(np.prod(block.outer_shape))
        last_tb = None
        for k in range(self.max_retries + 1):
            try:
                injector.maybe_fail(site, block.block_id, voxels=voxels)
                injector.maybe_hang(site, block.block_id)
                return fn(), k + 1, None, None
            except Exception as e:
                if on_error is not None:
                    try:
                        on_error(e)
                    except Exception:
                        pass
                last_tb = fu.cap_traceback(traceback.format_exc())
                resource = classify_resource_error(e)
                if resource is not None:
                    return None, k + 1, last_tb, resource
                if k < self.max_retries:
                    time.sleep(self._backoff(k))
        return None, self.max_retries + 1, last_tb, None

    def map_blocks(
        self,
        kernel: Callable,
        blocks: Sequence[Block],
        load_fn: Callable[[Block], Tuple],
        store_fn: Optional[Callable[[Block, Any], None]] = None,
        on_block_done: Optional[Callable[[Block], None]] = None,
        prefetch: int = 2,
        done_block_ids: Optional[Iterable[int]] = None,
        validate_fn: Optional[Callable[[Block, Any], Optional[str]]] = None,
        check_finite: bool = True,
        failures_path: Optional[str] = None,
        task_name: str = "map_blocks",
        schedule: str = "morton",
        sweep_mode: str = "auto",
        sharded_batch: Optional[int] = None,
        ragged: str = "auto",
        page_shape: Optional[Sequence[int]] = None,
        device_pool: str = "auto",
        device_pool_bytes: Optional[int] = None,
        block_deadline_s: Optional[float] = None,
        watchdog_period_s: Optional[float] = None,
        speculate: bool = True,
        store_verify_fn: Optional[Callable[[Block], None]] = None,
        splittable: bool = False,
        split_halo: Optional[Sequence[int]] = None,
        min_block_shape: Optional[Sequence[int]] = None,
        degrade_wait_s: float = 5.0,
        inflight_byte_budget: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Execute ``kernel`` over ``blocks``; see the module docstring.

        ``done_block_ids`` are skipped (marker resume).  ``schedule``:
        ``"morton"`` (default) or ``"given"`` order; blocks are independent,
        so the order never changes results.

        ``sweep_mode``: ``"per_block"``, ``"sharded"`` or ``"auto"`` (sharded
        with two shards or more, or once the sweep fills one batch: the
        reference's rule).  ``sharded_batch``: blocks per sharded call,
        rounded up to a multiple of ``n_devices`` (None: ``max(2 *
        batch_size, 8)`` rounded so).  ``ragged`` (sharded path only):
        ``"auto"`` packs partial and mixed-shape batches through the paged
        block pool, ``"on"`` packs every batch, ``"off"`` pads a partial
        batch by repeating its last block (the padded outputs are dropped)
        and runs mixed shapes per block.  ``page_shape`` overrides the
        pool's page tile for mixed-shape batches.  ``device_pool``
        (``"auto"``/``"on"``/``"off"``) stages ragged batches through the
        resident device page pool (``CTT_DEVICE_POOL=0`` switches it off);
        ``device_pool_bytes`` is its budget.

        ``block_deadline_s``: the per-block wall budget of a load, compute
        or store; the watchdog scans every ``watchdog_period_s`` (default a
        quarter of the deadline) and, with ``speculate``, starts one
        duplicate of each hung block.  ``store_verify_fn(block)``: the
        post-store check (:func:`region_verifier`).  ``splittable``: the
        kernel, ``load_fn`` and ``store_fn`` are pure functions of the block
        geometry at any shape and the kernel is shape-local, so a block that
        stays starved of a resource may re-run as sub-blocks
        (:func:`split_block` with ``split_halo`` and ``min_block_shape``)
        whose outputs tile the unsplit result.  ``inflight_byte_budget``
        drives the admission gate (module docstring); ``degrade_wait_s``
        bounds the headroom wait before a resource-starved block's
        re-attempt.

        Returns a summary: the summed host-clock seconds of the sweep's
        stages (``load_s`` and ``store_s`` on the IO threads; ``h2d_s``,
        ``kernel_s`` ended by a device sync, and ``d2h_s`` on the dispatch
        thread), the dispatch counters (``n_dispatches``,
        ``batches_dispatched``, ``blocks_dispatched``, ``dispatch_wait_s``,
        ``ragged_batches``, ``lanes_padded``, ``pages_in_use``), the
        admission gate's ``inflight_byte_budget`` and
        ``n_backpressure_waits`` (dispatches that drained stores first), the
        device-plane counters (``h2d_bytes``, ``d2h_bytes``,
        ``device_pool_hits``/``misses``/``evictions``,
        ``device_pool_resident_bytes``), the hardening counters
        (``n_unsharded``; with a deadline ``n_hung`` and ``n_speculated``;
        ``n_degraded``, ``n_split``, ``n_sub_blocks`` and ``split_depth``),
        the shard count (``n_devices``) and the device calls each shard
        made (``shard_calls``), and on the sharded path the rung each batch
        ran (``batch_rungs``: ``"batched"`` or ``"lanes"``).

        Raises RuntimeError naming every block still failed after the
        quarantine pass, and :class:`~.supervision.DrainInterrupt` after a
        drain (running work finished, markers and manifest flushed).
        """
        if done_block_ids:
            done = {int(b) for b in done_block_ids}
            blocks = [b for b in blocks if int(b.block_id) not in done]
        if schedule == "morton":
            blocks = morton_order(blocks)
        elif schedule not in ("given", None):
            raise ValueError(f"unknown schedule {schedule!r} (expected 'morton' or 'given')")
        sharded_width = resolve_sharded_batch(self.n_devices, self.batch_size, sharded_batch)
        use_sharded = use_sharded_sweep(sweep_mode, self.n_devices, len(blocks), sharded_width)
        if ragged not in ("auto", "on", "off"):
            raise ValueError(f"unknown ragged mode {ragged!r} (expected 'auto', 'on' or 'off')")
        if device_pool not in ("auto", "on", "off"):
            raise ValueError(f"unknown device_pool mode {device_pool!r} (expected 'auto', 'on' or 'off')")
        # the paged pool is a sharded-path feature, and the resident device
        # pool rides it (its page tables are the re-addressing mechanism)
        use_ragged = use_sharded and ragged != "off"
        ragged_pool = block_pool_mod.PagedBlockPool() if use_ragged else None
        dev_pool = (device_pool_mod.get_device_pool(device_pool_bytes)
                    if use_ragged and device_pool != "off" and device_pool_mod.device_pool_enabled() else None)
        if page_shape is not None:
            page_shape = tuple(int(p) for p in page_shape)
        stats = {"load_s": 0.0, "h2d_s": 0.0, "kernel_s": 0.0, "d2h_s": 0.0, "store_s": 0.0}
        if not blocks:
            return {"n_blocks": 0, "n_quarantined": 0, "n_failed": 0, **stats}
        # SIGTERM/SIGUSR1 flip the drain latch; the sweep checks it between
        # batches
        install_drain_handler()
        injector = faults_mod.get_injector()
        deadline = float(block_deadline_s or 0.0)
        block_by_id = {int(b.block_id): b for b in blocks}

        dev_snap = device_pool_mod.snapshot()
        counts = {"n_dispatches": 0, "batches_dispatched": 0, "blocks_dispatched": 0,
                  "dispatch_wait_s": 0.0, "ragged_batches": 0, "lanes_padded": 0, "pages_in_use": 0}
        # device calls by shard: a sharded batch makes one on each shard
        # that holds a real lane, a block alone one on its shard
        shard_calls = [0] * self.n_devices
        batch_rungs: List[str] = []
        failures: Dict[int, Dict[str, Any]] = {}
        quarantined_ids: set = set()
        # blocks whose sharded batch failed (or hung in compute): the
        # per-block path resolves them, attributed degraded:unsharded
        sharded_failed: set = set()
        finished_ids: set = set()
        lock = threading.Lock()
        speculated: set = set()
        commits = FirstWins()
        sweep_span = trace_mod.begin("executor.sweep", task=task_name, n_blocks=len(blocks),
                                     sharded=bool(use_sharded))

        # the service request's context is thread-local: every worker of
        # the sweep's pools (loads, stores, speculative re-runs) re-enters
        # it, so block-grain handoffs keep the request's namespace; while
        # a traced run is profiled, a task also runs under its submitter's
        # thread state, so its torch ops and phases land in the profile
        req_ctx = admission_mod.current_request()

        def scoped(fn):
            state = trace_mod.capture_thread_state()

            def run(*a, **kw):
                with admission_mod.request_scope(req_ctx), trace_mod.thread_state(state):
                    return fn(*a, **kw)
            return run

        # -- the admission gate (reference executor.py:1610-1690) ------------
        # in flight = loaded but not yet stored; the budget caps it
        if inflight_byte_budget is None:
            avail = host_mem_available_bytes()
            budget = int(avail * 0.25) if avail else 0
            # under a service request the auto budget is also capped at
            # the request's share of its tenant's byte quota; an explicit
            # inflight_byte_budget is never overridden
            tenant_cap = admission_mod.ambient_byte_cap()
            if tenant_cap:
                budget = min(budget, int(tenant_cap)) if budget else int(tenant_cap)
            if budget and chunk_cache_mod.cache_enabled():
                # the decompressed-chunk cache shares the host envelope,
                # floored at a quarter of it so small hosts keep making
                # progress
                budget = max(budget - chunk_cache_mod.get_chunk_cache().max_bytes, budget // 4)
            live_handoff = handoff_mod.live_bytes()
            if budget and live_handoff:
                # so do live in-memory handoffs, with the same floor
                budget = max(budget - live_handoff, budget // 4)
        else:
            budget = int(inflight_byte_budget)
        inflight = {"bytes": 0}
        backpressure = {"waits": 0}
        headroom_path = os.path.dirname(os.path.abspath(failures_path)) if failures_path else None

        def release(nbytes: int) -> None:
            with lock:
                inflight["bytes"] -= nbytes

        def admit(nbytes: int, writes: List[Future]) -> None:
            """Drain pending stores (oldest first) while ``nbytes`` more
            would pass the budget or host memory or disk runs low; the
            current batch is always admitted.  Low host memory first
            flushes completed handoffs to storage."""
            mem = host_mem_available_fraction()
            if mem is not None and mem < MEM_HEADROOM_FRACTION:
                handoff_mod.spill_for_headroom()
            waited = False
            while writes:
                with lock:
                    over = budget and inflight["bytes"] + nbytes > budget
                mem = host_mem_available_fraction()
                low_mem = mem is not None and mem < MEM_HEADROOM_FRACTION
                disk = disk_free_fraction(headroom_path) if headroom_path else None
                low_disk = disk is not None and disk < DISK_HEADROOM_FRACTION
                if not (over or low_mem or low_disk):
                    break
                waited = True
                writes.pop(0).result()
            if waited:
                backpressure["waits"] += 1
            with lock:
                inflight["bytes"] += nbytes

        def wait_for_headroom(resource: str) -> None:
            """Up to ``degrade_wait_s`` for the exhausted resource to
            recover before a re-attempt; returns at once on a healthy (or
            unmeasurable) host."""
            deadline_t = time.monotonic() + max(0.0, degrade_wait_s)
            while time.monotonic() < deadline_t:
                if resource == "enospc":
                    frac = disk_free_fraction(headroom_path) if headroom_path else None
                    if frac is None or frac > DISK_HEADROOM_FRACTION:
                        return
                else:
                    frac = host_mem_available_fraction()
                    if frac is None or frac > MEM_HEADROOM_FRACTION:
                        return
                time.sleep(min(0.2, max(0.01, degrade_wait_s / 20.0)))

        def add(key: str, dt: float) -> None:
            with lock:
                stats[key] += dt

        def note_dispatch(n_blocks: int, rb=None) -> None:
            """One call to the device: ``n_blocks`` blocks, ``rb`` the
            ragged batch it ran."""
            with lock:
                counts["n_dispatches"] += 1
                counts["batches_dispatched"] += 1
                counts["blocks_dispatched"] += int(n_blocks)
                if rb is not None:
                    counts["ragged_batches"] += 1
                    counts["lanes_padded"] += rb.lanes_padded
                    counts["pages_in_use"] += rb.pages_in_use

        # -- failure bookkeeping (the reference's records) -------------------
        def note_failure(block, site, attempts, error, quarantine, resource=None):
            if quarantine or error is not None:
                trace_mod.instant(f"fault:{site}", block=int(block.block_id), task=task_name,
                                  quarantined=bool(quarantine), resource=resource)
            with lock:
                rec = failures.setdefault(int(block.block_id), {
                    "block_id": int(block.block_id), "sites": {}, "error": None,
                    "quarantined": False, "resolved": True,
                })
                rec["sites"][site] = rec["sites"].get(site, 0) + int(attempts)
                if error is not None:
                    rec["error"] = error
                if resource is not None:
                    # the resource class steers the degrade ladder and is
                    # counted per class
                    rec["resource"] = resource
                    rec["sites"][resource] = rec["sites"].get(resource, 0) + 1
                if quarantine:
                    rec["quarantined"] = True
                    rec["resolved"] = False
                    quarantined_ids.add(int(block.block_id))

        def mark_resolved(block, resolution=None):
            if resolution is not None:
                trace_mod.instant(resolution, block=int(block.block_id), task=task_name)
            with lock:
                rec = failures.get(int(block.block_id))
                if rec is not None:
                    rec["resolved"] = True
                    if resolution is not None:
                        rec["resolution"] = resolution

        def unsharded_tag(block, resolved_by_fallback):
            """``"degraded:unsharded"`` when the per-block path resolved a
            block whose sharded batch failed (a late sharded primary that
            wins its own commit is no fallback)."""
            if not use_sharded or not resolved_by_fallback:
                return None
            with lock:
                fell = int(block.block_id) in sharded_failed
            return "degraded:unsharded" if fell else None

        def validate(block, out) -> Optional[str]:
            if check_finite:
                err = check_finite_outputs(block, out)
                if err:
                    return err
            return validate_fn(block, out) if validate_fn is not None else None

        # -- the hang defence ------------------------------------------------
        spec_pool: Optional[ThreadPoolExecutor] = None
        spec_futures: List[Future] = []
        watchdog: Optional[Watchdog] = None
        tokens = itertools.count()

        @contextlib.contextmanager
        def watched(block, stage, origin="primary"):
            if watchdog is None:
                yield
                return
            token = next(tokens)
            watchdog.register(token, block_id=int(block.block_id), stage=stage, origin=origin)
            try:
                yield
            finally:
                watchdog.clear(token)

        # each shard's card's dispatch lock, resolved once a sweep
        shard_locks = [dispatch_lock(d) for d in self.devices]

        def exec_single(val, block=None, shard: int = 0):
            """One block through the kernel, alone, on ``shard``'s device:
            inputs to the device, the call and a sync under the card's
            dispatch lock, outputs back as numpy.  With ``block`` this is
            the per-block sweep's own call (the reference's ``batch`` grain,
            with its ``executor.h2d`` and ``executor.d2h`` spans; the compute
            watch of ``block`` starts once the lock is held); without, a
            quarantine, speculation or split call (``per_block`` grain)."""
            device = self.devices[shard]
            # stage clocks on the tracer's clock, measured and never recorded
            clock = trace_mod.begin("executor.h2d")
            nbytes = sum(int(np.asarray(x).nbytes) for x in val)
            with (trace_mod.phase("executor.h2d", task=task_name, nbytes=nbytes, grain="dense")
                  if block is not None else contextlib.nullcontext()):
                inputs = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in val)
            device_pool_mod.record_h2d(nbytes)
            # blocked behind another thread's call on the card: a phase of
            # its own, not the copy's
            waiting = trace_mod.begin("executor.lock_wait", phase=True, task=task_name, lock="dispatch", shard=shard)
            with shard_locks[shard], _on_card(device), (watched(block, "compute") if block is not None
                                                        else contextlib.nullcontext()):
                waited = waiting.end()
                _sync(device)
                h2d_s = clock.end(discard=True)
                clock = trace_mod.begin("executor.dispatch")
                with trace_mod.phase("executor.dispatch", n_blocks=1, task=task_name,
                                     grain="batch" if block is not None else "per_block", shard=shard):
                    out = kernel(*inputs)
                    _sync(device)
                kernel_s = clock.end(discard=True)
            clock = trace_mod.begin("executor.d2h")
            with (trace_mod.phase("executor.d2h", task=task_name, n_blocks=1)
                  if block is not None else contextlib.nullcontext()):
                out = _to_numpy(out)
            d2h_s = clock.end(discard=True)
            device_pool_mod.record_d2h(_tree_nbytes(out))
            note_dispatch(1)
            with lock:
                shard_calls[shard] += 1
            add("h2d_s", h2d_s - waited)
            add("kernel_s", kernel_s)
            add("d2h_s", d2h_s)
            return out

        def issue(block):
            """``load_fn(block)`` (its futures, or its arrays) in the block's
            fault context: ``(value, traceback, resource)``."""
            clock = trace_mod.begin("executor.load")
            try:
                with faults_mod.block_context(int(block.block_id)):
                    return load_fn(block), None, None
            except Exception as e:
                return None, fu.cap_traceback(traceback.format_exc()), classify_resource_error(e)
            finally:
                add("load_s", clock.end(discard=True))

        class _PreIssueFailed(Exception):
            pass

        def load_block(block, issued=None, origin="primary"):
            """The block's inputs as numpy, with the load fault hooks and
            retries; None once quarantined.  The first attempt resolves
            ``issued`` (or takes its error), a retry calls ``load_fn``
            again; a resource error quarantines at once."""
            pre, pre_tb, pre_resource = issued if issued is not None else (None, None, None)
            last_tb, attempts = None, 0
            voxels = int(np.prod(block.outer_shape))
            clock = trace_mod.begin("executor.load")
            try:
                with watched(block, "load", origin), faults_mod.block_context(int(block.block_id)), \
                        trace_mod.phase("executor.load", block=int(block.block_id), origin=origin, task=task_name):
                    for k in range(self.max_retries + 1):
                        attempts = k + 1
                        try:
                            injector.maybe_fail("load", block.block_id, voxels=voxels)
                            injector.maybe_hang("load", block.block_id)
                            if k == 0 and pre_tb is not None:
                                last_tb = pre_tb
                                raise _PreIssueFailed()
                            per = pre if (k == 0 and pre is not None) else load_fn(block)
                            val = tuple(np.asarray(x.result() if hasattr(x, "result") else x) for x in per)
                        except _PreIssueFailed:
                            if pre_resource is not None:
                                note_failure(block, "load", attempts, last_tb, quarantine=True,
                                             resource=pre_resource)
                                return None
                            if k < self.max_retries:
                                time.sleep(self._backoff(k))
                        except Exception as e:
                            last_tb = fu.cap_traceback(traceback.format_exc())
                            resource = classify_resource_error(e)
                            if resource is not None:
                                note_failure(block, "load", attempts, last_tb, quarantine=True, resource=resource)
                                return None
                            if k < self.max_retries:
                                time.sleep(self._backoff(k))
                        else:
                            if attempts > 1:
                                note_failure(block, "load", attempts - 1, None, quarantine=False)
                            return val
            finally:
                add("load_s", clock.end(discard=True))
            note_failure(block, "load", attempts, last_tb, quarantine=True)
            return None

        def compute_site_ok(block) -> bool:
            """The kernel-dispatch fault hook before a block goes to the
            device (this block's share does not fit): an injected error
            quarantines the block and keeps the rest of its batch."""
            try:
                injector.maybe_fail("compute", block.block_id, voxels=int(np.prod(block.outer_shape)))
            except Exception as e:
                note_failure(block, "compute", 1, fu.cap_traceback(traceback.format_exc()), quarantine=True,
                             resource=classify_resource_error(e))
                return False
            return True

        # -- completion ------------------------------------------------------
        def register_lineage(blk):
            """After a verified store, how to recompute this block (load,
            kernel alone, store through the sidecar-recording path), keyed
            by the region the verifier checked.  Best effort."""
            ds = getattr(store_verify_fn, "dataset", None) if store_verify_fn is not None else None
            if ds is None or store_fn is None:
                return
            bb_of = getattr(store_verify_fn, "bb_of", None) or (lambda b: b.bb)

            def recompute(b=blk):
                with faults_mod.block_context(int(b.block_id)):
                    val = tuple(np.asarray(x.result() if hasattr(x, "result") else x) for x in load_fn(b))
                    out = exec_single(val)
                    err = validate(b, out)
                    if err is not None:
                        raise RuntimeError(f"lineage recompute of block {b.block_id} failed validation: {err}")
                    store_fn(b, out)

            try:
                from . import repair as repair_mod

                repair_mod.register_producer(ds, bb_of(blk), recompute, task=task_name, block_id=int(blk.block_id),
                                             failures_path=failures_path)
            except Exception:
                pass

        def finish_block(blk):
            """Completion side effects (lineage, marker, the block_done kill
            point) at most once a block: with speculation two copies can
            both end well."""
            with lock:
                if int(blk.block_id) in finished_ids:
                    return
                finished_ids.add(int(blk.block_id))
            register_lineage(blk)
            if on_block_done is not None:
                on_block_done(blk)
            injector.kill_point("block_done")

        def handle_output(blk, block_out, origin="primary"):
            """Injected corruption, validation, duplicate arbitration, store
            with retries and verification, completion.  Never raises: every
            failure is attributed to its block."""
            bid = int(blk.block_id)
            try:
                block_out = injector.corrupt("kernel", blk.block_id, block_out)
                err = validate(blk, block_out)
                if err is not None:
                    note_failure(blk, "validate", 1, err, quarantine=True)
                    return
                if store_fn is None:
                    mark_resolved(blk)
                    finish_block(blk)
                    return
                corrupt_seen = [0]
                dup = {"verdict": None, "digest": None, "contended": False}

                def classify(exc):
                    if isinstance(exc, ChunkCorruptionError):
                        corrupt_seen[0] += 1

                def store_and_verify():
                    # first wins, decided at the last moment before the
                    # write and once (retries reuse it): with the watchdog
                    # armed every copy registers its digest
                    if dup["verdict"] is None:
                        if watchdog is not None:
                            with lock:
                                dup["contended"] = bid in speculated
                            dup["digest"] = array_digest(_leaves(block_out))
                            dup["verdict"] = commits.commit(bid, dup["digest"])
                        else:
                            dup["verdict"] = FirstWins.WIN
                    if dup["verdict"] != FirstWins.WIN:
                        return
                    store_fn(blk, block_out)
                    if store_verify_fn is not None:
                        with trace_mod.phase("executor.store.verify", block=bid, task=task_name):
                            store_verify_fn(blk)

                clock = trace_mod.begin("executor.store")
                with watched(blk, "store", origin), faults_mod.block_context(bid), \
                        trace_mod.phase("executor.store", block=bid, origin=origin, task=task_name):
                    _, attempts, tb, store_resource = self._io_with_retries("store", blk, store_and_verify,
                                                                            on_error=classify)
                add("store_s", clock.end(discard=True))
                if dup["verdict"] == FirstWins.AGREE:
                    # this copy confirms the stored winner bit for bit; when
                    # it is the primary, a per-block duplicate won
                    mark_resolved(blk, unsharded_tag(blk, origin == "primary"))
                    with lock:
                        rec = failures.get(bid)
                        if rec is not None:
                            rec["duplicate"] = "agreed"
                    finish_block(blk)
                    return
                if dup["verdict"] == FirstWins.MISMATCH:
                    note_failure(blk, "determinism", 1,
                                 "speculative duplicate disagreed with the first result (nondeterministic "
                                 "kernel or corrupted data); block left unresolved for recompute",
                                 quarantine=True)
                    return
                if corrupt_seen[0]:
                    # the store "failures" were corruption the verify caught
                    note_failure(blk, "corrupt", corrupt_seen[0], None, quarantine=False)
                if tb is not None:
                    if dup["digest"] is not None:
                        # the claim's store never landed: release it
                        commits.withdraw(bid, dup["digest"])
                    note_failure(blk, "store", attempts, tb, quarantine=True, resource=store_resource)
                    return
                if attempts > 1:
                    note_failure(blk, "store", attempts - 1, None, quarantine=False)
                mark_resolved(blk, unsharded_tag(blk, origin == "speculative"))
                if not dup["contended"]:
                    # a contended winner leaves the marker to the duplicate's
                    # agreement
                    finish_block(blk)
            except Exception:
                note_failure(blk, "hook", 1, fu.cap_traceback(traceback.format_exc()), quarantine=True)

        def store_released(blk, out, nbytes: int) -> None:
            """:func:`handle_output`, then the block's bytes leave the
            admission gate's in-flight count."""
            try:
                handle_output(blk, out)
            finally:
                release(nbytes)

        def speculative_rerun(blk):
            """A hung block's duplicate: a fresh load, the kernel alone on
            the device, a first-wins commit against the original."""
            try:
                with trace_mod.phase("executor.speculate", block=int(blk.block_id), task=task_name):
                    val = load_block(blk, origin="speculative")
                    if val is None:
                        return
                    handle_output(blk, exec_single(val), origin="speculative")
            except Exception:
                note_failure(blk, "speculate", 1, fu.cap_traceback(traceback.format_exc()), quarantine=False)

        if deadline > 0:
            spec_pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="speculate")

            def on_hung(token, info, elapsed):
                bid = int(info["block_id"])
                blk = block_by_id[bid]
                note_failure(blk, "hung", 1, f"block exceeded block_deadline_s={deadline:g}s in stage "
                                             f"{info['stage']} ({elapsed:.2f}s elapsed)", quarantine=True)
                if not speculate or info.get("origin") != "primary":
                    return
                with lock:
                    if use_sharded and info.get("stage") == "compute":
                        # a hung device stalls the whole batch: this block's
                        # recovery is a per-block fallback
                        sharded_failed.add(bid)
                    if bid in speculated:
                        return
                    speculated.add(bid)
                spec_futures.append(spec_pool.submit(scoped(speculative_rerun), blk))

            watchdog = Watchdog(deadline, watchdog_period_s or max(0.02, deadline / 4.0), on_hung).start()

        # -- the sharded path --------------------------------------------------
        host_staged = {"recorded": False}

        def to_dev(arrays, device):
            return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]

        def stage_ragged(rb, device, block_id):
            """One ragged batch's page pools on ``device``'s card, with its
            page tables and valid extents (host arrays, every lane): through
            the card's resident page pool when it is on (pages already on
            the card are re-addressed, not re-sent), else from the host.
            Pool exhaustion stages this batch from the host
            (``degraded:host_staged``, recorded once a sweep)."""
            if dev_pool is not None:
                try:
                    sb = dev_pool.stage(rb, device, block_id=block_id)
                except device_pool_mod.DevicePoolExhausted as e:
                    device_pool_mod.bump("host_staged_fallbacks")
                    trace_mod.instant("degraded:host_staged", task=task_name, block=int(block_id))
                    with lock:
                        first = not host_staged["recorded"]
                        host_staged["recorded"] = True
                    if first and failures_path:
                        fu.record_failures(failures_path, f"{task_name}.device_pool", [{
                            "block_id": None, "sites": {"h2d": 1}, "error": fu.cap_traceback(str(e)),
                            "quarantined": False, "resolved": True, "resolution": "degraded:host_staged",
                        }])
                else:
                    return sb.pools, sb.tables, sb.valids, sb.specs
            nbytes = sum(int(p.nbytes) for p in rb.pools)
            with trace_mod.phase("executor.h2d", task=task_name, nbytes=nbytes, grain="ragged"):
                pools = to_dev(rb.pools, device)
            device_pool_mod.record_h2d(nbytes)
            return pools, rb.tables, rb.valids, rb.specs

        # the card of the sharded call that failed last
        failed_card: List[Optional[torch.device]] = [None]

        def run_card(batch, rb, payload, group):
            """The shards of one card that hold a real lane of ``batch``, in
            turn: each shard's sub-batch to the card, the sweep and a sync
            under the card's dispatch lock (its blocks' compute watched), its
            outputs back.  With a ragged batch the card's page pools are
            staged once for every lane, and the card's arenas stay locked
            until its last shard has gathered its lanes.  Returns ``[(shard,
            outputs, rung)]``."""
            device = self.devices[group[0][0]]
            results = []
            pool_wait = (trace_mod.begin("executor.lock_wait", phase=True, task=task_name, lock="device_pool")
                         if dev_pool is not None and rb is not None else None)
            with _on_card(device), (dev_pool.lock_for(device) if dev_pool is not None and rb is not None
                                    else contextlib.nullcontext()):
                if pool_wait is not None:
                    pool_wait.end()
                # a ragged batch's staging counts to its card's first
                # shard's h2d (stage clocks as in exec_single)
                clock = trace_mod.begin("executor.h2d")
                if rb is not None:
                    pools, tables, valids, specs = stage_ragged(rb, device, batch[0].block_id)
                for shard, lanes in group:
                    real = batch[lanes]
                    if rb is not None:
                        # the shard's lanes of the page tables and valid
                        # extents; the pools are the batch's, on its card
                        tabs, vals = [t[lanes] for t in tables], [v[lanes] for v in valids]
                        inputs = (pools, to_dev(tabs, device), to_dev(vals, device), specs)
                        device_pool_mod.record_h2d(sum(int(a.nbytes) for a in tabs + vals))
                    else:
                        arrays = [a[lanes] for a in payload]
                        nbytes = sum(int(a.nbytes) for a in arrays)
                        with trace_mod.phase("executor.h2d", task=task_name, grain="dense", nbytes=nbytes,
                                             shard=shard):
                            inputs = tuple(to_dev(arrays, device))
                        device_pool_mod.record_h2d(nbytes)
                    waiting = trace_mod.begin("executor.lock_wait", phase=True, task=task_name, lock="dispatch",
                                              shard=shard)
                    with shard_locks[shard], contextlib.ExitStack() as stack:
                        waited = waiting.end()
                        span_args = dict(task=task_name, n_blocks=len(real), shard=shard,
                                         grain="ragged" if rb is not None else "sharded")
                        if rb is not None:
                            span_args["lanes_padded"] = rb.lanes_padded
                        for blk in real:
                            stack.enter_context(watched(blk, "compute"))
                        _sync(device)
                        h2d_s = clock.end(discard=True)
                        clock = trace_mod.begin("executor.dispatch")
                        with trace_mod.phase("executor.dispatch", **span_args):
                            if rb is not None:
                                out, rung = ragged_sweep(kernel, *inputs)
                            else:
                                out, rung = batched_sweep(kernel, inputs)
                            # the lanes are gathered before the pool stages again
                            _sync(device)
                        kernel_s = clock.end(discard=True)
                    clock = trace_mod.begin("executor.d2h")
                    with trace_mod.phase("executor.d2h", task=task_name, n_blocks=len(real), shard=shard):
                        out = _to_numpy(out)
                    d2h_s = clock.end(discard=True)
                    device_pool_mod.record_d2h(_tree_nbytes(out))
                    add("h2d_s", h2d_s - waited)
                    add("kernel_s", kernel_s)
                    add("d2h_s", d2h_s)
                    with lock:
                        shard_calls[shard] += 1
                    results.append((shard, out, rung))
                    clock = trace_mod.begin("executor.h2d")
            return results

        def run_batch(batch, kind, payload):
            """One sharded call: the batch-grain fault site, then the batch
            split into ``n_devices`` equal sub-batches in lane order, each
            shard's run on its device (the cards in parallel, one thread
            each; the shards of one card in turn), and the outputs gathered
            back in lane order.  Shards whose lanes are all padding do not
            run.  Returns ``(outputs, rung, rb)``."""
            rb = payload if kind == "ragged" else None
            # the batch-grain fault site: a device OOM or a wedged device
            # takes the whole sharded call down, every shard of it
            with contextlib.ExitStack() as stack:
                for blk in batch:
                    stack.enter_context(watched(blk, "compute"))
                injector.maybe_fail("dispatch", batch[0].block_id,
                                    voxels=sum(int(np.prod(b.outer_shape)) for b in batch))
                injector.maybe_hang("dispatch", batch[0].block_id)
            groups: Dict[str, list] = {}
            for shard, lanes in enumerate(shard_lanes(bs, self.n_devices)):
                if lanes.start < len(batch):
                    groups.setdefault(card_key(self.devices[shard]), []).append((shard, lanes))
            futures = [card_pool.submit(scoped(run_card), batch, rb, payload, g) for g in groups.values()]
            # every card finishes before the batch is judged; the OOM ladder
            # frees the first card that failed
            errors = [f.exception() for f in futures]
            for group, e in zip(groups.values(), errors):
                if e is not None:
                    failed_card[0] = self.devices[group[0][0]]
                    raise e
            per_card = [f.result() for f in futures]
            results = sorted((r for card in per_card for r in card), key=lambda r: r[0])
            out = concat_lanes([r[1] for r in results])
            if rb is not None:
                rb.release()
            return out, results[0][2], rb

        bs = sharded_width if use_sharded else self.batch_size
        # one thread a card runs that card's shards of a sharded batch
        card_pool = (ThreadPoolExecutor(max_workers=len({card_key(d) for d in self.devices}),
                                        thread_name_prefix="card") if use_sharded else None)

        def load_batch(batch):
            """Load one batch: ``(blocks, kind, payload, vals)``, ``kind``
            routing the dispatch: ``"per_block"`` (the per-block path),
            ``"dense"`` (stacked arrays), ``"ragged"`` (a packed
            :class:`~..parallel.block_pool.RaggedBatch`), ``"mixed"``
            (lanes the pool could not pack) or ``"empty"``."""
            if not use_sharded:
                # every read of the batch is issued before any is resolved
                issued = [issue(b) for b in batch]
                ok, vals = [], []
                for b, i in zip(batch, issued):
                    val = load_block(b, i)
                    if val is not None and compute_site_ok(b):
                        ok.append(b)
                        vals.append(val)
                return ok, "per_block", None, vals
            # a batch's blocks load in parallel on their own pool (this
            # thread is one of the sweep pool's, which runs the stores)
            issued = list(block_loader.map(scoped(issue), batch))
            ok, vals = [], []
            for b, val in zip(batch, block_loader.map(scoped(load_block), batch, issued)):
                if val is not None and compute_site_ok(b):
                    ok.append(b)
                    vals.append(val)
            if not ok:
                return ok, "empty", None, vals
            n_args = len(vals[0])
            uniform = all(len({v[i].shape for v in vals}) == 1 for i in range(n_args))
            full = len(vals) == bs
            if use_ragged and (not uniform or not full or ragged == "on"):
                # a partial batch, mixed-shape lanes or a forced ragged sweep:
                # one paged call; padding lanes are dropped after it
                try:
                    return ok, "ragged", ragged_pool.pack(vals, bs, page_shape=page_shape), vals
                except ValueError:
                    if not uniform:
                        return ok, "mixed", None, vals
            if not uniform:
                return ok, "mixed", None, vals
            # pad a partial batch by repeating its last block; the padded
            # outputs are dropped
            padded = vals + [vals[-1]] * (bs - len(vals))
            return ok, "dense", tuple(np.stack([v[i] for v in padded]) for i in range(n_args)), vals

        def run_mixed(batch, vals, nbytes):
            """Lanes neither the dense nor the ragged call can take, one by
            one through the kernel (``degraded:unsharded``)."""
            try:
                for blk, val in zip(batch, vals):
                    note_failure(blk, "pack", 1, "mixed-shape lanes with the ragged pool unavailable; executed "
                                                 "per block", quarantine=True)
                    with lock:
                        sharded_failed.add(int(blk.block_id))
                    try:
                        out = exec_single(val, blk)
                    except Exception:
                        note_failure(blk, "compute", 1, fu.cap_traceback(traceback.format_exc()), quarantine=True)
                        continue
                    handle_output(blk, out)
                    with lock:
                        rec = failures.get(int(blk.block_id))
                        done_ok = bool(rec and rec["resolved"])
                    if done_ok:
                        mark_resolved(blk, "degraded:unsharded")
            finally:
                release(nbytes)

        def dispatch_sharded(batch, kind, payload, vals, writes: List[Future]) -> List[Future]:
            sizes = [_tree_nbytes(v) for v in vals]
            admit(sum(sizes), writes)
            if kind == "mixed":
                return [pool.submit(scoped(run_mixed), batch, vals, sum(sizes))]
            try:
                out, rung, rb = run_batch(batch, kind, payload)
            except Exception as e:
                # a failed sharded call (on any shard) quarantines the whole
                # batch; the quarantine pass runs its blocks alone
                # (degraded:unsharded)
                tb = fu.cap_traceback(traceback.format_exc())
                resource = classify_resource_error(e)
                failed_on, failed_card[0] = failed_card[0], None
                if resource == "oom" and failed_on is not None:
                    # the OOM ladder frees the card that failed: its
                    # resident arenas, then its cached blocks
                    if dev_pool is not None:
                        dev_pool.evict_all(failed_on)
                    if failed_on.type == "cuda":
                        with torch.cuda.device(failed_on):
                            torch.cuda.empty_cache()
                for blk in batch:
                    note_failure(blk, "dispatch", 1, tb, quarantine=True, resource=resource)
                with lock:
                    sharded_failed.update(int(b.block_id) for b in batch)
                release(sum(sizes))
                return []
            note_dispatch(len(batch), rb)
            batch_rungs.append(rung)
            crop = rb.crop if rb is not None else None
            return [pool.submit(scoped(store_released), blk, _lane(out, j, crop), sizes[j])
                    for j, blk in enumerate(batch)]

        # -- the degrade ladder: sub-blocks ------------------------------------
        split_stats = {"splits": 0, "max_depth": 0, "sub_blocks": 0}

        def load_sub(sub):
            """``("ok", val)``, ``("recurse", None)`` (a resource error: split
            deeper) or ``("fail", None)`` (attributed)."""
            voxels = int(np.prod(sub.outer_shape))
            val, last_tb = None, None
            for k in range(self.max_retries + 1):
                try:
                    injector.maybe_fail("load", sub.block_id, voxels=voxels)
                    injector.maybe_hang("load", sub.block_id)
                    val = tuple(np.asarray(x.result() if hasattr(x, "result") else x) for x in load_fn(sub))
                    break
                except Exception as e:
                    last_tb = fu.cap_traceback(traceback.format_exc())
                    if classify_resource_error(e) is not None:
                        return "recurse", None
                    if k < self.max_retries:
                        time.sleep(self._backoff(k))
            if val is None:
                note_failure(sub, "load", 1, last_tb, quarantine=True)
                return "fail", None
            return "ok", val

        def store_sub(sub, out, depth, tracker):
            """Validate and store (and verify) one sub-block's output with
            retries; a resource error waits for headroom and splits deeper."""
            voxels = int(np.prod(sub.outer_shape))
            err = validate(sub, out)
            if err is not None:
                note_failure(sub, "validate", 1, err, quarantine=True)
                return False
            if store_fn is None:
                return True
            last_tb = None
            for k in range(self.max_retries + 1):
                try:
                    injector.maybe_fail("store", sub.block_id, voxels=voxels)
                    injector.maybe_hang("store", sub.block_id)
                    store_fn(sub, out)
                    if store_verify_fn is not None:
                        store_verify_fn(sub)
                    return True
                except Exception as e:
                    last_tb = fu.cap_traceback(traceback.format_exc())
                    resource = classify_resource_error(e)
                    if resource is not None:
                        wait_for_headroom(resource)
                        return split_and_run(sub, depth + 1, tracker)
                    if k < self.max_retries:
                        time.sleep(self._backoff(k))
            note_failure(sub, "store", 1, last_tb, quarantine=True)
            return False

        def run_sub(sub, depth, tracker):
            """One sub-block through load, kernel, validation and store; a
            resource error at any stage splits one level deeper.  Failures
            are attributed to the parent's id (sub-blocks carry it)."""
            with faults_mod.block_context(int(sub.block_id)):
                status, val = load_sub(sub)
                if status == "recurse":
                    return split_and_run(sub, depth + 1, tracker)
                if status == "fail":
                    return False
                try:
                    injector.maybe_fail("compute", sub.block_id, voxels=int(np.prod(sub.outer_shape)))
                    out = exec_single(val)
                except Exception as e:
                    tb = fu.cap_traceback(traceback.format_exc())
                    if classify_resource_error(e) is not None:
                        return split_and_run(sub, depth + 1, tracker)
                    note_failure(sub, "compute", 1, tb, quarantine=True)
                    return False
                return store_sub(sub, out, depth, tracker)

        def split_and_run(blk, depth=1, tracker=None):
            """The recursive 2^d split of ``blk``; True when every sub-block
            landed.  ``tracker`` records the depth this parent reached."""
            subs = split_block(blk, halo=split_halo, min_shape=min_block_shape)
            if subs is None:
                note_failure(blk, "split", 1, "resource exhaustion persisted at "
                                              f"min_block_shape={tuple(min_block_shape or ())} — cannot split "
                                              "further", quarantine=True)
                return False
            split_stats["splits"] += 1
            split_stats["max_depth"] = max(split_stats["max_depth"], depth)
            split_stats["sub_blocks"] += len(subs)
            if tracker is not None:
                tracker["depth"] = max(tracker.get("depth", 0), depth)
            # stops at the first sub-block that fails, as the reference's
            # per-block rung does
            return all(run_sub(sub, depth, tracker) for sub in subs)

        # -- the sweep ----------------------------------------------------------
        drained = False
        degraded_ids: set = set()
        batches = [blocks[i:i + bs] for i in range(0, len(blocks), bs)]
        block_loader = ThreadPoolExecutor(max_workers=self.io_threads) if use_sharded else None
        try:
            with ThreadPoolExecutor(max_workers=self.io_threads) as pool, \
                    block_loader if block_loader is not None else contextlib.nullcontext():
                pending: List[Future] = [pool.submit(scoped(load_batch), b) for b in batches[:prefetch]]
                writes: List[Future] = []
                for i in range(len(batches)):
                    if drain_requested():
                        # stop claiming batches; the running loads and
                        # stores finish below
                        drained = True
                        break
                    # the wait span is the dispatch_wait_s clock; sub-100us
                    # waits are counted but not recorded
                    wait_span = trace_mod.begin("executor.batch_wait", phase=True, task=task_name, batch=i)
                    batch, kind, payload, vals = pending.pop(0).result()
                    waited = wait_span.end(discard=True)
                    if waited > 1e-4:
                        wait_span.end()
                    counts["dispatch_wait_s"] += waited
                    if i + prefetch < len(batches):
                        pending.append(pool.submit(scoped(load_batch), batches[i + prefetch]))
                    if not batch:
                        continue
                    if use_sharded:
                        writes.extend(dispatch_sharded(batch, kind, payload, vals, writes))
                    else:
                        # the blocks of a batch are dealt over the shards as
                        # a sharded batch's lanes are, one call a block
                        lane = {int(b.block_id): j for j, b in enumerate(batches[i])}
                        for block, val in zip(batch, vals):
                            nbytes = _tree_nbytes(val)
                            admit(nbytes, writes)
                            shard = (lane[int(block.block_id)] // self.device_batch) % self.n_devices
                            try:
                                out = exec_single(val, block, shard)
                            except Exception as e:
                                note_failure(block, "compute", 1, fu.cap_traceback(traceback.format_exc()),
                                             quarantine=True, resource=classify_resource_error(e))
                                release(nbytes)
                                continue
                            writes.append(pool.submit(scoped(store_released), block, out, nbytes))
                    # bounded store window: each pending store holds a block's outputs
                    while len(writes) > 2 * bs:
                        writes.pop(0).result()
                for f in pending:
                    f.result()
                for f in writes:
                    f.result()

            # settle the duplicates before judging what is unresolved (the
            # list grows while a primary stuck past its deadline fires)
            i_spec = 0
            while i_spec < len(spec_futures):
                spec_futures[i_spec].result()
                i_spec += 1
            if watchdog is not None:
                watchdog.stop()
            if spec_pool is not None:
                spec_pool.shutdown(wait=True)

            # -- the quarantine pass and the degrade ladder ----------------------
            with lock:
                unresolved_q = {b for b in quarantined_ids if not failures[b]["resolved"]}
            for blk in [b for b in blocks if int(b.block_id) in unresolved_q]:
                if drained or drain_requested():
                    drained = True
                    break
                bid = int(blk.block_id)
                with lock:
                    resource = failures[bid].get("resource")
                if resource is not None:
                    degraded_ids.add(bid)
                    wait_for_headroom(resource)
                val = load_block(blk)
                if val is not None:
                    out = None
                    try:
                        injector.maybe_fail("compute", blk.block_id, voxels=int(np.prod(blk.outer_shape)))
                        out = exec_single(val)
                    except Exception as e:
                        note_failure(blk, "compute", 1, fu.cap_traceback(traceback.format_exc()), quarantine=True,
                                     resource=classify_resource_error(e))
                    if out is not None:
                        handle_output(blk, out)
                with lock:
                    rec = failures[bid]
                    resolved_now = rec["resolved"]
                    resource = rec.get("resource")
                    fell_back = bid in sharded_failed
                if resolved_now:
                    if fell_back:
                        mark_resolved(blk, "degraded:unsharded")
                    elif resource is not None:
                        mark_resolved(blk, "degraded:backpressure")
                    continue
                if resource is not None and splittable:
                    tracker = {"depth": 0}
                    if split_and_run(blk, tracker=tracker):
                        mark_resolved(blk, "degraded:split")
                        with lock:
                            failures[bid]["split_depth"] = tracker["depth"]
                        finish_block(blk)
        finally:
            # the watchdog, the duplicates and the card threads never outlive
            # the sweep
            if card_pool is not None:
                card_pool.shutdown(wait=True)
            if watchdog is not None:
                watchdog.stop()
            if spec_pool is not None:
                spec_pool.shutdown(wait=True)
            _record_dispatch_metrics(
                counts, sweep_span.end(n_batches=counts["batches_dispatched"], n_quarantined=len(quarantined_ids)))

        unresolved = sorted(b for b, rec in failures.items() if not rec["resolved"])
        if failures_path and failures:
            fu.record_failures(failures_path, task_name, [failures[b] for b in sorted(failures)])
        if drained:
            # what ran is stored and marked; the rest is the resumed run's
            reason = drain_reason() or "drain requested"
            remaining = sorted(int(b.block_id) for b in blocks if int(b.block_id) not in finished_ids)
            if failures_path:
                fu.record_failures(failures_path, f"{task_name}.drain", [{
                    "block_id": None, "sites": {"preempt": 1}, "error": reason, "quarantined": False,
                    "resolved": True, "resolution": "requeued:preempt", "remaining_blocks": len(remaining),
                }])
            raise DrainInterrupt(reason, remaining)
        if unresolved:
            details = "\n".join(f"-- block {b} (sites {failures[b]['sites']}) --\n{failures[b]['error']}"
                                for b in unresolved[:5])
            raise RuntimeError(
                f"{task_name}: {len(unresolved)}/{len(blocks)} blocks failed permanently after retries "
                f"and a quarantine re-attempt (ids: {unresolved})"
                + (f"; see {failures_path}" if failures_path else "") + f"; first errors:\n{details}"
            )
        dev = device_pool_mod.delta(dev_snap)
        summary = {
            "n_blocks": len(blocks), "n_quarantined": len(quarantined_ids), "n_failed": 0,
            "sweep_mode": "sharded" if use_sharded else "per_block", **stats, **counts,
            "n_devices": self.n_devices, "shard_calls": shard_calls,
            "n_unsharded": len(sharded_failed),
            **{k: int(dev[k]) for k in ("h2d_bytes", "d2h_bytes", "device_pool_hits", "device_pool_misses",
                                        "device_pool_evictions", "host_staged_fallbacks")},
            "device_pool": "on" if dev_pool is not None else "off",
            "device_pool_resident_bytes": dev_pool.resident_bytes() if dev_pool is not None else 0,
            "inflight_byte_budget": budget, "n_backpressure_waits": backpressure["waits"],
            "n_degraded": len(degraded_ids), "n_split": split_stats["splits"],
            "n_sub_blocks": split_stats["sub_blocks"], "split_depth": split_stats["max_depth"],
        }
        if deadline > 0:
            summary["n_hung"] = sum(1 for rec in failures.values() if "hung" in rec["sites"])
            summary["n_speculated"] = len(speculated)
        if use_sharded:
            summary["sharded_batch"] = bs
            summary["batch_rungs"] = batch_rungs
        return summary
