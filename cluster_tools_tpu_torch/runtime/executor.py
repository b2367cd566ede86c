"""Blockwise executor: a per-block kernel over a list of blocks, with
prefetching IO, retries and a failure manifest.

Port of ``cluster_tools_tpu/runtime/executor.py::BlockwiseExecutor.map_blocks``
on one device.  Two sweep shapes, bit-identical to each other:

- **per block** (``sweep_mode="per_block"``): ``load_fn(block)`` on an IO
  thread pool, ``prefetch`` batches ahead; the inputs to the task's device
  and ``kernel(*inputs)`` there, one block a call; the outputs back to
  numpy, ``check_finite`` and ``validate_fn``; ``store_fn(block,
  outputs)`` on the IO pool, then ``on_block_done``.
- **sharded** (``"sharded"``, and ``"auto"`` once the sweep fills one
  batch of ``sharded_batch`` blocks, as in the reference): the blocks of a
  Morton batch go to the device as one stacked copy and run as one call of
  :func:`~..parallel.batch_shard.batched_sweep` (the kernel's lane-batched
  form, ``kernel.batched``, when it has one; else each lane in turn), with
  one sync and one copy back.  A partial or mixed-shape batch packs
  through the ragged paged pool (:mod:`..parallel.block_pool`,
  ``ragged``), staged through the device-resident page pool
  (:mod:`..parallel.device_pool`, ``device_pool``) when that is on.

Loads and stores retry with capped exponential backoff; a block whose
load, kernel, validation or store still fails is quarantined and re-run
once, alone, after the sweep (a block that failed for want of memory or
disk first waits up to ``degrade_wait_s`` for headroom,
``degraded:backpressure``).  A sharded batch whose call raises
``torch.OutOfMemoryError`` re-runs its blocks one by one through the same
kernel (``degraded:unsharded``); any other error quarantines its blocks as
on the per-block path.  Every failure lands in ``failures.json`` and a
RuntimeError names every block still failed at the end.  A kernel error is
never answered by running another implementation.

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

Not ported (ROADMAP Queue A item 11), and refused when asked for: the
hung-block watchdog and speculation (``block_deadline_s``),
degrade-and-split (``splittable=True``) and post-store checksum
verification (``store_verify_fn``).
"""

from __future__ import annotations

import contextlib
import errno
import os
import threading
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..io import chunk_cache as chunk_cache_mod
from ..parallel import block_pool as block_pool_mod
from ..parallel import device_pool as device_pool_mod
from ..parallel.batch_shard import batched_sweep, ragged_sweep, resolve_sharded_batch, use_sharded_sweep
from ..utils import function_utils as fu
from ..utils.volume_utils import Block
from . import handoff as handoff_mod
from .supervision import disk_free_fraction, host_mem_available_bytes, host_mem_available_fraction

TARGET_DEVICES = {"local": "cpu", "gpu": "cuda"}
# the admission gate's floors: host memory available, and disk free under
# the failure manifest, as fractions of their totals
MEM_HEADROOM_FRACTION = 0.05
DISK_HEADROOM_FRACTION = 0.02


def target_device(target: str) -> torch.device:
    """``local`` -> the CPU, ``gpu`` -> the card (raises without one)."""
    if target not in TARGET_DEVICES:
        raise ValueError(f"unknown target {target!r}, expected one of {sorted(TARGET_DEVICES)}")
    return resolve_device(TARGET_DEVICES[target])


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


def _refuse(what: str, item: int) -> None:
    raise NotImplementedError(f"{what} is not ported: ROADMAP Queue A item {item}")


def sweep_config(cfg) -> Dict[str, Any]:
    """The ``map_blocks`` knobs a blockwise task takes from its config."""
    return dict(
        schedule=str(cfg.get("block_schedule") or "morton"),
        sweep_mode=str(cfg.get("sweep_mode") or "auto"),
        sharded_batch=cfg.get("sharded_batch"),
        ragged=str(cfg.get("ragged") or "auto"),
        device_pool=str(cfg.get("device_pool") or "auto"),
        device_pool_bytes=cfg.get("device_pool_bytes"),
        block_deadline_s=cfg.get("block_deadline_s"),
        splittable=bool(cfg.get("allow_block_split")),
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


class BlockwiseExecutor:
    """Run a per-block kernel over blocks on the device of ``target``.

    ``load_fn(block)`` returns the kernel's input arrays (numpy, already
    padded to one shape) or futures of them; ``kernel(*tensors)`` gets them
    as tensors on the device and returns a tensor or a tuple of tensors and
    flags; ``store_fn(block, outputs)`` persists one block's outputs as
    numpy.
    """

    def __init__(self, target: str = "gpu", device_batch: int = 1, io_threads: int = 8,
                 max_retries: int = 2, backoff_base: float = 0.05, backoff_max: float = 5.0):
        self.target = target
        self.device = target_device(target)
        self.device_batch = max(1, int(device_batch))
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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _retry(self, fn: Callable) -> Tuple[Any, int, Optional[str], Optional[str]]:
        """``(value, attempts, traceback or None, resource class or None)``
        of ``fn`` with retries (:func:`classify_resource_error` of the last
        error)."""
        last_tb, resource = None, None
        for k in range(self.max_retries + 1):
            try:
                return fn(), k + 1, None, None
            except Exception as e:
                last_tb = fu.cap_traceback(traceback.format_exc())
                resource = classify_resource_error(e)
                if k < self.max_retries:
                    time.sleep(fu.backoff_delay(k, self.backoff_base, self.backoff_max))
        return None, self.max_retries + 1, last_tb, resource

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
        store_verify_fn: Optional[Callable[[Block], None]] = None,
        splittable: bool = False,
        degrade_wait_s: float = 5.0,
        inflight_byte_budget: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Execute ``kernel`` over ``blocks``; see the module docstring.

        ``done_block_ids`` are skipped (marker resume).  ``schedule``:
        ``"morton"`` (default) or ``"given"`` order; blocks are independent,
        so the order never changes results.

        ``sweep_mode``: ``"per_block"``, ``"sharded"`` or ``"auto"`` (sharded
        once the sweep fills one batch, the reference's rule on one
        device).  ``sharded_batch``: blocks per sharded call (None:
        ``max(2 * device_batch, 8)``).  ``ragged`` (sharded path only):
        ``"auto"`` packs partial and mixed-shape batches through the paged
        block pool, ``"on"`` packs every batch, ``"off"`` pads a partial
        batch by repeating its last block (the padded outputs are dropped)
        and runs mixed shapes per block.  ``page_shape`` overrides the
        pool's page tile for mixed-shape batches.  ``device_pool``
        (``"auto"``/``"on"``/``"off"``) stages ragged batches through the
        resident device page pool (``CTT_DEVICE_POOL=0`` switches it off);
        ``device_pool_bytes`` is its budget.

        ``inflight_byte_budget`` drives the admission gate (module
        docstring); ``degrade_wait_s`` bounds the headroom wait before a
        resource-starved block's re-attempt.

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
        ``device_pool_resident_bytes``), and on the sharded path the rung
        each batch ran (``batch_rungs``: ``"batched"`` or ``"lanes"``).
        """
        if block_deadline_s:
            _refuse("block_deadline_s (the hung-block watchdog and speculation)", 11)
        if splittable:
            _refuse("splittable=True (degrade and split)", 11)
        if store_verify_fn is not None:
            _refuse("store_verify_fn (post-store checksum verification)", 11)
        if done_block_ids:
            done = {int(b) for b in done_block_ids}
            blocks = [b for b in blocks if int(b.block_id) not in done]
        if schedule == "morton":
            blocks = morton_order(blocks)
        elif schedule not in ("given", None):
            raise ValueError(f"unknown schedule {schedule!r} (expected 'morton' or 'given')")
        sharded_width = resolve_sharded_batch(1, self.device_batch, sharded_batch)
        use_sharded = use_sharded_sweep(sweep_mode, 1, len(blocks), sharded_width)
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

        dev_snap = device_pool_mod.snapshot()
        counts = {"n_dispatches": 0, "n_unsharded": 0, "batches_dispatched": 0, "blocks_dispatched": 0,
                  "dispatch_wait_s": 0.0, "ragged_batches": 0, "lanes_padded": 0, "pages_in_use": 0}
        batch_rungs: List[str] = []
        failures: Dict[int, Dict[str, Any]] = {}
        sharded_failed: set = set()
        lock = threading.Lock()

        # -- the admission gate (reference executor.py:1610-1690) ------------
        # in flight = loaded but not yet stored; the budget caps it
        if inflight_byte_budget is None:
            avail = host_mem_available_bytes()
            budget = int(avail * 0.25) if avail else 0
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
            deadline = time.monotonic() + max(0.0, degrade_wait_s)
            while time.monotonic() < deadline:
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

        def note_failure(block, site, attempts, error, quarantine, resource=None):
            with lock:
                rec = failures.setdefault(int(block.block_id), {
                    "block_id": int(block.block_id), "sites": {}, "error": None,
                    "quarantined": False, "resolved": True,
                })
                rec["sites"][site] = rec["sites"].get(site, 0) + int(attempts)
                if error is not None:
                    rec["error"] = error
                if resource is not None:
                    rec["resource"] = resource
                if quarantine:
                    rec["quarantined"] = True
                    rec["resolved"] = False

        def issue(block):
            """``load_fn(block)`` (its futures, or its arrays) and the error
            it raised, one of them None."""
            t0 = time.perf_counter()
            try:
                return load_fn(block), None
            except Exception as e:
                return None, e
            finally:
                add("load_s", time.perf_counter() - t0)

        def load_block(block, issued=None):
            """The block's inputs as numpy, with retries: the first attempt
            resolves ``issued`` (or raises its error), a retry calls
            ``load_fn`` again."""
            pending = [issued]

            def attempt():
                pre, pending[0] = pending[0], None
                if pre is None:
                    per = load_fn(block)
                else:
                    per, exc = pre
                    if exc is not None:
                        raise exc
                return tuple(np.asarray(x.result() if hasattr(x, "result") else x) for x in per)

            t0 = time.perf_counter()
            val, attempts, tb, resource = self._retry(attempt)
            add("load_s", time.perf_counter() - t0)
            if tb is not None:
                note_failure(block, "load", attempts, tb, quarantine=True, resource=resource)
                return None
            if attempts > 1:
                note_failure(block, "load", attempts - 1, None, quarantine=False)
            return val

        def run_kernel(val):
            """Inputs to the device, the kernel, outputs back as numpy."""
            t0 = time.perf_counter()
            inputs = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(self.device) for x in val)
            device_pool_mod.record_h2d(sum(int(x.nbytes) for x in val))
            self._sync()
            t1 = time.perf_counter()
            out = kernel(*inputs)
            self._sync()
            t2 = time.perf_counter()
            out = _to_numpy(out)
            t3 = time.perf_counter()
            device_pool_mod.record_d2h(_tree_nbytes(out))
            note_dispatch(1)
            add("h2d_s", t1 - t0)
            add("kernel_s", t2 - t1)
            add("d2h_s", t3 - t2)
            return out

        def handle_output(block, out, resolution: Optional[str] = None) -> None:
            """Validation, store (with retries), completion hooks; never
            raises — every failure is attributed to its block."""
            try:
                err = (check_finite_outputs(block, out) if check_finite else None) or \
                    (validate_fn(block, out) if validate_fn is not None else None)
                if err is not None:
                    note_failure(block, "validate", 1, err, quarantine=True)
                    return
                if store_fn is not None:
                    t0 = time.perf_counter()
                    _, attempts, tb, resource = self._retry(lambda: store_fn(block, out))
                    add("store_s", time.perf_counter() - t0)
                    if tb is not None:
                        note_failure(block, "store", attempts, tb, quarantine=True, resource=resource)
                        return
                    if attempts > 1:
                        note_failure(block, "store", attempts - 1, None, quarantine=False)
                with lock:
                    rec = failures.get(int(block.block_id))
                    if rec is not None:
                        rec["resolved"] = True
                        if resolution is not None:
                            rec["resolution"] = resolution
                            counts["n_unsharded"] += resolution == "degraded:unsharded"
                if on_block_done is not None:
                    on_block_done(block)
            except Exception:
                note_failure(block, "hook", 1, fu.cap_traceback(traceback.format_exc()), quarantine=True)

        def execute(block, val) -> Optional[Any]:
            try:
                return run_kernel(val)
            except Exception as e:
                note_failure(block, "compute", 1, fu.cap_traceback(traceback.format_exc()), quarantine=True,
                             resource=classify_resource_error(e))
                return None

        def store_released(block, out, nbytes: int, resolution: Optional[str] = None) -> None:
            """:func:`handle_output`, then the block's bytes leave the
            admission gate's in-flight count."""
            try:
                handle_output(block, out, resolution)
            finally:
                release(nbytes)

        def run_unsharded(batch, vals, site, error) -> None:
            """The blocks of a batch the sharded call could not take, one by
            one through the same kernel (``degraded:unsharded``)."""
            for blk, val in zip(batch, vals):
                note_failure(blk, site, 1, error, quarantine=True)
                with lock:
                    sharded_failed.add(int(blk.block_id))
                out = execute(blk, val)
                if out is not None:
                    handle_output(blk, out, resolution="degraded:unsharded")

        host_staged = {"recorded": False}

        def stage_ragged(rb):
            """Device pools, tables and valid extents of one ragged batch:
            through the resident page pool when it is on (pages already on
            the device are re-addressed, not re-sent), else from the host.
            Pool exhaustion stages this batch from the host
            (``degraded:host_staged``, recorded once per sweep)."""
            to_dev = lambda arrays: [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays]
            if dev_pool is not None:
                try:
                    sb = dev_pool.stage(rb, self.device)
                except device_pool_mod.DevicePoolExhausted as e:
                    device_pool_mod.bump("host_staged_fallbacks")
                    if not host_staged["recorded"] and failures_path:
                        host_staged["recorded"] = True
                        fu.record_failures(failures_path, f"{task_name}.device_pool", [{
                            "block_id": None, "sites": {"h2d": 1}, "error": fu.cap_traceback(str(e)),
                            "quarantined": False, "resolved": True, "resolution": "degraded:host_staged",
                        }])
                else:
                    device_pool_mod.record_h2d(sum(int(a.nbytes) for a in sb.tables + sb.valids))
                    return sb.pools, to_dev(sb.tables), to_dev(sb.valids), sb.specs
            device_pool_mod.record_h2d(rb.nbytes)
            return to_dev(rb.pools), to_dev(rb.tables), to_dev(rb.valids), rb.specs

        def run_batch(kind, payload):
            """One sharded call: the batch to the device, the sweep, one
            sync, the outputs back.  Returns ``(outputs, rung, rb)``."""
            t0 = time.perf_counter()
            rb = None
            if kind == "dense":
                arrays = payload[0]
                inputs = tuple(torch.from_numpy(a).to(self.device) for a in arrays)
                device_pool_mod.record_h2d(sum(int(a.nbytes) for a in arrays))
                self._sync()
                t1 = time.perf_counter()
                out, rung = batched_sweep(kernel, inputs)
                self._sync()
            else:
                rb = payload[0]
                with dev_pool.lock if dev_pool is not None else contextlib.nullcontext():
                    pools, tables, valids, specs = stage_ragged(rb)
                    self._sync()
                    t1 = time.perf_counter()
                    out, rung = ragged_sweep(kernel, pools, tables, valids, specs)
                    # the lanes are gathered before the pool stages again
                    self._sync()
            t2 = time.perf_counter()
            out = _to_numpy(out)
            t3 = time.perf_counter()
            device_pool_mod.record_d2h(_tree_nbytes(out))
            if rb is not None:
                rb.release()
            add("h2d_s", t1 - t0)
            add("kernel_s", t2 - t1)
            add("d2h_s", t3 - t2)
            return out, rung, rb

        bs = sharded_width if use_sharded else self.device_batch

        def load_batch(batch):
            # every read of the batch is issued before any is resolved
            if not use_sharded:
                issued = [issue(b) for b in batch]
                return [(b, load_block(b, i)) for b, i in zip(batch, issued)]
            # a batch's blocks load in parallel on their own pool (this
            # thread is one of the sweep pool's, which runs the stores)
            issued = list(block_loader.map(issue, batch))
            ok, vals = [], []
            for b, val in zip(batch, block_loader.map(load_block, batch, issued)):
                if val is not None:
                    ok.append(b)
                    vals.append(val)
            if not ok:
                return ok, "empty", None
            n_args = len(vals[0])
            uniform = all(len({v[i].shape for v in vals}) == 1 for i in range(n_args))
            full = len(vals) == bs
            if use_ragged and (not uniform or not full or ragged == "on"):
                # a partial batch, mixed-shape lanes or a forced ragged sweep:
                # one paged call; padding lanes are dropped after it
                try:
                    return ok, "ragged", (ragged_pool.pack(vals, bs, page_shape=page_shape), vals)
                except ValueError:
                    if not uniform:
                        return ok, "mixed", vals
            if not uniform:
                return ok, "mixed", vals
            # pad a partial batch by repeating its last block; the padded
            # outputs are dropped
            padded = vals + [vals[-1]] * (bs - len(vals))
            return ok, "dense", (tuple(np.stack([v[i] for v in padded]) for i in range(n_args)), vals)

        def dispatch_sharded(batch, kind, payload, writes: List[Future]) -> List[Future]:
            vals = payload if kind == "mixed" else payload[1]
            sizes = [_tree_nbytes(v) for v in vals]
            admit(sum(sizes), writes)
            if kind == "mixed":
                try:
                    run_unsharded(batch, payload, "pack", "mixed-shape lanes the ragged pool cannot take; "
                                                          "executed per block")
                finally:
                    release(sum(sizes))
                return []
            try:
                out, rung, rb = run_batch(kind, payload)
            except torch.OutOfMemoryError:
                tb = fu.cap_traceback(traceback.format_exc())
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
                try:
                    run_unsharded(batch, vals, "dispatch", tb)
                finally:
                    release(sum(sizes))
                return []
            except Exception as e:
                tb = fu.cap_traceback(traceback.format_exc())
                for blk in batch:
                    note_failure(blk, "compute", 1, tb, quarantine=True, resource=classify_resource_error(e))
                with lock:
                    sharded_failed.update(int(b.block_id) for b in batch)
                release(sum(sizes))
                return []
            note_dispatch(len(batch), rb)
            batch_rungs.append(rung)
            crop = rb.crop if rb is not None else None
            return [pool.submit(store_released, blk, _lane(out, j, crop), sizes[j]) for j, blk in enumerate(batch)]

        batches = [blocks[i:i + bs] for i in range(0, len(blocks), bs)]
        block_loader = ThreadPoolExecutor(max_workers=self.io_threads) if use_sharded else None
        with ThreadPoolExecutor(max_workers=self.io_threads) as pool, \
                block_loader if block_loader is not None else contextlib.nullcontext():
            pending: List[Future] = [pool.submit(load_batch, b) for b in batches[:prefetch]]
            writes: List[Future] = []
            for i in range(len(batches)):
                t0 = time.perf_counter()
                loaded = pending.pop(0).result()
                counts["dispatch_wait_s"] += time.perf_counter() - t0
                if i + prefetch < len(batches):
                    pending.append(pool.submit(load_batch, batches[i + prefetch]))
                if use_sharded:
                    batch, kind, payload = loaded
                    if batch:
                        writes.extend(dispatch_sharded(batch, kind, payload, writes))
                else:
                    for block, val in loaded:
                        if val is None:
                            continue
                        nbytes = _tree_nbytes(val)
                        admit(nbytes, writes)
                        out = execute(block, val)
                        if out is not None:
                            writes.append(pool.submit(store_released, block, out, nbytes))
                        else:
                            release(nbytes)
                # bounded store window: each pending store holds a block's outputs
                while len(writes) > 2 * bs:
                    writes.pop(0).result()
            for f in writes:
                f.result()

        # quarantine pass: each block still unresolved, once more alone
        quarantined = sorted(b for b, rec in failures.items() if rec["quarantined"])
        for block in [b for b in blocks if int(b.block_id) in quarantined]:
            rec = failures[int(block.block_id)]
            if rec["resolved"]:
                continue
            # a block starved of memory or disk waits for headroom first
            resource = rec.get("resource")
            if resource is not None:
                wait_for_headroom(resource)
            val = load_block(block)
            if val is None:
                continue
            out = execute(block, val)
            if out is not None:
                resolution = "degraded:unsharded" if int(block.block_id) in sharded_failed else \
                    ("degraded:backpressure" if resource is not None else None)
                handle_output(block, out, resolution=resolution)

        unresolved = sorted(b for b, rec in failures.items() if not rec["resolved"])
        if failures_path and failures:
            fu.record_failures(failures_path, task_name, [failures[b] for b in sorted(failures)])
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
            "n_blocks": len(blocks), "n_quarantined": len(quarantined), "n_failed": 0,
            "sweep_mode": "sharded" if use_sharded else "per_block", **stats, **counts,
            **{k: int(dev[k]) for k in ("h2d_bytes", "d2h_bytes", "device_pool_hits", "device_pool_misses",
                                        "device_pool_evictions", "host_staged_fallbacks")},
            "device_pool": "on" if dev_pool is not None else "off",
            "device_pool_resident_bytes": dev_pool.resident_bytes() if dev_pool is not None else 0,
            "inflight_byte_budget": budget, "n_backpressure_waits": backpressure["waits"],
        }
        if use_sharded:
            summary["sharded_batch"] = bs
            summary["batch_rungs"] = batch_rungs
        return summary
