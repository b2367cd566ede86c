"""Blockwise executor: a per-block kernel over a list of blocks, with
prefetching IO, retries and a failure manifest.

Port of ``cluster_tools_tpu/runtime/executor.py::BlockwiseExecutor.map_blocks``
on its per-block path (the reference holds its sharded and ragged sweeps
bit-identical to it).  Per block:

1. ``load_fn(block)`` on an IO thread pool, ``prefetch`` batches ahead;
2. the inputs to the task's device as torch tensors and ``kernel(*inputs)``
   there, one block a call (``device_batch > 1`` loads that many blocks
   together and loops over them);
3. the outputs back to numpy, then ``check_finite`` and ``validate_fn``;
4. ``store_fn(block, outputs)`` on the IO pool, then ``on_block_done``.

Loads and stores retry with capped exponential backoff; a block whose
load, kernel, validation or store still fails is quarantined and re-run
once, alone, after the sweep.  Every failure lands in ``failures.json``
and a RuntimeError names every block still failed at the end.  A kernel
error is never answered by running another implementation.

Not ported (ROADMAP Queue A items 9 and 11), and refused when asked for:
sharded sweeps (``sweep_mode="sharded"``), the ragged paged pool and the
device page pool (``ragged="on"``, ``device_pool="on"``), the hung-block
watchdog and speculation (``block_deadline_s``), degrade-and-split
(``splittable=True``) and post-store checksum verification
(``store_verify_fn``).
"""

from __future__ import annotations

import threading
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils import function_utils as fu
from ..utils.volume_utils import Block

TARGET_DEVICES = {"local": "cpu", "gpu": "cuda"}


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


def _refuse(what: str, item: int) -> None:
    raise NotImplementedError(f"{what} is not ported: ROADMAP Queue A item {item}")


def sweep_config(cfg) -> Dict[str, Any]:
    """The ``map_blocks`` knobs a blockwise task takes from its config."""
    return dict(
        schedule=str(cfg.get("block_schedule") or "morton"),
        sweep_mode=str(cfg.get("sweep_mode") or "auto"),
        block_deadline_s=cfg.get("block_deadline_s"),
        device_pool=str(cfg.get("device_pool") or "auto"),
        splittable=bool(cfg.get("allow_block_split")),
    )


class BlockwiseExecutor:
    """Run a per-block kernel over blocks on the device of ``target``.

    ``load_fn(block)`` returns the kernel's input arrays (numpy, already
    padded to one shape); ``kernel(*tensors)`` gets them as tensors on the
    device and returns a tensor or a tuple of tensors and flags;
    ``store_fn(block, outputs)`` persists one block's outputs as numpy.
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

    def _retry(self, fn: Callable) -> Tuple[Any, int, Optional[str]]:
        """``(value, attempts, traceback or None)`` of ``fn`` with retries."""
        last_tb = None
        for k in range(self.max_retries + 1):
            try:
                return fn(), k + 1, None
            except Exception:
                last_tb = fu.cap_traceback(traceback.format_exc())
                if k < self.max_retries:
                    time.sleep(fu.backoff_delay(k, self.backoff_base, self.backoff_max))
        return None, self.max_retries + 1, last_tb

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
        block_deadline_s: Optional[float] = None,
        store_verify_fn: Optional[Callable[[Block], None]] = None,
        splittable: bool = False,
        ragged: str = "auto",
        device_pool: str = "auto",
    ) -> Dict[str, Any]:
        """Execute ``kernel`` over ``blocks``; see the class docstring.

        ``done_block_ids`` are skipped (marker resume).  ``schedule``:
        ``"morton"`` (default) or ``"given"`` order; blocks are independent,
        so the order never changes results.  ``sweep_mode``: ``"auto"`` and
        ``"per_block"`` run per block.  Returns a summary with the summed
        host-clock seconds of the sweep's stages: ``load_s`` and ``store_s``
        (IO threads), ``h2d_s``, ``kernel_s`` (ended by a device sync) and
        ``d2h_s`` (the dispatch thread).
        """
        if sweep_mode == "sharded":
            _refuse("sweep_mode='sharded' (one program per batch of blocks)", 9)
        if sweep_mode not in ("auto", "per_block"):
            raise ValueError(f"unknown sweep_mode {sweep_mode!r}")
        if ragged == "on":
            _refuse("ragged='on' (the paged block pool)", 9)
        if device_pool == "on":
            _refuse("device_pool='on' (the device page pool)", 9)
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
        stats = {"load_s": 0.0, "h2d_s": 0.0, "kernel_s": 0.0, "d2h_s": 0.0, "store_s": 0.0}
        if not blocks:
            return {"n_blocks": 0, "n_quarantined": 0, "n_failed": 0, **stats}

        failures: Dict[int, Dict[str, Any]] = {}
        lock = threading.Lock()

        def add(key: str, dt: float) -> None:
            with lock:
                stats[key] += dt

        def note_failure(block, site, attempts, error, quarantine):
            with lock:
                rec = failures.setdefault(int(block.block_id), {
                    "block_id": int(block.block_id), "sites": {}, "error": None,
                    "quarantined": False, "resolved": True,
                })
                rec["sites"][site] = rec["sites"].get(site, 0) + int(attempts)
                if error is not None:
                    rec["error"] = error
                if quarantine:
                    rec["quarantined"] = True
                    rec["resolved"] = False

        def load_block(block):
            t0 = time.perf_counter()
            val, attempts, tb = self._retry(lambda: tuple(np.asarray(x) for x in load_fn(block)))
            add("load_s", time.perf_counter() - t0)
            if tb is not None:
                note_failure(block, "load", attempts, tb, quarantine=True)
                return None
            if attempts > 1:
                note_failure(block, "load", attempts - 1, None, quarantine=False)
            return val

        def load_batch(batch):
            return [(b, load_block(b)) for b in batch]

        def run_kernel(val):
            """Inputs to the device, the kernel, outputs back as numpy."""
            t0 = time.perf_counter()
            inputs = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(self.device) for x in val)
            self._sync()
            t1 = time.perf_counter()
            out = kernel(*inputs)
            self._sync()
            t2 = time.perf_counter()
            out = _to_numpy(out)
            t3 = time.perf_counter()
            add("h2d_s", t1 - t0)
            add("kernel_s", t2 - t1)
            add("d2h_s", t3 - t2)
            return out

        def handle_output(block, out) -> None:
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
                    _, attempts, tb = self._retry(lambda: store_fn(block, out))
                    add("store_s", time.perf_counter() - t0)
                    if tb is not None:
                        note_failure(block, "store", attempts, tb, quarantine=True)
                        return
                    if attempts > 1:
                        note_failure(block, "store", attempts - 1, None, quarantine=False)
                with lock:
                    rec = failures.get(int(block.block_id))
                    if rec is not None:
                        rec["resolved"] = True
                if on_block_done is not None:
                    on_block_done(block)
            except Exception:
                note_failure(block, "hook", 1, fu.cap_traceback(traceback.format_exc()), quarantine=True)

        def execute(block, val) -> Optional[Any]:
            try:
                return run_kernel(val)
            except Exception:
                note_failure(block, "compute", 1, fu.cap_traceback(traceback.format_exc()), quarantine=True)
                return None

        bs = self.device_batch
        batches = [blocks[i:i + bs] for i in range(0, len(blocks), bs)]
        with ThreadPoolExecutor(max_workers=self.io_threads) as pool:
            pending: List[Future] = [pool.submit(load_batch, b) for b in batches[:prefetch]]
            writes: List[Future] = []
            for i in range(len(batches)):
                loaded = pending.pop(0).result()
                if i + prefetch < len(batches):
                    pending.append(pool.submit(load_batch, batches[i + prefetch]))
                for block, val in loaded:
                    if val is None:
                        continue
                    out = execute(block, val)
                    if out is not None:
                        writes.append(pool.submit(handle_output, block, out))
                # bounded store window: each pending store holds a block's outputs
                while len(writes) > 2 * bs:
                    writes.pop(0).result()
            for f in writes:
                f.result()

        # quarantine pass: each block still unresolved, once more alone
        quarantined = sorted(b for b, rec in failures.items() if rec["quarantined"])
        for block in [b for b in blocks if int(b.block_id) in quarantined]:
            if failures[int(block.block_id)]["resolved"]:
                continue
            val = load_block(block)
            if val is None:
                continue
            out = execute(block, val)
            if out is not None:
                handle_output(block, out)

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
        return {"n_blocks": len(blocks), "n_quarantined": len(quarantined), "n_failed": 0,
                "sweep_mode": "per_block", **stats}
