"""The tile kernels: CUDA wrappers and plain twins.

Port of ``cluster_tools_tpu/ops/pallas_kernels.py``.  Each TPU kernel has a
hand-written Hopper kernel in ``csrc/`` (built by ``..build``) and a plain
PyTorch twin here that computes the same function:

================================  ======================  =============================================
wrapper                           CUDA source             replaces (Pallas kernel)
================================  ======================  =============================================
``tile_ccl``                      tile_ccl.cu             ``tile_ccl_pallas`` (B1, ``_ccl_kernel``)
``tile_ccl(..., doubling=True)``  tile_ccl_doubling.cu    ``tile_ccl_pallas(doubling=True)`` (B1d)
``tile_ws_propagate``             tile_ws.cu              ``tile_ws_propagate_pallas`` (B2)
``edt_cascade``                   edt_cascade.cu          ``edt_cascade_pallas`` (B3)
``apply_remap``                   apply_remap.cu          ``apply_remap_pallas`` (B4)
``row_scan``                      row_scan.cu             no Pallas kernel: XLA's ``cumsum``/``cummax``
================================  ======================  =============================================

B1d computes B1's function by run doubling (``_ccl_kernel_doubling``); as
in the reference, nothing on the main path selects it.  ``row_scan`` is the
stages' row-wise inclusive scan, which the reference leaves to XLA and
PyTorch runs on one thread block a row.

A wrapper runs the twin only for a CPU tensor (or ``impl="torch"``); for
a CUDA tensor it launches its kernel or raises — never a silent fallback.
``LAUNCHES`` counts kernel launches (twin calls do not count) and
``CARD_LAUNCHES`` the same launches by ``(kernel, card)``; ``RUNGS``
counts which rung each remap site took (the per-tile table kernel or the
gather rung the reference takes when a table overflows).  The shards of a
mesh run on threads of one process, so the counts and the capture list
change only under ``_LOCK`` (:func:`count_rung`, :func:`_launch`,
:func:`_record`).
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_impl
from ..runtime import admission
from .ccl import _shift, label_components_batched

# background sentinel of the tiled phase; exceeds every global flat index
BIG = 2**30
# watershed pointer-propagation: value read from outside the tile
WS_MARKER = -(2**30)
# descent-direction codes 1..6 in this order; 0 = self (terminal)
WS_OFFS = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))

DEFAULT_TILE = (16, 16, 128)

LAUNCHES: Counter = Counter()
# launches by (kernel, "cuda:i"): which card each launch ran on
CARD_LAUNCHES: Counter = Counter()
RUNGS: Counter = Counter()
# launches by service request (``runtime/admission.py``'s ambient context),
# taken out by the server when the request ends
REQUEST_LAUNCHES: Dict[str, Counter] = {}
_CAPTURE: Optional[List[tuple]] = None
_LOCK = threading.Lock()


def reset_counts() -> None:
    with _LOCK:
        LAUNCHES.clear()
        CARD_LAUNCHES.clear()
        RUNGS.clear()
        REQUEST_LAUNCHES.clear()


def pop_request_launches(request_id: str) -> Dict[str, int]:
    """The kernel launches counted under ``request_id`` so far, removed."""
    with _LOCK:
        return dict(REQUEST_LAUNCHES.pop(request_id, {}))


def count_rung(name: str) -> None:
    """Count one remap site's choice of rung."""
    with _LOCK:
        RUNGS[name] += 1


@contextlib.contextmanager
def capture_inputs():
    """Record a clone of the arguments of every kernel launch.

    Yields the list of ``(name, args, kwargs)`` in launch order so a caller
    can replay each launch on exactly the inputs a run gave it.
    """
    global _CAPTURE
    _CAPTURE = []
    try:
        yield _CAPTURE
    finally:
        _CAPTURE = None


def _record(name: str, args: tuple, kwargs: dict) -> None:
    if _CAPTURE is not None:
        entry = (name, tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args), dict(kwargs))
        with _LOCK:
            if _CAPTURE is not None:
                _CAPTURE.append(entry)


def _launch(name: str, device: torch.device, lib, fn_name: str, *args) -> None:
    with torch.cuda.device(device):
        rc = getattr(lib, fn_name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: {lib.ct_error_string(rc).decode()} ({rc})"
        )
    ctx = admission.current_request()
    with _LOCK:
        LAUNCHES[name] += 1
        # a CUDA tensor's device always names its card
        CARD_LAUNCHES[(name, str(device))] += 1
        if ctx is not None:
            REQUEST_LAUNCHES.setdefault(ctx.request_id, Counter())[name] += 1


def _cuda_lib(name: str):
    from .. import build

    return build.library(name)


def _check(t: torch.Tensor, dtypes, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype not in dtypes:
        raise ValueError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _check_tiled(shape, tile) -> None:
    if len(shape) != 3 or any(s % t for s, t in zip(shape, tile)):
        raise ValueError(f"shape {tuple(shape)} must be 3-D and divisible by tile {tile}")


def to_tiles(a: torch.Tensor, tile) -> torch.Tensor:
    """(Z, Y, X) -> (n_tiles, tz, ty, tx), tiles in z-major grid order."""
    z, y, x = a.shape
    tz, ty, tx = tile
    gz, gy, gx = z // tz, y // ty, x // tx
    return a.reshape(gz, tz, gy, ty, gx, tx).permute(0, 2, 4, 1, 3, 5).reshape(gz * gy * gx, tz, ty, tx)


def from_tiles(a: torch.Tensor, shape, tile) -> torch.Tensor:
    """Inverse of :func:`to_tiles`."""
    z, y, x = shape
    tz, ty, tx = tile
    gz, gy, gx = z // tz, y // ty, x // tx
    return a.reshape(gz, gy, gx, tz, ty, tx).permute(0, 3, 1, 4, 2, 5).reshape(z, y, x)


# ---------------------------------------------------------------- B1 ----


def tile_ccl_torch(mask: torch.Tensor, tile=DEFAULT_TILE) -> torch.Tensor:
    """Twin of B1: the legacy labeller over every tile (batched), local
    representatives mapped to global flat indices; background ``BIG``."""
    z, y, x = mask.shape
    tz, ty, tx = tile
    gz, gy, gx = z // tz, y // ty, x // tx
    dev = mask.device
    local = label_components_batched(to_tiles(mask.to(torch.bool), tile), connectivity=1)
    nloc = tz * ty * tx
    tid = torch.arange(gz * gy * gx, dtype=torch.int32, device=dev).reshape(-1, 1, 1, 1)
    ti = tid // (gy * gx)
    tj = (tid // gx) % gy
    tk = tid % gx
    lz = local // (ty * tx)
    ly = (local // tx) % ty
    lx = local % tx
    glob = ((ti * tz + lz) * y + tj * ty + ly) * x + tk * tx + lx
    glob = torch.where(local == nloc, BIG, glob.to(torch.int32))
    return from_tiles(glob, (z, y, x), tile)


def _doubling_sweep(lab: torch.Tensor, m: torch.Tensor, ax: int) -> torch.Tensor:
    """The reference's sweep of one axis: in each direction a label jumps
    ``2^k`` along the axis where the whole segment between is foreground
    (``conn_k[i] = conn_{k-1}[i] & conn_{k-1}[i - 2^{k-1}]``)."""
    n = lab.shape[ax]
    for direction in (1, -1):
        conn = m & _shift(m, direction, ax, False)
        cur = lab
        step = 1
        while step < n:
            cand = _shift(cur, direction * step, ax, BIG)
            cur = torch.where(conn, torch.minimum(cur, cand), cur)
            if step * 2 < n:
                conn = conn & _shift(conn, direction * step, ax, False)
            step *= 2
        lab = torch.minimum(lab, torch.where(m, cur, BIG))
    return lab


def _runs_sweep(lab: torch.Tensor, m: torch.Tensor, ax: int) -> torch.Tensor:
    """The same sweep as the kernel computes it: every foreground run along
    the axis takes its minimum.  Run ids are a cumulative sum of run starts
    along the lines (background maps to one spare slot holding ``BIG``)."""
    lines, mm = lab.movedim(ax, -1), m.movedim(ax, -1)
    starts = mm & ~_shift(mm, 1, mm.dim() - 1, False)
    n = mm.numel()
    rid = torch.where(mm.reshape(-1), torch.cumsum(starts.reshape(-1), 0) - 1, n)
    mins = torch.full((n + 1,), BIG, dtype=lab.dtype, device=lab.device)
    mins = mins.scatter_reduce(0, rid, lines.reshape(-1), "amin")
    return mins[rid].reshape(mm.shape).movedim(-1, ax)


CCL_DOUBLING_FORMULATIONS = {"doubling": _doubling_sweep, "runs": _runs_sweep}


def tile_ccl_doubling_torch(mask: torch.Tensor, tile=DEFAULT_TILE, formulation: str = "doubling",
                            return_iterations: bool = False):
    """Twin of B1d, batched over tiles.  One iteration sweeps z, then y,
    then x; iterations stop when nothing changes.  ``formulation``:
    ``doubling``, the reference's guarded run doubling step for step, or
    ``runs``, the kernel's per-axis run minima; the two give the same state
    after every iteration.  With ``return_iterations`` also returns the
    int32 count of iterations each tile (z-major) takes, the last one
    included (the one that changes nothing)."""
    if formulation not in CCL_DOUBLING_FORMULATIONS:
        raise ValueError(f"formulation must be one of {tuple(CCL_DOUBLING_FORMULATIONS)}, got {formulation!r}")
    sweep = CCL_DOUBLING_FORMULATIONS[formulation]
    z, y, x = mask.shape
    dev = mask.device
    m = to_tiles(mask.to(torch.bool), tile)
    gidx = to_tiles(torch.arange(z * y * x, dtype=torch.int32, device=dev).reshape(z, y, x), tile)
    lab = torch.where(m, gidx, BIG)
    iters = torch.ones(m.shape[0], dtype=torch.int32, device=dev)
    it = 1
    while True:
        new = lab
        for ax in (1, 2, 3):
            new = sweep(new, m, ax)
        moved = (new != lab).reshape(m.shape[0], -1).any(1)
        if not bool(moved.any()):
            break
        it += 1
        iters = torch.where(moved, it, iters)
        lab = new
    out = from_tiles(lab, (z, y, x), tile)
    return (out, iters) if return_iterations else out


def tile_ccl(mask: torch.Tensor, tile=DEFAULT_TILE, impl: str = "auto", doubling: bool = False,
             return_iterations: bool = False):
    """Exact per-tile CCL of a 3-D bool mask; labels are global flat indices.

    Shape must be divisible by ``tile`` and hold fewer than ``2**30``
    voxels.  Foreground voxels get the minimum global flat index of their
    within-tile component; background ``BIG``.  ``doubling`` selects the
    run-doubling kernel (B1d), the same function; with it,
    ``return_iterations`` also returns each tile's iteration count (see
    :func:`tile_ccl_doubling_torch`).
    """
    _check_tiled(mask.shape, tile)
    if mask.numel() >= BIG:
        raise ValueError(f"volume {tuple(mask.shape)} has >= 2**30 voxels; shard it")
    if return_iterations and not doubling:
        raise ValueError("return_iterations needs doubling=True")
    if resolve_impl(impl, mask) == "torch":
        if doubling:
            return tile_ccl_doubling_torch(mask, tile, return_iterations=return_iterations)
        return tile_ccl_torch(mask, tile)
    name = "tile_ccl_doubling" if doubling else "tile_ccl"
    _record(name, (mask,), {"tile": tuple(tile)})
    _check(mask, (torch.bool, torch.uint8), f"{name} mask")
    out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    extra = ()
    if doubling:
        n_tiles = int(np.prod([s // t for s, t in zip(mask.shape, tile)]))
        iters = torch.empty(n_tiles, dtype=torch.int32, device=mask.device) if return_iterations else None
        extra = (None if iters is None else iters.data_ptr(),)
    _launch(
        name, mask.device, _cuda_lib(name), f"ct_{name}",
        mask.data_ptr(), out.data_ptr(), *extra, *mask.shape, *tile,
    )
    return (out, iters) if return_iterations else out


# ---------------------------------------------------------------- B2 ----


def ws_propagate_step(value, dirs, gidx, axes, ny, nx):
    """One step of label flow along descent pointers (the stepping form).

    Every voxel whose direction code is ``d`` copies the value of its
    descent target; terminals keep their value.  A copy that would read
    outside the tile (the shifted-in ``WS_MARKER``) resolves to the exit
    code ``-(target_gidx + 2)`` instead.  ``axes`` maps the three spatial
    offsets onto array axes; ``ny``/``nx`` are the global volume dims.
    """
    new = value
    for code, off in enumerate(WS_OFFS, start=1):
        foff = (off[0] * ny + off[1]) * nx + off[2]
        v_t = value
        for ax, s in zip(axes, off):
            if s:
                v_t = _shift(v_t, -s, ax, WS_MARKER)
        sel = dirs == code
        exit_code = -(gidx + foff) - 2
        new = torch.where(sel, torch.where(v_t == WS_MARKER, exit_code, v_t), new)
    return new


def _flow_tile_setup(dirs: torch.Tensor, sv: torch.Tensor, tile):
    z, y, x = dirs.shape
    idx = torch.arange(z * y * x, dtype=torch.int32, device=dirs.device).reshape(z, y, x)
    return to_tiles(idx, tile), to_tiles(dirs, tile), to_tiles(sv, tile)


def tile_ws_propagate_stepping(dirs: torch.Tensor, sv: torch.Tensor, tile=DEFAULT_TILE) -> torch.Tensor:
    """Twin of B2, per-hop stepping recurrence (the TPU kernel's math)."""
    shape = dirs.shape
    _, y, x = shape
    gidx, dirs_t, sv_t = _flow_tile_setup(dirs, sv, tile)
    terminal = dirs_t == 0
    value = torch.where(
        sv_t > 0, sv_t, torch.where(terminal & (sv_t == 0), -gidx - 2, 0)
    ).to(torch.int32)
    while True:
        v2 = ws_propagate_step(value, dirs_t, gidx, (1, 2, 3), y, x)
        if not bool((v2 != value).any()):
            return from_tiles(v2, shape, tile)
        value = v2


def tile_ws_propagate_jump(dirs: torch.Tensor, sv: torch.Tensor, tile=DEFAULT_TILE) -> torch.Tensor:
    """Twin of B2, pointer jumping: the in-tile successor table composed to
    closure, then every voxel takes its root's value.

    A root is a voxel that keeps its value under the stepping recurrence: a
    terminal (code 0), a voxel whose target leaves the tile (an exit), or a
    code outside 0..6 (never selected).  A terminal's or unknown code's
    value is ``s`` if ``s > 0``, else ``-(g + 2)`` for an unseeded terminal,
    else 0; an exit's is ``-(target + 2)`` whatever its ``s``.  Every other
    voxel ends at its root's value, seeded or not (the fixed point of the
    stepping recurrence on any acyclic field)."""
    shape = dirs.shape
    _, y, x = shape
    tz, ty, tx = tile
    dev = dirs.device
    gidx, dirs_t, sv_t = _flow_tile_setup(dirs, sv, tile)
    offs = torch.tensor(
        np.concatenate([[[0, 0, 0]], np.asarray(WS_OFFS)]).astype(np.int32), device=dev
    )
    known = (dirs_t >= 0) & (dirs_t <= len(WS_OFFS))
    d = torch.where(known, dirs_t, 0).long()
    oz, oy, ox = offs[:, 0][d], offs[:, 1][d], offs[:, 2][d]
    nt = dirs_t.shape[0]
    cz = torch.arange(tz, dtype=torch.int32, device=dev).reshape(1, tz, 1, 1)
    cy = torch.arange(ty, dtype=torch.int32, device=dev).reshape(1, 1, ty, 1)
    cx = torch.arange(tx, dtype=torch.int32, device=dev).reshape(1, 1, 1, tx)
    tzc, tyc, txc = cz + oz, cy + oy, cx + ox
    inb = (tzc >= 0) & (tzc < tz) & (tyc >= 0) & (tyc < ty) & (txc >= 0) & (txc < tx)
    self_flat = ((cz * ty + cy) * tx + cx).expand(nt, tz, ty, tx)
    tgt_flat = (tzc * ty + tyc) * tx + txc
    terminal = dirs_t == 0
    exit_code = -(gidx + (oz * y + oy) * x + ox) - 2
    root = ~known | terminal | ~inb
    nxt = torch.where(root, self_flat, tgt_flat)
    rootval = torch.where(
        ~inb,
        exit_code,
        torch.where(sv_t > 0, sv_t, torch.where(terminal & (sv_t == 0), -gidx - 2, 0)),
    ).to(torch.int32)
    nxt = nxt.reshape(nt, -1).long()
    while True:
        p2 = torch.gather(nxt, 1, nxt)
        if not bool((p2 != nxt).any()):
            break
        nxt = p2
    out = torch.gather(rootval.reshape(nt, -1), 1, nxt)
    return from_tiles(out.reshape(nt, tz, ty, tx), shape, tile)


def tile_ws_propagate_torch(dirs, sv, tile=DEFAULT_TILE, formulation: str = "jump"):
    """Twin of B2 (``formulation``: ``jump`` or ``stepping``; identical output)."""
    if formulation == "jump":
        return tile_ws_propagate_jump(dirs, sv, tile)
    if formulation == "stepping":
        return tile_ws_propagate_stepping(dirs, sv, tile)
    raise ValueError(f"formulation must be jump/stepping, got {formulation!r}")


def tile_ws_propagate(dirs: torch.Tensor, sv: torch.Tensor, tile=DEFAULT_TILE, impl: str = "auto"):
    """In-tile watershed label flow along a descent-direction field.

    ``dirs``: int32 codes (0 = terminal, 1..6 = ``WS_OFFS``); ``sv``: int32,
    -1 masked out, 0 no seed, >0 seed id.  Output per voxel: the value of
    its in-tile root (see :func:`tile_ws_propagate_jump`): a seed label,
    0 (invalid), ``-(t + 2)`` for the unseeded in-tile terminal ``t``, or
    ``-(g + 2)`` for an exit whose target ``g`` lies in another tile.  The
    field must be acyclic, as the flow stage's are: on a cycle the
    reference's stepping recurrence need not converge, the twins do not
    return, and the kernel stores 0 where a walk does not end.
    """
    _check_tiled(dirs.shape, tile)
    if resolve_impl(impl, dirs) == "torch":
        return tile_ws_propagate_torch(dirs, sv, tile)
    _record("tile_ws_propagate", (dirs, sv), {"tile": tuple(tile)})
    _check(dirs, (torch.int32,), "tile_ws_propagate dirs")
    _check(sv, (torch.int32,), "tile_ws_propagate seeds")
    if sv.shape != dirs.shape or sv.device != dirs.device:
        raise ValueError("dirs and seeds must have one shape and one device")
    out = torch.empty(dirs.shape, dtype=torch.int32, device=dirs.device)
    _launch(
        "tile_ws_propagate", dirs.device, _cuda_lib("tile_ws_propagate"), "ct_tile_ws_propagate",
        dirs.data_ptr(), sv.data_ptr(), out.data_ptr(), *dirs.shape, *tile,
    )
    return out


# ---------------------------------------------------------------- B3 ----


def _edt_step_cost(w: float, i: int) -> np.float32:
    # float32 w * (2i + 1), rounded as the reference rounds it
    return np.float32(w) * (np.float32(2.0) * np.float32(i) + np.float32(1.0))


def edt_cascade_torch(f: torch.Tensor, axis: int, radius: int, w: float, big: float) -> torch.Tensor:
    """Twin of B3: ``radius`` Jacobi steps of the parabolic erosion along
    ``axis`` (``big`` shifted in at both line ends)."""
    g = f
    for i in range(radius):
        c = torch.tensor(_edt_step_cost(w, i), dtype=torch.float32, device=f.device)
        lo = _shift(g, 1, axis, float(np.float32(big))) + c
        hi = _shift(g, -1, axis, float(np.float32(big))) + c
        g = torch.minimum(g, torch.minimum(lo, hi))
    return g


def edt_cascade(f: torch.Tensor, axis: int, radius: int, w: float, big: float, impl: str = "auto"):
    """Parabolic erosion cascade along one axis of a 3-D float32 volume:
    ``min(radius, n - 1)`` steps (any shape; no padding needed)."""
    if f.dim() != 3:
        raise ValueError("edt_cascade expects a 3-D volume")
    radius = max(0, min(int(radius), f.shape[axis] - 1))
    if resolve_impl(impl, f) == "torch":
        return edt_cascade_torch(f, axis, radius, w, big)
    _record("edt_cascade", (f,), {"axis": axis, "radius": radius, "w": w, "big": big})
    _check(f, (torch.float32,), "edt_cascade input")
    out = torch.empty_like(f)
    _launch(
        "edt_cascade", f.device, _cuda_lib("edt_cascade"), "ct_edt_cascade",
        f.data_ptr(), out.data_ptr(), *f.shape, int(axis), radius,
        float(np.float32(w)), float(np.float32(big)),
    )
    return out


# ---------------------------------------------------------------- B4 ----


def apply_remap_torch(labels, old_tbl, new_tbl, tile=DEFAULT_TILE, cap: int = 64):
    """Twin of B4: per-tile compare-select over the ``(n_tiles, cap)``
    tables, vectorised over tiles, slots applied in order."""
    lab = to_tiles(labels, tile).reshape(old_tbl.shape[0], -1)
    for c in range(cap):
        lab = torch.where(lab == old_tbl[:, c : c + 1], new_tbl[:, c : c + 1], lab)
    return from_tiles(lab, labels.shape, tile)


def apply_remap(labels, old_tbl, new_tbl, tile=DEFAULT_TILE, cap: int = 64, impl: str = "auto"):
    """Per-tile value remap: labels equal to ``old_tbl[t, c]`` become
    ``new_tbl[t, c]``, for ``c`` in slot order.  Tables are
    ``(n_tiles, cap)`` int32 in z-major tile order; unused slots hold -1."""
    _check_tiled(labels.shape, tile)
    n_tiles = int(np.prod([s // t for s, t in zip(labels.shape, tile)]))
    if tuple(old_tbl.shape) != (n_tiles, cap) or tuple(new_tbl.shape) != (n_tiles, cap):
        raise ValueError(f"tables must be {(n_tiles, cap)}, got {tuple(old_tbl.shape)}")
    if resolve_impl(impl, labels) == "torch":
        return apply_remap_torch(labels, old_tbl, new_tbl, tile, cap)
    _record("apply_remap", (labels, old_tbl, new_tbl), {"tile": tuple(tile), "cap": cap})
    for t, what in ((labels, "labels"), (old_tbl, "old_tbl"), (new_tbl, "new_tbl")):
        _check(t, (torch.int32,), f"apply_remap {what}")
        if t.device != labels.device:
            raise ValueError(f"apply_remap {what}: on {t.device}, labels on {labels.device}")
    out = torch.empty_like(labels)
    _launch(
        "apply_remap", labels.device, _cuda_lib("apply_remap"), "ct_apply_remap",
        labels.data_ptr(), old_tbl.data_ptr(), new_tbl.data_ptr(), out.data_ptr(),
        *labels.shape, *tile, int(cap),
    )
    return out


# ---------------------------------------------------------- row scan ----

SCAN_OPS = ("sum", "max")
# elements a CTA of the kernel scans (csrc/row_scan.cu, kTile)
ROW_SCAN_TILE = 4096


def row_scan_torch(x: torch.Tensor, op: str) -> torch.Tensor:
    """Twin of the row scan: ``torch.cumsum(x, 1, dtype=torch.int32)`` or
    ``torch.cummax(x, 1).values``."""
    if op == "sum":
        return torch.cumsum(x, 1, dtype=torch.int32)
    return torch.cummax(x, 1).values


def row_scan(x: torch.Tensor, op: str, impl: str = "auto") -> torch.Tensor:
    """Inclusive scan along the last axis of a ``[B, N]`` tensor, int32 out.

    ``op``: ``sum`` of int32 or bool input, wrapping as int32 arithmetic
    does, or ``max`` of int32 input.  Exact, so the kernel and the twin
    agree bit for bit.
    """
    if op not in SCAN_OPS:
        raise ValueError(f"op must be one of {SCAN_OPS}, got {op!r}")
    if x.dim() != 2:
        raise ValueError(f"row_scan expects a [B, N] tensor, got shape {tuple(x.shape)}")
    dtypes = (torch.int32, torch.bool) if op == "sum" else (torch.int32,)
    if x.dtype not in dtypes:
        raise ValueError(f"row_scan {op}: dtype {x.dtype} not in {dtypes}")
    if resolve_impl(impl, x) == "torch":
        return row_scan_torch(x, op)
    name = f"row_scan.{op}"
    _record(name, (x,), {"op": op})
    _check(x, dtypes, name)
    rows, n = x.shape
    out = torch.empty((rows, n), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    # a tile counter, then one status word per (row, tile)
    scratch = torch.zeros(1 + rows * -(-n // ROW_SCAN_TILE), dtype=torch.int64, device=x.device)
    _launch(
        name, x.device, _cuda_lib("row_scan"), "ct_row_scan",
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), rows, n, SCAN_OPS.index(op), int(x.dtype == torch.bool),
    )
    return out
