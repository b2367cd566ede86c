"""ctypes bindings of the host C++ rung (``csrc/ct_native.cpp``).

Port of ``cluster_tools_tpu/native.py``, with the same public names.  The
library holds the host-side merge and solver hot spots: union-find, GAEC,
round-based parallel contraction, Kernighan-Lin, the mutex-watershed
constraint loop, the count-weighted edge-feature merge, the exact squared
EDT and the bucket-queue seeded watershed.  It is built by ``g++`` at first
use into ``.torch_ext/`` (:func:`..build.host_library`), on any machine,
card or not; callers holding tensors pass host numpy copies.

One deliberate difference from the reference: no quiet fallback.  A failed
build raises ``RuntimeError`` with the compiler's output.  The Python paths
of the callers are reached only inside :func:`force_python` (every function
here then returns ``None``, as the reference's do when its library is off)
or through a caller's explicit ``impl="numpy"``.

:data:`COUNTS` counts the calls into the library per function, so a test or
``chip_smoke.py`` can show which rung ran (:func:`reset_counts`).  ctypes
releases the interpreter lock during a call and the C++ keeps no shared
state, so threads may call these at once.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, Optional

import numpy as np

from . import build

FUNCTIONS = (
    "union_find",
    "greedy_additive",
    "parallel_contract",
    "kernighan_lin",
    "mutex_watershed",
    "merge_edge_features",
    "edt_sq",
    "ws_flood",
)

#: calls into the library since the last :func:`reset_counts`, by function
COUNTS: Dict[str, int] = {name: 0 for name in FUNCTIONS}
_COUNTS_LOCK = threading.Lock()

_lib: Optional[ctypes.CDLL] = None
_forced_off = False


def reset_counts() -> None:
    with _COUNTS_LOCK:
        for name in COUNTS:
            COUNTS[name] = 0


def _count(name: str) -> None:
    with _COUNTS_LOCK:
        COUNTS[name] += 1


@contextlib.contextmanager
def force_python():
    """Route every caller to its Python path while inside (each function
    here returns ``None``): the reference's oracle switch.  Process-wide,
    as the reference's is."""
    global _forced_off
    _forced_off = True
    try:
        yield
    finally:
        _forced_off = False


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, building it at first use; ``None`` inside
    :func:`force_python`.  Raises when the build fails."""
    global _lib
    if _forced_off:
        return None
    if _lib is None:
        with build._BUILD_LOCK:
            if _lib is None:
                _lib = _bind(ctypes.CDLL(str(build.host_library())))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, f64, i32 = ctypes.c_int64, ctypes.c_double, ctypes.c_int
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    sigs = {
        "ct_union_find": ([i64p, i64, i64, i64p], i32),
        "ct_greedy_additive": ([i64, i64p, f64p, i64, f64, i64p], i32),
        "ct_parallel_contract": ([i64, i64p, f64p, i64, i64, i32, f64, i64p], i32),
        "ct_merge_edge_features": ([u64p, f64p, i64, u64p, i64, f64p, f64p, f64p, f64p, f64p], i64),
        "ct_mutex_watershed": ([i64, i64p, i64p, u8p, i64p, i64, i64p], i32),
        "ct_kernighan_lin": ([i64, i64p, f64p, i64, i64p, i64, f64], i32),
        "ct_edt_sq": ([u8p, i64, i64, i64, f64, f64, f64, f64, f32p], i32),
        "ct_ws_flood": ([u8p, u8p, i32p, i64, i64, i64], i32),
    }
    for sym, (argtypes, restype) in sigs.items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def available() -> bool:
    """False inside :func:`force_python`; otherwise builds the library if
    need be (raising if it cannot) and returns True."""
    return _load() is not None


def union_find(pairs: np.ndarray, n_labels: int) -> Optional[np.ndarray]:
    """Min-label component roots (int64); pairs with an endpoint outside
    ``[0, n_labels)`` are ignored."""
    lib = _load()
    if lib is None:
        return None
    pairs = np.ascontiguousarray(np.asarray(pairs).reshape(-1, 2), np.int64)
    out = np.empty(int(n_labels), np.int64)
    _count("union_find")
    lib.ct_union_find(pairs, len(pairs), int(n_labels), out)
    return out


def greedy_additive(n_nodes: int, edges: np.ndarray, costs: np.ndarray,
                    stop_cost: float = 0.0) -> Optional[np.ndarray]:
    """GAEC labels 0..k-1 (heap order ``(-cost, u, v)``, as the Python path)."""
    lib = _load()
    if lib is None:
        return None
    edges = np.ascontiguousarray(np.asarray(edges).reshape(-1, 2), np.int64)
    costs = np.ascontiguousarray(np.asarray(costs, np.float64))
    out = np.empty(int(n_nodes), np.int64)
    _count("greedy_additive")
    lib.ct_greedy_additive(int(n_nodes), edges, costs, len(edges), float(stop_cost), out)
    return out


def parallel_contract(n_nodes: int, edges: np.ndarray, payload: np.ndarray, mode_max: bool,
                      threshold: float) -> Optional[np.ndarray]:
    """Round-based parallel edge contraction (``ops/contraction.py``
    semantics): labels 0..k-1.  ``payload`` is [m, k] float64 columns summed
    on merge; the priority is column 0 (k == 1) or column 0 / column 1
    (k == 2)."""
    lib = _load()
    if lib is None:
        return None
    edges = np.ascontiguousarray(np.asarray(edges).reshape(-1, 2), np.int64)
    payload = np.ascontiguousarray(np.asarray(payload, np.float64).reshape(len(edges), -1))
    out = np.empty(int(n_nodes), np.int64)
    _count("parallel_contract")
    lib.ct_parallel_contract(int(n_nodes), edges, payload, len(edges), payload.shape[1], int(bool(mode_max)),
                             float(threshold), out)
    return out


def kernighan_lin(n_nodes: int, edges: np.ndarray, costs: np.ndarray, init_labels: np.ndarray,
                  max_outer: int = 20, epsilon: float = 1e-9) -> Optional[np.ndarray]:
    """KL refinement of ``init_labels`` (copied; not relabelled)."""
    lib = _load()
    if lib is None:
        return None
    edges = np.ascontiguousarray(np.asarray(edges).reshape(-1, 2), np.int64)
    costs = np.ascontiguousarray(np.asarray(costs, np.float64))
    labels = np.ascontiguousarray(np.asarray(init_labels, np.int64)).copy()
    _count("kernighan_lin")
    lib.ct_kernighan_lin(int(n_nodes), edges, costs, len(edges), labels, int(max_outer), float(epsilon))
    return labels


def mutex_watershed(n_nodes: int, u: np.ndarray, v: np.ndarray, is_attractive: np.ndarray,
                    order: np.ndarray) -> Optional[np.ndarray]:
    """Mutex-watershed component roots per node.  ``order`` is the edge
    processing order (decreasing priority); the partition is that of
    ``ops/mws.py::python_constraint_loop``."""
    lib = _load()
    if lib is None:
        return None
    u = np.ascontiguousarray(np.asarray(u), np.int64)
    v = np.ascontiguousarray(np.asarray(v), np.int64)
    att = np.ascontiguousarray(np.asarray(is_attractive), np.uint8)
    order = np.ascontiguousarray(np.asarray(order), np.int64)
    out = np.empty(int(n_nodes), np.int64)
    _count("mutex_watershed")
    lib.ct_mutex_watershed(int(n_nodes), u, v, att, order, len(order), out)
    return out


def merge_edge_features(parts, table: np.ndarray):
    """Accumulate per-block ``(uv, feats[m, 5])`` parts onto the lexsorted
    ``table``: (running count-weighted mean, running M2 = var * n, min, max,
    count sums) per table row, by the streaming Chan combine."""
    lib = _load()
    if lib is None:
        return None
    table = np.ascontiguousarray(np.asarray(table).reshape(-1, 2), np.uint64)
    k = len(table)
    means = np.zeros(k, np.float64)
    m2s = np.zeros(k, np.float64)
    mins = np.full(k, np.inf)
    maxs = np.full(k, -np.inf)
    counts = np.zeros(k, np.float64)
    _count("merge_edge_features")
    for uv, feats in parts:
        if len(uv) == 0:
            continue
        uv = np.ascontiguousarray(np.asarray(uv).reshape(-1, 2), np.uint64)
        feats = np.asarray(feats, np.float64)
        if feats.ndim != 2 or feats.shape[1] != 5:
            raise ValueError(
                f"edge-feature block has {feats.shape} columns, expected (m, 5) (mean, min, max, count, "
                "variance) -- regenerate per-block features written by an older format"
            )
        lib.ct_merge_edge_features(uv, np.ascontiguousarray(feats), len(uv), table, k, means, m2s, mins, maxs,
                                   counts)
    return means, m2s, mins, maxs, counts


def edt_sq(fg: np.ndarray, sampling=None, cap: Optional[float] = None) -> Optional[np.ndarray]:
    """Exact squared EDT of a 3-D bool mask (float32).  ``sampling`` is the
    per-axis voxel size (scipy's convention); ``cap`` clips the unsquared
    distance, as the device kernels' ``dt_max_distance``."""
    lib = _load()
    if lib is None:
        return None
    fg = np.ascontiguousarray(np.asarray(fg), np.uint8)
    if fg.ndim != 3:
        raise ValueError("edt_sq expects a 3-D mask")
    nz, ny, nx = fg.shape
    sz, sy, sx = (1.0, 1.0, 1.0) if sampling is None else map(float, sampling)
    out = np.empty(fg.shape, np.float32)
    cap_sq = float(cap) * float(cap) if cap is not None else 0.0
    _count("edt_sq")
    lib.ct_edt_sq(fg, nz, ny, nx, sz, sy, sx, cap_sq, out)
    return out


def ws_flood(hmap: np.ndarray, fg: np.ndarray, seeds: np.ndarray) -> Optional[np.ndarray]:
    """Seeded watershed by a 256-level bucket-queue priority flood
    (6-connectivity) over a uint8 priority map.  ``seeds``: int32, > 0;
    returns the flooded labels, 0 outside ``fg`` or unreached."""
    lib = _load()
    if lib is None:
        return None
    hmap = np.ascontiguousarray(np.asarray(hmap), np.uint8)
    fg = np.ascontiguousarray(np.asarray(fg), np.uint8)
    if hmap.ndim != 3 or hmap.shape != fg.shape:
        raise ValueError("ws_flood expects matching 3-D hmap/fg")
    labels = np.ascontiguousarray(np.asarray(seeds), np.int32).copy()
    nz, ny, nx = hmap.shape
    _count("ws_flood")
    lib.ct_ws_flood(hmap, fg, labels, nz, ny, nx)
    return labels
