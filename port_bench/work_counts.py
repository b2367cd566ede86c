"""The least time of a kernel entry's work on one H100, counted from its
arguments.

A frozen copy of ``chip_smoke.py::bound_ms`` as of commit d706128, with
the chip's peaks beside it.  Bytes count each input read once and the
output written once; operations count what the function needs, not what
an implementation does.  The least time is the larger of bytes over the
memory rate and operations over their type's rate.  The peaks are NVIDIA's
H100 SXM data sheet at the full 700 W power limit: 3.35 TB/s of HBM3,
67 TFLOP/s of float32 outside the tensor cores with a fused multiply-add
counted as two (so 33.5e12 plain float32 operations a second), and
int32 at half of that.
"""

from __future__ import annotations

from typing import Dict, Tuple

MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = 67e12 / 4


def call_work(name: str, shapes: Dict[str, int], live_tiles: int = 0) -> Tuple[float, float]:
    """``(bytes, seconds of operations)`` of one call of entry ``name``.

    ``shapes`` holds ``n`` (voxels of the first argument), ``itemsize``
    (its element size), and for ``edt_cascade`` its ``radius``, for
    ``apply_remap`` the tables' ``slots`` (rows times columns) and
    ``rows``.  ``live_tiles`` is the tiles of ``apply_remap`` whose table
    changes a label."""
    n = shapes["n"]
    t_ops = 0.0
    if name in ("tile_ccl", "tile_ccl_doubling"):
        nbytes = n * (shapes["itemsize"] + 4)
    elif name == "tile_ws_propagate":
        nbytes = n * 12
    elif name == "edt_cascade":
        nbytes = n * 8
        # per step: min of the two neighbours, one float32 add, one min
        t_ops = 3.0 * shapes["radius"] * n / FP32_OPS_PER_S
    elif name == "apply_remap":
        nbytes = n * 8 + shapes["slots"] * 8
        # hash (multiply, shift), compare the key, select: 4 int32 operations
        t_ops = 4.0 * live_tiles * (n / shapes["rows"]) / INT32_OPS_PER_S
    else:
        raise ValueError(f"no work count for {name!r}")
    return float(nbytes), t_ops


def least_seconds(name: str, shapes: Dict[str, int], live_tiles: int = 0) -> float:
    """The larger of the call's bytes over the memory rate and its
    operations over their rate."""
    nbytes, t_ops = call_work(name, shapes, live_tiles)
    return max(nbytes / MEM_BYTES_PER_S, t_ops)
