"""Block-grid math and bounding-box helpers.

Port (a copy) of ``cluster_tools_tpu/utils/volume_utils.py``, with
:func:`file_reader` opening the port's own containers (``..io``).  A block
is an axis-aligned box of the volume; kernels read it with a halo (clipped
at the volume border) and write only the inner block, so all writes are
disjoint.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

Coord = Tuple[int, ...]
BoundingBox = Tuple[slice, ...]


@dataclass(frozen=True)
class Block:
    """One block of a :class:`Blocking` grid: ``begin``/``end`` delimit the
    inner block, ``outer_begin``/``outer_end`` the halo-extended region."""

    block_id: int
    begin: Coord
    end: Coord
    outer_begin: Coord
    outer_end: Coord

    @property
    def shape(self) -> Coord:
        return tuple(e - b for b, e in zip(self.begin, self.end))

    @property
    def outer_shape(self) -> Coord:
        return tuple(e - b for b, e in zip(self.outer_begin, self.outer_end))

    @property
    def bb(self) -> BoundingBox:
        return tuple(slice(b, e) for b, e in zip(self.begin, self.end))

    @property
    def outer_bb(self) -> BoundingBox:
        return tuple(slice(b, e) for b, e in zip(self.outer_begin, self.outer_end))

    @property
    def inner_in_outer_bb(self) -> BoundingBox:
        """Slice selecting the inner block out of the outer (halo) block."""
        return tuple(slice(b - ob, e - ob) for b, e, ob in zip(self.begin, self.end, self.outer_begin))


class Blocking:
    """Regular block decomposition of an N-D volume."""

    def __init__(self, shape: Sequence[int], block_shape: Sequence[int]):
        if len(shape) != len(block_shape):
            raise ValueError(f"shape {shape} and block_shape {block_shape} must have the same rank")
        if any(b <= 0 for b in block_shape):
            raise ValueError(f"invalid block_shape {block_shape}")
        self.shape = tuple(int(s) for s in shape)
        self.block_shape = tuple(int(b) for b in block_shape)
        self.grid_shape = tuple(max(1, math.ceil(s / b)) for s, b in zip(self.shape, self.block_shape))
        self.n_blocks = int(np.prod(self.grid_shape))

    def block_grid_position(self, block_id: int) -> Coord:
        if not 0 <= block_id < self.n_blocks:
            raise IndexError(f"block_id {block_id} out of range [0, {self.n_blocks})")
        return tuple(int(p) for p in np.unravel_index(block_id, self.grid_shape))

    def grid_position_to_id(self, pos: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(pos), self.grid_shape))

    def get_block(self, block_id: int, halo: Optional[Sequence[int]] = None) -> Block:
        pos = self.block_grid_position(block_id)
        begin = tuple(p * b for p, b in zip(pos, self.block_shape))
        end = tuple(min((p + 1) * b, s) for p, b, s in zip(pos, self.block_shape, self.shape))
        if halo is None:
            outer_begin, outer_end = begin, end
        else:
            if len(halo) != len(self.shape):
                raise ValueError(f"halo {halo} has wrong rank for shape {self.shape}")
            outer_begin = tuple(max(0, b - h) for b, h in zip(begin, halo))
            outer_end = tuple(min(s, e + h) for e, h, s in zip(end, halo, self.shape))
        return Block(block_id, begin, end, outer_begin, outer_end)

    def neighbor_id_offset(self, block_id: int, offset: Sequence[int]) -> Optional[int]:
        """Grid neighbour at a per-axis offset (diagonals included), or None."""
        pos = [p + int(o) for p, o in zip(self.block_grid_position(block_id), offset)]
        if any(not 0 <= p < g for p, g in zip(pos, self.grid_shape)):
            return None
        return self.grid_position_to_id(pos)


def blocks_in_volume(shape: Sequence[int], block_shape: Sequence[int],
                     roi_begin: Optional[Sequence[int]] = None,
                     roi_end: Optional[Sequence[int]] = None) -> List[int]:
    """Ids of all blocks intersecting the ROI (the whole volume if none)."""
    blocking = Blocking(shape, block_shape)
    if roi_begin is None and roi_end is None:
        return list(range(blocking.n_blocks))
    roi_begin = tuple(0 if b is None else int(b) for b in (roi_begin or [None] * len(shape)))
    roi_end = tuple(s if e is None else int(e) for e, s in zip(roi_end or [None] * len(shape), shape))
    lo = [rb // bs for rb, bs in zip(roi_begin, block_shape)]
    hi = [min(gs, math.ceil(re / bs)) for re, bs, gs in zip(roi_end, block_shape, blocking.grid_shape)]
    return [blocking.grid_position_to_id([p + l for p, l in zip(pos, lo)])
            for pos in np.ndindex(*[h - l for l, h in zip(lo, hi)])]


def pad_block_to(data: np.ndarray, target_shape: Sequence[int], mode: str = "constant", **kwargs) -> np.ndarray:
    """Pad a border-clipped block up to ``target_shape`` (one kernel shape
    for every block)."""
    pad = [(0, t - s) for s, t in zip(data.shape, target_shape)]
    if any(p[1] < 0 for p in pad):
        raise ValueError(f"block {data.shape} larger than target {target_shape}")
    if all(p[1] == 0 for p in pad):
        return data
    return np.pad(data, pad, mode=mode, **kwargs)


def file_reader(path: str, mode: str = "a"):
    """Open a container by extension: ``.zarr``/``.zr`` (the port's numpy
    zarr v2) or ``memory://``; see :func:`..io.open_container`."""
    from ..io import open_container

    return open_container(path, mode=mode)


def get_shape(path: str, key: str) -> Tuple[int, ...]:
    with file_reader(path, "r") as f:
        return tuple(f[key].shape)
