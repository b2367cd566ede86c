"""Label multisets: per-cell label histograms for multiscale label data.

Port of ``cluster_tools_tpu/tasks/label_multisets.py``: a downscaled label
voxel is the multiset of the s0 labels it covers, with their counts, so
coarse levels stay exact about what they contain.  Stored as one npz per
block beside an ``argmax`` dataset (the winning label per cell, what
viewers render):

    <output_key>                      uint64 dataset, the argmax per cell
    tmp/label_multisets/s<level>/block_<id>.npz
        offsets  [n_cells+1]  CSR offsets into entries
        labels / counts       concatenated per-cell histograms
        cells                 the block's cell grid shape

Scale s+1 multisets are built from scale-s multisets by exact count
accumulation, not re-sampling.  Numpy on the host on every target, as in
the reference, with exact integer counts; each level's histograms are
built for all cells at once (sorted runs, then one lexicographic sort of
the (parent cell, label) entries) where the reference loops over cells,
with the same arrays as its result.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..runtime.executor import region_verifier
from ..runtime.task import BaseTask
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


def multiset_dir(tmp_folder: str, level: int) -> str:
    d = os.path.join(tmp_folder, "label_multisets", f"s{level}")
    os.makedirs(d, exist_ok=True)
    return d


def _runs_argmax(cell_of: np.ndarray, labels: np.ndarray, counts: np.ndarray, n_cells: int) -> np.ndarray:
    """Per cell, the label with the most counts among its non-zero labels,
    the smallest among ties (the first, in each cell's ascending labels); 0
    for a cell of background only.  ``cell_of``/``labels``/``counts`` list
    each cell's (label, count) entries, grouped by cell in ascending cell
    order, labels ascending within a cell."""
    argmax = np.zeros(n_cells, np.uint64)
    fg = labels != 0
    if not fg.any():
        return argmax
    c_fg, l_fg, n_fg = cell_of[fg], labels[fg], counts[fg]
    best = np.full(n_cells, -1, np.int64)
    np.maximum.at(best, c_fg, n_fg)
    hit = np.flatnonzero(n_fg == best[c_fg])
    cells, first = np.unique(c_fg[hit], return_index=True)
    argmax[cells] = l_fg[hit[first]]
    return argmax


def cell_multisets(seg: np.ndarray, factor: Sequence[int]):
    """Per-cell label histograms for one block: CSR arrays
    (offsets, labels, counts) over cells in C order, plus the argmax grid
    (the most frequent non-zero label of a cell, the smallest among ties;
    0 for a cell of background only).  Each cell's voxels are sorted and
    cut into runs of equal labels: the per-cell ``np.unique`` of the
    reference, for all cells at once."""
    factor = tuple(int(f) for f in factor)
    pad = [(0, (-s) % f) for s, f in zip(seg.shape, factor)]
    sentinel = np.uint64(np.iinfo(np.uint64).max)
    if any(p[1] for p in pad):
        # sentinel padding keeps counts exact on non-divisible shapes; the
        # sentinel is dropped from every cell histogram below
        seg = np.pad(seg, pad, mode="constant", constant_values=sentinel)
    new_shape = []
    for s, f in zip(seg.shape, factor):
        new_shape += [s // f, f]
    order = [2 * i for i in range(seg.ndim)] + [2 * i + 1 for i in range(seg.ndim)]
    cells = np.sort(seg.reshape(new_shape).transpose(order).reshape(-1, int(np.prod(factor))), axis=1)
    n_cells, k = cells.shape
    starts = np.ones(cells.shape, bool)
    starts[:, 1:] = cells[:, 1:] != cells[:, :-1]
    flat_starts = np.flatnonzero(starts)
    labels = cells.reshape(-1)[flat_starts]
    # a run ends where the next starts, or at the end of its cell's row
    ends = np.append(flat_starts[1:], n_cells * k)
    cell_of = flat_starts // k
    counts = (np.minimum(ends, (cell_of + 1) * k) - flat_starts).astype(np.int64)
    keep = labels != sentinel
    labels, counts, cell_of = labels[keep].astype(np.uint64), counts[keep], cell_of[keep]
    offsets = np.zeros(n_cells + 1, np.int64)
    np.cumsum(np.bincount(cell_of, minlength=n_cells), out=offsets[1:])
    grid = tuple(s // f for s, f in zip(seg.shape, factor))
    return offsets, labels, counts, _runs_argmax(cell_of, labels, counts, n_cells).reshape(grid)


class CreateMultisetBase(BaseTask):
    """Scale-1 multisets + argmax from the s0 segmentation.  Params:
    ``input_path/input_key``, ``output_path/output_key``,
    ``scale_factor``."""

    task_name = "create_multiset"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "scale_factor": [2, 2, 2]}

    def run_impl(self):
        cfg = self.get_config()
        ds = file_reader(cfg["input_path"])[cfg["input_key"]]
        shape = ds.shape
        factor = tuple(int(f) for f in cfg.get("scale_factor", [2, 2, 2]))
        out_shape = tuple((s + f - 1) // f for s, f in zip(shape, factor))
        block_shape = tuple(cfg["block_shape"])
        out = file_reader(cfg["output_path"]).require_dataset(cfg["output_key"], shape=out_shape, chunks=block_shape,
                                                              dtype="uint64")
        # blocks over the OUTPUT grid; input window = block * factor
        blocking = Blocking(out_shape, block_shape)
        block_ids = blocks_in_volume(out_shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        d = multiset_dir(self.tmp_folder, 1)

        def process(block_id):
            block = blocking.get_block(block_id)
            in_bb = tuple(slice(b.start * f, min(b.stop * f, s)) for b, f, s in zip(block.bb, factor, shape))
            offsets, labels, counts, argmax = cell_multisets(np.asarray(ds[in_bb]), factor)
            np.savez(os.path.join(d, f"block_{block_id}.npz"), offsets=offsets, labels=labels, counts=counts,
                     cells=np.asarray(argmax.shape, np.int64))
            out[block.bb] = argmax

        n = self.host_block_map(block_ids, process, store_verify_fn=region_verifier(out), blocking=blocking)
        out.update_attrs(downsamplingFactors=list(factor), isLabelMultiset=True)
        return {"n_blocks": n, "out_shape": list(out_shape)}


class CreateMultisetLocal(CreateMultisetBase):
    target = "local"


class CreateMultisetGPU(CreateMultisetBase):
    target = "gpu"


class DownscaleMultisetBase(BaseTask):
    """Scale s -> s+1 by exact count accumulation from the scale-s
    multisets.  One task in the main process: the multiset artifacts are
    host-side CSR files.  Params: ``level`` (produce ``s<level+1>``), ``level_shape``
    (the cell grid at ``level``), ``output_path/output_key``,
    ``scale_factor``."""

    task_name = "downscale_multiset"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "scale_factor": [2, 2, 2]}

    def run_impl(self):
        cfg = self.get_config()
        level = int(cfg["level"])
        factor = tuple(int(f) for f in cfg.get("scale_factor", [2, 2, 2]))
        src_dir = multiset_dir(self.tmp_folder, level)
        dst_dir = multiset_dir(self.tmp_folder, level + 1)
        shape = tuple(cfg["level_shape"])
        block_shape = tuple(cfg["block_shape"])
        blocking = Blocking(shape, block_shape)
        out_shape = tuple((s + f - 1) // f for s, f in zip(shape, factor))
        out = file_reader(cfg["output_path"]).require_dataset(cfg["output_key"], shape=out_shape, chunks=block_shape,
                                                              dtype="uint64")

        # every (cell, label, count) entry of the level, keyed by its parent
        # cell's index in the next level's C order, summed per (parent, label)
        parents, labs, cnts = [], [], []
        for b in range(blocking.n_blocks):
            p = os.path.join(src_dir, f"block_{b}.npz")
            if not os.path.exists(p):
                continue
            block = blocking.get_block(b)
            with np.load(p) as f:
                offsets, labels, counts = f["offsets"], f["labels"], f["counts"]
                cells = tuple(f["cells"])
            grid = np.array(np.unravel_index(np.arange(int(np.prod(cells))), cells)).T
            coord = (grid + np.asarray(block.begin)) // np.asarray(factor)
            parent = np.ravel_multi_index(tuple(coord.T), out_shape)
            parents.append(np.repeat(parent, np.diff(offsets)))
            labs.append(labels.astype(np.uint64))
            cnts.append(counts.astype(np.int64))
        parent = np.concatenate(parents) if parents else np.zeros(0, np.int64)
        lab = np.concatenate(labs) if labs else np.zeros(0, np.uint64)
        cnt = np.concatenate(cnts) if cnts else np.zeros(0, np.int64)
        order = np.lexsort((lab, parent))
        parent, lab, cnt = parent[order], lab[order], cnt[order]
        first = np.ones(len(parent), bool)
        first[1:] = (parent[1:] != parent[:-1]) | (lab[1:] != lab[:-1])
        at = np.flatnonzero(first)
        parent, lab, cnt = parent[at], lab[at], np.add.reduceat(cnt, at) if len(at) else cnt[at]
        coords = np.array(np.unravel_index(parent, out_shape)).T.reshape(-1, len(out_shape))

        out_blocking = Blocking(out_shape, block_shape)
        for b in range(out_blocking.n_blocks):
            block = out_blocking.get_block(b)
            inside = ((coords >= np.asarray(block.begin)) & (coords < np.asarray(block.end))).all(axis=1)
            local = np.ravel_multi_index(tuple((coords[inside] - np.asarray(block.begin)).T), block.shape)
            n_cells = int(np.prod(block.shape))
            offsets = np.zeros(n_cells + 1, np.int64)
            np.cumsum(np.bincount(local, minlength=n_cells), out=offsets[1:])
            argmax = _runs_argmax(local, lab[inside], cnt[inside], n_cells).reshape(block.shape)
            np.savez(os.path.join(dst_dir, f"block_{b}.npz"), offsets=offsets, labels=lab[inside],
                     counts=cnt[inside], cells=np.asarray(block.shape, np.int64))
            out[block.bb] = argmax
        out.update_attrs(isLabelMultiset=True)
        return {"level": level + 1, "out_shape": list(out_shape)}


class DownscaleMultisetLocal(DownscaleMultisetBase):
    target = "local"


class DownscaleMultisetGPU(DownscaleMultisetBase):
    target = "gpu"
