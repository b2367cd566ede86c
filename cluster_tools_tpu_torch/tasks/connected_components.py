"""Blockwise connected components with global label stitching.

Port of ``cluster_tools_tpu/tasks/connected_components.py``.  Per-block
labels are the global flat index of the component's minimum voxel + 1
(unique by construction, so no offset pass); the merge is a union-find
over the block-face equivalences.  Task chain:

    BlockComponents   (executor)   per-block CCL -> global labels + uniques
    MergeLabels       (host)       per-block uniques -> sorted label table
    BlockFaces        (host pool)  boundary scan (faces, plus edges and
                                   corners at connectivity > 1) -> pairs
    MergeAssignments  (device)     union-find -> consecutive 1..K table
    Write             (host pool)  apply the table blockwise
"""

from __future__ import annotations

import os
from itertools import product

import numpy as np
import torch

from ..ops.ccl import _neighbor_offsets, label_components_batched, label_components_keyed_tensor
from ..ops.unionfind import union_find_host, union_find_tensor
from ..runtime import handoff
from ..runtime.executor import BlockwiseExecutor, region_verifier, sweep_config, validate_labels
from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader, pad_block_to


def _uniques_path(tmp_folder: str, block_id: int) -> str:
    d = os.path.join(tmp_folder, "cc_uniques")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"block_{block_id}.npy")


def _faces_path(tmp_folder: str, block_id: int) -> str:
    d = os.path.join(tmp_folder, "cc_faces")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"block_{block_id}.npy")


class BlockComponentsBase(BaseTask):
    """Pass 1: per-block CCL on the thresholded or binary input.

    Params: ``input_path/input_key``, ``output_path/output_key`` (uint64
    labels), optional ``threshold`` + ``threshold_mode`` (``greater`` /
    ``less``), ``mask_path/mask_key``, ``keyed`` (components of equal-valued
    regions: CC on a segmentation).
    """

    task_name = "block_components"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "threshold": None, "threshold_mode": "greater",
                "connectivity": 1, "keyed": False}

    def run_impl(self):
        cfg = self.get_config()
        inp = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"])
        shape = inp.shape
        block_shape = tuple(cfg["block_shape"])
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        out = self.handoff_dataset(cfg["output_path"], cfg["output_key"], shape=shape, chunks=block_shape,
                                   dtype="uint64")
        # the per-block uniques are block-grain artifact handoffs: stamp the
        # marker epoch even when the dataset spilled at birth
        self.declare_handoff_producer()
        done = set(self.blocks_done())
        blocks_all = [blocking.get_block(b) for b in block_ids]
        threshold = cfg.get("threshold")
        mode = cfg.get("threshold_mode", "greater")
        connectivity = int(cfg.get("connectivity", 1))
        if not 1 <= connectivity <= len(shape):
            raise ValueError(f"connectivity must be in [1, {len(shape)}]")
        keyed = bool(cfg.get("keyed", False))
        mask_ds = file_reader(cfg["mask_path"])[cfg["mask_key"]] if cfg.get("mask_path") else None

        def load(block):
            data = np.asarray(inp[block.bb])
            if keyed:
                # dense per-block int32 keys; key identity only matters in a block
                _, keys = np.unique(data, return_inverse=True)
                keys = keys.reshape(data.shape).astype(np.int32)
                keys[data == 0] = 0
                if mask_ds is not None:
                    keys[~(np.asarray(mask_ds[block.bb]) > 0)] = 0
                return (pad_block_to(keys, block_shape),)
            if threshold is None:
                m = data > 0
            elif mode == "greater":
                m = data > threshold
            else:
                m = data < threshold
            if mask_ds is not None:
                m &= mask_ds[block.bb] > 0
            return (pad_block_to(m, block_shape).astype(bool),)

        n_pad = int(np.prod(block_shape))

        def kernel(m):
            if keyed:
                return label_components_keyed_tensor(m, connectivity=connectivity)
            return label_components_batched(m.unsqueeze(0), connectivity)[0]

        # the lane-batched form: both labellers take a leading item axis
        kernel.batched = (
            (lambda m: label_components_keyed_tensor(m, connectivity=connectivity, lead=1)) if keyed
            else (lambda m: label_components_batched(m, connectivity))
        )

        def store(block, raw):
            # raw: padded-block flat index of the component's min voxel, sentinel n
            bs = block.shape
            raw = raw[tuple(slice(0, s) for s in bs)]
            fg = raw < n_pad
            local = np.unravel_index(raw[fg].astype(np.int64), block_shape)
            coords = tuple(l + b for l, b in zip(local, block.begin))
            glob = np.ravel_multi_index(coords, shape).astype(np.uint64) + 1
            labels = np.zeros(bs, np.uint64)
            labels[fg] = glob
            out[block.bb] = labels
            self.save_handoff_array(_uniques_path(self.tmp_folder, block.block_id), np.unique(glob))

        sweep = BlockwiseExecutor.for_task(self.target, cfg, self.max_jobs).map_blocks(
            kernel, blocks_all, load, store,
            on_block_done=lambda b: self.log_block_success(b.block_id),
            done_block_ids=done, validate_fn=validate_labels, failures_path=self.failures_path,
            task_name=self.uid, store_verify_fn=region_verifier(out),
            # never splittable: the per-block CC decomposition (and the
            # min-voxel label of a component crossing a would-be split
            # plane) changes under sub-block re-execution
            splittable=False, **sweep_config(cfg),
        )
        return {"n_blocks": len(block_ids), "shape": list(shape), "sweep": sweep}


class BlockComponentsLocal(BlockComponentsBase):
    target = "local"


class BlockComponentsGPU(BlockComponentsBase):
    target = "gpu"


class MergeLabelsBase(BaseTask):
    """Merge per-block unique labels into the sorted global label table."""

    task_name = "merge_labels"

    def run_impl(self):
        cfg = self.get_config()
        shape = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"]).shape
        block_ids = blocks_in_volume(shape, tuple(cfg["block_shape"]), cfg.get("roi_begin"), cfg.get("roi_end"))
        uniques = [handoff.load_array(_uniques_path(self.tmp_folder, b)) for b in block_ids
                   if handoff.array_exists(_uniques_path(self.tmp_folder, b))]
        table = np.unique(np.concatenate(uniques)) if uniques else np.zeros(0, np.uint64)
        self.save_handoff_array(os.path.join(self.tmp_folder, "cc_label_table.npy"), table)
        return {"n_labels": len(table)}


class MergeLabelsLocal(MergeLabelsBase):
    target = "local"


class MergeLabelsGPU(MergeLabelsBase):
    target = "gpu"


def _shifted_views(a: np.ndarray, b: np.ndarray, shifts) -> tuple:
    """Views pairing ``a[p]`` with ``b[p + shifts]`` (per free axis)."""
    sl_a, sl_b = [], []
    for sh, n in zip(shifts, a.shape):
        if sh == 1:
            sl_a.append(slice(0, n - 1))
            sl_b.append(slice(1, n))
        elif sh == -1:
            sl_a.append(slice(1, n))
            sl_b.append(slice(0, n - 1))
        else:
            sl_a.append(slice(None))
            sl_b.append(slice(None))
    return a[tuple(sl_a)], b[tuple(sl_b)]


class BlockFacesBase(BaseTask):
    """Pass 2: label equivalences across block boundaries.

    For every block and every unordered neighbour direction (faces at
    connectivity 1; faces, edges and corners above), the one-voxel slabs on
    either side of the shared boundary give ``(label_a, label_b)`` pairs for
    every voxel offset with at most ``connectivity`` differing coordinates
    (scipy's neighbourhood).  Host-side: thin-slab IO.
    """

    task_name = "block_faces"

    def run_impl(self):
        cfg = self.get_config()
        connectivity = int(cfg.get("connectivity", 1))
        keyed = bool(cfg.get("keyed", False))
        inp_ds = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"]) if keyed else None
        ds = handoff.resolve_dataset(cfg["output_path"], cfg["output_key"])
        shape = ds.shape
        ndim = len(shape)
        block_shape = tuple(cfg["block_shape"])
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        roi_set = set(block_ids)
        if not 1 <= connectivity <= ndim:
            raise ValueError(f"connectivity must be in [1, {ndim}]")
        # the half-neighbourhood doubles as the unordered block-direction list
        directions = _neighbor_offsets(ndim, connectivity)
        self.declare_handoff_producer()

        def slab_bbs(block, d):
            """(our-side bb, neighbour-side bb) of the shared boundary."""
            bb_a, bb_b = [], []
            for a, o in enumerate(d):
                b, e = block.begin[a], block.end[a]
                if o == 1:
                    bb_a.append(slice(e - 1, e))
                    bb_b.append(slice(e, e + 1))
                elif o == -1:
                    bb_a.append(slice(b, b + 1))
                    bb_b.append(slice(b - 1, b))
                else:
                    bb_a.append(slice(b, e))
                    bb_b.append(slice(b, e))
            return tuple(bb_a), tuple(bb_b)

        def process(block_id: int):
            block = blocking.get_block(block_id)
            pairs = []
            for d in directions:
                nbr = blocking.neighbor_id_offset(block_id, d)
                if nbr is None or nbr not in roi_set:
                    continue
                bb_a, bb_b = slab_bbs(block, d)
                crossing = tuple(a for a in range(ndim) if d[a] != 0)
                A = np.asarray(ds[bb_a]).squeeze(axis=crossing)
                B = np.asarray(ds[bb_b]).squeeze(axis=crossing)
                if keyed:
                    ka = np.asarray(inp_ds[bb_a]).squeeze(axis=crossing)
                    kb = np.asarray(inp_ds[bb_b]).squeeze(axis=crossing)
                free_budget = connectivity - len(crossing)
                for s in product((-1, 0, 1), repeat=ndim - len(crossing)):
                    if sum(1 for o in s if o) > free_budget:
                        continue
                    av, bv = _shifted_views(A, B, s)
                    both = (av > 0) & (bv > 0)
                    if keyed:
                        # merge across the boundary only where the segment matches
                        kav, kbv = _shifted_views(ka, kb, s)
                        both &= kav == kbv
                    if both.any():
                        pairs.append(np.unique(np.stack([av[both], bv[both]], axis=1), axis=0))
            result = np.concatenate(pairs) if pairs else np.zeros((0, 2), np.uint64)
            self.save_handoff_array(_faces_path(self.tmp_folder, block_id), result)

        return {"n_blocks": self.host_block_map(block_ids, process)}


class BlockFacesLocal(BlockFacesBase):
    target = "local"


class BlockFacesGPU(BlockFacesBase):
    target = "gpu"


class MergeAssignmentsBase(BaseTask):
    """Union-find over all face equivalences -> global assignment table,
    roots renumbered consecutively.  On the task's device, or on the host
    (``union_find_host``) when ``use_device`` is False."""

    task_name = "merge_assignments"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "use_device": True}

    def run_impl(self):
        cfg = self.get_config()
        shape = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"]).shape
        table = handoff.load_array(os.path.join(self.tmp_folder, "cc_label_table.npy"))
        block_ids = blocks_in_volume(shape, tuple(cfg["block_shape"]), cfg.get("roi_begin"), cfg.get("roi_end"))
        pair_files = [_faces_path(self.tmp_folder, b) for b in block_ids
                      if handoff.array_exists(_faces_path(self.tmp_folder, b))]
        pairs = (np.concatenate([handoff.load_array(f) for f in pair_files]) if pair_files
                 else np.zeros((0, 2), np.uint64))
        if len(pairs):
            pairs = np.unique(pairs, axis=0)
        n = len(table)
        dense_pairs = np.searchsorted(table, pairs).astype(np.int64)
        if n and cfg.get("use_device", True) and len(dense_pairs):
            pairs_t = torch.from_numpy(dense_pairs.astype(np.int32)).to(self.device)
            roots = union_find_tensor(pairs_t, n).cpu().numpy().astype(np.int64)
        else:
            roots = union_find_host(dense_pairs, n)
        uniq_roots, assignment = np.unique(roots, return_inverse=True)
        assignment = (assignment + 1).astype(np.uint64)
        self.save_handoff_arrays(os.path.join(self.tmp_folder, "cc_assignments.npz"), keys=table, values=assignment)
        return {"n_labels": n, "n_components": len(uniq_roots)}


class MergeAssignmentsLocal(MergeAssignmentsBase):
    target = "local"


class MergeAssignmentsGPU(MergeAssignmentsBase):
    target = "gpu"


class ConnectedComponentsWorkflow(WorkflowBase):
    """End-to-end blockwise CCL (the reference's ``ConnectedComponentsWorkflow``)."""

    task_name = "connected_components_workflow"

    def requires(self):
        from . import connected_components as cc_mod
        from . import write as write_mod

        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        p = self.params
        # provisional per-block labels live in a tmp dataset, so the final
        # write never mutates its own input (crash-safe block resume)
        tmp_path = os.path.join(self.tmp_folder, "cc_blocks.zarr")
        tmp_key = "labels"
        bs = {k: p[k] for k in ("block_shape",) if k in p}
        t1 = get_task_cls(cc_mod, "BlockComponents", self.target)(
            **common, dependencies=self.dependencies, input_path=p["input_path"], input_key=p["input_key"],
            output_path=tmp_path, output_key=tmp_key,
            **{k: p[k] for k in ("threshold", "threshold_mode", "mask_path", "mask_key", "block_shape",
                                 "connectivity", "keyed") if k in p},
        )
        t2 = get_task_cls(cc_mod, "MergeLabels", self.target)(
            **common, dependencies=[t1], input_path=p["input_path"], input_key=p["input_key"], **bs,
        )
        t3 = get_task_cls(cc_mod, "BlockFaces", self.target)(
            **common, dependencies=[t2], output_path=tmp_path, output_key=tmp_key, input_path=p["input_path"],
            input_key=p["input_key"], **{k: p[k] for k in ("block_shape", "connectivity", "keyed") if k in p},
        )
        t4 = get_task_cls(cc_mod, "MergeAssignments", self.target)(
            **common, dependencies=[t3], input_path=p["input_path"], input_key=p["input_key"], **bs,
        )
        t5 = get_task_cls(write_mod, "Write", self.target)(
            **common, dependencies=[t4], input_path=tmp_path, input_key=tmp_key, output_path=p["output_path"],
            output_key=p["output_key"], assignment_path=os.path.join(self.tmp_folder, "cc_assignments.npz"), **bs,
        )
        return [t5]
