"""Postprocessing: size filtering, connected components on a segmentation,
hole filling and the graph-watershed size filter.

Port of ``cluster_tools_tpu/tasks/postprocess.py``: per-block label
histograms (``BlockLabelSizes``), the merged keep/drop assignment
(``SizeFilterAssignments``) and :class:`SizeFilterWorkflow`, which writes
it through the generic write task (staged first when the write is in
place); :class:`ConnectedComponentsOnSegmentationWorkflow`, the cc chain
with the keyed labeller (voxels connect only where their segment ids are
equal), on the task's device; :class:`FillHolesWorkflow`, whose background
mask goes through ``Threshold`` and the cc chain, then per-block contact
votes (``HoleVotes``), the merged fill table (``MergeHoleAssignments``) and
``FillHolesWrite``; and :class:`GraphWatershedSizeFilterWorkflow`, which
builds the region graph and its edge features on the task's device and
absorbs each small segment into its kept neighbour across the weakest
boundary (``GraphWatershedAssignments``).  The votes, merges and
assignments are numpy on the host, as in the reference, in its order (the
contact votes count (component, segment) rows through one 64-bit key,
:func:`..ops.rag.unique_pair_counts`: the same rows in the same order).
``ThresholdedComponentsWorkflow`` chains the size filter after connected
components.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.rag import unique_pair_counts
from ..runtime.executor import region_verifier
from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


def _sizes_dir(tmp_folder):
    d = os.path.join(tmp_folder, "label_sizes")
    os.makedirs(d, exist_ok=True)
    return d


class BlockLabelSizesBase(BaseTask):
    """Per-block label histograms (unique labels + voxel counts)."""

    task_name = "block_label_sizes"

    def run_impl(self):
        cfg = self.get_config()
        ds = file_reader(cfg["input_path"])[cfg["input_key"]]
        shape = ds.shape
        block_shape = tuple(cfg["block_shape"])
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        d = _sizes_dir(self.tmp_folder)

        def process(block_id):
            labels = ds[blocking.get_block(block_id).bb]
            u, c = np.unique(labels[labels != 0], return_counts=True)
            np.savez(os.path.join(d, f"block_{block_id}.npz"), labels=u, counts=c)

        n = self.host_block_map(block_ids, process)
        return {"n_blocks": n}


class BlockLabelSizesLocal(BlockLabelSizesBase):
    target = "local"


class BlockLabelSizesGPU(BlockLabelSizesBase):
    target = "gpu"


class SizeFilterAssignmentsBase(BaseTask):
    """Merge histograms -> assignment keeping labels with
    ``min_size <= size < max_size`` (others -> 0), optionally relabeled
    consecutively (``relabel=True``, default)."""

    task_name = "size_filter_assignments"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "min_size": 1, "max_size": None, "relabel": True}

    def run_impl(self):
        cfg = self.get_config()
        shape = file_reader(cfg["input_path"])[cfg["input_key"]].shape
        block_ids = blocks_in_volume(shape, tuple(cfg["block_shape"]), cfg.get("roi_begin"), cfg.get("roi_end"))
        d = _sizes_dir(self.tmp_folder)
        all_labels = {}
        for b in block_ids:
            f = os.path.join(d, f"block_{b}.npz")
            if not os.path.exists(f):
                continue
            with np.load(f) as npz:
                for lab, cnt in zip(npz["labels"], npz["counts"]):
                    all_labels[int(lab)] = all_labels.get(int(lab), 0) + int(cnt)
        keys = np.array(sorted(all_labels), dtype=np.uint64)
        sizes = np.array([all_labels[int(k)] for k in keys], dtype=np.int64)
        min_size = int(cfg.get("min_size") or 1)
        max_size = cfg.get("max_size")
        keep = sizes >= min_size
        if max_size is not None:
            keep &= sizes < int(max_size)
        if cfg.get("relabel", True):
            values = np.zeros(len(keys), np.uint64)
            values[keep] = np.arange(1, int(keep.sum()) + 1, dtype=np.uint64)
        else:
            values = np.where(keep, keys, np.uint64(0))
        np.savez(os.path.join(self.tmp_folder, "size_filter_assignments.npz"), keys=keys, values=values)
        return {"n_labels": int(len(keys)), "n_kept": int(keep.sum()), "n_filtered": int((~keep).sum())}


class SizeFilterAssignmentsLocal(SizeFilterAssignmentsBase):
    target = "local"


class SizeFilterAssignmentsGPU(SizeFilterAssignmentsBase):
    target = "gpu"


class SizeFilterWorkflow(WorkflowBase):
    """sizes -> filter assignment -> write (the reference's ``SizeFilterWorkflow``)."""

    task_name = "size_filter_workflow"

    def requires(self):
        from . import postprocess as pp_mod
        from .relabel import staged_write_tasks

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        bs = {k: p[k] for k in ("block_shape",) if k in p}
        io = dict(input_path=p["input_path"], input_key=p["input_key"])
        t1 = get_task_cls(pp_mod, "BlockLabelSizes", self.target)(**common, dependencies=self.dependencies, **io, **bs)
        t2 = get_task_cls(pp_mod, "SizeFilterAssignments", self.target)(
            **common, dependencies=[t1], **io, **bs,
            **{k: p[k] for k in ("min_size", "max_size", "relabel") if k in p},
        )
        t3 = staged_write_tasks(
            self, [t2], assignment_path=os.path.join(self.tmp_folder, "size_filter_assignments.npz"),
            input_path=p["input_path"], input_key=p["input_key"],
            output_path=p.get("output_path", p["input_path"]), output_key=p.get("output_key", p["input_key"]),
            stage_name="size_filter", bs=bs,
        )
        return [t3]

    def run_impl(self):
        return {}


class ConnectedComponentsOnSegmentationWorkflow(WorkflowBase):
    """Split every segment into its spatially connected parts: the
    blockwise cc chain with the keyed labeller
    (:func:`..ops.ccl.label_components_keyed_tensor`) on the task's device."""

    task_name = "cc_on_segmentation_workflow"

    def requires(self):
        from .connected_components import ConnectedComponentsWorkflow

        return [ConnectedComponentsWorkflow(tmp_folder=self.tmp_folder, config_dir=self.config_dir,
                                            max_jobs=self.max_jobs, target=self.target,
                                            dependencies=self.dependencies, keyed=True, **self.params)]


def _hole_dir(tmp_folder):
    d = os.path.join(tmp_folder, "fill_holes")
    os.makedirs(d, exist_ok=True)
    return d


class HoleVotesBase(BaseTask):
    """Per block: which background components touch the volume border, and
    per (background component, segment) face-contact counts.

    Params: ``input_path/input_key`` (the segmentation), ``cc_path/cc_key``
    (cc labels of the background mask).
    """

    task_name = "hole_votes"

    def run_impl(self):
        from .graph import _upper_halo_bb

        cfg = self.get_config()
        seg_ds = file_reader(cfg["input_path"])[cfg["input_key"]]
        cc_ds = file_reader(cfg["cc_path"])[cfg["cc_key"]]
        shape = seg_ds.shape
        block_shape = tuple(cfg["block_shape"])
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        d = _hole_dir(self.tmp_folder)

        def process(block_id):
            block = blocking.get_block(block_id)
            # +1 upper halo so cross-block contacts are counted once
            bb = _upper_halo_bb(block, shape)
            seg = np.asarray(seg_ds[bb])
            cc = np.asarray(cc_ds[bb])
            votes = {}
            for axis in range(seg.ndim):
                sl_a = [slice(0, n) for n in block.shape]
                sl_b = [slice(0, n) for n in block.shape]
                n_ax = min(block.shape[axis] + 1, seg.shape[axis])
                sl_a[axis] = slice(0, n_ax - 1)
                sl_b[axis] = slice(1, n_ax)
                cc_a, cc_b = cc[tuple(sl_a)], cc[tuple(sl_b)]
                sg_a, sg_b = seg[tuple(sl_a)], seg[tuple(sl_b)]
                for hole, lab in ((cc_a, sg_b), (cc_b, sg_a)):
                    m = (hole > 0) & (lab > 0)
                    if m.any():
                        uv, c = unique_pair_counts(np.stack([hole[m], lab[m]], 1).astype(np.uint64))
                        for (h, l), n_votes in zip(uv, c):
                            key = (int(h), int(l))
                            votes[key] = votes.get(key, 0) + int(n_votes)
            # background components on the volume border are not holes
            border = set()
            for axis in range(seg.ndim):
                for edge, face in ((0, block.begin[axis]), (shape[axis], block.end[axis])):
                    if face != edge:
                        continue
                    sl = [slice(0, n) for n in block.shape]
                    sl[axis] = slice(0, 1) if edge == 0 else slice(block.shape[axis] - 1, block.shape[axis])
                    u = np.unique(cc[tuple(sl)])
                    border.update(int(x) for x in u[u > 0])
            pairs = np.array(sorted(votes), np.uint64).reshape(-1, 2)
            counts = np.array([votes[tuple(map(int, p))] for p in pairs], np.int64)
            np.savez(os.path.join(d, f"block_{block_id}.npz"), pairs=pairs, counts=counts,
                     border=np.array(sorted(border), np.uint64))

        n = self.host_block_map(block_ids, process)
        return {"n_blocks": n}


class HoleVotesLocal(HoleVotesBase):
    target = "local"


class HoleVotesGPU(HoleVotesBase):
    target = "gpu"


class MergeHoleAssignmentsBase(BaseTask):
    """Merge votes/border sets -> hole fill table (cc label -> segment
    label); border-touching components map to 0 (stay background).  The
    majority vote keeps the first segment, in vote-insertion order, among
    equal counts, as the reference does."""

    task_name = "merge_hole_assignments"

    def run_impl(self):
        cfg = self.get_config()
        shape = file_reader(cfg["input_path"])[cfg["input_key"]].shape
        block_ids = blocks_in_volume(shape, tuple(cfg["block_shape"]), cfg.get("roi_begin"), cfg.get("roi_end"))
        d = _hole_dir(self.tmp_folder)
        votes = {}
        border = set()
        for b in block_ids:
            p = os.path.join(d, f"block_{b}.npz")
            if not os.path.exists(p):
                continue
            with np.load(p) as f:
                for (h, l), c in zip(f["pairs"], f["counts"]):
                    key = (int(h), int(l))
                    votes[key] = votes.get(key, 0) + int(c)
                border.update(int(x) for x in f["border"])
        fill = {}
        for (h, l), c in votes.items():
            if h in border:
                continue
            if h not in fill or c > fill[h][1]:
                fill[h] = (l, c)
        keys = np.array(sorted(fill), np.uint64)
        values = np.array([fill[int(k)][0] for k in keys], np.uint64)
        np.savez(os.path.join(self.tmp_folder, "hole_assignments.npz"), keys=keys, values=values)
        return {"n_holes": int(len(keys)), "n_border_components": len(border)}


class MergeHoleAssignmentsLocal(MergeHoleAssignmentsBase):
    target = "local"


class MergeHoleAssignmentsGPU(MergeHoleAssignmentsBase):
    target = "gpu"


class FillHolesWriteBase(BaseTask):
    """Apply the hole table: out = seg where seg > 0 else fill[cc]."""

    task_name = "fill_holes_write"

    def run_impl(self):
        from .write import apply_assignment_np

        cfg = self.get_config()
        seg_ds = file_reader(cfg["input_path"])[cfg["input_key"]]
        cc_ds = file_reader(cfg["cc_path"])[cfg["cc_key"]]
        shape = seg_ds.shape
        block_shape = tuple(cfg["block_shape"])
        with np.load(os.path.join(self.tmp_folder, "hole_assignments.npz")) as f:
            keys, values = f["keys"], f["values"]
        out = file_reader(cfg["output_path"]).require_dataset(cfg["output_key"], shape=shape, chunks=block_shape,
                                                              dtype="uint64")
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))

        def process(block_id):
            bb = blocking.get_block(block_id).bb
            seg = np.asarray(seg_ds[bb]).astype(np.uint64)
            cc = np.asarray(cc_ds[bb]).astype(np.uint64)
            out[bb] = np.where(seg > 0, seg, apply_assignment_np(cc, keys, values))

        n = self.host_block_map(block_ids, process, store_verify_fn=region_verifier(out), blocking=blocking)
        return {"n_blocks": n}


class FillHolesWriteLocal(FillHolesWriteBase):
    target = "local"


class FillHolesWriteGPU(FillHolesWriteBase):
    target = "gpu"


class FillHolesWorkflow(WorkflowBase):
    """Fill internal background cavities of a segmentation: cc of the
    background mask (on the task's device), components touching the volume
    border stay background, each enclosed component takes its majority
    surrounding segment, and ``seg | filled`` is written.

    Params: ``input_path/input_key`` (segmentation), ``output_path/
    output_key``."""

    task_name = "fill_holes_workflow"

    def requires(self):
        from . import postprocess as pp_mod
        from . import thresholded_components as tc_mod
        from .connected_components import ConnectedComponentsWorkflow

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        bs = {k: p[k] for k in ("block_shape",) if k in p}
        seg = dict(input_path=p["input_path"], input_key=p["input_key"])
        scratch = os.path.join(self.tmp_folder, "fill_holes.zarr")
        cc = dict(cc_path=scratch, cc_key="bg_cc")
        # background mask: seg == 0
        t_mask = get_task_cls(tc_mod, "Threshold", self.target)(
            **common, dependencies=self.dependencies, **seg, output_path=scratch, output_key="bg_mask",
            threshold=0.5, threshold_mode="less", **bs)
        t_cc = ConnectedComponentsWorkflow(**common, target=self.target, dependencies=[t_mask], input_path=scratch,
                                           input_key="bg_mask", output_path=scratch, output_key="bg_cc", **bs)
        t_votes = get_task_cls(pp_mod, "HoleVotes", self.target)(**common, dependencies=[t_cc], **seg, **cc, **bs)
        t_merge = get_task_cls(pp_mod, "MergeHoleAssignments", self.target)(
            **common, dependencies=[t_votes], **seg, **bs)
        t_write = get_task_cls(pp_mod, "FillHolesWrite", self.target)(
            **common, dependencies=[t_merge], **seg, **cc, output_path=p["output_path"],
            output_key=p["output_key"], **bs)
        return [t_write]


class GraphWatershedAssignmentsBase(BaseTask):
    """Size filter with graph-watershed reassignment: instead of zeroing
    small objects, each is absorbed by its strongest-connected kept
    neighbour (lowest mean boundary edge), iterated so chains of small
    objects resolve to a kept root.

    Requires the graph and features artifacts and the label-size
    histograms in the same tmp_folder.  Params: ``min_size``."""

    task_name = "graph_watershed_assignments"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "min_size": 100}

    def run_impl(self):
        from ..runtime import handoff
        from .features import features_path
        from .graph import load_global_graph

        cfg = self.get_config()
        nodes, _, edges, _ = load_global_graph(self.tmp_folder)
        probs = handoff.load_array(features_path(self.tmp_folder))[:, 0].astype(np.float64)
        # node sizes from the label-size histograms
        d = _sizes_dir(self.tmp_folder)
        shape = file_reader(cfg["input_path"])[cfg["input_key"]].shape
        block_ids = blocks_in_volume(shape, tuple(cfg["block_shape"]), cfg.get("roi_begin"), cfg.get("roi_end"))
        labs, cnts = [np.zeros(0, np.uint64)], [np.zeros(0, np.int64)]
        for b in block_ids:
            f = os.path.join(d, f"block_{b}.npz")
            if os.path.exists(f):
                with np.load(f) as npz:
                    labs.append(npz["labels"].astype(np.uint64))
                    cnts.append(npz["counts"].astype(np.int64))
        lab_ids, inv = np.unique(np.concatenate(labs), return_inverse=True)
        lab_sizes = np.zeros(len(lab_ids), np.int64)
        np.add.at(lab_sizes, inv.ravel(), np.concatenate(cnts))
        pos = np.searchsorted(lab_ids, nodes)
        found = pos < len(lab_ids)
        found[found] = lab_ids[pos[found]] == nodes[found]
        sizes = np.zeros(len(nodes), np.int64)
        sizes[found] = lab_sizes[pos[found]]
        small = sizes < int(cfg.get("min_size", 100))

        # graph watershed: repeatedly attach small nodes to their best
        # (lowest boundary value) neighbour that is already kept/absorbed;
        # the sweep order (ascending node index) decides which neighbour a
        # node finds resolved, so it is the reference's
        n = len(nodes)
        target = np.arange(n, dtype=np.int64)
        resolved = ~small
        adj = [[] for _ in range(n)]
        for (u, v), pr in zip(edges.tolist(), probs.tolist()):
            adj[u].append((v, pr))
            adj[v].append((u, pr))
        changed = True
        while changed:
            changed = False
            for u in np.flatnonzero(small & ~resolved):
                best, best_p = -1, np.inf
                for v, pr in adj[u]:
                    if resolved[v] and pr < best_p:
                        best, best_p = v, pr
                if best >= 0:
                    target[u] = target[best]
                    resolved[u] = True
                    changed = True
        # unresolvable small islands -> background
        values = np.where(resolved, nodes[target], np.uint64(0)).astype(np.uint64)
        np.savez(os.path.join(self.tmp_folder, "graph_ws_assignments.npz"), keys=nodes, values=values)
        return {"n_nodes": int(n), "n_small": int(small.sum()), "n_unresolved": int((small & ~resolved).sum())}


class GraphWatershedAssignmentsLocal(GraphWatershedAssignmentsBase):
    target = "local"


class GraphWatershedAssignmentsGPU(GraphWatershedAssignmentsBase):
    target = "gpu"


class GraphWatershedSizeFilterWorkflow(WorkflowBase):
    """Size filter that reassigns small objects through the region graph
    instead of deleting them: graph + features (on the task's device) +
    sizes -> graph-watershed assignment -> write.  Params:
    ``input_path/input_key`` (segmentation), ``boundary_path/boundary_key``
    (the map edges are scored by), ``min_size``, ``output_path/output_key``."""

    task_name = "graph_ws_size_filter_workflow"

    def requires(self):
        from . import postprocess as pp_mod
        from .features import EdgeFeaturesWorkflow
        from .graph import GraphWorkflow
        from .relabel import staged_write_tasks

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        bs = {k: p[k] for k in ("block_shape",) if k in p}
        seg = dict(input_path=p["input_path"], input_key=p["input_key"])
        g = GraphWorkflow(**common, target=self.target, dependencies=self.dependencies, **seg, **bs)
        feats = EdgeFeaturesWorkflow(**common, target=self.target, dependencies=[g], input_path=p["boundary_path"],
                                     input_key=p["boundary_key"], labels_path=p["input_path"],
                                     labels_key=p["input_key"], **bs)
        sizes = get_task_cls(pp_mod, "BlockLabelSizes", self.target)(
            **common, dependencies=self.dependencies, **seg, **bs)
        assign = get_task_cls(pp_mod, "GraphWatershedAssignments", self.target)(
            **common, dependencies=[feats, sizes], **seg, **{k: p[k] for k in ("min_size",) if k in p}, **bs)
        write = staged_write_tasks(
            self, [assign], assignment_path=os.path.join(self.tmp_folder, "graph_ws_assignments.npz"), **seg,
            output_path=p.get("output_path", p["input_path"]), output_key=p.get("output_key", p["input_key"]),
            stage_name="graph_ws_filter", bs=bs)
        return [write]
