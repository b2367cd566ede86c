"""Stitch independent per-block segmentations into consistent labels.

Port of ``cluster_tools_tpu/tasks/stitching.py``:

- **Face consensus** (:class:`StitchFacesBase` + the union-find merge):
  for each adjacent block face, the mean value of an underlying map
  (boundary probability or attractive affinity) over the face contacts of
  each label pair; pairs that pass the threshold merge (union-find), and
  the generic write task applies the assignment blockwise.
- **Stitch-via-multicut** is the GraphWorkflow/MulticutWorkflow
  composition on the stitched input (``MulticutSegmentationWorkflow``
  with ``skip_ws=True``): no code here.

``merge_mode='less'`` (default) merges a face pair whose mean is below
``stitch_threshold`` (boundary maps); ``'greater'`` merges above it
(affinities, as the MWS workflow uses it); ``'multicut'`` turns the face
means into signed costs (``compute_costs`` with ``beta = 1 -
stitch_threshold``, so a pair is attractive exactly when its mean is below
the threshold) and lets the round-based parallel GAEC
(:mod:`..ops.contraction`) decide the merges on the task's device (the
torch rung on the card), over the reduce tree with ``solver_shards > 1``.
The face scans are numpy on the host threads, as in the reference.
"""

from __future__ import annotations

import os

import numpy as np

from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader
from .features import _read_boundary_map


def _stitch_dir(tmp_folder: str) -> str:
    d = os.path.join(tmp_folder, "stitch_faces")
    os.makedirs(d, exist_ok=True)
    return d


def stitch_assignments_path(tmp_folder: str) -> str:
    return os.path.join(_stitch_dir(tmp_folder), "stitch_assignments.npz")


class StitchFacesBase(BaseTask):
    """A block's face scan: label-pair statistics across each upper face.

    Params: ``seg_path/seg_key`` (blockwise labels), ``input_path/
    input_key`` (the map of the merge criterion; ``channel`` reduces a
    leading channel axis).  For affinities pass ``axis_channels`` (one
    channel a spatial axis, e.g. [0, 1, 2] for the unit offsets): a face
    along axis ``a`` is then scored by channel ``axis_channels[a]`` read on
    its upper side, the affinity of the edges crossing it.
    """

    task_name = "stitch_faces"

    @staticmethod
    def default_task_config():
        return {
            "threads_per_job": 1,
            "device_batch": 1,
            "channel": None,
            "axis_channels": None,
        }

    def run_impl(self):
        cfg = self.get_config()
        ds_seg = file_reader(cfg["seg_path"])[cfg["seg_key"]]
        ds_map = file_reader(cfg["input_path"])[cfg["input_key"]]
        shape = ds_seg.shape
        block_shape = tuple(cfg["block_shape"])
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        roi_set = set(block_ids)
        channel = cfg.get("channel")
        axis_channels = cfg.get("axis_channels")
        d = _stitch_dir(self.tmp_folder)

        def process(block_id):
            block = blocking.get_block(block_id)
            pairs, sums, counts = [], [], []
            for axis in range(len(shape)):
                nbr = blocking.neighbor_id(block_id, axis, 1)
                if nbr is None or nbr not in roi_set:
                    continue
                face = block.end[axis]
                bb_lo = tuple(slice(face - 1, face) if a == axis else slice(b, e)
                              for a, (b, e) in enumerate(zip(block.begin, block.end)))
                bb_hi = tuple(slice(face, face + 1) if a == axis else slice(b, e)
                              for a, (b, e) in enumerate(zip(block.begin, block.end)))
                lo = np.asarray(ds_seg[bb_lo]).ravel()
                hi = np.asarray(ds_seg[bb_hi]).ravel()
                if axis_channels is not None:
                    # the crossing edge's affinity lives on the upper voxel
                    # in the axis' attractive channel
                    val = _read_boundary_map(ds_map, bb_hi, int(axis_channels[axis])).ravel().astype(np.float64)
                else:
                    v_lo = _read_boundary_map(ds_map, bb_lo, channel).ravel()
                    v_hi = _read_boundary_map(ds_map, bb_hi, channel).ravel()
                    val = np.maximum(v_lo, v_hi).astype(np.float64)
                both = (lo > 0) & (hi > 0) & (lo != hi)
                if not both.any():
                    continue
                # (min, max) rows, so both orientations of a pair pool into
                # one mean
                a = lo[both]
                b = hi[both]
                pq = np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1).astype(np.uint64)
                uv, inv = np.unique(pq, axis=0, return_inverse=True)
                s = np.zeros(len(uv))
                np.add.at(s, inv.ravel(), val[both])
                pairs.append(uv)
                sums.append(s)
                counts.append(np.bincount(inv.ravel(), minlength=len(uv)))
            if pairs:
                np.savez(os.path.join(d, f"block_{block_id}.npz"), pairs=np.concatenate(pairs),
                         sums=np.concatenate(sums), counts=np.concatenate(counts))
            else:
                np.savez(os.path.join(d, f"block_{block_id}.npz"), pairs=np.zeros((0, 2), np.uint64),
                         sums=np.zeros(0), counts=np.zeros(0, np.int64))

        return {"n_blocks": self.host_block_map(block_ids, process)}


class StitchFacesLocal(StitchFacesBase):
    target = "local"


class StitchFacesGPU(StitchFacesBase):
    target = "gpu"


class MergeStitchAssignmentsBase(BaseTask):
    """Merge the face statistics, apply the criterion, union-find, and
    write the write task's assignment table (reference:
    ``SimpleStitchAssignmentsBase``)."""

    task_name = "merge_stitch_assignments"

    @staticmethod
    def default_task_config():
        return {
            "threads_per_job": 1,
            "device_batch": 1,
            "stitch_threshold": 0.5,
            "merge_mode": "less",
            # merge_mode='multicut' only: weight each face pair's cost by
            # its contact area before the global GAEC solve
            "weight_by_contact_area": False,
        }

    def run_impl(self):
        from concurrent.futures import ThreadPoolExecutor

        from ..ops.unionfind import union_find_host

        cfg = self.get_config()
        ds_seg = file_reader(cfg["seg_path"])[cfg["seg_key"]]
        shape = ds_seg.shape
        block_shape = tuple(cfg["block_shape"])
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        d = _stitch_dir(self.tmp_folder)
        solver_stats = None
        all_pairs, all_sums, all_counts = [], [], []
        for b in block_ids:
            p = os.path.join(d, f"block_{b}.npz")
            if os.path.exists(p):
                with np.load(p) as f:
                    all_pairs.append(f["pairs"])
                    all_sums.append(f["sums"])
                    all_counts.append(f["counts"])

        # the node set covers every label, merged or not: the block uniques
        def collect(block_id):
            u = np.unique(np.asarray(ds_seg[blocking.get_block(block_id).bb]))
            return u[u != 0]

        uniques = set()
        with ThreadPoolExecutor(max_workers=max(1, self.max_jobs)) as pool:
            for u in pool.map(collect, block_ids):
                uniques.update(u.tolist())
        nodes = np.array(sorted(uniques), dtype=np.uint64)

        if all_pairs and sum(len(p) for p in all_pairs):
            pairs = np.concatenate([p for p in all_pairs if len(p)])
            sums = np.concatenate([s for s, p in zip(all_sums, all_pairs) if len(p)])
            counts = np.concatenate([c for c, p in zip(all_counts, all_pairs) if len(p)])
            uv, inv = np.unique(pairs, axis=0, return_inverse=True)
            s = np.zeros(len(uv))
            np.add.at(s, inv.ravel(), sums)
            c = np.zeros(len(uv), np.int64)
            np.add.at(c, inv.ravel(), counts)
            mean = s / np.maximum(c, 1)
            thr = float(cfg.get("stitch_threshold", 0.5))
            mode = cfg.get("merge_mode", "less")
            dense = np.searchsorted(nodes, uv).astype(np.int64)
            if mode == "less":
                merge = mean < thr
            elif mode == "greater":
                merge = mean > thr
            elif mode == "multicut":
                labels, solver_stats = self._multicut(cfg, len(nodes), dense, mean, c, thr, d)
                merge = labels[dense[:, 0]] == labels[dense[:, 1]]
            else:
                raise ValueError(f"unknown merge_mode {mode!r}")
            merge_pairs = dense[merge]
        else:
            merge_pairs = np.zeros((0, 2), np.int64)

        roots = union_find_host(merge_pairs, len(nodes))
        _, assignment = np.unique(roots, return_inverse=True)
        np.savez(stitch_assignments_path(self.tmp_folder), keys=nodes, values=(assignment + 1).astype(np.uint64))
        out = {
            "n_labels": int(len(nodes)),
            "n_merged_pairs": int(len(merge_pairs)),
            "n_components": int(assignment.max()) + 1 if len(assignment) else 0,
        }
        if solver_stats is not None:
            out["solver"] = solver_stats
        return out

    def _multicut(self, cfg, n_nodes, dense, mean, contacts, thr, d):
        """Stitch-via-multicut on the face graph: face means -> costs (cost
        > 0 iff mean < thr), then the parallel GAEC on the task's device
        decides which pairs merge given the whole graph.  With
        ``solver_shards > 1`` the solve shards over the reduce tree, the
        labels' id range standing in for octants (blockwise labelling
        orders ids spatially); a sharded failure degrades to the
        single-host GAEC.  Returns ``(labels, solver manifest)``."""
        from ..ops import contraction as contraction_mod
        from ..ops.contraction import gaec_parallel
        from ..ops.multicut import multicut_energy
        from ..parallel import reduce_tree as reduce_tree_mod
        from .costs import compute_costs
        from .multicut import _solver_manifest

        costs = compute_costs(mean.astype(np.float32), beta=min(max(1.0 - thr, 1e-4), 1.0 - 1e-4),
                              edge_sizes=contacts.astype(np.float64) if cfg.get("weight_by_contact_area") else None,
                              device=self.device).astype(np.float64)
        shards = int(cfg.get("solver_shards", 1) or 1)
        solver_snap = contraction_mod.solver_snapshot()
        tree_snap = reduce_tree_mod.solve_snapshot()
        if shards > 1:
            labels, solve_info = reduce_tree_mod.solve_with_reduce_tree(
                n_nodes, dense, costs,
                node_shard=reduce_tree_mod.contiguous_node_shards(n_nodes, shards),
                solver_shards=shards,
                fanout=int(cfg.get("reduce_fanout", 2) or 2),
                reduce_plane=str(cfg.get("reduce_plane", "auto") or "auto"),
                hop_deadline_s=cfg.get("hop_deadline_s"),
                failures_path=self.failures_path,
                task_name=self.uid,
                unsharded=lambda: gaec_parallel(n_nodes, dense, costs, device=self.device),
                workers=int(cfg.get("solver_workers", 1) or 1),
                scratch_dir=os.path.join(d, "reduce_tree"),
                max_workers=max(1, self.max_jobs),
                device=self.device,
            )
        else:
            labels = gaec_parallel(n_nodes, dense, costs, device=self.device)
            solve_info = {"sharded": False, "shards": 1}
        return labels, _solver_manifest(multicut_energy(dense.astype(np.int64), costs, labels), dense, labels,
                                        contraction_mod.solver_delta(solver_snap),
                                        reduce_tree_mod.solve_delta(tree_snap), solve_info)


class MergeStitchAssignmentsLocal(MergeStitchAssignmentsBase):
    target = "local"


class MergeStitchAssignmentsGPU(MergeStitchAssignmentsBase):
    target = "gpu"


class StitchingWorkflow(WorkflowBase):
    """stitch_faces -> merge_stitch_assignments -> write (in place on the
    segmentation by default; crash-safe through the staged write)."""

    task_name = "stitching_workflow"

    def requires(self):
        from . import stitching as st_mod
        from .relabel import staged_write_tasks

        p = self.params
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        grid = {k: p[k] for k in ("block_shape", "roi_begin", "roi_end") if k in p}
        t1 = get_task_cls(st_mod, "StitchFaces", self.target)(
            **common, dependencies=self.dependencies, seg_path=p["seg_path"], seg_key=p["seg_key"],
            input_path=p["input_path"], input_key=p["input_key"],
            **{k: p[k] for k in ("channel", "axis_channels") if k in p}, **grid,
        )
        t2 = get_task_cls(st_mod, "MergeStitchAssignments", self.target)(
            **common, dependencies=[t1], seg_path=p["seg_path"], seg_key=p["seg_key"],
            **{k: p[k] for k in ("stitch_threshold", "merge_mode", "solver_shards", "reduce_fanout", "solver_workers")
               if k in p},
            **grid,
        )
        return [staged_write_tasks(
            self, [t2], assignment_path=stitch_assignments_path(self.tmp_folder), input_path=p["seg_path"],
            input_key=p["seg_key"], output_path=p.get("output_path", p["seg_path"]),
            output_key=p.get("output_key", p["seg_key"]), stage_name="stitch",
            bs={k: p[k] for k in ("block_shape",) if k in p},
        )]
