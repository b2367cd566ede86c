"""Edge features: per-block accumulation + global weighted merge.

Port of ``cluster_tools_tpu/tasks/features.py``: the per-block scan and
accumulation is :func:`..ops.rag.block_rag` with values, on the task's
device; the merge is :func:`..ops.rag.merge_feature_lists` in the main process.

Artifacts (in ``tmp_folder/graph``, next to the graph):

    features_block_<id>.npz  {uv, feats}     per-block edge features
    features.npy             float32 [m, 5]  (mean, min, max, count, variance)
                                             per global edge, aligned with
                                             graph.npz's edge list
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.rag import block_rag, merge_feature_lists
from ..runtime import handoff
from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking
from .graph import _grid_block_ids, _upper_halo_bb, graph_dir, load_global_graph


def block_features_path(tmp_folder: str, block_id: int) -> str:
    return os.path.join(graph_dir(tmp_folder), f"features_block_{block_id}.npz")


def features_path(tmp_folder: str) -> str:
    return os.path.join(graph_dir(tmp_folder), "features.npy")


def _read_boundary_map(ds, bb, channel):
    """Read a boundary/affinity map block; reduce a channel axis if present.

    ``channel``: None (no channel axis), int, or list of ints (averaged).
    """
    if channel is None:
        return np.asarray(ds[bb])
    if isinstance(channel, int):
        return np.asarray(ds[(slice(channel, channel + 1),) + bb][0])
    sel = np.asarray(ds[(slice(min(channel), max(channel) + 1),) + bb])
    sel = sel[[c - min(channel) for c in channel]]
    return sel.mean(axis=0)


class BlockEdgeFeaturesBase(BaseTask):
    """Per-block edge-feature accumulation (reference:
    ``block_edge_features.py``).  Params: ``input_path/input_key``
    (boundary or affinity map, optionally with a leading channel axis and a
    ``channel`` selector), ``labels_path/labels_key`` (the supervoxels the
    graph was built from)."""

    task_name = "block_edge_features"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "channel": None}

    def run_impl(self):
        cfg = self.get_config()
        ds_in = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"])
        ds_labels = handoff.resolve_dataset(cfg["labels_path"], cfg["labels_key"])
        shape = ds_labels.shape
        blocking = Blocking(shape, tuple(cfg["block_shape"]))
        channel = cfg.get("channel")
        dev = self.device
        self.declare_handoff_producer()

        def process(block_id: int):
            block = blocking.get_block(block_id)
            bb = _upper_halo_bb(block, shape)
            seg = np.asarray(ds_labels[bb])
            val = _read_boundary_map(ds_in, bb, channel)
            uv, _, feats = block_rag(seg, values=val, inner_shape=block.shape, device=dev)
            self.save_handoff_arrays(block_features_path(self.tmp_folder, block_id), uv=uv, feats=feats)

        return {"n_blocks": self.host_block_map(_grid_block_ids(cfg, shape), process)}


class BlockEdgeFeaturesLocal(BlockEdgeFeaturesBase):
    target = "local"


class BlockEdgeFeaturesGPU(BlockEdgeFeaturesBase):
    target = "gpu"


class MergeEdgeFeaturesBase(BaseTask):
    """Count-weighted merge of block features onto the global edge list
    (reference: ``merge_edge_features.py``)."""

    task_name = "merge_edge_features"

    def run_impl(self):
        cfg = self.get_config()
        shape = handoff.resolve_dataset(cfg["labels_path"], cfg["labels_key"]).shape
        _, uv_global, _, _ = load_global_graph(self.tmp_folder)

        def parts():
            for b in _grid_block_ids(cfg, shape):
                f = handoff.load_arrays(block_features_path(self.tmp_folder, b))
                yield f["uv"], f["feats"]

        feats = merge_feature_lists(uv_global, parts())
        self.save_handoff_array(features_path(self.tmp_folder), feats)
        return {"n_edges": len(feats)}


class MergeEdgeFeaturesLocal(MergeEdgeFeaturesBase):
    target = "local"


class MergeEdgeFeaturesGPU(MergeEdgeFeaturesBase):
    target = "gpu"


class EdgeFeaturesWorkflow(WorkflowBase):
    """BlockEdgeFeatures -> MergeEdgeFeatures."""

    task_name = "edge_features_workflow"

    def requires(self):
        from . import features as feat_mod

        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        keys = {k: self.params[k] for k in ("input_path", "input_key", "labels_path", "labels_key", "channel",
                                            "block_shape", "roi_begin", "roi_end") if k in self.params}
        t1 = get_task_cls(feat_mod, "BlockEdgeFeatures", self.target)(
            **common, dependencies=self.dependencies, **keys)
        return [get_task_cls(feat_mod, "MergeEdgeFeatures", self.target)(**common, dependencies=[t1], **keys)]
