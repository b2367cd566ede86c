"""Region-adjacency-graph extraction as a blockwise task chain.

Port of ``cluster_tools_tpu/tasks/graph.py``: the per-block scan runs on
the task's device (:mod:`..ops.rag`), and the graph artifacts are the
reference's npz files in ``tmp_folder/graph``:

    InitialSubGraphs  (host IO pool + device scans)  block_<id>.npz {nodes, uv, sizes}
    MergeSubGraphs    (main process)                  graph.npz {nodes, uv, edges, sizes}
    MapEdgeIds        (host IO pool)                  edge_ids_<id>.npy

``nodes``/``uv`` carry the original (uint64) segment labels; ``edges`` is
the same edge list in dense node indices (row into ``nodes``) for solver
use.  Label 0 is background and never becomes a node.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.rag import block_rag, edge_id_finder, merge_edge_lists
from ..runtime import handoff
from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume


def graph_dir(tmp_folder: str) -> str:
    d = os.path.join(tmp_folder, "graph")
    os.makedirs(d, exist_ok=True)
    return d


def block_graph_path(tmp_folder: str, block_id: int) -> str:
    return os.path.join(graph_dir(tmp_folder), f"block_{block_id}.npz")


def global_graph_path(tmp_folder: str) -> str:
    return os.path.join(graph_dir(tmp_folder), "graph.npz")


def edge_ids_path(tmp_folder: str, block_id: int) -> str:
    return os.path.join(graph_dir(tmp_folder), f"edge_ids_{block_id}.npy")


def load_global_graph(tmp_folder: str):
    """The merged graph: ``(nodes, uv, edges, sizes)``."""
    f = handoff.load_arrays(global_graph_path(tmp_folder))
    return f["nodes"], f["uv"], f["edges"], f["sizes"]


def _upper_halo_bb(block, shape):
    """Inner bb extended by +1 voxel on upper faces (clipped): the RAG halo
    convention of :mod:`..ops.rag`."""
    return tuple(slice(b, min(e + 1, s)) for b, e, s in zip(block.begin, block.end, shape))


def _grid_block_ids(cfg, shape):
    return blocks_in_volume(shape, tuple(cfg["block_shape"]), cfg.get("roi_begin"), cfg.get("roi_end"))


class InitialSubGraphsBase(BaseTask):
    """Per-block RAG extraction (reference: ``initial_sub_graphs.py``).
    Params: ``input_path/input_key`` (the supervoxel volume)."""

    task_name = "initial_sub_graphs"

    def run_impl(self):
        cfg = self.get_config()
        ds = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"])
        shape = ds.shape
        blocking = Blocking(shape, tuple(cfg["block_shape"]))
        dev = self.device
        # block graphs are published in memory for MergeSubGraphs; stale
        # markers of another process are invalidated here
        self.declare_handoff_producer()

        def process(block_id: int):
            block = blocking.get_block(block_id)
            seg = np.asarray(ds[_upper_halo_bb(block, shape)])
            # the inner node set comes out of the extraction's own dense labels
            uv, sizes, _, nodes = block_rag(seg, inner_shape=block.shape, return_nodes=True, device=dev)
            self.save_handoff_arrays(block_graph_path(self.tmp_folder, block_id), nodes=nodes.astype(np.uint64),
                                     uv=uv, sizes=sizes)

        return {"n_blocks": self.host_block_map(_grid_block_ids(cfg, shape), process)}


class InitialSubGraphsLocal(InitialSubGraphsBase):
    target = "local"


class InitialSubGraphsGPU(InitialSubGraphsBase):
    target = "gpu"


class MergeSubGraphsBase(BaseTask):
    """Merge per-block graphs into the global graph (reference:
    ``merge_sub_graphs.py``), in the main process."""

    task_name = "merge_sub_graphs"

    def run_impl(self):
        cfg = self.get_config()
        shape = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"]).shape
        edge_lists, node_lists = [], []
        for b in _grid_block_ids(cfg, shape):
            f = handoff.load_arrays(block_graph_path(self.tmp_folder, b))
            edge_lists.append((f["uv"], f["sizes"]))
            node_lists.append(f["nodes"])
        uv, sizes = merge_edge_lists(edge_lists)
        nodes = np.unique(np.concatenate(node_lists)) if node_lists else np.zeros(0, np.uint64)
        # dense edge representation for solvers: rows index into `nodes`
        edges = np.searchsorted(nodes, uv).astype(np.int64)
        self.save_handoff_arrays(global_graph_path(self.tmp_folder), nodes=nodes, uv=uv, edges=edges, sizes=sizes)
        return {"n_nodes": len(nodes), "n_edges": len(uv)}


class MergeSubGraphsLocal(MergeSubGraphsBase):
    target = "local"


class MergeSubGraphsGPU(MergeSubGraphsBase):
    target = "gpu"


class MapEdgeIdsBase(BaseTask):
    """Map each block's edges to global edge ids (reference:
    ``map_edge_ids.py``)."""

    task_name = "map_edge_ids"

    def run_impl(self):
        cfg = self.get_config()
        shape = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"]).shape
        _, uv_global, _, _ = load_global_graph(self.tmp_folder)
        find = edge_id_finder(uv_global)
        self.declare_handoff_producer()

        def process(block_id: int):
            uv = handoff.load_arrays(block_graph_path(self.tmp_folder, block_id))["uv"]
            self.save_handoff_array(edge_ids_path(self.tmp_folder, block_id), find(uv))

        return {"n_blocks": self.host_block_map(_grid_block_ids(cfg, shape), process)}


class MapEdgeIdsLocal(MapEdgeIdsBase):
    target = "local"


class MapEdgeIdsGPU(MapEdgeIdsBase):
    target = "gpu"


class GraphWorkflow(WorkflowBase):
    """InitialSubGraphs -> MergeSubGraphs -> MapEdgeIds."""

    task_name = "graph_workflow"

    def requires(self):
        from . import graph as graph_mod

        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        keys = {k: self.params[k] for k in ("input_path", "input_key", "block_shape", "roi_begin", "roi_end")
                if k in self.params}
        t1 = get_task_cls(graph_mod, "InitialSubGraphs", self.target)(
            **common, dependencies=self.dependencies, **keys)
        t2 = get_task_cls(graph_mod, "MergeSubGraphs", self.target)(**common, dependencies=[t1], **keys)
        return [get_task_cls(graph_mod, "MapEdgeIds", self.target)(**common, dependencies=[t2], **keys)]
