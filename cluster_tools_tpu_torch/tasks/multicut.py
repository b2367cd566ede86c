"""Hierarchical multicut: blockwise subproblems -> reduce -> global solve.

Port of ``cluster_tools_tpu/tasks/multicut.py`` (the domain-decomposition
scheme of Pape et al. 2017):

    for scale s in 0..S-1:
        SolveSubproblems  per scale-s block: the sub-graph of the current
                          problem induced by the block's nodes, solved; the
                          edges it cuts are recorded
        ReduceProblem     contract every edge no subproblem cut (union-find),
                          sum parallel-edge costs -> a smaller problem;
                          scale-(s+1) blocks are 2x larger per axis
    SolveGlobal           solve the final reduced problem with a registry
                          solver, compose the labelings back to the nodes

State between tasks lives in ``tmp_folder/multicut/problem_s<level>.npz``
(``edges``/``costs`` of the current reduced graph and ``node_labeling``,
original dense node -> current id); the result is the write task's
assignment table ``mc_assignments.npz`` (sorted uint64 ``keys`` -> uint64
``values``).  Solvers of the contraction engine run on the task's device.
With ``solver_shards > 1`` the global solve shards over the reduce tree
(:mod:`..parallel.reduce_tree`) by Morton block octants.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..ops import contraction as contraction_mod
from ..ops.multicut import SolverCheckpoint, contract_graph, multicut_energy
from ..ops.unionfind import union_find_host
from ..runtime import handoff
from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.segmentation_utils import get_multicut_solver
from ..utils.volume_utils import Blocking, blocks_in_volume
from .costs import costs_path
from .graph import block_graph_path, load_global_graph


def mc_dir(tmp_folder: str) -> str:
    d = os.path.join(tmp_folder, "multicut")
    os.makedirs(d, exist_ok=True)
    return d


def problem_path(tmp_folder: str, scale: int) -> str:
    return os.path.join(mc_dir(tmp_folder), f"problem_s{scale}.npz")


def cut_edges_path(tmp_folder: str, scale: int) -> str:
    return os.path.join(mc_dir(tmp_folder), f"cut_edges_s{scale}.npz")


def assignments_path(tmp_folder: str) -> str:
    return os.path.join(mc_dir(tmp_folder), "mc_assignments.npz")


def solver_kwargs(solver, device):
    """The solve's device for the round engine's solvers."""
    return {"device": device} if getattr(solver, "round_engine", False) else {}


def _load_problem(tmp_folder: str, scale: int):
    """Problem at ``scale``: s0 is built from the graph + costs artifacts."""
    if scale == 0:
        _, _, edges, _ = load_global_graph(tmp_folder)
        costs = handoff.load_array(costs_path(tmp_folder)).astype(np.float64)
        n_nodes = int(edges.max()) + 1 if len(edges) else 0
        return edges.astype(np.int64), costs, np.arange(n_nodes, dtype=np.int64)
    f = handoff.load_arrays(problem_path(tmp_folder, scale))
    return f["edges"].astype(np.int64), f["costs"].astype(np.float64), f["node_labeling"].astype(np.int64)


def _octant_node_shards(tmp_folder, cfg, scale, node_labeling, n_nodes, n_shards):
    """Node -> shard by Morton block octants: the scale-0 blocks (their node
    sets map through ``node_labeling`` to current ids, so coarser scales
    shard as well) ordered along the Z-order curve and split into
    ``n_shards`` contiguous runs.  A node in several blocks takes the first
    (lowest-Morton) block's shard.  Returns int64 [n_nodes], or None when
    the grid has no blocks to shard by."""
    from ..parallel.reduce_tree import morton_argsort

    block_nodes = _scale_block_nodes(tmp_folder, cfg, 0, node_labeling)
    if not block_nodes:
        return None
    shape = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"]).shape
    blocking_s = Blocking(shape, tuple(cfg["block_shape"]))
    ids = sorted(block_nodes)
    pos = np.array([blocking_s.block_grid_position(b) for b in ids])
    order = morton_argsort(pos)
    node_shard = np.full(int(n_nodes), -1, np.int64)
    k = max(1, min(int(n_shards), len(ids)))
    for rank, oi in enumerate(order):
        shard = rank * k // len(ids)
        nodes = block_nodes[ids[oi]]
        if len(nodes) == 0:
            continue
        fresh = nodes[node_shard[nodes] < 0]
        node_shard[fresh] = shard
    node_shard[node_shard < 0] = 0  # nodes outside every block: shard 0
    return node_shard


def _scale_block_nodes(tmp_folder, cfg, scale, node_labeling):
    """Node sets (current ids) per scale-``scale`` block.

    Scale-s blocks are ``block_shape * 2**s``; their node sets come from the
    scale-0 per-block graphs, mapped through the original-label -> dense ->
    current chain."""
    shape = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"]).shape
    block_shape0 = tuple(cfg["block_shape"])
    nodes_table, _, _, _ = load_global_graph(tmp_folder)
    block_shape_s = tuple(b * (2 ** scale) for b in block_shape0)
    blocking_s = Blocking(shape, block_shape_s)
    blocking_0 = Blocking(shape, block_shape0)
    roi = (cfg.get("roi_begin"), cfg.get("roi_end"))
    ids_0 = set(blocks_in_volume(shape, block_shape0, *roi))
    factor = 2 ** scale
    out = {}
    for bs in blocks_in_volume(shape, block_shape_s, *roi):
        pos_s = blocking_s.block_grid_position(bs)
        ranges = [range(p * factor, min((p + 1) * factor, g)) for p, g in zip(pos_s, blocking_0.grid_shape)]
        node_set = []
        for pos0 in np.stack(np.meshgrid(*ranges, indexing="ij"), axis=-1).reshape(-1, len(ranges)):
            b0 = blocking_0.grid_position_to_id(pos0)
            if b0 not in ids_0:
                continue
            labels = handoff.load_arrays(block_graph_path(tmp_folder, b0))["nodes"]
            node_set.append(node_labeling[np.searchsorted(nodes_table, labels)])
        out[bs] = np.unique(np.concatenate(node_set)) if node_set else np.zeros(0, np.int64)
    return out


def _solver_manifest(energy, edges, labels, solver_delta, tree_delta=None, solve_info=None):
    """The solve's observability block (the reference's keys): objective
    energy, edges in vs surviving inter-cluster edges, contraction rounds
    (the engine's and the reduce tree's), solver calls, and the reduce
    tree's shape when the solve ran sharded."""
    edges = np.asarray(edges)
    labels = np.asarray(labels)
    edges_out = int((labels[edges[:, 0]] != labels[edges[:, 1]]).sum()) if len(edges) else 0
    out = {
        "energy": float(energy) if energy is not None else None,
        "edges_in": int(len(edges)),
        "edges_out": edges_out,
        "rounds": int((solver_delta or {}).get("solver_rounds", 0) + (tree_delta or {}).get("tree_rounds", 0)),
        "solver_calls": int((solver_delta or {}).get("solver_calls", 0)),
    }
    out.update(solve_info or {"sharded": False, "shards": 1})
    return out


class SolveSubproblemsBase(BaseTask):
    """Per-block multicut subproblems at one scale (reference:
    ``solve_subproblems.py``).  Params: ``scale``, ``agglomerator`` (solver
    key; default the round-based parallel GAEC), plus the graph-defining
    params (input path/key, block_shape).  A round-engine solver takes all
    blocks' subproblems in one solve of their disjoint union (the same
    cuts as one solve a block, in one pass of rounds); other solvers run
    one solve a block on the host threads."""

    task_name = "solve_subproblems"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "agglomerator": "gaec_parallel"}

    def run_impl(self):
        cfg = self.get_config()
        scale = int(cfg.get("scale", 0))
        solver = get_multicut_solver(cfg.get("agglomerator", "gaec_parallel"))
        skw = solver_kwargs(solver, self.device)
        edges, costs, node_labeling = _load_problem(self.tmp_folder, scale)
        n_nodes = int(node_labeling.max()) + 1 if len(node_labeling) else 0
        solver_snap = contraction_mod.solver_snapshot()
        block_nodes = _scale_block_nodes(self.tmp_folder, cfg, scale, node_labeling)
        cut = np.zeros(len(edges), dtype=bool)
        seen = np.zeros(len(edges), dtype=bool)

        def extract(item):
            """A block's subproblem: its edge rows and compact edges."""
            _, nodes = item
            if len(nodes) < 2:
                return None
            # np.isin of both endpoints, as one membership table a block
            member = np.zeros(n_nodes, bool)
            member[nodes] = True
            idx = np.flatnonzero(member[edges[:, 0]] & member[edges[:, 1]])
            if not len(idx):
                return None
            sub_nodes, sub_e = np.unique(edges[idx], return_inverse=True)
            return idx, sub_e.reshape(-1, 2), len(sub_nodes)

        def cut_of(sub_e, labels):
            return labels[sub_e[:, 0]] != labels[sub_e[:, 1]]

        with ThreadPoolExecutor(max_workers=max(1, self.max_jobs)) as pool:
            subs = [r for r in pool.map(extract, sorted(block_nodes.items())) if r is not None]
            if getattr(solver, "round_engine", False) and subs:
                # one solve of the disjoint union of the subproblems: the
                # engine decides at each edge's endpoints only, so every
                # part comes out as its own solve would give it
                offsets = np.cumsum([0] + [k for _, _, k in subs])
                labels = solver(int(offsets[-1]), np.concatenate([e + o for (_, e, _), o in zip(subs, offsets)]),
                                np.concatenate([costs[idx] for idx, _, _ in subs]), **skw)
                results = [(idx, cut_of(e + o, labels)) for (idx, e, _), o in zip(subs, offsets)]
            else:
                results = pool.map(lambda sub: (sub[0], cut_of(sub[1], solver(sub[2], sub[1], costs[sub[0]], **skw))),
                                   subs)
            for idx, is_cut in results:
                seen[idx] = True
                cut[idx[is_cut]] = True

        # an edge merges only if some subproblem saw it and none cut it
        self.save_handoff_arrays(cut_edges_path(self.tmp_folder, scale), cut=cut, seen=seen)
        sd = contraction_mod.solver_delta(solver_snap)
        return {
            "scale": scale,
            "n_subproblems": len(block_nodes),
            "n_cut": int(cut.sum()),
            "n_edges": len(edges),
            "solver": {
                "solver_calls": int(sd.get("solver_calls", 0)),
                "rounds": int(sd.get("solver_rounds", 0)),
                "edges_in": int(sd.get("solver_edges_in", 0)),
                "edges_out": int(sd.get("solver_edges_out", 0)),
            },
        }


class SolveSubproblemsLocal(SolveSubproblemsBase):
    target = "local"


class SolveSubproblemsGPU(SolveSubproblemsBase):
    target = "gpu"


class ReduceProblemBase(BaseTask):
    """Contract all edges no subproblem cut -> problem at scale+1
    (reference: ``reduce_problem.py``)."""

    task_name = "reduce_problem"

    def run_impl(self):
        cfg = self.get_config()
        scale = int(cfg.get("scale", 0))
        edges, costs, node_labeling = _load_problem(self.tmp_folder, scale)
        f = handoff.load_arrays(cut_edges_path(self.tmp_folder, scale))
        n_nodes = int(node_labeling.max()) + 1 if len(node_labeling) else 0
        roots = union_find_host(edges[f["seen"] & ~f["cut"]], n_nodes)
        _, new_ids = np.unique(roots, return_inverse=True)
        new_ids = new_ids.astype(np.int64)
        new_edges, new_costs = contract_graph(edges, costs, new_ids)
        self.save_handoff_arrays(problem_path(self.tmp_folder, scale + 1), edges=new_edges, costs=new_costs,
                                 node_labeling=new_ids[node_labeling])
        return {"scale": scale, "n_nodes": int(new_ids.max()) + 1 if len(new_ids) else 0,
                "n_edges": len(new_edges)}


class ReduceProblemLocal(ReduceProblemBase):
    target = "local"


class ReduceProblemGPU(ReduceProblemBase):
    target = "gpu"


class SolveGlobalBase(BaseTask):
    """Solve the final reduced problem and emit the node-assignment table
    (reference: ``solve_global.py``).  Params: ``scale`` (the final level),
    ``agglomerator``.  A checkpoint-capable solver (Kernighan-Lin) persists
    its partition every outer sweep, so a killed solve resumes mid-solve.

    With ``solver_shards > 1`` the solve shards over the Morton-octant
    reduce tree (:mod:`..parallel.reduce_tree`): frontier-aware contraction
    rounds a shard, boundary edges merged up a ``reduce_fanout``-ary tree,
    in this process (``reduce_plane``: the collective plane on a sibling
    mesh, or the packet plane) or over a ``solver_workers``-process group.
    The configured ``agglomerator`` stays the single-host solver: the
    ``solver_shards=1`` case and the ``degraded:unsharded_solve``
    fallback."""

    task_name = "solve_global"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "agglomerator": "kernighan-lin"}

    def run_impl(self):
        from ..parallel import reduce_tree as reduce_tree_mod

        cfg = self.get_config()
        scale = int(cfg.get("scale", 0))
        solver = get_multicut_solver(cfg.get("agglomerator", "kernighan-lin"))
        edges, costs, node_labeling = _load_problem(self.tmp_folder, scale)
        n_nodes = int(node_labeling.max()) + 1 if len(node_labeling) else 0
        shards = int(cfg.get("solver_shards", 1) or 1)
        solver_snap = contraction_mod.solver_snapshot()
        tree_snap = reduce_tree_mod.solve_snapshot()

        def unsharded():
            ckpt = None
            solver_kw = solver_kwargs(solver, self.device)
            if getattr(solver, "supports_checkpoint", False) and len(edges):
                ckpt = SolverCheckpoint(os.path.join(mc_dir(self.tmp_folder), f"solve_global_s{scale}.ckpt.npz"),
                                        edges, costs)
                solver_kw["checkpoint"] = ckpt
            labels = solver(n_nodes, edges, costs, **solver_kw) if len(edges) else np.zeros(n_nodes, np.int64)
            if ckpt is not None:
                ckpt.clear()
            return labels

        if shards > 1 and len(edges):
            # the partition as a thunk: it re-opens block geometry, and a
            # failure there must degrade, not fail the task
            labels, solve_info = reduce_tree_mod.solve_with_reduce_tree(
                n_nodes, edges, costs,
                node_shard=lambda: _octant_node_shards(self.tmp_folder, cfg, scale, node_labeling, n_nodes, shards),
                solver_shards=shards,
                fanout=int(cfg.get("reduce_fanout", 2) or 2),
                failures_path=self.failures_path,
                task_name=self.uid,
                unsharded=unsharded,
                workers=int(cfg.get("solver_workers", 1) or 1),
                scratch_dir=os.path.join(mc_dir(self.tmp_folder), "reduce_tree"),
                max_workers=max(1, self.max_jobs),
                reduce_plane=str(cfg.get("reduce_plane", "auto") or "auto"),
                hop_deadline_s=cfg.get("hop_deadline_s"),
                device=self.device,
                device_pool_bytes=cfg.get("device_pool_bytes"),
            )
        else:
            labels = unsharded()
            solve_info = {"sharded": False, "shards": 1}
        final = labels[node_labeling]  # original dense node -> segment
        nodes_table, _, edges0, _ = load_global_graph(self.tmp_folder)
        energy = multicut_energy(edges0.astype(np.int64),
                                 handoff.load_array(costs_path(self.tmp_folder)).astype(np.float64), final)
        self.save_handoff_arrays(assignments_path(self.tmp_folder), keys=nodes_table,
                                 values=(final + 1).astype(np.uint64))
        return {
            "n_segments": int(final.max()) + 1 if len(final) else 0,
            "energy": energy,
            "solver": _solver_manifest(energy, edges, labels, contraction_mod.solver_delta(solver_snap),
                                       reduce_tree_mod.solve_delta(tree_snap), solve_info),
        }


class SolveGlobalLocal(SolveGlobalBase):
    target = "local"


class SolveGlobalGPU(SolveGlobalBase):
    target = "gpu"


class MulticutWorkflow(WorkflowBase):
    """The scale loop + global solve, given graph/features/costs artifacts.
    Params: ``n_scales`` (subproblem levels, default 1), ``agglomerator``,
    plus graph params (``input_path/input_key`` = supervoxels,
    ``block_shape``)."""

    task_name = "multicut_workflow"

    def requires(self):
        from . import multicut as mc_mod

        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        p = self.params
        keys = {k: p[k] for k in ("input_path", "input_key", "block_shape", "roi_begin", "roi_end", "agglomerator",
                                  "solver_shards", "reduce_fanout", "solver_workers", "reduce_plane",
                                  "hop_deadline_s") if k in p}
        deps = list(self.dependencies)
        for s in range(int(p.get("n_scales", 1))):
            t_solve = get_task_cls(mc_mod, "SolveSubproblems", self.target)(
                **common, dependencies=deps, scale=s, **keys)
            deps = [get_task_cls(mc_mod, "ReduceProblem", self.target)(
                **common, dependencies=[t_solve], scale=s, **keys)]
        return [get_task_cls(mc_mod, "SolveGlobal", self.target)(
            **common, dependencies=deps, scale=int(p.get("n_scales", 1)), **keys)]
