"""Hierarchical lifted multicut.

Port of ``cluster_tools_tpu/tasks/lifted_multicut.py``: the multicut
domain-decomposition scheme (:mod:`.multicut`) with the lifted objective,
sparse long-range edges whose costs apply whenever their endpoints end up
in different clusters.  SolveLiftedSubproblems -> ReduceLiftedProblem per
scale, then SolveLiftedGlobal, with the lifted edge set carried through
every reduction: contracted endpoints map through the node labelling,
internal lifted edges drop out and parallel ones add.  The lifted GAEC is
the reference's host heap (:func:`..ops.multicut.lifted_greedy_additive`)
on every target; the sharded global solve's tree nodes without lifted
edges run the contraction engine on the task's device.

State: ``tmp_folder/lifted_multicut/problem_s<level>.npz`` {edges, costs,
lifted_edges, lifted_costs, node_labeling} and ``cut_edges_s<level>.npz``
{cut, seen}; the final assignment table is the write task's
(``lmc_assignments.npz``).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..ops.multicut import contract_graph, lifted_greedy_additive, lifted_multicut_energy
from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from .costs import costs_path
from .graph import load_global_graph
from .lifted_features import lifted_problem_path
from .multicut import _scale_block_nodes


def lmc_dir(tmp_folder: str) -> str:
    d = os.path.join(tmp_folder, "lifted_multicut")
    os.makedirs(d, exist_ok=True)
    return d


def lmc_problem_path(tmp_folder: str, scale: int) -> str:
    return os.path.join(lmc_dir(tmp_folder), f"problem_s{scale}.npz")


def lmc_cut_edges_path(tmp_folder: str, scale: int) -> str:
    return os.path.join(lmc_dir(tmp_folder), f"cut_edges_s{scale}.npz")


def lmc_assignments_path(tmp_folder: str) -> str:
    return os.path.join(lmc_dir(tmp_folder), "lmc_assignments.npz")


def _load_problem(tmp_folder: str, scale: int):
    """``(edges, costs, lifted_edges, lifted_costs, node_labeling)`` at
    ``scale``: s0 from the graph, costs and lifted-problem artifacts."""
    if scale == 0:
        from ..runtime import handoff

        _, _, edges, _ = load_global_graph(tmp_folder)
        costs = handoff.load_array(costs_path(tmp_folder)).astype(np.float64)
        with np.load(lifted_problem_path(tmp_folder)) as f:
            lifted_edges = f["edges"].astype(np.int64)
            lifted_costs = f["costs"].astype(np.float64)
        n_nodes = int(edges.max()) + 1 if len(edges) else 0
        node_labeling = np.arange(n_nodes, dtype=np.int64)
        return edges.astype(np.int64), costs, lifted_edges, lifted_costs, node_labeling
    with np.load(lmc_problem_path(tmp_folder, scale)) as f:
        return (f["edges"].astype(np.int64), f["costs"].astype(np.float64), f["lifted_edges"].astype(np.int64),
                f["lifted_costs"].astype(np.float64), f["node_labeling"].astype(np.int64))


class SolveLiftedSubproblemsBase(BaseTask):
    """Per-block lifted subproblems at one scale (reference:
    ``solve_lifted_subproblems.py``): a block's local and lifted edges
    between its nodes, solved by the lifted GAEC; the local edges it cuts
    are recorded."""

    task_name = "solve_lifted_subproblems"

    def run_impl(self):
        cfg = self.get_config()
        scale = int(cfg.get("scale", 0))
        edges, costs, ledges, lcosts, node_labeling = _load_problem(self.tmp_folder, scale)
        block_nodes = _scale_block_nodes(self.tmp_folder, cfg, scale, node_labeling)
        n_nodes = int(node_labeling.max()) + 1 if len(node_labeling) else 0
        cut = np.zeros(len(edges), dtype=bool)
        seen = np.zeros(len(edges), dtype=bool)

        def process(item):
            _, nodes = item
            if len(nodes) < 2:
                return None
            # np.isin of both endpoints, as one membership table a block
            member = np.zeros(n_nodes, bool)
            member[nodes] = True
            sub_mask = member[edges[:, 0]] & member[edges[:, 1]]
            if not sub_mask.any():
                return None
            sub_edges = edges[sub_mask]
            lsub_mask = member[ledges[:, 0]] & member[ledges[:, 1]] if len(ledges) else np.zeros(0, bool)
            # compact ids over the local and lifted endpoints
            all_e = np.concatenate([sub_edges, ledges[lsub_mask]]) if lsub_mask.any() else sub_edges
            sub_nodes, inv = np.unique(all_e, return_inverse=True)
            inv = inv.reshape(all_e.shape)
            n_local = len(sub_edges)
            labels = lifted_greedy_additive(len(sub_nodes), inv[:n_local], costs[sub_mask], inv[n_local:],
                                            lcosts[lsub_mask])
            return sub_mask, labels[inv[:n_local, 0]] != labels[inv[:n_local, 1]]

        with ThreadPoolExecutor(max_workers=max(1, self.max_jobs)) as pool:
            for res in pool.map(process, sorted(block_nodes.items())):
                if res is None:
                    continue
                sub_mask, is_cut = res
                idx = np.flatnonzero(sub_mask)
                seen[idx] = True
                cut[idx[is_cut]] = True

        np.savez(lmc_cut_edges_path(self.tmp_folder, scale), cut=cut, seen=seen)
        return {"scale": scale, "n_subproblems": len(block_nodes), "n_cut": int(cut.sum())}


class SolveLiftedSubproblemsLocal(SolveLiftedSubproblemsBase):
    target = "local"


class SolveLiftedSubproblemsGPU(SolveLiftedSubproblemsBase):
    target = "gpu"


class ReduceLiftedProblemBase(BaseTask):
    """Contract the merge edges; carry the lifted edges to the reduced id
    space (reference: ``reduce_lifted_problem.py``)."""

    task_name = "reduce_lifted_problem"

    def run_impl(self):
        from ..ops.unionfind import union_find_host

        cfg = self.get_config()
        scale = int(cfg.get("scale", 0))
        edges, costs, ledges, lcosts, node_labeling = _load_problem(self.tmp_folder, scale)
        with np.load(lmc_cut_edges_path(self.tmp_folder, scale)) as f:
            cut, seen = f["cut"], f["seen"]
        n_nodes = int(node_labeling.max()) + 1 if len(node_labeling) else 0
        roots = union_find_host(edges[seen & ~cut], n_nodes)
        _, new_ids = np.unique(roots, return_inverse=True)
        new_ids = new_ids.astype(np.int64)
        new_edges, new_costs = contract_graph(edges, costs, new_ids)
        new_ledges, new_lcosts = contract_graph(ledges, lcosts, new_ids)
        np.savez(lmc_problem_path(self.tmp_folder, scale + 1), edges=new_edges, costs=new_costs,
                 lifted_edges=new_ledges, lifted_costs=new_lcosts, node_labeling=new_ids[node_labeling])
        return {"scale": scale, "n_nodes": int(new_ids.max()) + 1 if len(new_ids) else 0,
                "n_edges": len(new_edges), "n_lifted_edges": len(new_ledges)}


class ReduceLiftedProblemLocal(ReduceLiftedProblemBase):
    target = "local"


class ReduceLiftedProblemGPU(ReduceLiftedProblemBase):
    target = "gpu"


class SolveLiftedGlobalBase(BaseTask):
    """Final lifted solve and the assignment table (reference:
    ``solve_lifted_global.py``).

    ``solver_shards > 1`` shards the solve over the Morton-octant reduce
    tree as :class:`.multicut.SolveGlobalBase` does, with the lifted edge
    set carried through every level: a tree node with lifted edges runs the
    lifted GAEC (boundary-blind: the lifted objective has no frontier
    formulation, so the collective plane refuses it), one without runs the
    contraction engine on the task's device.  The single-host lifted GAEC
    is the ``solver_shards=1`` case and the ``degraded:unsharded_solve``
    fallback."""

    task_name = "solve_lifted_global"

    def run_impl(self):
        from ..ops import contraction as contraction_mod
        from ..parallel import reduce_tree as reduce_tree_mod
        from ..runtime import handoff
        from .multicut import _octant_node_shards, _solver_manifest

        cfg = self.get_config()
        scale = int(cfg.get("scale", 0))
        edges, costs, ledges, lcosts, node_labeling = _load_problem(self.tmp_folder, scale)
        n_nodes = int(node_labeling.max()) + 1 if len(node_labeling) else 0
        shards = int(cfg.get("solver_shards", 1) or 1)
        solver_snap = contraction_mod.solver_snapshot()
        tree_snap = reduce_tree_mod.solve_snapshot()

        def unsharded():
            return lifted_greedy_additive(n_nodes, edges, costs, ledges, lcosts) if len(edges) else \
                np.zeros(n_nodes, np.int64)

        if shards > 1 and len(edges):
            # the partition as a thunk: a failure to build it degrades
            labels, solve_info = reduce_tree_mod.solve_with_reduce_tree(
                n_nodes, edges, costs,
                node_shard=lambda: _octant_node_shards(self.tmp_folder, cfg, scale, node_labeling, n_nodes, shards),
                solver_shards=shards,
                fanout=int(cfg.get("reduce_fanout", 2) or 2),
                reduce_plane=str(cfg.get("reduce_plane", "auto") or "auto"),
                hop_deadline_s=cfg.get("hop_deadline_s"),
                failures_path=self.failures_path,
                task_name=self.uid,
                unsharded=unsharded,
                lifted_edges=ledges,
                lifted_payload=lcosts,
                workers=int(cfg.get("solver_workers", 1) or 1),
                scratch_dir=os.path.join(lmc_dir(self.tmp_folder), "reduce_tree"),
                max_workers=max(1, self.max_jobs),
                device=self.device,
            )
        else:
            labels = unsharded()
            solve_info = {"sharded": False, "shards": 1}
        final = labels[node_labeling]
        nodes_table, _, edges0, _ = load_global_graph(self.tmp_folder)
        with np.load(lifted_problem_path(self.tmp_folder)) as f:
            le0, lc0 = f["edges"].astype(np.int64), f["costs"].astype(np.float64)
        energy = lifted_multicut_energy(edges0.astype(np.int64),
                                        handoff.load_array(costs_path(self.tmp_folder)).astype(np.float64),
                                        le0, lc0, final)
        np.savez(lmc_assignments_path(self.tmp_folder), keys=nodes_table, values=(final + 1).astype(np.uint64))
        return {
            "n_segments": int(final.max()) + 1 if len(final) else 0,
            "energy": energy,
            "solver": _solver_manifest(energy, edges, labels, contraction_mod.solver_delta(solver_snap),
                                       reduce_tree_mod.solve_delta(tree_snap), solve_info),
        }


class SolveLiftedGlobalLocal(SolveLiftedGlobalBase):
    target = "local"


class SolveLiftedGlobalGPU(SolveLiftedGlobalBase):
    target = "gpu"


class LiftedMulticutWorkflow(WorkflowBase):
    """The lifted scale loop and global solve, given the graph, costs and
    lifted artifacts.  Params as :class:`.multicut.MulticutWorkflow`."""

    task_name = "lifted_multicut_workflow"

    def requires(self):
        from . import lifted_multicut as lmc_mod

        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        p = self.params
        n_scales = int(p.get("n_scales", 1))
        keys = {k: p[k] for k in ("input_path", "input_key", "block_shape", "roi_begin", "roi_end", "solver_shards",
                                  "reduce_fanout", "solver_workers") if k in p}
        deps = list(self.dependencies)
        for s in range(n_scales):
            t_solve = get_task_cls(lmc_mod, "SolveLiftedSubproblems", self.target)(
                **common, dependencies=deps, scale=s, **keys)
            deps = [get_task_cls(lmc_mod, "ReduceLiftedProblem", self.target)(
                **common, dependencies=[t_solve], scale=s, **keys)]
        return [get_task_cls(lmc_mod, "SolveLiftedGlobal", self.target)(
            **common, dependencies=deps, scale=n_scales, **keys)]
