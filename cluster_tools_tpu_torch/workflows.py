"""End-to-end segmentation workflows (BASELINE config 4).

Port of ``cluster_tools_tpu/workflows.py``: ``MulticutSegmentationWorkflow``
chains

    watershed (supervoxels) -> graph -> edge features -> costs
    -> hierarchical multicut -> write

and ``AgglomerativeClusteringWorkflow`` the same with average-linkage
agglomeration in place of costs and multicut.  ``target`` selects the
stage tasks (``gpu``, the default, or ``local``); ``get_config()``
aggregates every stage's defaults.  The lifted workflow is ROADMAP Queue A
item 12.
"""

from __future__ import annotations

from typing import Any, Dict

from .runtime.task import WorkflowBase, get_task_cls
from .tasks import agglomerative_clustering as ac_mod
from .tasks import costs as costs_mod
from .tasks import features as feat_mod
from .tasks import graph as graph_mod
from .tasks import multicut as mc_mod
from .tasks import watershed as ws_mod
from .tasks import write as write_mod

_WS_PARAMS = ("threshold", "sigma_seeds", "min_seed_distance", "sampling", "size_filter", "two_d", "halo",
              "block_shape", "mask_path", "mask_key")


def _pick(p: Dict[str, Any], *names: str) -> Dict[str, Any]:
    return {k: p[k] for k in names if k in p}


def _supervoxel_graph_features(wf: WorkflowBase):
    """The shared head of both workflows: watershed (unless ``skip_ws``),
    graph and edge features; returns ``(common, grid, features task)``."""
    p = wf.params
    common = dict(tmp_folder=wf.tmp_folder, config_dir=wf.config_dir, max_jobs=wf.max_jobs)
    ws_path, ws_key = p["ws_path"], p["ws_key"]
    deps = list(wf.dependencies)
    if not p.get("skip_ws", False):
        deps = [ws_mod.WatershedWorkflow(
            **common, target=wf.target, dependencies=deps, input_path=p["input_path"], input_key=p["input_key"],
            output_path=ws_path, output_key=ws_key, two_pass=p.get("two_pass_ws", False), **_pick(p, *_WS_PARAMS),
        )]
    grid = _pick(p, "block_shape", "roi_begin", "roi_end")
    g = graph_mod.GraphWorkflow(**common, target=wf.target, dependencies=deps, input_path=ws_path,
                                input_key=ws_key, **grid)
    feats = feat_mod.EdgeFeaturesWorkflow(
        **common, target=wf.target, dependencies=[g], input_path=p["input_path"], input_key=p["input_key"],
        labels_path=ws_path, labels_key=ws_key, **_pick(p, "channel"), **grid,
    )
    return common, grid, feats


def _write(wf: WorkflowBase, common, dep, assignment_path: str):
    p = wf.params
    return get_task_cls(write_mod, "Write", wf.target)(
        **common, dependencies=[dep], input_path=p["ws_path"], input_key=p["ws_key"], output_path=p["output_path"],
        output_key=p["output_key"], assignment_path=assignment_path, **_pick(p, "block_shape"),
    )


class MulticutSegmentationWorkflow(WorkflowBase):
    """boundary map -> supervoxels -> RAG -> features -> costs -> multicut
    -> segmentation.

    Params:
      ``input_path/input_key``    boundary/affinity map (float),
      ``ws_path/ws_key``          supervoxel dataset (created unless
                                  ``skip_ws``),
      ``output_path/output_key``  final segmentation,
      ``skip_ws``                 use an existing supervoxel dataset,
      ``two_pass_ws``             checkerboard two-pass watershed,
      watershed params (``threshold``, ``sigma_seeds``, ``halo``, ...),
      ``channel``                 boundary-map channel selector for features,
      ``beta``/``weighting_scheme`` cost transform,
      ``n_scales``                subproblem levels,
      ``agglomerator``            solver key for subproblems + global solve.
    """

    task_name = "multicut_segmentation_workflow"

    def requires(self):
        p = self.params
        common, grid, feats = _supervoxel_graph_features(self)
        costs = get_task_cls(costs_mod, "ProbsToCosts", self.target)(
            **common, dependencies=[feats], **_pick(p, "beta", "weighting_scheme", "weighting_exponent"))
        mc = mc_mod.MulticutWorkflow(
            **common, target=self.target, dependencies=[costs], input_path=p["ws_path"], input_key=p["ws_key"],
            **_pick(p, "n_scales", "agglomerator", "solver_shards"), **grid,
        )
        return [_write(self, common, mc, mc_mod.assignments_path(self.tmp_folder))]

    @staticmethod
    def get_config() -> Dict[str, Dict[str, Any]]:
        """Aggregated per-task default configs."""
        return {
            "global": WorkflowBase.default_global_config(),
            "watershed": ws_mod.WatershedBase.default_task_config(),
            "two_pass_watershed": ws_mod.TwoPassWatershedBase.default_task_config(),
            "initial_sub_graphs": graph_mod.InitialSubGraphsBase.default_task_config(),
            "block_edge_features": feat_mod.BlockEdgeFeaturesBase.default_task_config(),
            "probs_to_costs": costs_mod.ProbsToCostsBase.default_task_config(),
            "solve_subproblems": mc_mod.SolveSubproblemsBase.default_task_config(),
            "solve_global": mc_mod.SolveGlobalBase.default_task_config(),
        }


class AgglomerativeClusteringWorkflow(WorkflowBase):
    """boundary map -> supervoxels -> RAG -> features -> average-linkage
    agglomeration -> segmentation.  Same parameters as
    :class:`MulticutSegmentationWorkflow` minus the multicut ones, plus
    ``agglomeration_threshold`` (merge edges while the mean boundary
    probability is below it)."""

    task_name = "agglomerative_clustering_workflow"

    def requires(self):
        common, _, feats = _supervoxel_graph_features(self)
        ac = get_task_cls(ac_mod, "AgglomerativeClustering", self.target)(
            **common, dependencies=[feats], threshold=self.params.get("agglomeration_threshold", 0.5))
        return [_write(self, common, ac, ac_mod.agglomerative_assignments_path(self.tmp_folder))]

    @staticmethod
    def get_config() -> Dict[str, Dict[str, Any]]:
        """Aggregated per-task default configs."""
        return {
            "global": WorkflowBase.default_global_config(),
            "watershed": ws_mod.WatershedBase.default_task_config(),
            "initial_sub_graphs": graph_mod.InitialSubGraphsBase.default_task_config(),
            "block_edge_features": feat_mod.BlockEdgeFeaturesBase.default_task_config(),
            "agglomerative_clustering": ac_mod.AgglomerativeClusteringBase.default_task_config(),
        }


class LiftedMulticutSegmentationWorkflow(WorkflowBase):
    """Lifted multicut segmentation: not ported (ROADMAP Queue A item 12)."""

    task_name = "lifted_multicut_segmentation_workflow"

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("LiftedMulticutSegmentationWorkflow (lifted multicut) is not ported: "
                                  "ROADMAP Queue A item 12")
