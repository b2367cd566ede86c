"""Thin command-line entry point.

Port of ``cluster_tools_tpu/cli.py``:

    python -m cluster_tools_tpu_torch.cli run <workflow> --config config.json
    python -m cluster_tools_tpu_torch.cli configs <workflow> --out config_dir/
    python -m cluster_tools_tpu_torch.cli report <tmp_folder>

``run`` reads ONE json with {tmp_folder, config_dir, max_jobs, target,
params: {...}} and builds the named workflow; ``target`` defaults to
``"gpu"`` (the card; ``"local"`` runs on the CPU).  ``configs``
materializes a workflow's default task configs into a config_dir for
editing (the reference's ``get_config`` pattern); ``report`` prints the
runtime table.

:data:`WORKFLOWS` keeps every name of the reference's registry.  A name
not in :data:`PORTED` raises ``NotImplementedError`` naming
:data:`UNPORTED_ITEM` when it is resolved (never at import).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


WORKFLOWS = {
    # name -> "module:Class"
    "connected_components": "cluster_tools_tpu_torch.tasks.connected_components:ConnectedComponentsWorkflow",
    "thresholded_components": "cluster_tools_tpu_torch.tasks.thresholded_components:ThresholdedComponentsWorkflow",
    "watershed": "cluster_tools_tpu_torch.tasks.watershed:WatershedWorkflow",
    "fused_segmentation": "cluster_tools_tpu_torch.tasks.fused:FusedSegmentationWorkflow",
    "multicut": "cluster_tools_tpu_torch.workflows:MulticutSegmentationWorkflow",
    "lifted_multicut": "cluster_tools_tpu_torch.workflows:LiftedMulticutSegmentationWorkflow",
    "agglomerative_clustering": "cluster_tools_tpu_torch.workflows:AgglomerativeClusteringWorkflow",
    "mutex_watershed": "cluster_tools_tpu_torch.tasks.mutex_watershed:MwsWorkflow",
    "stitching": "cluster_tools_tpu_torch.tasks.stitching:StitchingWorkflow",
    "relabel": "cluster_tools_tpu_torch.tasks.relabel:RelabelWorkflow",
    "size_filter": "cluster_tools_tpu_torch.tasks.postprocess:SizeFilterWorkflow",
    "graph_ws_size_filter": "cluster_tools_tpu_torch.tasks.postprocess:GraphWatershedSizeFilterWorkflow",
    "fill_holes": "cluster_tools_tpu_torch.tasks.postprocess:FillHolesWorkflow",
    "cc_on_segmentation": "cluster_tools_tpu_torch.tasks.postprocess:ConnectedComponentsOnSegmentationWorkflow",
    "downscaling": "cluster_tools_tpu_torch.tasks.downscaling:DownscalingWorkflow",
    "copy_volume": "cluster_tools_tpu_torch.tasks.copy_volume:CopyVolumeWorkflow",
    "inference": "cluster_tools_tpu_torch.tasks.inference:InferenceWorkflow",
    "ilastik_prediction": "cluster_tools_tpu_torch.tasks.ilastik:IlastikPredictionWorkflow",
    "morphology": "cluster_tools_tpu_torch.tasks.morphology:MorphologyWorkflow",
    "node_labels": "cluster_tools_tpu_torch.tasks.node_labels:NodeLabelWorkflow",
    "evaluation": "cluster_tools_tpu_torch.tasks.evaluation:EvaluationWorkflow",
    "skeletons": "cluster_tools_tpu_torch.tasks.skeletons:SkeletonWorkflow",
    "meshes": "cluster_tools_tpu_torch.tasks.meshes:MeshWorkflow",
    "transformations": "cluster_tools_tpu_torch.tasks.transformations:TransformationsWorkflow",
    "distances": "cluster_tools_tpu_torch.tasks.distances:PairwiseDistanceWorkflow",
    "statistics": "cluster_tools_tpu_torch.tasks.statistics:DataStatisticsWorkflow",
    "paintera_conversion": "cluster_tools_tpu_torch.tasks.paintera:PainteraConversionWorkflow",
    "paintera_to_bdv": "cluster_tools_tpu_torch.tasks.paintera:PainteraToBdvWorkflow",
}

#: the names the port has
PORTED = ("connected_components", "thresholded_components", "watershed", "fused_segmentation", "multicut",
          "agglomerative_clustering", "relabel", "copy_volume", "inference", "ilastik_prediction", "size_filter",
          "graph_ws_size_filter", "fill_holes", "cc_on_segmentation", "downscaling", "morphology", "node_labels",
          "evaluation", "skeletons", "meshes", "transformations", "distances", "statistics", "paintera_conversion",
          "paintera_to_bdv")

#: the ROADMAP item that ports every other name
UNPORTED_ITEM = "ROADMAP item 12"


def resolve_spec(name: str, spec: str):
    """The workflow class behind ``spec`` (``module:Class``); a registered
    ``name`` not in :data:`PORTED` raises ``NotImplementedError``."""
    import importlib

    if name in WORKFLOWS and name not in PORTED:
        raise NotImplementedError(f"workflow {name!r} is not ported: {UNPORTED_ITEM}")
    mod_name, cls_name = spec.split(":", 1)
    return getattr(importlib.import_module(mod_name), cls_name)


def _resolve(name: str):
    try:
        spec = WORKFLOWS[name]
    except KeyError:
        raise SystemExit(
            f"unknown workflow {name!r}; available:\n  "
            + "\n  ".join(sorted(WORKFLOWS))
        )
    return resolve_spec(name, spec)


def cmd_run(args) -> int:
    from .runtime.supervision import REQUEUE_EXIT_CODE, DrainInterrupt
    from .runtime.task import build

    with open(args.config) as f:
        cfg = json.load(f)
    # the reference's JAX platform pin has no counterpart: torch picks no device before a task runs
    cls = _resolve(args.workflow)
    wf = cls(
        tmp_folder=cfg["tmp_folder"],
        config_dir=cfg.get("config_dir", cfg["tmp_folder"]),
        max_jobs=int(cfg.get("max_jobs", 4)),
        target=cfg.get("target", "gpu"),
        **cfg.get("params", {}),
    )
    try:
        ok = build([wf], rerun=args.rerun)
    except DrainInterrupt as e:
        # graceful preemption: markers/manifests are flushed — exit with
        # the requeue code so the scheduler resubmits us, and the resumed
        # run picks up at block grain behind the markers
        print(f"DRAINED ({e.reason}); exiting {REQUEUE_EXIT_CODE} for requeue")
        return REQUEUE_EXIT_CODE
    print("SUCCESS" if ok else "FAILED (see logs in tmp_folder)")
    return 0 if ok else 1


def cmd_configs(args) -> int:
    import importlib
    import inspect

    from .runtime.task import BaseTask, WorkflowBase

    cls = _resolve(args.workflow)
    os.makedirs(args.out, exist_ok=True)
    get_config = getattr(cls, "get_config", None)
    if get_config is not None and get_config is not BaseTask.get_config:
        # workflow defines its own aggregator (workflows.py pattern); let
        # real failures inside it propagate rather than silently falling
        # back to an incomplete module scan
        configs = get_config()
    else:
        # task-module workflow: aggregate the defaults of every task family
        # defined in the workflow's module (one `<task_name>.config` per
        # task).  ``task_name in vars(obj)`` excludes abstract helpers that
        # merely inherit BaseTask's name.
        configs = {"global": BaseTask.default_global_config()}
        mod = importlib.import_module(cls.__module__)
        for obj in vars(mod).values():
            if (
                inspect.isclass(obj)
                and issubclass(obj, BaseTask)
                and not issubclass(obj, WorkflowBase)
                and obj.__name__.endswith("Base")
                and "task_name" in vars(obj)
            ):
                configs[obj.task_name] = obj.default_task_config()
    from .utils.task_utils import dump_config

    for name, cfg in configs.items():
        path = os.path.join(
            args.out, "global.config" if name == "global" else f"{name}.config"
        )
        dump_config(path, cfg)
        print("wrote", path)
    return 0


def cmd_report(args) -> int:
    from .utils.parse_utils import report

    print(report(args.tmp_folder, n_voxels=args.n_voxels))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cluster_tools_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run a workflow from a json config")
    pr.add_argument("workflow", help="workflow name (see `configs --list`)")
    pr.add_argument("--config", required=True, help="run config json")
    pr.add_argument("--rerun", action="store_true", help="ignore success targets")
    pr.set_defaults(fn=cmd_run)

    pc = sub.add_parser("configs", help="materialize default task configs")
    pc.add_argument("workflow")
    pc.add_argument("--out", required=True, help="config_dir to write into")
    pc.set_defaults(fn=cmd_configs)

    pp = sub.add_parser("report", help="runtime report for a tmp_folder")
    pp.add_argument("tmp_folder")
    pp.add_argument("--n-voxels", type=int, default=None)
    pp.set_defaults(fn=cmd_report)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
