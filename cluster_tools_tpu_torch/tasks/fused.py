"""The fused mesh-resident segmentation step as a task.

Port of ``cluster_tools_tpu/tasks/fused.py``.  When the working ROI fits in
device memory, the blockwise watershed and connected-components chains
collapse into the sharded ws+cc step
(:func:`..parallel.pipeline.make_ws_ccl_step`, or its four-stage twin
:func:`..parallel.split_pipeline.make_ws_ccl_split`): read the ROI, run the
step over a mesh of shards, write the ``ws``/``cc`` labels back.

The mesh has :func:`..parallel.mesh.visible_shards` shards on the task's
device (the reference uses ``len(jax.devices())``): the card count, or
``CTT_MESH_SHARDS``.
"""

from __future__ import annotations

import numpy as np

from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, file_reader


class FusedSegmentationBase(BaseTask):
    """Whole-ROI fused watershed + merged CC on a mesh of shards.

    Params: ``input_path/input_key`` (boundary map), ``output_path`` +
    ``ws_key``/``cc_key`` (either may be omitted to skip that output).
    Config: ``threshold``, ``halo``, ``dt_max_distance``,
    ``min_seed_distance``, ``stitch_ws_threshold``, ``exact_edt``,
    ``max_labels_per_shard``, ``impl``; ``decomposition`` (``"slab"``
    shards z, ``"grid"`` factors the shards over z and y) and ``execution``
    (``"fused"``, one shard_map, or ``"split"``, the four-stage chain; the
    same outputs).  The sharded extents must divide over the spatial mesh
    axes; a label-capacity overflow is refused.
    """

    task_name = "fused_segmentation"

    @staticmethod
    def default_task_config():
        return {
            "threads_per_job": 1,
            "threshold": 0.25,
            "halo": 4,
            "dt_max_distance": None,
            "min_seed_distance": 0.0,
            "stitch_ws_threshold": None,
            "exact_edt": False,
            "max_labels_per_shard": None,
            "impl": "auto",
            "decomposition": "slab",
            "execution": "fused",
        }

    def run_impl(self):
        from ..parallel.mesh import make_mesh, visible_shards
        from ..parallel.pipeline import make_ws_ccl_step
        from ..parallel.split_pipeline import make_ws_ccl_split
        from ..runtime import handoff

        cfg = self.get_config()
        # a live in-memory boundary map is consumed without a storage read
        inp = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"])
        shape = inp.shape
        roi_begin = tuple(cfg.get("roi_begin") or (0,) * len(shape))
        roi_end = tuple(cfg.get("roi_end") or shape)
        roi = tuple(slice(b, e) for b, e in zip(roi_begin, roi_end))
        roi_shape = tuple(e - b for b, e in zip(roi_begin, roi_end))
        if len(roi_shape) != 3:
            raise ValueError(f"fused segmentation is 3-D only, got {roi_shape}")

        # one ROI = a batch of 1: every shard goes to the spatial axes
        dev = self.device
        n_dev = visible_shards(dev)
        decomposition = str(cfg.get("decomposition", "slab"))
        if decomposition == "grid" and n_dev > 1:
            # factor the shards over z and y, z getting the larger share
            sy = next(d for d in range(int(n_dev ** 0.5), 0, -1) if n_dev % d == 0)
            sz = n_dev // sy
            mesh = make_mesh(n_dev, axis_names=("dp", "spz", "spy"), grid=(1, sz, sy), devices=dev)
            sp_axis = ("spz", "spy")
            divides = (roi_shape[0] % sz == 0) and (roi_shape[1] % sy == 0)
            sp_desc = f"spz={sz} spy={sy}"
        elif decomposition in ("slab", "grid"):
            mesh = make_mesh(n_dev, axis_names=("dp", "sp"), grid=(1, n_dev), devices=dev)
            sp_axis = "sp"
            divides = roi_shape[0] % n_dev == 0
            sp_desc = f"sp={n_dev}"
        else:
            raise ValueError(f"decomposition must be 'slab' or 'grid', got {decomposition!r}")
        if not divides:
            raise ValueError(f"ROI extents {roi_shape} do not divide over the spatial mesh axes ({sp_desc})")

        halo = int(np.max(cfg.get("halo") or 0))
        dt_max = cfg.get("dt_max_distance")
        if dt_max is None and halo and not cfg.get("exact_edt"):
            # the per-shard EDT is halo-capped by default (the blockwise
            # semantics); with exact_edt, None means truly global radii
            dt_max = float(halo)
        execution = str(cfg.get("execution", "fused"))
        if execution not in ("fused", "split"):
            raise ValueError(f"execution must be 'fused' or 'split', got {execution!r}")
        build_step = make_ws_ccl_step if execution == "fused" else make_ws_ccl_split
        step = build_step(mesh, halo=halo, threshold=float(cfg["threshold"]), sp_axis=sp_axis,
                          dt_max_distance=dt_max, min_seed_distance=float(cfg.get("min_seed_distance") or 0.0),
                          max_labels_per_shard=cfg.get("max_labels_per_shard"), impl=str(cfg.get("impl", "auto")),
                          exact_edt=bool(cfg.get("exact_edt", False)),
                          stitch_ws_threshold=cfg.get("stitch_ws_threshold"))
        self.logger.info(f"{execution} step on mesh {sp_desc}, roi {roi_shape}, halo={halo}")
        vol = np.asarray(inp[roi]).astype(np.float32)
        ws, cc, n_fg, overflow = step(vol[None])
        if overflow:
            raise RuntimeError("fused step overflowed a label capacity; raise max_labels_per_shard or use the "
                               "blockwise task chain")

        out_f = file_reader(cfg["output_path"])
        block_shape = tuple(cfg["block_shape"])
        # the ROI's blocks, in ROI coordinates, for the chunked writes
        blocking = Blocking(roi_shape, block_shape)
        written = {}
        for key_cfg, data in (("ws_key", ws), ("cc_key", cc)):
            key = cfg.get(key_cfg)
            if not key:
                continue
            arr = data[0].cpu().numpy()
            ds = out_f.require_dataset(key, shape=shape, chunks=block_shape, dtype="uint64")
            for b in range(blocking.n_blocks):
                bb = blocking.get_block(b).bb
                ds[tuple(slice(r.start + s.start, r.start + s.stop) for r, s in zip(roi, bb))] = \
                    arr[bb].astype(np.uint64)
            written[key] = int(arr.max())
        return {
            # a float32 sum: exact below 2**24 per shard; round to nearest,
            # so a representation one ulp low cannot report one less
            "n_foreground": int(round(float(n_fg))),
            "mesh": sp_desc,
            "written": written,
        }


class FusedSegmentationLocal(FusedSegmentationBase):
    target = "local"


class FusedSegmentationGPU(FusedSegmentationBase):
    target = "gpu"


class FusedSegmentationWorkflow(WorkflowBase):
    """One-task workflow wrapper, so the fused step launches as a workflow."""

    task_name = "fused_segmentation_workflow"

    def requires(self):
        from . import fused as fused_mod

        return [get_task_cls(fused_mod, "FusedSegmentation", self.target)(
            tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs,
            dependencies=self.dependencies, **self.params)]

    def run_impl(self):
        # the inner task's output stats in the workflow's own manifest
        try:
            doc = self.requires()[0].output().read()
        except OSError:
            return {}
        return {k: doc[k] for k in ("n_foreground", "written", "mesh") if k in doc}
