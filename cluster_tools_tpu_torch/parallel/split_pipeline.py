"""The ws+cc step as a chain of four stages over a mesh.

Port of ``cluster_tools_tpu/parallel/split_pipeline.py::make_ws_ccl_split``:
the fused step (:mod:`.pipeline`) cut into four :func:`~.spmd.shard_map`
stages whose intermediates stay with their shards:

1. ``seeds`` — halo exchange (``fill=1.0``), the capped EDT (kernel B3) or
   the mesh-exact one, maxima, seed CCL (B1 + B4 when
   ``seed_mode="tiled"``);
2. ``flow``  — descent directions, in-tile flow (B2), exit chase + remap (B4);
3. ``fill``  — unseeded-basin fill, remap (B4), halo crop, fragment ids
   globalized by shard rank, the cross-shard stitch;
4. ``cc``    — the distributed CCL of the foreground (B1 + B4) and the
   mesh-wide foreground count.

``step(boundaries)`` takes a float32 ``(B, Z, Y, X)`` batch and returns
``(ws_labels, cc_labels, n_foreground, overflow)`` — the fused step's
contract, equal to it bit for bit.  Each stage frees what the next one
does not need (the reference donates them).  Without a mesh the step runs
on one shard of ``device``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

from . import spmd
from .pipeline import as_batch, resolve_mesh, resolve_step_impl, stage_bodies, step_config


class SplitWsCclStep:
    """Callable chain of the four stages.  ``stages`` maps stage name to
    its function; ``run_staged(boundaries, sync)`` calls
    ``sync(name, *outputs)`` after each stage (pass a blocking sync to time
    stages one by one)."""

    def __init__(self, stages, runner):
        self.stages = stages
        self._runner = runner

    def __call__(self, boundaries):
        return self._runner(boundaries, sync=None)

    def run_staged(self, boundaries, sync):
        return self._runner(boundaries, sync=sync)


def make_ws_ccl_split(mesh=None, halo: int = 4, threshold: float = 0.3, connectivity: int = 1,
                      dp_axis: str = "dp", sp_axis: Union[str, Sequence[str]] = "sp",
                      dt_max_distance: Optional[float] = None, min_seed_distance: float = 0.0,
                      max_labels_per_shard: Optional[int] = None, impl: str = "auto", exact_edt: bool = False,
                      stitch_ws_threshold: Optional[float] = None, fill_mode: Optional[str] = None,
                      seed_mode: Optional[str] = None, tier_mode: Optional[str] = None,
                      device=None) -> SplitWsCclStep:
    """Build the split twin of :func:`~.pipeline.make_ws_ccl_step` for
    ``mesh`` (default: one shard on ``device``, the card unless the caller
    names the CPU).  Same arguments and output contract; ``impl`` is the
    tiled family (``auto``/``cuda``/``torch``), 3-D volumes, connectivity
    1.  ``fill_mode``/``seed_mode``/``tier_mode`` mirror
    ``CT_FILL_MODE``/``CT_SEED_CCL``/``CT_TIER_MODE`` (``None`` reads the
    variable here; the defaults are ``auto``/``tiled``/``cond``).
    """
    if impl == "legacy":
        raise ValueError("split mode covers the tiled kernels only")
    if connectivity != 1:
        raise ValueError("split mode supports connectivity=1 only")
    mesh = resolve_mesh(mesh, device, dp_axis, sp_axis)
    impl = resolve_step_impl(impl, mesh)
    names = (sp_axis,) if isinstance(sp_axis, str) else tuple(sp_axis)
    seeds_body, flow_body, fill_body, cc_body = stage_bodies(**step_config(
        mesh, dp_axis, sp_axis, fill_mode, seed_mode, tier_mode, halo=halo, threshold=threshold,
        connectivity=connectivity, dt_max_distance=dt_max_distance, min_seed_distance=min_seed_distance,
        max_labels_per_shard=max_labels_per_shard, impl=impl, exact_edt=exact_edt,
        stitch_ws_threshold=stitch_ws_threshold))
    spec = spmd.P(dp_axis, *names)
    rep = spmd.P()

    def smap(body, in_specs, out_specs, name):
        return spmd.shard_map(body, mesh, in_specs, out_specs, name=name, keep_sharded=True)

    stages = {
        "seeds": smap(seeds_body, (spec,), (spec, spec, rep), "seeds"),
        "flow": smap(flow_body, (spec, spec, rep), (spec, spec, rep), "flow"),
        "fill": smap(fill_body, (spec, spec, spec, rep), (spec, rep), "fill"),
        "cc": smap(cc_body, (spec, rep), (spec, rep, rep), "cc"),
    }

    def runner(boundaries, sync=None):
        vol = spmd.shard(as_batch(boundaries), mesh, spec)
        padded, seeds, ovf = stages["seeds"](vol)
        if sync is not None:
            sync("seeds", seeds)
        values, h, ovf = stages["flow"](padded, seeds, ovf)
        del padded, seeds
        if sync is not None:
            sync("flow", values)
        ws_lab, ovf = stages["fill"](values, h, vol, ovf)
        del values, h
        if sync is not None:
            sync("fill", ws_lab)
        cc_lab, n_fg, overflow = stages["cc"](vol, ovf)
        if sync is not None:
            sync("cc", cc_lab)
        return ws_lab.full(), cc_lab.full(), n_fg, bool(overflow)

    return SplitWsCclStep(stages, runner)
