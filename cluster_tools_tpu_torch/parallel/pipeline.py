"""The fused, mesh-sharded watershed + CCL step.

Port of ``cluster_tools_tpu/parallel/pipeline.py``: one
:func:`~.spmd.shard_map` body over a ``(dp, sp...)`` mesh runs, for each
volume of its ``dp`` share,

- the halo exchange (one per sharded axis; later exchanges forward the
  halos received by earlier ones, so corners arrive right),
- the DT watershed of the padded shard (the tiled kernels, or the legacy
  ``ops/watershed.py`` path), seeded from the halo-capped per-shard EDT or
  from the mesh-exact one (``exact_edt``),
- the crop, the fragment ids globalized by shard rank (compacted with
  ``max_labels_per_shard``), and the stitch of fragments across the cuts
  (``stitch_ws_threshold``),
- the distributed CCL of the foreground,

then a float32 ``psum`` of the foreground count over the whole mesh and a
mesh-wide overflow flag.  The tiled route is the four stage bodies of
:func:`stage_bodies`, run in sequence; :mod:`.split_pipeline` runs the same
bodies as four ``shard_map`` stages.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device, resolve_impl
from ..ops.ccl import relabel_consecutive
from ..ops.tile_ccl import DEFAULT_TABLE_CAP, resolve_tier_mode
from ..ops.tile_ws import _dt_seeds_core, _ws_fill_core, _ws_flow_core, resolve_fill_mode, resolve_seed_mode
from . import spmd
from .distributed_ccl import (
    ShardAxis,
    linearized_shard_rank,
    merge_labels_by_pairs,
    sharded_label_components,
    sp_axes_for_mesh,
)
from .halo import crop_halo, exchange_halo, neighbor_face
from .mesh import make_mesh

IMPLS = ("auto", "cuda", "torch", "legacy")


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(v), device=like.device)


def exchange_all(x: torch.Tensor, sp_axes: Sequence[ShardAxis], halo: int, fill) -> torch.Tensor:
    """One halo exchange per sharded axis, in order; later exchanges forward
    the halos received by earlier ones, so corner regions arrive with the
    neighbour-of-neighbour data."""
    for a, name, size in sp_axes:
        x = exchange_halo(x, halo, a, name, size, fill=fill)
    return x


def globalize_fragments(ws: torch.Tensor, n_pad: int, n_shards: int, rank: int,
                        max_labels_per_shard: Optional[int]) -> Tuple[torch.Tensor, int, bool]:
    """Fragment ids (padded-shard flat indices + 1) made unique across
    shards: ``+ rank * n_pad``, or compacted to ``1..K`` and ``+ rank * (cap
    + 1)``.  Returns ``(ws, span, overflow)``."""
    if max_labels_per_shard is not None:
        cap = int(max_labels_per_shard)
        if n_shards * (cap + 1) >= 2**31:
            raise ValueError(f"{n_shards} shards x {cap} ws fragments overflow int32")
        # ids are padded-volume flat indices (+1): pass the padded span so
        # the bitmap path engages
        ws, n_frag = relabel_consecutive(ws, max_labels=cap, value_bound=n_pad + 1)
        return torch.where(ws > 0, ws + rank * (cap + 1), 0).to(torch.int32), cap + 1, int(n_frag) > cap
    if n_shards * n_pad >= 2**31:
        raise ValueError(f"{n_shards} shards of {n_pad} padded voxels overflow int32 labels; "
                         "pass max_labels_per_shard")
    return torch.where(ws > 0, ws + rank * n_pad, 0).to(torch.int32), n_pad, False


def stitch_ws_fragments(ws: torch.Tensor, vol: torch.Tensor, axes: Sequence[ShardAxis], rank: int, span: int,
                        threshold: float) -> torch.Tensor:
    """Merge watershed fragments across every sharded cut by face
    consensus: two fragments facing each other merge where the larger of
    the two sides' boundary values at the contact is below ``threshold``."""
    pairs = []
    neg1 = torch.tensor(-1, dtype=torch.int32, device=ws.device)
    thr = _f32(threshold, vol)
    for a, name, size in axes:
        mine_l = ws.narrow(a, 0, 1).reshape(-1)
        theirs_l = neighbor_face(ws, a, name, size, direction=-1).reshape(-1)
        mine_b = vol.narrow(a, 0, 1).reshape(-1)
        theirs_b = neighbor_face(vol, a, name, size, direction=-1, fill=1.0).reshape(-1)
        val = torch.maximum(mine_b, theirs_b)
        ok = (mine_l > 0) & (theirs_l > 0) & (val < thr)
        pairs.append(torch.stack([torch.where(ok, theirs_l, neg1), torch.where(ok, mine_l, neg1)], dim=1))
    return merge_labels_by_pairs(ws, torch.cat(pairs, dim=0), axes, rank, span)


def reduce_all(v: torch.Tensor, sp_axes: Sequence[ShardAxis], dp_axis: str, op=spmd.pmax) -> torch.Tensor:
    """``op`` over every sharded spatial axis, then over ``dp``."""
    for _, name, _ in sp_axes:
        v = op(v, name)
    return op(v, dp_axis)


def flag(v: bool, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(int(v), dtype=torch.int32, device=like.device)


def foreground_count(cc_lab: torch.Tensor, sp_axes, dp_axis) -> torch.Tensor:
    """The mesh-wide foreground count, summed in float32 (an int32 sum would
    wrap past 2**31 voxels; float32 is exact below 2**24 a shard)."""
    return reduce_all((cc_lab > 0).sum().to(torch.float32), sp_axes, dp_axis, op=spmd.psum)


def resolve_mesh(mesh, device, dp_axis: str, sp_axis):
    """``mesh``, or a one-shard mesh on ``device`` (default: the card)."""
    if mesh is not None:
        if device is not None and any(d != resolve_device(device) for d in mesh.devices):
            raise ValueError(f"device={device} disagrees with the mesh's devices")
        return mesh
    names = (sp_axis,) if isinstance(sp_axis, str) else tuple(sp_axis)
    return make_mesh(1, axis_names=(dp_axis,) + names, devices=[resolve_device(device)])


def resolve_step_impl(impl: str, mesh) -> str:
    """``legacy``, or the kernel route (``cuda``/``torch``) on the mesh's
    devices."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "legacy":
        return impl
    routes = {resolve_impl(impl, d) for d in mesh.devices}
    if len(routes) != 1:
        raise ValueError(f"impl={impl!r} resolves to {routes} over the mesh's devices")
    return routes.pop()


def step_config(mesh, dp_axis: str, sp_axis, fill_mode, seed_mode, tier_mode, **kw) -> dict:
    """The per-shard bodies' keyword arguments: the sharded axes of
    ``mesh`` and the three modes resolved here, at build time."""
    return dict(kw, sp_axes=sp_axes_for_mesh(mesh, sp_axis), dp_axis=dp_axis,
                fill_mode=resolve_fill_mode(fill_mode, mesh.devices[0]), seed_mode=resolve_seed_mode(seed_mode),
                tier=resolve_tier_mode(tier_mode))


def as_batch(boundaries) -> torch.Tensor:
    """A float32 tensor of the batch (left on its device)."""
    if isinstance(boundaries, np.ndarray):
        boundaries = torch.from_numpy(np.ascontiguousarray(boundaries))
    return torch.as_tensor(boundaries).to(torch.float32)


def finish_fragments(ws: torch.Tensor, vol: torch.Tensor, n_pad: int, *, sp_axes, halo, max_labels_per_shard,
                     stitch_ws_threshold) -> Tuple[torch.Tensor, bool]:
    """A padded shard's watershed → its final fragments: the halo cropped,
    the ids globalized by shard rank, and stitched across the cuts.
    Returns ``(ws, overflow)``."""
    n_shards = int(np.prod([s for _, _, s in sp_axes]))
    rank = linearized_shard_rank(sp_axes)
    for a, _, _ in sp_axes:
        ws = crop_halo(ws, halo, a)
    ws, span, over = globalize_fragments(ws, n_pad, n_shards, rank, max_labels_per_shard)
    if stitch_ws_threshold is not None and n_shards > 1:
        ws = stitch_ws_fragments(ws, vol, sp_axes, rank, span, float(stitch_ws_threshold))
    return ws, over


def stage_bodies(*, sp_axes, dp_axis, halo, threshold, connectivity, dt_max_distance, min_seed_distance,
                 max_labels_per_shard, impl, exact_edt, stitch_ws_threshold, fill_mode, seed_mode, tier):
    """The step's four per-shard stage bodies ``(seeds, flow, fill, cc)``
    on the tiled kernels; :func:`make_ws_ccl_step` runs them in sequence in
    one ``shard_map`` body and :mod:`.split_pipeline` as four.  Each
    replicated overflow flag is reduced over the mesh, so it is the same on
    every shard."""
    from .distributed_edt import sharded_distance_transform_squared

    sharded_dims = [a for a, _, _ in sp_axes]
    caps = dict(tile=None, table_cap=DEFAULT_TABLE_CAP, tier=tier)
    finish = dict(sp_axes=sp_axes, halo=halo, max_labels_per_shard=max_labels_per_shard,
                  stitch_ws_threshold=stitch_ws_threshold)

    def seeds_body(boundaries):
        if boundaries.dim() - 1 != 3:
            raise ValueError("the tiled step expects a (B, Z, Y, X) batch of 3-D volumes")
        pad_out, seed_out, ovf = [], [], False
        for vol in boundaries:
            # border fill 1.0 (pure boundary): basins never leak out of the volume
            padded = exchange_all(vol, sp_axes, halo, 1.0)
            dist_pad = None
            if exact_edt:
                # the globally exact squared EDT (capped at dt_max_distance, if
                # given), halo-exchanged so the padded window sees it; fill 0:
                # outside the volume is background
                dist_sq = sharded_distance_transform_squared(vol < _f32(threshold, vol), shard_axes=sp_axes,
                                                             max_distance=dt_max_distance, impl=impl)
                dist_pad = exchange_all(dist_sq, sp_axes, halo, 0.0)
            seeds, _, s_ovf = _dt_seeds_core(
                padded, None, dist=dist_pad, threshold=threshold, min_seed_distance=min_seed_distance,
                sampling=None, dt_max_distance=dt_max_distance, impl=impl, pair_cap=None, edge_cap=None,
                seed_cap=None, seed_mode=seed_mode, **caps,
            )
            ovf = ovf or s_ovf
            pad_out.append(padded)
            seed_out.append(seeds)
        return torch.stack(pad_out), torch.stack(seed_out), reduce_all(flag(ovf, boundaries), sp_axes, dp_axis)

    def flow_body(padded, seeds, ovf_in):
        val_out, h_out, ovf = [], [], False
        for b in range(padded.shape[0]):
            values, h, o = _ws_flow_core(padded[b], seeds[b], None, impl=impl, exit_cap=None, **caps)
            ovf = ovf or o
            val_out.append(values)
            h_out.append(h)
        ovf = torch.maximum(ovf_in, reduce_all(flag(ovf, padded), sp_axes, dp_axis))
        return torch.stack(val_out), torch.stack(h_out), ovf

    def fill_body(values, h, boundaries, ovf_in):
        pad_shape = tuple(boundaries.shape[1 + i] + (2 * halo if i in sharded_dims else 0) for i in range(3))
        ws_out, ovf = [], False
        for b in range(values.shape[0]):
            ws, o = _ws_fill_core(values[b], h[b], pad_shape, impl=impl, exit_cap=None, fill_cap=None,
                                  adj_cap=None, fill_rounds=None, fill_mode=fill_mode, **caps)
            ws, over = finish_fragments(ws, boundaries[b], int(np.prod(pad_shape)), **finish)
            ovf = ovf or o or over
            ws_out.append(ws)
        ovf = torch.maximum(ovf_in, reduce_all(flag(ovf, values), sp_axes, dp_axis))
        return torch.stack(ws_out), ovf

    def cc_body(boundaries, ovf_in):
        cc_out = []
        ovf = flag(False, boundaries)
        thr = _f32(threshold, boundaries)
        for vol in boundaries:
            cc, cc_over = sharded_label_components(
                vol < thr, shard_axes=sp_axes, connectivity=connectivity,
                max_labels_per_shard=max_labels_per_shard, return_overflow=True, impl=impl, tier=tier,
            )
            ovf = torch.maximum(ovf, cc_over.to(torch.int32))
            cc_out.append(cc)
        cc_lab = torch.stack(cc_out)
        n_fg = foreground_count(cc_lab, sp_axes, dp_axis)
        return cc_lab, n_fg, torch.maximum(ovf_in, reduce_all(ovf, sp_axes, dp_axis)) > 0

    return seeds_body, flow_body, fill_body, cc_body


def _ws_ccl_shard(boundaries: torch.Tensor, bodies, cfg: dict):
    """Per-shard body of the fused step: the local shard is
    ``(local_batch,) + local_volume``.  The tiled route runs the four stage
    bodies; the legacy dense watershed (and any volume the tiled kernels do
    not cover: 2-D, connectivity > 1) has its own ws and shares the cc."""
    from ..ops.watershed import distance_transform_watershed

    seeds_body, flow_body, fill_body, cc_body = bodies
    sp_axes, halo = cfg["sp_axes"], cfg["halo"]
    if cfg["impl"] != "legacy" and cfg["connectivity"] == 1 and boundaries.dim() - 1 == 3:
        padded, seeds, ovf = seeds_body(boundaries)
        values, h, ovf = flow_body(padded, seeds, ovf)
        del padded, seeds
        ws_lab, ovf = fill_body(values, h, boundaries, ovf)
        del values, h
        return (ws_lab,) + cc_body(boundaries, ovf)
    if cfg["exact_edt"]:
        raise ValueError(f"exact_edt requires the tiled kernels, which are 3-D only "
                         f"(got a {boundaries.dim() - 1}-D volume)")
    finish = dict(sp_axes=sp_axes, halo=halo, max_labels_per_shard=cfg["max_labels_per_shard"],
                  stitch_ws_threshold=cfg["stitch_ws_threshold"])
    ws_out, ovf = [], False
    for vol in boundaries:
        padded = exchange_all(vol, sp_axes, halo, 1.0)
        ws = distance_transform_watershed(padded, threshold=cfg["threshold"],
                                          min_seed_distance=cfg["min_seed_distance"],
                                          connectivity=cfg["connectivity"], dt_max_distance=cfg["dt_max_distance"],
                                          device=padded.device)
        ws, over = finish_fragments(ws, vol, padded.numel(), **finish)
        ovf = ovf or over
        ws_out.append(ws)
    ovf = reduce_all(flag(ovf, boundaries), sp_axes, cfg["dp_axis"])
    return (torch.stack(ws_out),) + cc_body(boundaries, ovf)


def make_ws_ccl_step(mesh=None, halo: int = 4, threshold: float = 0.3, connectivity: int = 1,
                     dp_axis: str = "dp", sp_axis: Union[str, Sequence[str]] = "sp",
                     dt_max_distance: Optional[float] = None, min_seed_distance: float = 0.0,
                     max_labels_per_shard: Optional[int] = None, impl: str = "auto", exact_edt: bool = False,
                     stitch_ws_threshold: Optional[float] = None, fill_mode: Optional[str] = None,
                     seed_mode: Optional[str] = None, tier_mode: Optional[str] = None, device=None):
    """Build the fused step for ``mesh`` (default: one shard on ``device``,
    the card unless the caller names the CPU).

    ``step(boundaries)`` takes a float32 batch ``(B,) + volume`` with ``B``
    divisible by the ``dp`` size; ``sp_axis`` is one mesh axis (z slabs) or
    a sequence (the leading volume axes over the respective axes).  Returns
    ``(ws_labels, cc_labels, n_foreground, overflow)``: int32 labels of the
    batch's shape, a float32 0-d foreground count and a bool, True when a
    shard exceeded ``max_labels_per_shard`` or a kernel capacity.

    ``impl``: ``auto`` (kernels on the card, twins on the CPU), ``cuda``,
    ``torch`` or ``legacy`` (the dense fixpoint watershed and labeller).
    ``exact_edt`` seeds from the mesh-exact EDT (tiled kernels,
    connectivity 1; the reshard target's local extent must divide by each
    sharded axis size).  ``stitch_ws_threshold`` merges fragments across the
    cuts where the contact's boundary evidence is below it.
    ``fill_mode``/``seed_mode``/``tier_mode`` mirror
    ``CT_FILL_MODE``/``CT_SEED_CCL``/``CT_TIER_MODE`` (``None`` reads them
    here, at build time).
    """
    if exact_edt and (impl == "legacy" or connectivity != 1):
        raise ValueError("exact_edt requires the tiled kernels (impl != 'legacy') and connectivity=1")
    mesh = resolve_mesh(mesh, device, dp_axis, sp_axis)
    impl = resolve_step_impl(impl, mesh)
    names = (sp_axis,) if isinstance(sp_axis, str) else tuple(sp_axis)
    spec = spmd.P(dp_axis, *names)
    cfg = step_config(mesh, dp_axis, sp_axis, fill_mode, seed_mode, tier_mode, halo=halo, threshold=threshold,
                      connectivity=connectivity, dt_max_distance=dt_max_distance,
                      min_seed_distance=min_seed_distance, max_labels_per_shard=max_labels_per_shard, impl=impl,
                      exact_edt=exact_edt, stitch_ws_threshold=stitch_ws_threshold)
    bodies = stage_bodies(**cfg)
    fn = spmd.shard_map(lambda b: _ws_ccl_shard(b, bodies, cfg), mesh, spec,
                        (spec, spec, spmd.P(), spmd.P()), name="step")

    def step(boundaries):
        ws, cc, n_fg, overflow = fn(as_batch(boundaries))
        return ws, cc, n_fg, bool(overflow)

    return step
