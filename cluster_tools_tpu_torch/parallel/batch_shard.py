"""Batched sweep execution: one kernel call per batch of blocks.

Port of ``cluster_tools_tpu/parallel/batch_shard.py`` on one device.  The
reference runs a batch of blocks as one ``jit(shard_map(vmap(kernel)))``
program; the port's counterpart of that program is one call over the
batch's stacked lanes:

- :func:`batched_sweep` — the kernel's arguments stacked to ``[batch,
  ...]`` on the device.  A kernel that carries a lane-batched form
  (``kernel.batched``) is called once over the whole stack (rung
  ``"batched"``); any other kernel is called on each lane of the
  device-resident stack in order (rung ``"lanes"``).  Either way the
  batch crosses the host bus once each way and syncs once.
- :func:`ragged_sweep` — the paged pool's batches
  (:mod:`.block_pool`): each lane is rebuilt on the device from its pages
  (gather, reshape, permute, then the fill beyond its valid extent: value
  movement only, so every lane is bit-equal to its host-padded array),
  then run as :func:`batched_sweep` does.
- :func:`exchange_batch_halo` and :func:`sharded_slab_sweep` — slab runs
  along axis 0 whose interior halos are rebuilt from batch neighbours by
  local slicing, so every voxel is read once.  Over ``n_ranks > 1`` shards
  of a mesh the batch splits into sub-batches, one a shard, and the slabs
  at the shards' cuts travel over ``spmd.ppermute``, as the reference's
  sharded program does.

- :func:`shard_lanes` and :func:`concat_lanes` — the split of a batch
  over the executor's ``n_devices`` shards, as the reference's
  ``batched_shard_map`` and ``ragged_shard_map`` split it over their mesh:
  ``n_devices`` equal sub-batches in lane order, one a shard, each run on
  its shard's device as one :func:`batched_sweep` or :func:`ragged_sweep`
  call, and the outputs gathered back in lane order.  A ragged batch's page
  pools go to every card its shards sit on (the reference replicates
  them); its page tables and valid extents split with the lanes.  A
  batch's width is a multiple of the shard count
  (:func:`resolve_sharded_batch` rounds it up), so every shard holds an
  equal sub-batch.

The policy functions (:func:`resolve_sharded_batch`,
:func:`use_sharded_sweep`, :func:`slab_sweep_device_feed_ok`) are the
reference's, word for word.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime import trace as trace_mod
from . import device_pool as device_pool_mod


def slab_sweep_device_feed_ok(
    shape: Sequence[int], extent: int, halo: int
) -> bool:
    """True when the batch geometry allows the inner-only-load device feed:
    axis-0 decomposes into whole slabs of ``extent`` (no ragged tail — tails
    would need per-block host reads anyway) and the halo fits inside one
    slab so :func:`exchange_batch_halo` can rebuild every interior halo from
    batch-neighbor data alone."""
    size = int(shape[0])
    return (
        extent > 0
        and 0 <= halo <= extent
        and size >= extent
        and size % extent == 0
    )


def resolve_sharded_batch(
    n_devices: int,
    base_batch: int,
    sharded_batch: Optional[int] = None,
) -> int:
    """The sharded batch width: ``sharded_batch`` (rounded up to a device
    multiple), or a default of ``max(2 * base_batch, 8)`` — big enough that
    dispatch overhead amortizes, always divisible by the mesh size so every
    device holds an equal sub-batch."""
    if sharded_batch is not None:
        b = max(1, int(sharded_batch))
    else:
        b = max(2 * int(base_batch), 8)
    b = max(b, n_devices)
    return ((b + n_devices - 1) // n_devices) * n_devices


def use_sharded_sweep(
    sweep_mode: str, n_devices: int, n_blocks: int, batch: int
) -> bool:
    """Resolve the ``sweep_mode`` knob: ``"sharded"`` / ``"per_block"``
    force a path; ``"auto"`` picks sharded when the mesh has >= 2 devices
    (per-block dispatch would leave all but one idle behind the dispatch
    lock) or the sweep has at least one full sharded batch of blocks (the
    dispatch-amortization regime) — single-block sweeps stay per-block."""
    if sweep_mode == "per_block":
        return False
    if sweep_mode == "sharded":
        return True
    if sweep_mode == "auto":
        return n_blocks > 1 and (n_devices >= 2 or n_blocks >= batch)
    raise ValueError(
        f"unknown sweep_mode {sweep_mode!r} "
        "(expected 'auto', 'sharded' or 'per_block')"
    )


def _stack_leaves(outs):
    """Per-lane output trees -> one tree of ``[batch, ...]`` tensors."""
    first = outs[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_leaves([o[i] for o in outs]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack_leaves([o[k] for o in outs]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    return torch.as_tensor(np.stack([np.asarray(o) for o in outs]))


def batched_sweep(kernel: Callable, args: Sequence[torch.Tensor]) -> Tuple[object, str]:
    """Run ``kernel`` over ``args`` stacked to ``[batch, ...]`` (device
    tensors).  Returns ``(outputs, rung)``: outputs stacked to ``[batch,
    ...]`` leaf by leaf, rung ``"batched"`` (one call of
    ``kernel.batched``) or ``"lanes"`` (one call of ``kernel`` per lane)."""
    args = tuple(args)
    batched = getattr(kernel, "batched", None)
    if batched is not None:
        return batched(*args), "batched"
    width = int(args[0].shape[0])
    return _stack_leaves([kernel(*(a[i] for a in args)) for i in range(width)]), "lanes"


def shard_lanes(width: int, n_shards: int) -> List[slice]:
    """The lanes of each shard's sub-batch: ``n_shards`` equal runs of a
    ``width``-lane batch, in lane order."""
    width, n_shards = int(width), int(n_shards)
    if n_shards < 1 or width % n_shards:
        raise ValueError(f"a batch of {width} lanes does not split over {n_shards} shards")
    per = width // n_shards
    return [slice(s * per, (s + 1) * per) for s in range(n_shards)]


def concat_lanes(outs):
    """Per-shard output trees (numpy, ``[lanes, ...]`` leaves) -> one tree
    of the shards' lanes in order."""
    first = outs[0]
    if len(outs) == 1:
        return first
    if isinstance(first, (tuple, list)):
        return type(first)(concat_lanes([o[i] for o in outs]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: concat_lanes([o[k] for o in outs]) for k in first}
    return np.concatenate([np.asarray(o) for o in outs], axis=0)


def reassemble_lanes(pool: torch.Tensor, table: torch.Tensor, valid: torch.Tensor, spec) -> torch.Tensor:
    """Every lane of one ragged argument as a dense ``[width,
    *spec.padded_shape]`` tensor: pages gathered by ``table``, the page
    grid interleaved back to dense, and ``spec.fill`` beyond each lane's
    valid extent (the reference's ``_reassemble``, over all lanes)."""
    nd = len(spec.grid)
    width = int(table.shape[0])
    pages = pool[table.long()]  # [width, pages_per_lane, *page_shape]
    x = pages.reshape((width,) + tuple(spec.grid) + tuple(spec.page_shape))
    perm = [0]
    for ax in range(nd):
        perm.extend((1 + ax, 1 + nd + ax))
    x = x.permute(perm).reshape((width,) + tuple(spec.padded_shape))
    mask = None
    for ax in range(nd):
        view = [1] * (nd + 1)
        view[1 + ax] = spec.padded_shape[ax]
        iota = torch.arange(spec.padded_shape[ax], device=x.device).reshape(view)
        m = iota < valid[:, ax].reshape((width,) + (1,) * nd)
        mask = m if mask is None else (mask & m)
    fill = torch.tensor(spec.fill, dtype=x.dtype, device=x.device)
    return torch.where(mask, x, fill)


def ragged_sweep(kernel: Callable, pools: Sequence[torch.Tensor], tables: Sequence[torch.Tensor],
                 valids: Sequence[torch.Tensor], specs: Sequence) -> Tuple[object, str]:
    """Run ``kernel`` over a ragged batch: per argument a page pool
    ``[pool_pages, *page_shape]``, page tables ``[width, pages_per_lane]``
    and valid extents ``[width, ndim]``, all on the device.  The lanes are
    rebuilt by :func:`reassemble_lanes` and run as :func:`batched_sweep`
    runs them; returns ``(outputs, rung)``."""
    args = [reassemble_lanes(p, t, v, s) for p, t, v, s in zip(pools, tables, valids, specs)]
    return batched_sweep(kernel, args)


def exchange_batch_halo(
    x: torch.Tensor,
    halo: int,
    axis: int,
    lo_edge: Optional[torch.Tensor] = None,
    hi_edge: Optional[torch.Tensor] = None,
    fill=0,
    axis_name: Optional[str] = None,
) -> torch.Tensor:
    """Halo reconstruction along the *batch* axis.

    ``x`` is a stacked batch ``[b, *spatial]`` whose blocks form a
    contiguous run along spatial ``axis``.  Each block's missing halo along
    that axis is its batch neighbour's edge slab: a local slice inside the
    batch; with ``axis_name`` (inside a :func:`~.spmd.shard_map` body, ``x``
    this shard's sub-batch) one ``ppermute`` each way across the shards'
    cuts.  ``lo_edge`` / ``hi_edge`` are the run-end slabs for the globally
    first and last block (``fill`` without them).  Returns ``[b, ...]`` with
    the extent along ``axis`` grown by ``2 * halo``.
    """
    if halo <= 0:
        return x
    ax = axis + 1  # x carries the batch axis in front
    extent = x.shape[ax]
    if extent < halo:
        raise ValueError(f"block extent {extent} along axis {axis} smaller than halo {halo}")
    lo_slabs = x.narrow(ax, 0, halo)
    hi_slabs = x.narrow(ax, extent - halo, halo)
    slab_shape = tuple(lo_slabs.shape[1:])

    def _edge(edge):
        if edge is None:
            return torch.full((1,) + slab_shape, fill, dtype=x.dtype, device=x.device)
        return edge.to(device=x.device, dtype=x.dtype).reshape((1,) + slab_shape)

    from_prev, from_next = _edge(lo_edge), _edge(hi_edge)
    if axis_name is not None:
        from . import spmd

        n = spmd.context().axis_size(axis_name)
        idx = spmd.axis_index(axis_name)
        # my last block's high slab -> the next shard (its pred), my first
        # block's low slab -> the previous shard (its succ)
        got_prev = spmd.ppermute(hi_slabs[-1:].contiguous(), axis_name, [(i, i + 1) for i in range(n - 1)])
        got_next = spmd.ppermute(lo_slabs[:1].contiguous(), axis_name, [(i, i - 1) for i in range(1, n)])
        if idx > 0:
            from_prev = got_prev
        if idx < n - 1:
            from_next = got_next
    pred = torch.cat([from_prev, hi_slabs[:-1]], dim=0)
    succ = torch.cat([lo_slabs[1:], from_next], dim=0)
    return torch.cat([pred, x, succ], dim=ax)


def sharded_slab_sweep(
    vol,
    kernel: Callable,
    extent: int,
    halo: int,
    batch: Optional[int] = None,
    fill=0.0,
    keep_on_device: bool = False,
    n_ranks: int = 1,
    device=None,
):
    """Sweep ``vol`` decomposed into axis-0 slabs of ``extent``, one call
    per batch of slabs, with the halos rebuilt on the device.

    Each batch of consecutive slabs is loaded without its axis-0 halos
    (every voxel is read once); :func:`exchange_batch_halo` rebuilds the
    interior halos and :func:`batched_sweep` runs ``kernel`` over the
    halo'd slabs, so ``kernel`` receives ``[extent + 2*halo, ...]`` exactly
    as per-slab overlapped reads would have produced it (volume ends padded
    with ``fill``).  A partial final batch is padded with synthetic slabs
    that lead with the true ``hi`` edge (so the last real slab still sees
    its true halo); their outputs are dropped.  Returns the per-slab
    outputs stacked along axis 0.

    ``vol`` is a host :class:`numpy.ndarray` (each batch's stack is
    uploaded to ``device``, counted as ``h2d_bytes``) or a tensor already
    on the device (sliced there; the skipped upload is counted as
    ``bytes_not_staged``).  ``keep_on_device=True`` returns a device tensor
    (no device-to-host copy); the default returns numpy and counts
    ``d2h_bytes``.  ``n_ranks > 1`` splits each batch (rounded up to a
    multiple of ``n_ranks``) over a mesh of ``n_ranks`` shards on the
    device, the halos at the shards' cuts exchanged by ``ppermute``; the
    output equals ``n_ranks=1`` bit for bit.
    """
    n_ranks = int(n_ranks)
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
    size = int(vol.shape[0])
    if size % extent:
        raise ValueError(
            f"volume extent {size} is not a multiple of the slab extent {extent} "
            "(run the ragged tail per-block)"
        )
    if halo > extent:
        raise ValueError(f"halo {halo} exceeds the slab extent {extent}")
    n_slabs = size // extent
    if batch is None:
        batch = min(n_slabs, max(n_ranks, 8))
    batch = -(-max(1, int(batch)) // n_ranks) * n_ranks

    on_device = isinstance(vol, torch.Tensor)
    if on_device:
        dev = vol.device
        dtype = vol.dtype
    else:
        from ..device import resolve_device

        dev = resolve_device(device)
        vol = np.asarray(vol)
        dtype = torch.from_numpy(vol[:0]).dtype
    slab_shape = (extent,) + tuple(vol.shape[1:])
    edge_shape = (halo,) + tuple(vol.shape[1:])
    itemsize = torch.empty((), dtype=dtype).element_size()

    def _slab(lo, hi):
        s = vol[lo:hi]
        return s if on_device else torch.from_numpy(np.ascontiguousarray(s))

    fill_edge = torch.full(edge_shape, fill, dtype=dtype)
    run = None
    if n_ranks > 1:
        from . import spmd
        from .mesh import make_mesh

        mesh = make_mesh(n_ranks, axis_names=("blocks",), devices=dev)

        def _body(stack, lo, hi):
            halod = exchange_batch_halo(stack, halo, 0, lo_edge=lo, hi_edge=hi, fill=fill, axis_name="blocks")
            return batched_sweep(kernel, (halod,))[0]

        run = spmd.shard_map(_body, mesh, (spmd.P("blocks"), spmd.P(), spmd.P()), spmd.P("blocks"),
                             name="slab_sweep")
    outs = []
    for start in range(0, n_slabs, batch):
        idxs = list(range(start, min(start + batch, n_slabs)))
        stack = torch.stack([_slab(i * extent, (i + 1) * extent) for i in idxs])
        lo = _slab(start * extent - halo, start * extent) if start > 0 else fill_edge
        end = idxs[-1] + 1
        hi = _slab(end * extent, end * extent + halo) if end < n_slabs else fill_edge
        n_pad = batch - len(idxs)
        if n_pad:
            # padding slabs lead with the real hi edge so the last real
            # slab's succ halo is still its true neighbour data
            pad = torch.zeros(slab_shape, dtype=dtype, device=stack.device)
            pad[:halo] = hi.to(stack.device)
            stack = torch.cat([stack, pad.unsqueeze(0).expand((n_pad,) + slab_shape)], dim=0)
        feed_bytes = int(stack.numel()) * itemsize
        if on_device:
            device_pool_mod.bump("bytes_not_staged", feed_bytes)
        else:
            device_pool_mod.record_h2d(feed_bytes)
            stack = stack.to(dev)
        # one span a slab batch; it ends after the copy back (or, with the
        # result kept on the card and tracing on, after a sync)
        with trace_mod.span("shard.slab_batch", start=start, n_slabs=len(idxs),
                            feed="device" if on_device else "host"):
            if run is None:
                halod = exchange_batch_halo(stack, halo, 0, lo_edge=lo, hi_edge=hi, fill=fill)
                out, _ = batched_sweep(kernel, (halod,))
            else:
                out = run(stack, lo.to(dev), hi.to(dev))
            out = out[: len(idxs)]
            if not keep_on_device:
                out = out.cpu().numpy()
                device_pool_mod.record_d2h(int(out.nbytes))
            elif trace_mod.enabled() and out.device.type == "cuda":
                torch.cuda.synchronize(out.device)
        outs.append(out)
    if keep_on_device:
        return torch.cat(outs, dim=0)
    return np.concatenate(outs, axis=0)
