"""Exact Euclidean distance transform of a mesh-sharded volume.

Port of ``cluster_tools_tpu/parallel/distributed_edt.py``.  The separable
min-plus passes commute, so a sharded axis's pass runs after an
all-to-all (:mod:`.reshard`) makes that axis resident, at full global
extent, and a second all-to-all flips the sharding back.  Every pass is
``ops/edt.py::edt_axis_pass``: kernel B3 on the card, its twin elsewhere.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.edt import _BIG, _norm_sampling, edt_axis_pass
from . import spmd
from .reshard import reshard_axis


def sharded_distance_transform_squared(mask: torch.Tensor, *, axis_name: Optional[str] = None,
                                       axis_size: Optional[int] = None, sharded_axis: int = 0,
                                       shard_axes: Optional[Sequence[Tuple[int, str, int]]] = None,
                                       sampling: Optional[Sequence[float]] = None,
                                       max_distance: Optional[float] = None, impl: str = "auto") -> torch.Tensor:
    """Squared EDT inside ``shard_map``; ``mask`` is the local shard.

    Slab sharding: ``axis_name``/``axis_size`` (+ ``sharded_axis``); a
    multi-axis decomposition: ``shard_axes`` of ``(array_axis,
    mesh_axis_name, mesh_axis_size)``.  Distances are exact across the
    shard cuts (up to ``max_distance``, if given): the resident axes' passes
    run first, then each sharded axis flips onto the reshard target (the
    last unsharded axis, or the last other sharded axis of a fully
    decomposed volume), runs its pass at full extent and flips back.  The
    target's local extent must divide by each flipped mesh-axis size.
    """
    from .distributed_ccl import _norm_shard_axes

    axes = _norm_shard_axes(axis_name, axis_size, sharded_axis, shard_axes)
    ndim = mask.dim()
    sampling = _norm_sampling(ndim, sampling)
    sharded = {a: (name, n) for a, name, n in axes}
    global_extent = {a: mask.shape[a] * sharded.get(a, (None, 1))[1] for a in range(ndim)}
    if max_distance is None:
        radii = {a: global_extent[a] - 1 for a in range(ndim)}
    else:
        radii = {a: int(np.ceil(float(max_distance) / sampling[a])) for a in range(ndim)}

    big = torch.tensor(_BIG, device=mask.device)
    f = torch.where(mask, big, torch.tensor(np.float32(0.0), device=mask.device)).contiguous()
    # passes along the already-resident axes (no communication)
    for a in range(ndim):
        if a not in sharded:
            f = edt_axis_pass(f, a, sampling[a] ** 2, radii[a], impl=impl, device=f.device)
    for a, name, n in axes:
        # prefer an unsharded flip target (no extra divisibility constraint)
        free = [x for x in range(ndim) if x != a and x not in sharded]
        resident = max(free) if free else max(x for x in range(ndim) if x != a)
        if f.shape[resident] % n:
            raise ValueError(f"reshard axis {resident} local extent {f.shape[resident]} "
                             f"not divisible by mesh axis {name!r} size {n}")
        f = reshard_axis(f, name, from_axis=a, to_axis=resident).contiguous()
        f = edt_axis_pass(f, a, sampling[a] ** 2, radii[a], impl=impl, device=f.device)
        f = reshard_axis(f, name, from_axis=resident, to_axis=a).contiguous()
    return torch.minimum(f, big)


def distributed_distance_transform_squared(mask, mesh, sp_axis: Union[str, Sequence[str]] = "sp",
                                           sharded_axis: int = 0, sampling: Optional[Sequence[float]] = None,
                                           max_distance: Optional[float] = None, impl: str = "auto"):
    """Whole-volume wrapper: the exact squared EDT of ``mask`` sharded over
    ``sp_axis`` (one mesh axis name: ``sharded_axis`` is sharded; a
    sequence: the leading array axes are).  Returns the global tensor."""
    mask = torch.as_tensor(mask).to(torch.bool)
    if sampling is not None:
        sampling = tuple(float(s) for s in np.atleast_1d(sampling))
    names = (sp_axis,) if isinstance(sp_axis, str) else tuple(sp_axis)
    if isinstance(sp_axis, str):
        array_axes = (int(sharded_axis) % mask.dim(),)
    else:
        if sharded_axis != 0:
            raise ValueError("sharded_axis only applies to single-axis sharding; a "
                             "sequence sp_axis shards the leading array axes")
        array_axes = tuple(range(len(names)))
    shard_axes = tuple((a, name, mesh.axis_size(name)) for a, name in zip(array_axes, names))
    spec = [None] * mask.dim()
    for a, name in zip(array_axes, names):
        spec[a] = name
    fn = spmd.shard_map(
        lambda m: sharded_distance_transform_squared(m, shard_axes=shard_axes, sampling=sampling,
                                                     max_distance=max_distance, impl=impl),
        mesh, spmd.P(*spec), spmd.P(*spec), name="edt",
    )
    return fn(mask)


def distributed_distance_transform(mask, mesh, sp_axis: Union[str, Sequence[str]] = "sp",
                                   sharded_axis: int = 0, sampling: Optional[Sequence[float]] = None,
                                   max_distance: Optional[float] = None, impl: str = "auto"):
    """The (non-squared) exact EDT of a sharded volume; see
    :func:`distributed_distance_transform_squared`.  Distances do not
    saturate at any halo."""
    return torch.sqrt(distributed_distance_transform_squared(
        mask, mesh, sp_axis=sp_axis, sharded_axis=sharded_axis, sampling=sampling,
        max_distance=max_distance, impl=impl,
    ))
