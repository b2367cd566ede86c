"""Plain reference of the ws+cc step: the same semantics, written out directly.

Nothing here imports the program.  Each function states the rule it
computes; the program's tiled kernels, capacities, tiers and exit chases
are implementation and have no counterpart here.  Everything runs on the
device of its input, in plain torch operations.

The DT watershed of one volume ``b`` (float32, every voxel valid):

1. foreground ``fg = b < threshold``;
2. squared EDT of ``fg`` capped per axis: three separable min-plus passes
   ``g[i] = min_{|d| <= r} f[i + d] + d^2`` over the voxels inside the
   volume, ``f`` = 0 on background and 1e12 on foreground, ``r`` =
   ``ceil(dt_max_distance)`` clipped to the axis extent, the result
   clipped at 1e12;
3. seeds: the 6-connected components of the plateau maxima (``dist >=`` each
   of its 6 neighbours, outside the volume counts as -inf) that lie in
   ``fg`` with ``dist >= min_seed_distance^2``, each labelled by its smallest
   flat index + 1;
4. descent: every voxel points at the lexicographic minimum of
   ``(height, flat index)`` over itself and its 6 neighbours; seed voxels
   point at themselves; a voxel takes the seed label of the end of its
   chain, or its chain end's code ``-(index) - 2`` where that end is no seed
   (an unseeded basin);
5. fill: the unseeded basins merge across saddles.  A face between two
   voxels of different values, one of them unseeded, is a contact ``(a,
   b)`` (``a`` on the lower side along the face's axis) with the saddle
   ``max`` of the two heights.  The faces of one axis lie in rows (along x
   for z- and y-faces, along y for x-faces); of each run of equal ``(a,
   b)`` along a row only the first face is an edge, with its own saddle,
   and parallel edges keep their lowest saddle.  That is the program's
   capacity rule (``fill_mode="capacity"``), which the configuration
   names: it is not the lowest saddle of each pair, and the dense rule
   gives other labels.  Edges are ordered by (saddle, a, b).  Each tree of
   the minimum spanning forest in which seeded basins are roots takes its
   root's label; basins whose tree holds no seed are 0.  Boruvka rounds in
   which only unseeded components hook give that forest.

The step's ws labels are those of the halo-padded volume (padding 1.0,
pure boundary), cropped, plus ``rank * n_pad`` on shard ``rank`` of a
z-slab mesh; its cc labels are the 6-connected components of ``fg`` over
the whole volume, compared as a partition.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

EDT_BIG = float(np.float32(1e12))
_I64_MAX = torch.iinfo(torch.int64).max


def _pairs(shape, axis: int):
    """Slices of the lower and the upper voxel of every face along ``axis``."""
    n = shape[axis]
    lo = [slice(None)] * len(shape)
    hi = [slice(None)] * len(shape)
    lo[axis] = slice(0, n - 1)
    hi[axis] = slice(1, n)
    return tuple(lo), tuple(hi)


def capped_squared_edt(fg: torch.Tensor, max_distance: float) -> torch.Tensor:
    """Step 2: the squared distance of each voxel of ``fg`` to the nearest
    background voxel, within ``ceil(max_distance)`` voxels along each axis."""
    big = torch.tensor(EDT_BIG, dtype=torch.float32, device=fg.device)
    f = torch.where(fg, big, torch.zeros((), dtype=torch.float32, device=fg.device))
    for axis in range(fg.dim()):
        n = fg.shape[axis]
        r = min(int(math.ceil(float(max_distance))), n - 1)
        g = f.clone()
        for d in range(1, r + 1):
            c = float(np.float32(d * d))
            for src, dst in ((slice(d, n), slice(0, n - d)), (slice(0, n - d), slice(d, n))):
                s = [slice(None)] * fg.dim()
                t = [slice(None)] * fg.dim()
                s[axis], t[axis] = src, dst
                torch.minimum(g[tuple(t)], f[tuple(s)] + c, out=g[tuple(t)])
        f = g
    return torch.minimum(f, big)


def plateau_maxima(x: torch.Tensor) -> torch.Tensor:
    """``x >=`` each of its 6 neighbours inside the volume."""
    m = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    for axis in range(x.dim()):
        lo, hi = _pairs(x.shape, axis)
        m[lo] &= x[lo] >= x[hi]
        m[hi] &= x[hi] >= x[lo]
    return m


def _compress(parent: torch.Tensor) -> torch.Tensor:
    """Pointer jumping ``p = p[p]`` to the fixpoint."""
    while True:
        nxt = parent[parent]
        if torch.equal(nxt, parent):
            return parent
        parent = nxt


def components_min_index(mask: torch.Tensor) -> torch.Tensor:
    """6-connected components of ``mask``: int64, each voxel's component's
    smallest flat index + 1, 0 off the mask.  Roots hook to the smaller of
    two adjacent roots until no face joins two roots."""
    shape = mask.shape
    n = mask.numel()
    idx = torch.arange(n, dtype=torch.int64, device=mask.device)
    parent = idx.clone()
    while True:
        roots = parent.view(shape)
        hooked = False
        for axis in range(mask.dim()):
            lo, hi = _pairs(shape, axis)
            ra, rb = roots[lo], roots[hi]
            join = mask[lo] & mask[hi] & (ra != rb)
            if bool(join.any()):
                ra, rb = ra[join], rb[join]
                parent.scatter_reduce_(0, torch.maximum(ra, rb), torch.minimum(ra, rb), "amin")
                hooked = True
            del ra, rb, join
        if not hooked:
            break
        parent = _compress(parent)
    return torch.where(mask.reshape(-1), parent + 1, 0).view(shape)


def dt_seeds(b: torch.Tensor, threshold: float, max_distance: float, min_seed_distance: float):
    """Steps 1-3: ``(fg, seeds)``; seeds int64, 0 = none."""
    fg = b < torch.tensor(np.float32(threshold), device=b.device)
    dist = capped_squared_edt(fg, max_distance)
    msd2 = float(np.float32(min_seed_distance * min_seed_distance))
    maxima = plateau_maxima(dist) & fg & (dist >= msd2)
    del dist
    return fg, components_min_index(maxima)


def descent_values(height: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """Step 4: int64 per voxel, a seed label (> 0) or an unseeded code
    ``-(chain end) - 2``."""
    shape = height.shape
    n = height.numel()
    best_h = height.clone()
    best_i = torch.arange(n, dtype=torch.int64, device=height.device).view(shape)
    own_i = best_i.clone()
    for axis in range(height.dim()):
        lo, hi = _pairs(shape, axis)
        for me, nb in ((lo, hi), (hi, lo)):
            nh, ni = height[nb], own_i[nb]
            bh, bi = best_h[me], best_i[me]
            better = (nh < bh) | ((nh == bh) & (ni < bi))
            best_h[me] = torch.where(better, nh, bh)
            best_i[me] = torch.where(better, ni, bi)
            del better
    del best_h, own_i
    flat_seeds = seeds.reshape(-1)
    ptr = torch.where(flat_seeds > 0, torch.arange(n, dtype=torch.int64, device=height.device), best_i.reshape(-1))
    del best_i
    end = _compress(ptr)
    lab = flat_seeds[end]
    return torch.where(lab > 0, lab, -end - 2).view(shape)


def _previous(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``y[i] = x[i - 1]`` along ``axis``, 0 before the first."""
    y = torch.zeros_like(x)
    n = x.shape[axis]
    dst = [slice(None)] * x.dim()
    src = [slice(None)] * x.dim()
    dst[axis], src[axis] = slice(1, n), slice(0, n - 1)
    y[tuple(dst)] = x[tuple(src)]
    return y


def sortable_key(f: torch.Tensor) -> torch.Tensor:
    """A monotone float32 -> int32 map (total order on non-NaN floats)."""
    u = f.to(torch.float32).contiguous().view(torch.int32)
    return u ^ ((u >> 31) & 0x7FFFFFFF)


def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """Order by ``keys[0]``, then ``keys[1]``, ...: stable sorts from the last."""
    order = torch.arange(keys[0].numel(), device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def fill_unseeded(values: torch.Tensor, height: torch.Tensor) -> torch.Tensor:
    """Step 5: every unseeded basin to its forest root's label (0 where its
    tree holds no seed); returns int64 labels, 0 = none."""
    a_l, b_l, k_l = [], [], []
    for axis in range(values.dim()):
        lo, hi = _pairs(values.shape, axis)
        a, b = values[lo], values[hi]
        row = values.dim() - 1 if axis != values.dim() - 1 else values.dim() - 2
        edge = (a != b) & ((a < 0) | (b < 0)) & ((a != _previous(a, row)) | (b != _previous(b, row)))
        a_l.append(a[edge])
        b_l.append(b[edge])
        k_l.append(sortable_key(torch.maximum(height[lo], height[hi]))[edge])
        del edge
    a, b, key = torch.cat(a_l), torch.cat(b_l), torch.cat(k_l).to(torch.int64)
    del a_l, b_l, k_l
    out = torch.where(values > 0, values, 0)
    if a.numel() == 0:
        return out
    order = _lexsort(a, b, key)
    a, b, key = a[order], b[order], key[order]
    first = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    first[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    a, b, key = a[first], b[first], key[first]
    # (saddle, a, b): the pairs are sorted by (a, b), so the rank breaks ties
    rank = torch.arange(a.numel(), dtype=torch.int64, device=a.device)
    order_key = ((key + 2**31) << 31) | rank
    nodes, inv = torch.unique(torch.cat([a, b]), return_inverse=True)
    da, db = inv[: a.numel()], inv[a.numel():]
    m = nodes.numel()
    unseeded = nodes <= -2
    me = torch.arange(m, dtype=torch.int64, device=a.device)
    parent = me.clone()
    while True:
        ra, rb = parent[da], parent[db]
        live = ra != rb
        best = torch.full((m,), _I64_MAX, dtype=torch.int64, device=a.device)
        sides = []
        for src, dst in ((ra, rb), (rb, ra)):
            hook = live & unseeded[src]
            best.scatter_reduce_(0, src[hook], order_key[hook], "amin")
            sides.append((src, dst, hook))
        step = me.clone()
        hooked = False
        for src, dst, hook in sides:
            win = hook & (best[src] == order_key)
            if bool(win.any()):
                step[src[win]] = dst[win]
                hooked = True
        if not hooked:
            break
        # two roots that chose each other: the smaller stays a root
        mutual = (step[step] == me) & (me < step)
        step = torch.where(mutual, me, step)
        parent = _compress(step)[parent]
    root_val = nodes[parent]
    final = torch.where(root_val > 0, root_val, 0)
    neg = values <= -2
    codes = values[neg]
    pos = torch.searchsorted(nodes, codes).clamp(max=m - 1)
    out[neg] = torch.where(nodes[pos] == codes, final[pos], 0)
    return out


def dt_watershed(b: torch.Tensor, threshold: float, max_distance: float, min_seed_distance: float) -> torch.Tensor:
    """Steps 1-5 on one volume; int64 labels (seed's smallest flat index + 1)."""
    _, seeds = dt_seeds(b, threshold, max_distance, min_seed_distance)
    values = descent_values(b, seeds)
    del seeds
    return fill_unseeded(values, b)


def float32_count(slab_counts) -> float:
    """The step's foreground count: each slab's count cast to float32 and
    summed in float32 in rank order (exact below 2**24 voxels a slab)."""
    total = np.float32(slab_counts[0])
    for c in slab_counts[1:]:
        total = np.float32(total + np.float32(c))
    return float(total)


def step_reference(vol: torch.Tensor, n_shards: int, halo: int, threshold: float, max_distance: float,
                   min_seed_distance: float) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """The ws+cc step of one volume ``(Z, Y, X)`` over ``n_shards`` z-slabs:
    ``(ws int64, cc int64, n_foreground)``.  Each slab is padded by ``halo``
    planes of its neighbours (1.0 past the volume's ends), watershedded,
    cropped and offset by ``rank * n_pad``; cc runs over the whole volume;
    the count is :func:`float32_count` of the slabs' counts."""
    z = vol.shape[0]
    if z % n_shards:
        raise ValueError(f"{z} planes do not split into {n_shards} slabs")
    slab = z // n_shards
    ws = torch.empty(vol.shape, dtype=torch.int64, device=vol.device)
    for rank in range(n_shards):
        z0, z1 = rank * slab - halo, (rank + 1) * slab + halo
        padded = torch.ones((z1 - z0,) + tuple(vol.shape[1:]), dtype=torch.float32, device=vol.device)
        lo, hi = max(z0, 0), min(z1, z)
        padded[lo - z0: hi - z0] = vol[lo:hi]
        lab = dt_watershed(padded, threshold, max_distance, min_seed_distance)[halo: halo + slab]
        ws[rank * slab: (rank + 1) * slab] = torch.where(lab > 0, lab + rank * padded.numel(), 0)
        del padded, lab
    fg = vol < torch.tensor(np.float32(threshold), device=vol.device)
    n_fg = float32_count([int(s.sum()) for s in fg.split(slab)])
    cc = components_min_index(fg)
    return ws, cc, n_fg


def workflow_reference(vol: torch.Tensor, block, halo, threshold: float, max_distance: float,
                       min_seed_distance: float) -> torch.Tensor:
    """The blockwise single-pass watershed of ``vol`` (Z, Y, X): each block
    of the grid (C order) with ``halo`` voxels around it, clipped at the
    volume and padded with 1.0 at its high ends to the outer shape ``block
    + 2 * halo``, watershedded, its inner part cropped; labels ``block_id *
    (n_outer + 1) + label`` (int64, 0 = none)."""
    import itertools

    shape = tuple(vol.shape)
    outer = tuple(b + 2 * h for b, h in zip(block, halo))
    n_outer = int(np.prod(outer))
    grid = [-(-s // b) for s, b in zip(shape, block)]
    out = torch.zeros(shape, dtype=torch.int64, device=vol.device)
    for block_id, pos in enumerate(itertools.product(*(range(g) for g in grid))):
        begin = [p * b for p, b in zip(pos, block)]
        end = [min((p + 1) * b, s) for p, b, s in zip(pos, block, shape)]
        ob = [max(0, b - h) for b, h in zip(begin, halo)]
        oe = [min(s, e + h) for e, h, s in zip(end, halo, shape)]
        data = torch.ones(outer, dtype=torch.float32, device=vol.device)
        data[tuple(slice(0, e - b) for b, e in zip(ob, oe))] = vol[tuple(slice(b, e) for b, e in zip(ob, oe))]
        lab = dt_watershed(data, threshold, max_distance, min_seed_distance)
        inner = lab[tuple(slice(b - o, e - o) for b, e, o in zip(begin, end, ob))]
        out[tuple(slice(b, e) for b, e in zip(begin, end))] = torch.where(inner > 0, block_id * (n_outer + 1) + inner, 0)
        del data, lab, inner
    return out
