"""CREMI-like synthetic boundary maps: box-smoothed uniform noise in [0, 1].

The recipe of the reference benchmark's on-device volume: uniform noise,
``passes`` separable 3-tap box passes per spatial axis with periodic
borders (``(v + roll(v, 1) + roll(v, -1)) / 3``), then min-max
normalisation.  Twelve passes give ~20-voxel objects, the scale of CREMI
neurites at native resolution.  Two makers: numpy from an integer seed (the
tests feed it to the JAX reference and the port alike) and torch on the
device from a ``torch.Generator`` (the on-card run).
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_PASSES = 12


def synthetic_boundaries_np(shape, seed: int = 0, passes: int = DEFAULT_PASSES,
                            spatial_axes=None) -> np.ndarray:
    """float32 boundary map of ``shape`` from ``np.random.default_rng(seed)``;
    ``spatial_axes`` (default: the last three, or all if fewer) are smoothed."""
    v = np.random.default_rng(seed).random(shape).astype(np.float32)
    axes = spatial_axes if spatial_axes is not None else tuple(range(max(0, len(shape) - 3), len(shape)))
    for axis in axes:
        for _ in range(passes):
            v = (v + np.roll(v, 1, axis) + np.roll(v, -1, axis)) / np.float32(3.0)
    lo, hi = v.min(), v.max()
    return ((v - lo) / max(hi - lo, np.float32(1e-6))).astype(np.float32)


def synthetic_boundaries(shape, generator: torch.Generator, passes: int = DEFAULT_PASSES,
                         device=None) -> torch.Tensor:
    """float32 boundary map of ``shape`` made on ``device`` (default: the
    generator's device) from ``generator``; the last three axes are smoothed."""
    device = generator.device if device is None else torch.device(device)
    v = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    for axis in range(max(0, len(shape) - 3), len(shape)):
        for _ in range(passes):
            v = (v + torch.roll(v, 1, axis) + torch.roll(v, -1, axis)) / 3.0
    lo, hi = v.min(), v.max()
    return (v - lo) / torch.clamp(hi - lo, min=1e-6)


def serpentine_order(tile) -> np.ndarray:
    """Position of each voxel along a one-voxel-wide path filling a tile
    (-1 off the path): full x-rows on every other ``(z, y)``, visited in
    boustrophedon order and joined by one voxel at the row end where the
    path turns (the longest in-tile path a sweep labeller can meet)."""
    tz, ty, tx = tile
    order = np.full(tile, -1, np.int64)
    cells = []
    for zi in range((tz + 1) // 2):
        ys = range((ty + 1) // 2)
        cells += [(2 * zi, 2 * yi) for yi in (ys if zi % 2 == 0 else reversed(ys))]
    pos = 0
    for k, (z, y) in enumerate(cells):
        order[z, y, :] = pos + (np.arange(tx) if k % 2 == 0 else np.arange(tx)[::-1])
        pos += tx
        if k + 1 < len(cells):
            z2, y2 = cells[k + 1]
            order[(z + z2) // 2, (y + y2) // 2, tx - 1 if k % 2 == 0 else 0] = pos
            pos += 1
    return order


def serpentine_tile(tile) -> np.ndarray:
    """The voxels of :func:`serpentine_order`'s path."""
    return serpentine_order(tile) >= 0


def adversarial_tiles_np(tile) -> np.ndarray:
    """Eight tiles (2 x 2 x 2 of ``tile``) that stress in-tile CCL: all
    foreground, checkerboard, isolated voxels, a serpentine and its mirror,
    a serpentine whose rows are cut into short runs, random p=0.5, empty."""
    tz, ty, tx = tile
    i = np.indices(tile)
    serp = serpentine_tile(tile)
    cut = serp.copy()
    cut[0::2, 0::2, 1::2] = False
    pats = [
        np.ones(tile, bool), i.sum(0) % 2 == 0, (i % 2 == 0).all(0), serp, serp[:, :, ::-1],
        cut, np.random.default_rng(0).random(tile) < 0.5, np.zeros(tile, bool),
    ]
    vol = np.zeros((2 * tz, 2 * ty, 2 * tx), bool)
    for k, p in enumerate(pats):
        vol[_eighth(k, tile)] = p
    return vol


# the tiles of adversarial_tiles_np, in z-major order
CCL_TILE_KINDS = ("all foreground", "checkerboard", "isolated", "serpentine", "serpentine mirrored",
                  "serpentine cut", "random p=0.5", "empty")


def adversarial_ccl_tiles_np(tile):
    """:func:`adversarial_tiles_np` cut into its eight tiles:
    ``[(kind, mask), ...]``."""
    vol = adversarial_tiles_np(tile)
    return [(kind, vol[_eighth(k, tile)].copy()) for k, kind in enumerate(CCL_TILE_KINDS)]


def _eighth(k: int, tile) -> tuple:
    """Slices of tile ``k`` (z-major) of a 2 x 2 x 2 block of ``tile``."""
    return tuple(slice(i * t, (i + 1) * t) for i, t in zip((k // 4, (k // 2) % 2, k % 2), tile))


def _tile_ids(shape, tile) -> np.ndarray:
    """Z-major tile id of every voxel."""
    i = np.indices(shape)
    g = [s // t for s, t in zip(shape, tile)]
    return ((i[0] // tile[0]) * g[1] + i[1] // tile[1]) * g[2] + i[2] // tile[2]


def flow_edits_np(dirs, sv, tile, tiles=None, n_each: int = 8, seed: int = 0):
    """Copies of a descent field ``dirs`` and seed map ``sv`` with voxels the
    flow stage never makes (it makes every seed and invalid voxel a
    terminal), only inside the tiles ``tiles`` (z-major ids; all if None):

    - seeded and invalid voxels whose code points at an unseeded in-tile
      terminal;
    - seeded, invalid and unseeded voxels whose target leaves the tile;
    - codes outside 0..6, seeded and unseeded.

    Every edit points a voxel at a terminal or makes it a root, so the
    field stays acyclic."""
    from ..ops.kernels import WS_OFFS

    dirs, sv = dirs.astype(np.int32).copy(), sv.astype(np.int32).copy()
    shape = np.asarray(dirs.shape)
    tsz = np.asarray(tile)
    rng = np.random.default_rng(seed)
    tid = _tile_ids(dirs.shape, tile)
    used = np.zeros(dirs.shape, bool) if tiles is None else ~np.isin(tid, list(tiles))
    label = max(int(sv.max()), 0) + 1

    def next_label():
        nonlocal label
        label += 1
        return label - 1

    terms = np.argwhere((dirs == 0) & (sv == 0) & ~used)
    rng.shuffle(terms)
    k = 0
    for t in terms:
        if k == 2 * n_each:
            break
        if used[tuple(t)]:
            continue
        for code, off in enumerate(WS_OFFS, start=1):
            n = t - np.asarray(off)  # its code `code` points at t
            if (n < 0).any() or (n >= shape).any() or (n // tsz != t // tsz).any() or used[tuple(n)]:
                continue
            dirs[tuple(n)] = code
            sv[tuple(n)] = next_label() if k % 2 == 0 else -1
            used[tuple(t)] = used[tuple(n)] = True
            k += 1
            break

    exits = []
    for code, off in enumerate(WS_OFFS, start=1):
        tgt = np.indices(dirs.shape) + np.asarray(off).reshape(3, 1, 1, 1)
        inside = ((tgt >= 0) & (tgt < shape.reshape(3, 1, 1, 1))).all(0)
        leaves = (tgt // tsz.reshape(3, 1, 1, 1) != np.indices(dirs.shape) // tsz.reshape(3, 1, 1, 1)).any(0)
        exits += [(tuple(p), code) for p in np.argwhere(inside & leaves & ~used)]
    for j in rng.permutation(len(exits))[: 3 * n_each]:
        p, code = exits[j]
        if used[p]:
            continue
        dirs[p] = code
        sv[p] = (next_label(), -1, 0)[j % 3]
        used[p] = True

    free = np.argwhere(~used)
    for j, p in enumerate(free[rng.permutation(len(free))[:n_each]]):
        dirs[tuple(p)] = (7, -1, 100)[j % 3]
        sv[tuple(p)] = next_label() if j % 2 == 0 else 0
    return dirs, sv


def adversarial_flow_np(tile, seed: int = 0):
    """``(dirs, sv)`` int32 over eight tiles (2 x 2 x 2 of ``tile``) that
    stress in-tile label flow, each built from a height field through
    :func:`..ops.tile_ws.descent_directions`:

    - (0,0,0) a serpentine descent (:func:`serpentine_order`), seeded at
      its low end: one path through about a quarter of the tile, which the
      walls between its rows drain into (or out of the tile, where a lower
      tile lies across the face);
    - (0,0,1) all invalid;
    - (0,1,0) the serpentine again, unseeded;
    - (0,1,1) full of seeds;
    - (1,0,0) a monotone drain out of the +x face: every path is an exit;
    - (1,0,1) noise below every other tile (the drain's sink), a few seeds
      and invalid voxels;
    - (1,1,0) all terminal: unseeded minima on even parity, seeds and
      invalid voxels on odd;
    - (1,1,1) noise with seeds and invalid voxels, then
      :func:`flow_edits_np` (the voxels the flow stage never makes).
    """
    import torch

    from ..ops.tile_ws import descent_directions

    tz, ty, tx = tile
    rng = np.random.default_rng(seed)
    shape = (2 * tz, 2 * ty, 2 * tx)
    h = np.zeros(shape, np.float32)
    sv = np.zeros(shape, np.int32)
    par = np.indices(tile).sum(0) % 2
    order = serpentine_order(tile)
    serp = np.where(order >= 0, 1000 + order.max() - order, 1e6).astype(np.float32)
    low_end = np.unravel_index(np.argmax(order), tile)
    labels = iter(range(1, 1 << 30))

    def put(k, height, seeds):
        a, b, c = k // 4, (k // 2) % 2, k % 2
        sl = (slice(a * tz, (a + 1) * tz), slice(b * ty, (b + 1) * ty), slice(c * tx, (c + 1) * tx))
        h[sl] = height
        sv[sl] = seeds

    def seeded(where):
        out = np.zeros(tile, np.int32)
        out[where] = [next(labels) for _ in range(int(where.sum()))]
        return out

    def noisy(base, p_seed, p_invalid):
        r = rng.random(tile)
        s = seeded(r < p_seed)
        return base + rng.random(tile).astype(np.float32), np.where(r > 1 - p_invalid, -1, s)

    end = np.zeros(tile, bool)
    end[low_end] = True
    put(0, serp, seeded(end))
    put(1, 0.0, -1)
    put(2, serp, 0)
    put(3, 1e5, seeded(np.ones(tile, bool)))
    put(4, 100.0 + tx - np.indices(tile)[2], 0)
    put(5, *noisy(-1000.0, 0.01, 0.05))
    odd_invalid = (par == 1) & (np.indices(tile)[0] % 2 == 1)
    put(6, np.where(par == 0, -1e4, 600.0), np.where(odd_invalid, -1, seeded((par == 1) & ~odd_invalid)))
    put(7, *noisy(2000.0, 0.01, 0.05))
    dirs = descent_directions(torch.from_numpy(h), torch.from_numpy(sv > 0), torch.from_numpy(sv >= 0)).numpy()
    return flow_edits_np(dirs, sv, tile, tiles=[7], seed=seed)


REMAP_KINDS = ("all_live", "duplicates", "chains", "extreme_keys", "noop_tail")


def adversarial_remap_np(labels, tile, kind: str = "mixed", cap: int = 64, seed: int = 0):
    """``(labels, old, new)``: a copy of an int32 label volume and
    ``(n_tiles, cap)`` remap tables (z-major tiles, unused slots -1 -> -1)
    that stress the ordered per-tile remap.  ``kind`` is one of
    :data:`REMAP_KINDS` for every tile, or ``mixed`` (tile t takes kind
    ``t % 5``):

    - ``all_live``: every slot changes a label present in the tile;
    - ``duplicates``: each old value in two slots with different new values;
    - ``chains``: a 3-chain, a pair whose second link comes first, and a
      2-cycle;
    - ``extreme_keys``: -1, ``INT_MIN`` and ``2**30`` as labels and keys,
      chained through each other;
    - ``noop_tail``: a few live slots, then slots with ``old == new`` (on a
      key an earlier slot matched, on a chained value, after the last live
      slot)."""
    tz, ty, tx = tile
    z, y, x = labels.shape
    gz, gy, gx = z // tz, y // ty, x // tx
    n_tiles = gz * gy * gx
    rng = np.random.default_rng(seed)
    tiles = labels.astype(np.int32).reshape(gz, tz, gy, ty, gx, tx).transpose(0, 2, 4, 1, 3, 5)
    tiles = tiles.reshape(n_tiles, -1).copy()
    old = np.full((n_tiles, cap), -1, np.int32)
    new = np.full((n_tiles, cap), -1, np.int32)
    imin, big = np.int32(np.iinfo(np.int32).min), np.int32(2**30)
    for t in range(n_tiles):
        k = REMAP_KINDS[t % len(REMAP_KINDS)] if kind == "mixed" else kind
        present = np.unique(tiles[t])

        def pick(n):
            return rng.choice(present, size=n, replace=len(present) < n).astype(np.int32)

        if k == "all_live":
            o = pick(cap)
            old[t], new[t] = o, o + rng.integers(1, 1000, cap).astype(np.int32)
        elif k == "duplicates":
            o = pick(cap // 4)
            old[t, : cap // 2] = np.concatenate([o, o[::-1]])
            new[t, : cap // 2] = np.concatenate([o + 1, o[::-1] + 2])
        elif k == "chains":
            a, b, c, d, e, f = (int(v) for v in pick(6))
            for s, (o, n) in zip((5, 9, 20, 2, 25, 30, 31), ((a, b), (b, c), (c, d), (e, f), (d, e), (b, f), (f, b))):
                old[t, s], new[t, s] = o, n
        elif k == "extreme_keys":
            tiles[t, 0:8], tiles[t, 8:16], tiles[t, 16:24] = -1, imin, big
            p = int(present[0])
            for s, (o, n) in zip((0, 3, 5, 6), ((-1, imin), (big, 7), (imin, big), (p, -1))):
                old[t, s], new[t, s] = o, n
        elif k == "noop_tail":
            o = pick(4)
            old[t, :4], new[t, :4] = o, o + 5
            old[t, 4] = new[t, 4] = o[0]
            old[t, 10] = new[t, 10] = o[1] + 5
            old[t, cap - 4] = new[t, cap - 4] = pick(1)[0]
        else:
            raise ValueError(f"kind must be one of {REMAP_KINDS} or 'mixed', got {kind!r}")
    lab = tiles.reshape(gz, gy, gx, tz, ty, tx).transpose(0, 3, 1, 4, 2, 5).reshape(z, y, x)
    return np.ascontiguousarray(lab), old, new


# the tiles of adversarial_flow_np, in z-major order
FLOW_TILE_KINDS = ("serpentine seeded", "all invalid", "serpentine unseeded", "all seeds",
                   "drain (all exits)", "sink", "all terminal", "edited")


def adversarial_flow_tiles_np(tile, seed: int = 0):
    """:func:`adversarial_flow_np` cut into its eight tiles:
    ``[(kind, dirs, sv), ...]`` (codes are tile-local, so a cut tile keeps
    its exits and in-tile paths)."""
    dirs, sv = adversarial_flow_np(tile, seed)
    return [(kind, dirs[_eighth(k, tile)].copy(), sv[_eighth(k, tile)].copy())
            for k, kind in enumerate(FLOW_TILE_KINDS)]
