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


def serpentine_tile(tile) -> np.ndarray:
    """A one-voxel-wide path filling a tile: full x-rows on every other
    ``(z, y)``, visited in boustrophedon order and joined by one voxel at
    the row end where the path turns (the longest in-tile path a sweep
    labeller can meet)."""
    tz, ty, tx = tile
    m = np.zeros(tile, bool)
    cells = []
    for zi in range((tz + 1) // 2):
        ys = range((ty + 1) // 2)
        cells += [(2 * zi, 2 * yi) for yi in (ys if zi % 2 == 0 else reversed(ys))]
    for k, (z, y) in enumerate(cells):
        m[z, y, :] = True
        if k + 1 < len(cells):
            z2, y2 = cells[k + 1]
            m[(z + z2) // 2, (y + y2) // 2, tx - 1 if k % 2 == 0 else 0] = True
    return m


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
        a, b, c = k // 4, (k // 2) % 2, k % 2
        vol[a * tz:(a + 1) * tz, b * ty:(b + 1) * ty, c * tx:(c + 1) * tx] = p
    return vol
