"""Host per-block kernels: the watershed task's ``impl="host"`` path.

Port of ``cluster_tools_tpu/ops/host.py``.  Per-job compute on the CPU, as
the original cluster_tools ran its scipy/vigra calls inside cluster jobs:
thresholded foreground, Euclidean distance transform, EDT-maxima seeds,
seeded watershed, and a connected-components pass.  On 3-D input the two
hot stages run in the host C++ rung (:mod:`..native`): the exact
Felzenszwalb-Huttenlocher squared EDT (``edt_sq``) and a 256-level
bucket-queue priority-flood watershed (``ws_flood``).  2-D input, and any
input inside ``native.force_python()``, takes scipy's
``distance_transform_edt`` and ``watershed_ift``.

These are semantic (not bit-exact) host counterparts of the tiled device
watershed and CCL; they equal the reference's host functions bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import native


def host_label_components(mask: np.ndarray) -> np.ndarray:
    """Connected components of a boolean mask (scipy, connectivity 1)."""
    from scipy import ndimage

    lab, _ = ndimage.label(mask)
    return lab.astype(np.int32)


def host_dt_watershed(
    vol: np.ndarray,
    threshold: float,
    dt_max_distance: Optional[float] = None,
    min_seed_distance: float = 0.0,
    mask: Optional[np.ndarray] = None,
    sampling: Optional[Tuple[float, ...]] = None,
    fg: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Distance-transform watershed of a boundary map on the host.

    Foreground is ``vol < threshold`` (or the given ``fg``), restricted to
    ``mask``; seeds are the EDT's local maxima at least
    ``min_seed_distance`` from the boundary; fragments grow over the
    boundary map quantized to uint8.  ``sampling`` is the per-axis voxel
    size (scipy's convention).  ``dt_max_distance`` clips the transform as
    the device kernels' capped EDT does, so seeds are consistent with the
    device path (interiors thicker than twice the cap saturate into one
    plateau, one seed).
    """
    from scipy import ndimage

    if fg is None:
        fg = vol < threshold
    if mask is not None:
        fg = fg & mask
    dist_sq = native.edt_sq(fg, sampling=sampling, cap=dt_max_distance) if vol.ndim == 3 else None
    if dist_sq is not None:
        # the maxima of the squared distance are the distance's (monotone);
        # the cap is applied inside the native kernel
        dist = dist_sq
        min_seed = min_seed_distance * min_seed_distance
    else:
        dist = ndimage.distance_transform_edt(fg, sampling=sampling)
        if dt_max_distance is not None:
            dist = np.minimum(dist, float(dt_max_distance))
        min_seed = min_seed_distance
    maxima = (ndimage.maximum_filter(dist, size=3) == dist) & fg
    if min_seed_distance > 0:
        maxima &= dist >= min_seed
    seeds, _ = ndimage.label(maxima)
    hmap = np.clip(vol * 255, 0, 255).astype(np.uint8)
    ws = native.ws_flood(hmap, fg, seeds.astype(np.int32)) if vol.ndim == 3 else None
    if ws is None:
        ws = ndimage.watershed_ift(hmap, seeds.astype(np.int32))
        ws[~fg] = 0
    return ws


def host_ws_ccl(
    vol: np.ndarray,
    threshold: float,
    dt_max_distance: Optional[float] = None,
    min_seed_distance: float = 0.0,
    sampling: Optional[Tuple[float, ...]] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """The fused ws + cc step on the host: ``(ws, cc, n_foreground)``."""
    fg = vol < threshold
    ws = host_dt_watershed(vol, threshold, dt_max_distance=dt_max_distance, min_seed_distance=min_seed_distance,
                           sampling=sampling, fg=fg)
    cc = host_label_components(fg)
    return ws, cc, int(fg.sum())
