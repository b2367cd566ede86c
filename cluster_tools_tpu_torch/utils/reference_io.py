"""Carry the reference's inputs and keyword arguments over to the port.

This path has no learned parameters: its "state" is the input volume and
the configuration (threshold, halo, caps, modes).  :func:`from_reference`
turns a numpy volume (plus optional seeds / mask) and the JAX package's
keyword arguments into the port's tensors and keyword arguments, so a
parity check feeds both sides the same arrays and the same settings.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import as_tensor, resolve_device

# reference kwargs with no counterpart on one device; dropped
_DROPPED = ("interpret", "mesh", "dp_axis", "sp_axis")
# reference kwargs this single-device helper carries only at their
# default (the mesh builders of ``parallel/`` take the mesh-only ones)
_DEFAULT_ONLY = {
    "exact_edt": False,
    "sigma_seeds": 0.0,
    "max_labels_per_shard": None,
    "dist": None,
}


def from_reference(volume: np.ndarray, seeds: Optional[np.ndarray] = None,
                   mask: Optional[np.ndarray] = None, device=None,
                   **config: Any) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Returns ``(tensors, kwargs)``.

    ``tensors`` holds ``volume`` (float32) and, when given, ``seeds``
    (int32) and ``mask`` (bool) on ``device``; ``.cpu().numpy()`` of them
    is what the reference should be fed.  ``kwargs`` is ``config`` with the
    reference's ``impl`` (``pallas``/``xla``/``tiled``/``auto``) mapped to
    the port's ``auto`` (kernels on the card, twins on the CPU), mesh-only
    arguments dropped, and ``stitch_ws_threshold`` dropped (it only acts
    between shards).  Arguments the port does not support at a non-default
    value raise.
    """
    dev = resolve_device(device)
    tensors = {"volume": as_tensor(np.asarray(volume, np.float32), dev, torch.float32)}
    if seeds is not None:
        tensors["seeds"] = as_tensor(np.asarray(seeds, np.int32), dev, torch.int32)
    if mask is not None:
        tensors["mask"] = as_tensor(np.asarray(mask, bool), dev, torch.bool)
    kwargs: Dict[str, Any] = {}
    for key, value in config.items():
        if key in _DROPPED:
            if key == "mesh" and value is not None and getattr(value, "size", 1) != 1:
                raise NotImplementedError("from_reference carries single-device arguments; build a mesh of "
                                          "several shards with parallel.mesh.make_mesh")
            continue
        if key in _DEFAULT_ONLY:
            if value != _DEFAULT_ONLY[key]:
                raise NotImplementedError(f"{key}={value!r} is not carried by this single-device helper")
            continue
        if key == "stitch_ws_threshold":
            continue
        if key == "impl":
            if value not in ("auto", "pallas", "xla", "tiled"):
                raise ValueError(f"unknown reference impl {value!r}")
            value = "auto"
        kwargs[key] = value
    kwargs["device"] = dev
    return tensors, kwargs
