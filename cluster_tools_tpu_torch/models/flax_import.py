"""Carry U-Net weights between the JAX package's flax parameters and the
port's ``state_dict``.

The JAX package saves its parameters as a flat npz whose keys are the
flax parameter paths joined by ``'/'`` (``tasks/inference.py::
save_checkpoint``), with or without the leading ``params/``:
``ConvBlock_{i}/Conv_{j}/kernel``, ``ConvBlock_{i}/GroupNorm_{j}/scale``,
``Conv_{k}/bias``, ``ConvTranspose_{t}/kernel`` ...  The port's modules
carry the same auto-names (:mod:`.unet`), so the map is by name, never by
position; only the layouts change:

- ``Conv`` kernel ``(kD, kH, kW, I, O)`` <-> weight ``(O, I, kD, kH, kW)``;
- ``ConvTranspose`` kernel ``(kD, kH, kW, I, O)``, flipped on all three
  spatial axes, <-> weight ``(I, O, kD, kH, kW)`` (torch's transposed
  convolution is the gradient of a correlation; flax's does not mirror);
- ``GroupNorm`` ``scale`` / ``bias`` <-> ``weight`` / ``bias``;
- every ``bias`` as it is.

A missing or extra key, or a shape that does not fit, raises and names
the key.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

def _flax_leaf(torch_key: str) -> str:
    """The flax path of a port ``state_dict`` key."""
    *mods, leaf = torch_key.split(".")
    if leaf == "weight":
        leaf = "scale" if mods[-1].startswith("GroupNorm") else "kernel"
    return "/".join(mods + [leaf])


def _is_transpose(path: str) -> bool:
    return path.split("/")[-2].startswith("ConvTranspose")


def flax_to_torch_array(path: str, a: np.ndarray) -> np.ndarray:
    """One flax leaf in the port's layout."""
    if path.endswith("/kernel") and a.ndim == 5:
        if _is_transpose(path):
            return np.ascontiguousarray(a[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2))
        return np.ascontiguousarray(a.transpose(4, 3, 0, 1, 2))
    return np.ascontiguousarray(a)


def torch_to_flax_array(path: str, a: np.ndarray) -> np.ndarray:
    """One port tensor in flax's layout (the inverse of :func:`flax_to_torch_array`)."""
    if path.endswith("/kernel") and a.ndim == 5:
        if _is_transpose(path):
            return np.ascontiguousarray(a.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1])
        return np.ascontiguousarray(a.transpose(2, 3, 4, 1, 0))
    return np.ascontiguousarray(a)


def flax_to_state_dict(flat: Mapping[str, np.ndarray], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``model`` from flat ``'/'``-joined flax
    parameters (an npz's arrays; a leading ``params/`` is dropped)."""
    flat = {(k[len("params/"):] if k.startswith("params/") else k): np.asarray(v) for k, v in flat.items()}
    want = model.state_dict()
    paths = {_flax_leaf(k): k for k in want}
    extra = sorted(set(flat) - set(paths))
    if extra:
        raise ValueError(f"flax parameter {extra[0]!r} has no place in {type(model).__name__} "
                         f"({len(extra)} extra: {extra[:5]})")
    missing = [p for p in paths if p not in flat]
    if missing:
        raise ValueError(f"flax parameters lack {missing[0]!r} ({len(missing)} missing: {missing[:5]})")
    out = {}
    for path, key in paths.items():
        a = flax_to_torch_array(path, flat[path])
        if tuple(a.shape) != tuple(want[key].shape):
            raise ValueError(f"flax {path!r} {tuple(flat[path].shape)} converts to {tuple(a.shape)}, "
                             f"but {key!r} wants {tuple(want[key].shape)}")
        out[key] = torch.from_numpy(a.astype(np.float32))
    return out


def state_dict_to_flax(model: torch.nn.Module, prefix: str = "params/") -> Dict[str, np.ndarray]:
    """``model``'s parameters as flat flax arrays, keys ``prefix`` + path
    (the layout the JAX package's ``save_checkpoint`` writes)."""
    out = {}
    for key, t in model.state_dict().items():
        path = _flax_leaf(key)
        out[prefix + path] = torch_to_flax_array(path, t.detach().cpu().numpy())
    return out
