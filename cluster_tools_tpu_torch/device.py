"""Device and kernel-route resolution shared by every entry point.

Entry points take ``device=`` (default ``"cuda"``) and ``impl=``:

- ``device=None`` means the card.  Without a card that raises: the port
  never drifts onto the CPU unless the caller asks for it
  (``device="cpu"``, as the tests do).
- ``impl="auto"`` launches the hand-written CUDA kernels for CUDA tensors
  and runs their plain PyTorch twins for CPU tensors; ``"cuda"`` insists
  on the kernels (and raises for a CPU tensor); ``"torch"`` runs the twins
  on any device.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

IMPLS = ("auto", "cuda", "torch")


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on; ``None`` means the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def card_key(device) -> str:
    """The name of ``device``'s card, ``"cuda:i"`` (a bare ``"cuda"`` names
    the current card), or ``"cpu"``: the key of per-card state."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def resolve_impl(impl: str, device: Union[torch.device, torch.Tensor]) -> str:
    """``auto``/``cuda``/``torch`` -> ``cuda`` or ``torch`` for ``device``."""
    if isinstance(device, torch.Tensor):
        device = device.device
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if impl == "cuda" and device.type != "cuda":
        raise ValueError("impl='cuda' needs CUDA tensors; got a tensor on " + str(device))
    return impl


def as_tensor(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a contiguous tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    else:
        x = torch.as_tensor(x)
    x = x.to(device=device, dtype=dtype if dtype is not None else x.dtype)
    return x.contiguous()
