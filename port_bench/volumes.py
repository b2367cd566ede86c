"""Boundary maps made on the device from a seed.

A frozen copy of ``cluster_tools_tpu_torch/utils/synthetic.py::
synthetic_boundaries`` as of commit d706128 (the port's own maker may
change; the benchmark's inputs may not): uniform noise, ``passes``
separable 3-tap box passes along each of the last three axes with
periodic borders, then min-max normalisation to [0, 1].  Twelve passes
give objects of about 20 voxels, the scale of CREMI neurites at native
resolution.
"""

from __future__ import annotations

import torch


def synthetic_boundaries(shape, generator: torch.Generator, passes: int) -> torch.Tensor:
    """float32 boundary map of ``shape`` on the generator's device."""
    v = torch.rand(shape, generator=generator, dtype=torch.float32, device=generator.device)
    for axis in range(max(0, len(shape) - 3), len(shape)):
        for _ in range(passes):
            v = (v + torch.roll(v, 1, axis) + torch.roll(v, -1, axis)) / 3.0
    lo, hi = v.min(), v.max()
    return (v - lo) / torch.clamp(hi - lo, min=1e-6)
