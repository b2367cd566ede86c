"""The comparisons that decide ``correct``: each returns a number that is
held against a limit of the configuration's file."""

from __future__ import annotations

import torch


def differing(got: torch.Tensor, want: torch.Tensor) -> int:
    """Voxels whose labels differ (exact values)."""
    if tuple(got.shape) != tuple(want.shape):
        return int(want.numel())
    return int((got.reshape(-1).to(torch.int64) != want.reshape(-1).to(torch.int64).to(got.device)).sum())


def canonical(labels: torch.Tensor) -> torch.Tensor:
    """Each voxel's segment named by its smallest flat index + 1 (0 stays 0),
    so two labellings of one partition become equal."""
    flat = labels.reshape(-1).to(torch.int64)
    ids, inv = torch.unique(flat, return_inverse=True)
    first = torch.full((ids.numel(),), flat.numel(), dtype=torch.int64, device=flat.device)
    first.scatter_reduce_(0, inv, torch.arange(flat.numel(), dtype=torch.int64, device=flat.device), "amin")
    out = torch.where(flat > 0, first[inv] + 1, 0)
    return out.view(labels.shape)


def partition_differing(got: torch.Tensor, want_canonical: torch.Tensor) -> int:
    """Voxels whose segment differs from the reference's, whose labels
    are already canonical (:func:`canonical`)."""
    if tuple(got.shape) != tuple(want_canonical.shape):
        return int(want_canonical.numel())
    return differing(canonical(got.to(want_canonical.device)), want_canonical)
