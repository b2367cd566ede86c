"""Device meshes of shards.

Port of ``cluster_tools_tpu/parallel/mesh.py``.  A :class:`Mesh` names its
axes (``dp`` over independent volumes, ``sp`` over spatial slabs, as in the
reference), factors its shards into a grid, and gives each shard a device.
A device may hold several shards: one card carries a whole mesh the way
the reference's tests carry one on eight virtual CPU devices of a host.
Shards are dealt round-robin over the cards of the machine; so are the
blockwise executor's (:func:`backend_devices`).  A mesh that
spans processes (:func:`~.multihost.pod_mesh`) also records the process of
each shard; the shards of one process run there, the rest elsewhere.

The reference sizes a default mesh by ``len(jax.devices())``, and its tests
get eight devices from XLA's ``--xla_force_host_platform_device_count=8``.
:func:`visible_shards` is the port's counterpart of that count: the number
of cards, unless ``CTT_MESH_SHARDS`` asks for that many shards dealt over
the visible devices (on the CPU: that many shards, else one).  It is not a
new knob: it is where the CPU tests and a one-card run set the count the
reference takes from its device list.  :func:`make_mesh` and
:func:`sibling_mesh` without a shard count, the fused segmentation task
and the blockwise executor (:func:`backend_devices`) read it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device


def _pick_grid(n: int, n_axes: int) -> Tuple[int, ...]:
    """Factor ``n`` shards into a mesh grid, favoring the last (sp) axis."""
    if n_axes == 1:
        return (n,)
    # give sp (last axis) the largest power-of-two factor, dp the rest
    sp = 1
    m = n
    while m % 2 == 0 and sp < n // 2:
        sp *= 2
        m //= 2
    if sp == 1:
        sp = n  # odd n: everything on sp, dp=1
    dp = n // sp
    grid = [1] * n_axes
    grid[-1] = sp
    grid[0] = dp
    return tuple(grid)


class Mesh:
    """Named axes over a grid of shards, each shard with a device (and a
    process).  Shard ``s`` sits at ``coords(s)``, row-major over ``grid``."""

    def __init__(self, grid: Sequence[int], axis_names: Sequence[str], devices: Sequence[torch.device],
                 processes: Optional[Sequence[int]] = None, process_index: int = 0, comm=None):
        self.grid = tuple(int(g) for g in grid)
        self.axis_names = tuple(axis_names)
        if len(self.grid) != len(self.axis_names):
            raise ValueError(f"grid {self.grid} does not match axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")
        self.size = int(np.prod(self.grid))
        if len(devices) != self.size:
            raise ValueError(f"grid {self.grid} does not cover {len(devices)} devices")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.processes: List[int] = [0] * self.size if processes is None else [int(p) for p in processes]
        self.process_index = int(process_index)
        # the cross-process communicator of a pod mesh (None in one process)
        self.comm = comm

    def axis_size(self, name: str) -> int:
        return self.grid[self.axis_names.index(name)]

    def coords(self, shard: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(shard, self.grid))

    def shard_at(self, coords: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.grid))

    def local_shards(self) -> List[int]:
        """The shards this process runs."""
        return [s for s in range(self.size) if self.processes[s] == self.process_index]

    @property
    def n_processes(self) -> int:
        return len(set(self.processes))

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={g}" for n, g in zip(self.axis_names, self.grid))
        devs = sorted({str(d) for d in self.devices})
        return f"Mesh({axes}; devices {devs}; processes {self.n_processes})"


#: environment variable: the shard count :func:`visible_shards` reports
ENV_MESH_SHARDS = "CTT_MESH_SHARDS"


def visible_shards(device=None) -> int:
    """The shard count of a default mesh on ``device`` (``None``: the card):
    ``CTT_MESH_SHARDS`` when set, else the number of cards (one on the
    CPU).  The counterpart of the reference's ``len(jax.devices())``."""
    dev = resolve_device(device)
    env = os.environ.get(ENV_MESH_SHARDS)
    if env:
        n = int(env)
        if n < 1:
            raise ValueError(f"{ENV_MESH_SHARDS} must be >= 1, got {n}")
        return n
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _card_devices(n: int) -> List[torch.device]:
    resolve_device("cuda")  # raises without a card
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


#: the device type of each of the executor's targets
TARGET_DEVICES = {"local": "cpu", "gpu": "cuda"}


def backend_devices(target: str = "local", n_devices: Optional[int] = None) -> List[torch.device]:
    """One device per shard of a ``target`` (the reference's
    ``backend_devices``): ``n_devices`` shards (``None``:
    :func:`visible_shards`), all on the CPU for ``"local"``, dealt
    round-robin over the cards for ``"gpu"`` (which raises without one).
    Unlike the reference, a count above the cards is no error: several
    shards then share a card, as they share one in :func:`make_mesh`."""
    if target not in TARGET_DEVICES:
        raise ValueError(f"unknown target {target!r}, expected one of {sorted(TARGET_DEVICES)}")
    kind = TARGET_DEVICES[target]
    resolve_device(kind)  # raises for "gpu" without a card
    n = visible_shards(kind) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    return _card_devices(n) if kind == "cuda" else [torch.device("cpu")] * n


def make_mesh(n_shards: Optional[int] = None, axis_names: Sequence[str] = ("dp", "sp"),
              grid: Optional[Sequence[int]] = None,
              devices: Union[None, str, torch.device, Sequence] = None) -> Mesh:
    """Build a mesh of ``n_shards`` shards.

    ``devices``: one device per shard (a list), or one device for all of
    them (a string or ``torch.device``); ``None`` deals the shards
    round-robin over the machine's cards and raises without one.
    ``n_shards`` defaults to the length of a device list, else to the number
    of cards, and with one device to :func:`visible_shards`.  ``grid`` pins
    the per-axis sizes; otherwise the shards are factored so the spatial
    (last) axis gets the largest power-of-two share.
    """
    if devices is None:
        if n_shards is None:
            n_shards = visible_shards("cuda")
        devs = _card_devices(n_shards)
    elif isinstance(devices, (str, torch.device)):
        if n_shards is None:
            n_shards = visible_shards(devices)
        devs = [resolve_device(devices)] * n_shards
    else:
        devs = [resolve_device(d) for d in devices]
        if n_shards is not None:
            if n_shards > len(devs):
                raise ValueError(f"requested {n_shards} shards, only {len(devs)} devices given")
            devs = devs[:n_shards]
    n = len(devs)
    if grid is None:
        grid = _pick_grid(n, len(axis_names))
    if int(np.prod(grid)) != n:
        raise ValueError(f"grid {tuple(grid)} does not cover {n} shards")
    return Mesh(grid, axis_names, devs)


def mesh_axis_sizes(mesh: Mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.grid))


#: the reduce tree's sibling axis: the groups of one tree level are dealt
#: over this 1-D mesh and their labels gathered over it
SIBLING_AXIS = "sib"


def sibling_mesh(n_devices: Optional[int] = None, devices: Union[None, str, torch.device, Sequence] = None) -> Mesh:
    """1-D mesh of ``n_devices`` shards (default :func:`visible_shards`)
    with axis :data:`SIBLING_AXIS`: the collective reduce plane's hop
    fabric.  ``devices`` as in :func:`make_mesh` (``None``: the cards)."""
    return make_mesh(n_devices, axis_names=(SIBLING_AXIS,), devices=devices)
