"""CT005 fixture for the port's rule: device work timed without a
synchronization, and draws from a global random generator in per-shard
bodies.  Every line marked ``# fires`` carries one finding."""

import random
import time
from functools import partial

import numpy as np
import torch

from cluster_tools_tpu_torch.ops import kernels as K
from cluster_tools_tpu_torch.ops.kernels import tile_ccl
from cluster_tools_tpu_torch.ops.kernels import apply_remap as remap
from cluster_tools_tpu_torch.parallel import spmd


def time_imported_kernel(mask):
    t0 = time.perf_counter()  # fires
    labels = tile_ccl(mask)  # the launch is async: this times the enqueue
    return labels, time.perf_counter() - t0


def time_module_kernel(f):
    t0 = time.monotonic()  # fires
    out = K.edt_cascade(f, 0, 4, 1.0, 1e9)
    return out, time.monotonic() - t0


def time_aliased_kernel(labels, old, new):
    t0 = time.time()  # fires
    out = remap(labels, old, new)
    return out, time.time() - t0


def noisy_body(x):
    return x + torch.rand(x.shape, device=x.device)  # fires


def reseeding_body(x):
    torch.manual_seed(0)  # fires
    return x + torch.randn_like(x)  # fires


def legacy_numpy_body(x, scale):
    return x * float(np.random.rand()) * scale  # fires


def stdlib_body(x):
    return x * random.random()  # fires


def inplace_body(x):
    return torch.empty_like(x).uniform_()  # fires


def time_shard_map_callable(mesh, x):
    fn = spmd.shard_map(noisy_body, mesh, spmd.P("z"), spmd.P("z"))
    t0 = time.perf_counter()  # fires
    y = fn(x)  # every shard's work is still queued on its card
    return y, time.perf_counter() - t0


def build_the_rest(mesh):
    a = spmd.shard_map(reseeding_body, mesh, spmd.P("z"), spmd.P("z"))
    b = spmd.shard_map(partial(legacy_numpy_body, scale=2.0), mesh, spmd.P("z"), spmd.P("z"))
    c = spmd.shard_map(stdlib_body, mesh, spmd.P("z"), spmd.P("z"))
    d = spmd.shard_map(inplace_body, mesh, spmd.P("z"), spmd.P("z"))
    e = spmd.shard_map(lambda x: x + torch.randint(0, 9, x.shape), mesh,  # fires
                       spmd.P("z"), spmd.P("z"))
    return a, b, c, d, e
