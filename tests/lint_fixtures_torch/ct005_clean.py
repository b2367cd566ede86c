"""CT005 fixture for the port's rule, the compliant forms: every timing of
device work synchronizes before it reads the clock, and per-shard bodies
draw only from generators of their own."""

import random
import time

import numpy as np
import torch

from cluster_tools_tpu_torch.ops import kernels as K
from cluster_tools_tpu_torch.ops.kernels import tile_ccl
from cluster_tools_tpu_torch.parallel import spmd


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_kernel_synchronized(mask):
    t0 = time.perf_counter()
    labels = tile_ccl(mask)
    torch.cuda.synchronize()
    return labels, time.perf_counter() - t0


def time_kernel_through_helper(f):
    t0 = time.perf_counter()
    out = K.edt_cascade(f, 0, 4, 1.0, 1e9)
    _sync(f.device)  # the helper synchronizes
    return out, time.perf_counter() - t0


def time_kernel_with_events(mask):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    labels = tile_ccl(mask)
    end.record()
    end.synchronize()
    return labels, start.elapsed_time(end), time.perf_counter() - t0


def time_kernel_read_back(mask):
    t0 = time.perf_counter()
    n = int(tile_ccl(mask).max().item())
    return n, time.perf_counter() - t0


def time_host_work(path):
    t0 = time.perf_counter()
    data = np.load(path)
    return data, time.perf_counter() - t0


def seeded_body(x, seed):
    g = torch.Generator(device=x.device)
    g.manual_seed(int(seed))
    noise = torch.rand(x.shape, generator=g, device=x.device)
    jitter = np.random.default_rng(7).random()
    return x + noise * jitter * random.Random(3).random()


def time_shard_map_synchronized(mesh, x, seed):
    fn = spmd.shard_map(seeded_body, mesh, (spmd.P("z"), spmd.P()), spmd.P("z"))
    t0 = time.perf_counter()
    y = fn(x, seed)
    total = y.sum().cpu()
    return y, total, time.perf_counter() - t0
