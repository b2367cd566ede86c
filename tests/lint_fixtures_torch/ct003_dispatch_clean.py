"""CT003 fixture for the port's forms of a card's dispatch lock, the
compliant form: only the launch and its synchronization under the lock;
staging, waits and IO outside it."""

import contextlib

import numpy as np
import torch

from cluster_tools_tpu_torch.runtime.executor import dispatch_lock


def launch(devices, shard, kernel, path, fut):
    shard_locks = [dispatch_lock(d) for d in devices]
    inputs = torch.from_numpy(np.load(path)).to(devices[shard])
    value = fut.result()
    with shard_locks[shard], contextlib.ExitStack():
        out = kernel(inputs, value)
        torch.cuda.synchronize(devices[shard])
    lk = dispatch_lock(devices[shard])
    with lk:
        again = kernel(out, value)
    np.save(path, again.cpu().numpy())
    return out
