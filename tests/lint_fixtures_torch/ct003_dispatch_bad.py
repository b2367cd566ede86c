"""CT003 fixture for the port's forms of a card's dispatch lock (and of the
device pool's per-card lock): a blocking call and an IO call under each.
Every line marked ``# fires`` carries one finding."""

import contextlib
import json
import os
import time

import numpy as np

from cluster_tools_tpu_torch.runtime.executor import dispatch_lock


def io_under_the_called_lock(device, path, doc):
    with dispatch_lock(device):
        time.sleep(0.1)  # fires
        with open(path, "w") as f:  # fires
            json.dump(doc, f)  # fires


def io_under_a_bound_name(device, path, fut):
    lk = dispatch_lock(device)
    with lk:
        out = fut.result()  # fires
        np.save(path, out)  # fires


def io_under_a_list_element(devices, shard, path, fut):
    shard_locks = [dispatch_lock(d) for d in devices]
    with shard_locks[shard], contextlib.ExitStack():
        fut.wait()  # fires
        return np.load(path)  # fires


def io_under_a_tuple_element(devices, path, worker):
    card_locks = (dispatch_lock(devices[0]), dispatch_lock(devices[1]))
    with card_locks[1]:
        worker.join()  # fires
        os.makedirs(path)  # fires


def io_under_the_pool_lock(pool, device, staged, path, fut):
    with (pool.lock_for(device) if staged else contextlib.nullcontext()):
        fut.result()  # fires
        os.remove(path)  # fires
