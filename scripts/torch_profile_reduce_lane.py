#!/usr/bin/env python3
"""Where the collective reduce plane's lane program spends its time on one GPU.

Usage: ``python3 scripts/torch_profile_reduce_lane.py [--seed 0]
[--out chiprun_out/torch_profile_reduce_lane]``

One leaf lane at the size of the 512^3 agglomerative graph's leaves (8
shards of 1,313,177 nodes and 8,032,486 edges: Wn = 2^18 node slots,
about 164k members, 1M internal edges and 300k frontier rows in lanes of
2^20 and 2^19 rows; a 3-D grid RAG with random extra edges, average-linkage
payload, threshold 0.5), built from the seed:

1. ``lane_frontier_rounds`` on the card alone: wall, rounds, ms a round;
2. the same lane once under ``torch.profiler``: device time by aten
   operator and the device's busy share of the wall;
3. eight such lanes (seeds ``seed..seed+7``) through the plane's program on
   a sibling mesh of 8 shards on the one card (a thread and a stream a
   shard): wall against 8 x (1), lane 0's labels equal to (1)'s.

Prints each result and then all of it as one JSON line; the key_averages
table goes to ``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cluster_tools_tpu_torch.ops.contraction import lane_frontier_rounds  # noqa: E402
from cluster_tools_tpu_torch.parallel import reduce_tree as rt  # noqa: E402

WN, WE, WF = 2 ** 18, 2 ** 20, 2 ** 19
G = 54  # 54^3 = 157,464 members


def make_lane(seed: int):
    """Padded numpy lane: ``(u, v, pay, f_node, f_ghost, f_pay)``."""
    rng = np.random.default_rng(seed)
    n = G ** 3
    ids = np.arange(n).reshape(G, G, G)
    grid = np.concatenate([np.stack([np.moveaxis(ids, ax, 0)[:-1].ravel(), np.moveaxis(ids, ax, 0)[1:].ravel()], 1)
                           for ax in range(3)])
    extra = rng.integers(0, n, (1_000_000 - len(grid), 1))
    extra = np.concatenate([extra, np.clip(extra + rng.integers(1, 3 * G * G, extra.shape), 0, n - 1)], 1)
    edges = np.concatenate([grid, extra])
    m, fm = len(edges), 300_000
    u, v = np.full(WE, WN, np.int64), np.full(WE, WN, np.int64)
    u[:m], v[:m] = edges[:, 0], edges[:, 1]
    pay = np.zeros((WE, 2))
    pay[:m, 1] = rng.integers(1, 200, m)
    pay[:m, 0] = rng.random(m) * pay[:m, 1]
    f_node, f_ghost, f_pay = np.full(WF, WN, np.int64), np.zeros(WF, np.int64), np.zeros((WF, 2))
    f_node[:fm], f_ghost[:fm] = rng.integers(0, n, fm), rng.integers(0, 1_300_000, fm)
    f_pay[:fm, 1] = rng.integers(1, 200, fm)
    f_pay[:fm, 0] = rng.random(fm) * f_pay[:fm, 1]
    return u, v, pay, f_node, f_ghost, f_pay


def run_lane(args, device):
    t = [torch.from_numpy(a).to(device) for a in args]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, rounds = lane_frontier_rounds(*t, 0.5, n_pad=WN, mode="min", k=2)
    torch.cuda.synchronize()
    return labels, rounds, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/torch_profile_reduce_lane")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    rec = {"card": smi}
    lane = make_lane(args.seed)

    run_lane(lane, "cuda")  # warm-up
    labels, rounds, wall = run_lane(lane, "cuda")
    rec.update(lane_s=wall, rounds=rounds, ms_per_round=wall / max(rounds, 1) * 1e3)
    print(f"[lane] one leaf lane (Wn {WN}, We {WE}, Wf {WF}) alone: {wall:.3f} s, {rounds} rounds, "
          f"{rec['ms_per_round']:.3f} ms a round", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, pwall = run_lane(lane, "cuda")
    ka = prof.key_averages()
    table = ka.table(sort_by="self_cuda_time_total", row_limit=25)
    with open(os.path.join(args.out, "key_averages.txt"), "w") as fh:
        fh.write(table)
    dev_us = sum(e.self_device_time_total for e in ka)
    top = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in ka), key=lambda x: -x[1])[:10]
    rec.update(profiled_s=pwall, device_ms=dev_us / 1e3, busy_share=dev_us / 1e6 / pwall,
               top_ops=[(k, round(ms, 3), c) for k, ms, c in top])
    print(f"[profile] profiled lane {pwall:.3f} s, device {dev_us / 1e3:.1f} ms = busy "
          f"{100 * rec['busy_share']:.1f}% of the wall; by operator (ms, calls): "
          + "; ".join(f"{k} {ms:.1f} ({c})" for k, ms, c in top), flush=True)

    # eight lanes at once through the plane's level program
    os.environ["CTT_MESH_SHARDS"] = "8"
    plane = rt.CollectiveReducePlane("min", 0.5, 2, device="cuda")
    lanes = [make_lane(args.seed + i) for i in range(8)]
    pools = [torch.from_numpy(np.stack([ln[j] for ln in lanes])).cuda() for j in range(6)]
    tabs = torch.arange(8, dtype=torch.int64)[:, None].repeat(1, 6)
    prog = plane._program(WN, threading.Event())
    prog(*pools, tabs)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gathered, grounds = prog(*pools, tabs)
    torch.cuda.synchronize()
    wall8 = time.perf_counter() - t0
    rec.update(eight_lanes_s=wall8, eight_lanes_rounds=grounds.tolist())
    print(f"[plane] 8 lanes on 8 sibling shards on one card: {wall8:.3f} s (8 x one lane alone "
          f"{8 * wall:.3f} s); rounds {grounds.tolist()}", flush=True)
    if not torch.equal(gathered[0].cpu(), labels.cpu()):
        raise AssertionError("lane 0 through the plane differs from the lane alone")

    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
