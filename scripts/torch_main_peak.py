#!/usr/bin/env python3
"""Peak device memory of the port's 512^3 main path, stage by stage.

Usage: ``python3 scripts/torch_main_peak.py [--tree NAME=PATH ...] [--seed 0]``

Runs ``make_ws_ccl_split(device="cuda")`` at ``chip_smoke.py``'s main-path
configuration on its synthetic ``(1, 512, 512, 512)`` volume, once to warm
up and once measured, in each checkout of the repository named by
``--tree`` (default: this one), each in a process of its own with that
checkout's package first on ``sys.path``, so two trees compare in one call
on one card.  The measured run resets the card's peak before it starts and
after each stage: each stage's peak of allocated memory is its own, with
what is resident between stages (the input volume, the stage outputs kept)
counted in it.  Prints one JSON line a tree: the card, the bytes resident
before the run, each stage's peak and the largest, in GB.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys, torch
from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split
from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries

build.build_all()
cfg = dict(halo=32, threshold=0.45, dt_max_distance=32.0, min_seed_distance=2.0, seed_mode="sparse")
vol = synthetic_boundaries((1, 512, 512, 512), torch.Generator(device="cuda").manual_seed(int(sys.argv[1])))
step = make_ws_ccl_split(device="cuda", **cfg)
step(vol)
torch.cuda.synchronize()
peaks = {}

def mark(stage, *_):
    torch.cuda.synchronize()
    peaks[stage] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()

torch.cuda.reset_peak_memory_stats()
resident = torch.cuda.memory_allocated() / 1e9
out = step.run_staged(vol, mark)
torch.cuda.synchronize()
print(json.dumps({"card": torch.cuda.get_device_name(0), "resident_gb": resident, "stage_peak_gb": peaks,
                  "peak_gb": max(peaks.values()), "overflow": bool(out[3])}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None, help="NAME=PATH of a checkout (repeatable)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = [t.split("=", 1) for t in (args.tree or [f"this={root}"])]
    for name, path in trees:
        path = os.path.abspath(path)
        env = dict(os.environ, PYTHONPATH=path + os.pathsep + os.environ.get("PYTHONPATH", ""))
        out = subprocess.run([sys.executable, "-c", CHILD, str(args.seed)], cwd=path, env=env, capture_output=True,
                             text=True, timeout=900)
        if out.returncode != 0:
            print(f"tree {name}: exit {out.returncode}\n{out.stderr[-3000:]}", file=sys.stderr)
            return out.returncode
        doc = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(tree=name, **doc)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
