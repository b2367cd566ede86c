#!/usr/bin/env python3
"""Per-block sweep walls of two checkouts of the port on one GPU, each run
in a process of its own, the checkouts alternated.

Usage: ``python3 scripts/torch_per_block_ab.py --tree parent=.scratch/parent
--tree change=. [--pairs 10] [--runs 1] [--seed 0]``

Each process puts one checkout first on ``sys.path``, builds its kernels,
makes the main path's 512^3 boundary map from ``--seed`` on the card into
``memory://``, and runs that checkout's single-pass ``WatershedWorkflow``
(halo 32, threshold 0.45, EDT cap 32, block 128^3: the smoke's "sweeps"
phase) with ``sweep_mode="per_block"``: one warm-up, then ``--runs`` timed
runs, each wall ended by a device sync.  The pairs run in the order A B,
B A, A B, ... so that a drift of the host falls on both.  Prints each run
and, per checkout, the walls' median and quartiles and the executor's
summed stage seconds; the last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

MAIN_SHAPE = (1, 512, 512, 512)
BLOCK = (128, 128, 128)
WS = dict(halo=[32, 32, 32], threshold=0.45, dt_max_distance=32.0, min_seed_distance=2.0, two_pass=False)
STAGES = ("load_s", "h2d_s", "kernel_s", "d2h_s", "store_s")


def child(tree: str, seed: int, runs: int) -> None:
    """One process: the walls of one checkout, printed as one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from cluster_tools_tpu_torch import build
    from cluster_tools_tpu_torch.io.containers import open_container
    from cluster_tools_tpu_torch.runtime.task import build as run_dag
    from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow
    from cluster_tools_tpu_torch.utils import function_utils as fu
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries

    build.build_all()
    os.environ["CT_FILL_MODE"], os.environ["CT_TIER_MODE"] = "capacity", "cond"
    vol = synthetic_boundaries(MAIN_SHAPE, torch.Generator(device="cuda").manual_seed(seed))
    mem = "memory://ab"
    open_container(mem).require_dataset("boundaries", shape=MAIN_SHAPE[1:], chunks=BLOCK,
                                        dtype="float32")[...] = vol.reshape(MAIN_SHAPE[1:]).cpu().numpy()
    del vol
    walls, stages = [], []
    with tempfile.TemporaryDirectory(prefix="ab-") as root:
        for i in range(runs + 1):
            d = os.path.join(root, str(i))
            os.makedirs(os.path.join(d, "cfg"))
            fu.atomic_write_json(os.path.join(d, "cfg", "global.config"),
                                 {"block_shape": list(BLOCK), "sweep_mode": "per_block"})
            wf = WatershedWorkflow(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"), max_jobs=8,
                                   block_shape=list(BLOCK), input_path=mem, input_key="boundaries", output_path=mem,
                                   output_key="ws", **WS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if not run_dag([wf]):
                raise SystemExit(f"{tree}: the workflow failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tmp = os.path.join(d, "tmp")
            sweeps = [json.load(open(os.path.join(tmp, n))).get("sweep", {}) for n in sorted(os.listdir(tmp))
                      if n.endswith(".success.json")]
            if {s.get("sweep_mode") for s in sweeps if s} != {"per_block"}:
                raise SystemExit(f"{tree}: the sweep ran {[s.get('sweep_mode') for s in sweeps]}")
            if i:
                walls.append(wall)
                stages.append({k: sum(s.get(k, 0.0) for s in sweeps) for k in STAGES})
    print("AB_CHILD " + json.dumps({"walls": walls, "stages": stages, "ws_sum": int(np.asarray(
        open_container(mem)["ws"][...], np.uint64).sum() % (1 << 61))}), flush=True)


def quartiles(xs):
    import numpy as np

    q = np.percentile(xs, [25, 50, 75])
    return {"q1": float(q[0]), "median": float(q[1]), "q3": float(q[2])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], help="NAME=PATH of a checkout (twice)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--runs", type=int, default=1, help="timed runs in each process, after its warm-up")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.seed, args.runs)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    if len(trees) != 2:
        raise SystemExit("give two checkouts: --tree A=PATH --tree B=PATH")
    names = list(trees)
    res = {n: {"walls": [], "stages": [], "ws_sum": set()} for n in names}
    t_start = time.perf_counter()
    for p in range(args.pairs):
        for n in (names if p % 2 == 0 else names[::-1]):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", trees[n], "--seed",
                                  str(args.seed), "--runs", str(args.runs)], capture_output=True, text=True)
            line = next((ln for ln in out.stdout.splitlines() if ln.startswith("AB_CHILD ")), None)
            if out.returncode or line is None:
                sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
                raise SystemExit(f"{n}: the process failed (exit {out.returncode})")
            r = json.loads(line[len("AB_CHILD "):])
            res[n]["walls"] += r["walls"]
            res[n]["stages"] += r["stages"]
            res[n]["ws_sum"].add(r["ws_sum"])
            print(f"[ab] pair {p} {n}: walls {[round(w, 3) for w in r['walls']]} s", flush=True)
    if len({s for n in names for s in res[n]["ws_sum"]}) != 1:
        raise SystemExit("the checkouts' watersheds differ")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    summary = {"card": card, "pairs": args.pairs, "runs": args.runs, "seconds": time.perf_counter() - t_start}
    for n in names:
        summary[n] = {"walls": res[n]["walls"], **quartiles(res[n]["walls"]),
                      "stages_median": {k: quartiles([s[k] for s in res[n]["stages"]])["median"] for k in STAGES}}
        print(f"[ab] {n}: per_block ws wall median {summary[n]['median']:.3f} s, quartiles "
              f"{summary[n]['q1']:.3f} / {summary[n]['q3']:.3f} s over {len(res[n]['walls'])} runs; stage medians "
              + ", ".join(f"{k} {v:.3f}" for k, v in summary[n]["stages_median"].items()) + f" [{card}]")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
