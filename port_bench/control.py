"""The control of each cell's comparison: the plain reference put in the
program's place and computed in the precision below the configuration's
(the boundary maps rounded to bfloat16), compared with the reference at
float32 by the cell's own comparisons.  It has to come out as not correct.

    python3 port_bench/control.py --workload <name> --seeds 11,12,13 [--out FILE]

runs on the card, at the cell's own size, one line of readings a seed.
The benchmark's runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(spec, workload: str, seed: int, device: str) -> dict:
    """The control's compared numbers for ``seed`` beside the cell's limits."""
    cell = spec.cell(workload)
    config = spec.config(cell["config"])
    drv = spec.driver(config["driver"])(config, spec.traffic(cell["traffic"]), seed, device, False)
    got = drv.control()
    return {name: {"value": value, "limit": config["limits"][name]} for name, value in got}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))
    import torch

    import harness

    if not torch.cuda.is_available():
        print("port_bench control: needs a CUDA card", file=sys.stderr)
        return 3
    spec = harness.Spec(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "control": readings(spec, args.workload, seed, "cuda"),
                           "kind": torch.cuda.get_device_name(0), "power_limit_w": harness.power_limit_w()})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
