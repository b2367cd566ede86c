"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The run makes
its inputs on the card from ``--seed``, sets up and warms up the program,
measures for ``--seconds``, checks what the window produced against the
plain reference, and prints the numbers it compared (and their limits) as
the last lines of standard error and one JSON object as the last line of
standard output.  It fails without a card, with fewer cards than the cell
asks for, and when a module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches at fixed paths inside the checkout; no library may load JAX
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".port_bench_cache" / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))
    import harness

    spec = harness.Spec(ROOT)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 3
    result, checks = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                                      T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {found}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    for name, value, limit in checks:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
