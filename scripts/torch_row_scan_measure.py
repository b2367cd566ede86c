"""Time the port's row scan (``kernels.row_scan``, ``csrc/row_scan.cu``) on the card.

    python3 scripts/torch_row_scan_measure.py [--reps 20] [--seed 0]

1. At the stages' shapes, each op and input type: the kernel's ms, the
   torch call the stages made before it (``torch.cumsum`` of the int32
   cast, ``torch.cummax(...).values``) and its bound (bytes read and
   written once, at 3.35 TB/s), held equal.  The one-row sum is also timed
   on int32 input, where torch's only cost is its scan (cub).
2. The ``ws_cc_step.512`` configuration's step (512^3 + halo, one card),
   every row-scan launch of one step captured and replayed: per op the
   launches, the kernel's ms summed, the torch call's and the bound's.

Prints the card's name and power limit first; fails without a card.
"""

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MEM_BYTES_PER_S = 3.35e12


def card_line() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi failed: {e}"
    return f"{torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}"


def cuda_ms(fn, reps: int) -> float:
    """Mean ms a call over ``reps`` calls after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def torch_call(x: torch.Tensor, op: str) -> torch.Tensor:
    """The stages' scan before the kernel."""
    if op == "sum":
        return torch.cumsum(x.to(torch.int32), 1, dtype=torch.int32)
    return torch.cummax(x, 1).values


def bound_ms(x: torch.Tensor) -> float:
    return x.numel() * (x.element_size() + 4) / MEM_BYTES_PER_S * 1e3


def shapes(K, reps: int, gen: torch.Generator) -> None:
    dev = gen.device
    cases = [
        ((1, 576**3), "sum", torch.int32), ((1, 576**3), "sum", torch.bool),
        ((1, 28_311_552), "max", torch.int32),
        ((8, 114 * 576 * 576), "sum", torch.bool), ((8, 114 * 576 * 576), "sum", torch.int32),
        ((8, 114 * 576 * 576), "max", torch.int32), ((3, 1_000_003), "sum", torch.bool),
    ]
    for shape, op, dtype in cases:
        if dtype == torch.bool:
            x = torch.rand(shape, generator=gen, device=dev) < 0.3
        elif op == "max":
            col = torch.arange(shape[1], dtype=torch.int32, device=dev).expand(*shape)
            x = torch.where(torch.rand(shape, generator=gen, device=dev) < 1e-3, col, -1)
        else:
            x = torch.randint(0, 2, shape, generator=gen, dtype=torch.int32, device=dev)
        if not torch.equal(K.row_scan(x, op, impl="cuda"), torch_call(x, op)):
            raise AssertionError(f"row scan {op} of {shape} {dtype} differs from torch")
        k = cuda_ms(lambda: K.row_scan(x, op, impl="cuda"), reps)
        t = cuda_ms(lambda: torch_call(x, op), max(2, reps // 4))
        b = bound_ms(x)
        print(f"[shape] {op} {shape} {str(dtype).split('.')[-1]}: kernel {k:.4f} ms, torch {t:.4f} ms "
              f"({t / k:.2f}x), bound {b:.4f} ms (bound / kernel {b / k:.1%})", flush=True)
        del x


def step_replay(K, reps: int, gen: torch.Generator) -> None:
    from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries

    config = json.loads((ROOT / "port_bench/configs/ws_cc_step_512.json").read_text())
    step = make_ws_ccl_split(device="cuda", **config["step"])
    vol = synthetic_boundaries((1,) + tuple(config["volume_shape"]), gen)
    step(vol)
    torch.cuda.synchronize()
    K.reset_counts()
    with K.capture_inputs() as captured:
        step(vol)
    torch.cuda.synchronize()
    print(f"[step] launches in one step: {dict(K.LAUNCHES)}", flush=True)
    sums = defaultdict(lambda: [0, 0.0, 0.0, 0.0])
    for name, args, kwargs in captured:
        if not name.startswith("row_scan."):
            continue
        x, op = args[0], kwargs["op"]
        if not torch.equal(K.row_scan(x, op, impl="cuda"), torch_call(x, op)):
            raise AssertionError(f"step replay: {name} of {tuple(x.shape)} differs from torch")
        k = cuda_ms(lambda: K.row_scan(x, op, impl="cuda"), reps)
        t = cuda_ms(lambda: torch_call(x, op), 2)
        s = sums[(name, x.shape[0])]
        s[0] += 1
        s[1] += k
        s[2] += t
        s[3] += bound_ms(x)
        if x.numel() >= 1 << 22:
            print(f"[step] {name} {tuple(x.shape)} {str(x.dtype).split('.')[-1]}: kernel {k:.4f} ms, "
                  f"torch {t:.4f} ms, bound {bound_ms(x):.4f} ms", flush=True)
    for (name, rows), (n, k, t, b) in sorted(sums.items()):
        print(f"[step-sum] {name} rows={rows}: {n} launches, kernel {k:.3f} ms, torch {t:.3f} ms, "
              f"bound {b:.3f} ms", flush=True)
    captured.clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the row scan is timed on the card only", file=sys.stderr)
        return 2
    from cluster_tools_tpu_torch import build
    from cluster_tools_tpu_torch.ops import kernels as K

    print(f"[card] {card_line()}", flush=True)
    print(f"[build] {build.build_all()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    shapes(K, args.reps, gen)
    step_replay(K, args.reps, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
