#!/usr/bin/env python3
"""Measurements of B1d (``csrc/tile_ccl_doubling.cu``) on one GPU: its CTA
size, and where an iteration's time goes.

Usage: ``python3 scripts/torch_b1d_measure.py [--seed 0]``

1. CTA size: builds a copy of the source once per size in ``THREADS``
   (its ``kThreads`` set to the size) with ``-Xptxas -v`` (its register,
   spill and stack lines are printed), then times the builds with CUDA
   events, in
   turns (each size, then each in reverse order), on the cc stage's 512^3
   input (the main path's synthetic volume below its threshold, 0.45) and
   on 512^3 volumes whose tiles are all one adversarial CCL tile.
2. Passes: builds a copy of the source at the default size in which the
   first thread of each CTA reads ``clock64`` around the z, y and x passes
   of every iteration (each ending at its barrier or vote) and around the
   whole kernel, and prints the SM clocks per tile each took on the same
   inputs.  Three CTAs share an SM, so these are wall clocks of one CTA,
   not its share of the SM.

Every build's labels must equal the unit-step twin's (on the cc input) and
B1's (on the adversarial volumes).  Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cluster_tools_tpu_torch import build  # noqa: E402
from cluster_tools_tpu_torch.ops import kernels as K  # noqa: E402
from cluster_tools_tpu_torch.utils.synthetic import adversarial_ccl_tiles_np, synthetic_boundaries  # noqa: E402

THREADS = (256, 384, 512, 1024)
SHAPE = (512, 512, 512)
P, I = ctypes.c_void_p, ctypes.c_int

THREADS_LINE = "constexpr int kThreads = 256;"

# (anchor in the kernel source, what replaces it) for the clocked copy
CLOCK_PATCH = (
    ('#include "tile_mask.cuh"\n',
     '#include "tile_mask.cuh"\n__device__ unsigned long long g_clk[4];  // z, y, x, whole kernel\n'),
    ("  extern __shared__ __align__(16) uint16_t lab[];\n",
     "  extern __shared__ __align__(16) uint16_t lab[];\n  const long long c_start = clock64();\n"
     "  long long c_z = 0, c_y = 0, c_x = 0, c_0, c_1;\n"),
    ("    uint32_t fell = 0;\n", "    uint32_t fell = 0;\n    c_0 = clock64();\n"),
    ("    // y: columns", "    c_1 = clock64(); c_z += c_1 - c_0; c_0 = c_1;\n    // y: columns"),
    ("    // x: rows", "    c_1 = clock64(); c_y += c_1 - c_0; c_0 = c_1;\n    // x: rows"),
    ("    if (!__syncthreads_or(fell != 0)) break;\n",
     "    const int more = __syncthreads_or(fell != 0);\n    c_x += clock64() - c_0;\n    if (!more) break;\n"),
)


def source(threads: int = 256) -> str:
    """The kernel source with ``threads`` threads a CTA."""
    src = (build.CSRC / build.SOURCES["tile_ccl_doubling"]).read_text()
    if src.count(THREADS_LINE) != 1:
        raise RuntimeError(f"{THREADS_LINE!r} not found once in the kernel source")
    return src.replace(THREADS_LINE, f"constexpr int kThreads = {threads};")


def clocked_source() -> str:
    src = source()
    for anchor, text in CLOCK_PATCH:
        if src.count(anchor) != 1:
            raise RuntimeError(f"clock patch: anchor not found once: {anchor!r}")
        src = src.replace(anchor, text)
    tail = "    for (int v = threadIdx.x; v < nv; v += kThreads) out[g.global(v)] = label(lab[v]);\n  }\n}\n"
    if src.count(tail) != 1:
        raise RuntimeError("clock patch: kernel end not found once")
    src = src.replace(tail, tail[:-2] + "  if (threadIdx.x == 0) {\n"
                      "    atomicAdd(&g_clk[0], c_z); atomicAdd(&g_clk[1], c_y); atomicAdd(&g_clk[2], c_x);\n"
                      "    atomicAdd(&g_clk[3], (unsigned long long)(clock64() - c_start));\n  }\n}\n")
    return src + ('\nextern "C" int ct_clocks(void* out, int reset) {\n'
                  "  static const unsigned long long zero[4] = {0, 0, 0, 0};\n"
                  "  return reset ? (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(zero))\n"
                  "               : (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(zero));\n}\n")


def nvcc(src: Path, out: Path):
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(build.CSRC),
           "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines() if "registers" in ln or "spill" in ln]
    lib = ctypes.CDLL(str(out))
    lib.ct_tile_ccl_doubling.argtypes = [P, P, P, I, I, I, I, I, I, P]
    lib.ct_tile_ccl_doubling.restype = ctypes.c_int
    return lib, ptxas


def run(lib, mask: torch.Tensor) -> torch.Tensor:
    out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    rc = lib.ct_tile_ccl_doubling(mask.data_ptr(), out.data_ptr(), None, *mask.shape, *K.DEFAULT_TILE,
                                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed ({rc})")
    return out


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_b1d_measure: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    work = build.BUILD_DIR / "measure"
    work.mkdir(parents=True, exist_ok=True)
    libs = {}
    for t in THREADS:
        (work / f"b1d_t{t}.cu").write_text(source(t))
        libs[t], ptxas = nvcc(work / f"b1d_t{t}.cu", work / f"libb1d_t{t}.so")
        print(f"[ptxas {t} threads] " + " | ".join(ptxas), flush=True)
    (work / "b1d_clocked.cu").write_text(clocked_source())
    clib, _ = nvcc(work / "b1d_clocked.cu", work / "libb1d_clocked.so")
    clib.ct_clocks.argtypes = [P, I]

    vol = synthetic_boundaries((1,) + SHAPE, torch.Generator(device="cuda").manual_seed(args.seed))
    inputs = [("cc input", (vol[0] < 0.45).contiguous())]
    del vol
    reps = [s // t for s, t in zip(SHAPE, K.DEFAULT_TILE)]
    inputs += [(kind, torch.from_numpy(m).cuda().repeat(*reps).contiguous())
               for kind, m in adversarial_ccl_tiles_np(K.DEFAULT_TILE)]
    n_tiles = K.to_tiles(inputs[0][1], K.DEFAULT_TILE).shape[0]
    result = {"card": smi, "ms": {}, "clocks_per_tile": {}}
    for what, mask in inputs:
        want = K.tile_ccl_torch(mask, K.DEFAULT_TILE) if what == "cc input" else K.tile_ccl(mask, impl="cuda")
        times = {t: [] for t in THREADS}
        for t in THREADS + THREADS[::-1]:
            if not torch.equal(run(libs[t], mask), want):
                raise AssertionError(f"{t} threads: labels differ on {what}")
            times[t].append(cuda_ms(lambda: run(libs[t], mask)))
        clib.ct_clocks(None, 1)
        if not torch.equal(run(clib, mask), want):
            raise AssertionError(f"clocked build: labels differ on {what}")
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 4)()
        clib.ct_clocks(buf, 0)
        clocks = dict(zip(("z", "y", "x", "kernel"), (v / n_tiles for v in buf)))
        _, iters = K.tile_ccl(mask, impl="cuda", doubling=True, return_iterations=True)
        result["ms"][what] = times
        result["clocks_per_tile"][what] = dict(clocks, iterations=float(iters.double().mean()))
        print(f"[{what}] " + ", ".join(f"{t} threads {v[0]:.3f} / {v[1]:.3f} ms" for t, v in times.items())
              + "; clocks per tile: " + ", ".join(f"{k} {v:.0f}" for k, v in clocks.items())
              + f"; iterations per tile {float(iters.double().mean()):.3f}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
