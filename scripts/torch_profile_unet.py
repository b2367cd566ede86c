#!/usr/bin/env python3
"""Where the port's U-Net inference spends its time on one GPU.

Usage: ``python3 scripts/torch_profile_unet.py [--seed 0]
[--out chiprun_out/torch_profile_unet]``

On one 144^3 block (a 128^3 block with halo 8, the inference task's
default; the synthetic boundary volume of ``chip_smoke.py``, normalised),
the full-width U-Net (base 16, depth 2, GroupNorm, bfloat16; seeded
weights):

1. the forward's time (CUDA events, mean of 10 after a warm-up) in four
   settings, in turns (A B C D D C B A, each the mean of its two runs):
   NCDHW with cuDNN's heuristic algorithm choice (what the task runs),
   NCDHW with ``cudnn.benchmark`` (cuDNN times its algorithms), the
   ``channels_last_3d`` memory format, and float32 with TF32 off;
2. one forward under ``torch.profiler``: device time by aten operator
   (convolutions, GroupNorm's passes, GELU, casts, bias adds, concat) and
   the costliest kernels, with the device's busy share of the forward;
3. ``InferenceWorkflow`` at 512^3 (block 128^3, 64 blocks, ``memory://``)
   once to warm up and once under the profiler: wall time, device time and
   the device's busy share of the wall.

Prints each result and then all of it as one JSON line; the key_averages
tables and Chrome traces go to ``--out``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _device_us(evt, total: bool = False) -> float:
    names = ("device_time_total", "cuda_time_total") if total else ("self_device_time_total", "self_cuda_time_total")
    for attr in names:
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_us(prof) -> float:
    """Summed device time of the profiled kernels."""
    return sum(_device_us(e) for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/torch_profile_unet")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2

    from cluster_tools_tpu_torch.io.containers import MemoryContainer, open_container
    from cluster_tools_tpu_torch.models import UNet3D
    from cluster_tools_tpu_torch.runtime.task import build as run_dag
    from cluster_tools_tpu_torch.tasks.inference import InferenceWorkflow, normalize, save_checkpoint
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries

    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} cudnn {torch.backends.cudnn.version()}")
    result = {"card": smi}

    vol = synthetic_boundaries((1, 512, 512, 512), torch.Generator(device="cuda").manual_seed(args.seed))
    raw = vol[0].cpu().numpy()
    x = torch.from_numpy(normalize(raw[:144, :144, :144]))[None, None].cuda()
    models = {}
    for dtype in (torch.bfloat16, torch.float32):
        m = UNet3D(dtype=dtype)
        m.reset_parameters(torch.Generator().manual_seed(args.seed))
        models[dtype] = m.cuda().eval()
    m16 = models[torch.bfloat16]
    x_cl = x.contiguous(memory_format=torch.channels_last_3d)

    def run(setting):
        with torch.no_grad():
            if setting == "ncdhw":
                return m16(x)
            if setting == "benchmark":
                with torch.backends.cudnn.flags(enabled=True, benchmark=True):
                    return m16(x)
            if setting == "channels_last_3d":
                return m16(x_cl)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return models[torch.float32](x)

    settings = ("ncdhw", "benchmark", "channels_last_3d", "float32")
    for s in settings:  # warm-up (and cuDNN's benchmark search)
        run(s)
    times = {s: [] for s in settings}
    for s in settings + settings[::-1]:
        times[s].append(_events_ms(lambda: run(s), 10))
    fwd = {s: sum(v) / len(v) for s, v in times.items()}
    print("forward of one 144^3 block, ms: " + ", ".join(f"{s} {t:.3f}" for s, t in fwd.items()))
    result["forward_ms"] = fwd

    # ---- one forward under the profiler ----
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run("ncdhw")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(args.out, "forward_trace.json"))
    ka = prof.key_averages()
    with open(os.path.join(args.out, "forward_key_averages.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cuda_time_total", row_limit=60))
    kernels = sorted((e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA), key=_device_us, reverse=True)
    dev_us = sum(_device_us(e) for e in kernels)
    ops = sorted((e for e in ka if e.key.startswith("aten::") and _device_us(e, total=True) > 0),
                 key=lambda e: _device_us(e, total=True), reverse=True)
    top_ops = [(e.key, e.count, _device_us(e, total=True) / 1e3) for e in ops[:12]]
    top_kernels = [(e.key[:90], e.count, _device_us(e) / 1e3) for e in kernels[:10]]
    print(f"profiled forward: wall {wall * 1e3:.3f} ms, device {dev_us / 1e3:.3f} ms "
          f"(busy {dev_us / 1e3 / (wall * 1e3):.1%})")
    print("aten ops by device ms (count): " + "; ".join(f"{k} {ms:.3f} ({n})" for k, n, ms in top_ops))
    print("kernels by device ms (count): " + "; ".join(f"{k} {ms:.3f} ({n})" for k, n, ms in top_kernels))
    result["forward_profile"] = dict(wall_ms=wall * 1e3, device_ms=dev_us / 1e3, top_ops=top_ops,
                                     top_kernels=top_kernels)

    # ---- the workflow at 512^3 ----
    mem = "memory://profile-unet"
    open_container(mem).require_dataset("raw", shape=raw.shape, chunks=(128,) * 3, dtype="float32")[...] = raw
    with tempfile.TemporaryDirectory(prefix="profile-unet-") as root:
        ckpt = os.path.join(root, "unet.npz")
        save_checkpoint(ckpt, m16)

        def workflow(tag):
            # no config files: the parameters carry the block shape
            d = os.path.join(root, tag)
            wf = InferenceWorkflow(tmp_folder=os.path.join(d, "tmp"), config_dir=d, max_jobs=8,
                                   input_path=mem, input_key="raw", output_path=mem, output_key="pred",
                                   checkpoint_path=ckpt, model={"name": "unet3d"}, halo=[8, 8, 8],
                                   block_shape=[128, 128, 128])
            if not run_dag([wf]):
                raise RuntimeError(f"the inference workflow failed ({tag})")

        workflow("warm")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            workflow("profiled")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    del MemoryContainer._registry[mem]
    prof.export_chrome_trace(os.path.join(args.out, "workflow_trace.json"))
    dev_ms = _kernel_us(prof) / 1e3
    print(f"InferenceWorkflow 512^3 under the profiler: wall {wall:.3f} s, device {dev_ms:.1f} ms "
          f"(busy {dev_ms / 1e3 / wall:.1%}, idle {1 - dev_ms / 1e3 / wall:.1%})")
    result["workflow"] = dict(wall_s=wall, device_ms=dev_ms)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
