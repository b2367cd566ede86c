#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cluster_tools_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py [--seed 0]``

Phases, each one line of output, each raising on failure:

1. card: the device name and ``nvidia-smi`` name / power limit;
2. build: compile every kernel of ``cluster_tools_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once);
3. kernels: each kernel against its plain PyTorch twin on CUDA tensors,
   exact equality (B1 tiled CCL and B1d, its run-doubling variant, against
   the CCL twins on a smooth mask, on adversarial tiles (all foreground,
   checkerboard, isolated voxels, one-voxel-wide serpentines) and on noise,
   at tiles with unaligned rows, with an axis of extent 1, with long
   columns and with rows that span a warp; B1d against both formulations
   of its twin, per-tile iteration counts included;
   B2 watershed flow against both flow twins on a descent field, on it
   edited with voxels the flow stage never makes, and on the adversarial
   fields of ``adversarial_flow_np`` at four tile shapes; B3 EDT cascade on
   all axes at radius 32 and n-1, and at n in {1, 7, 31, 33, 127, 576,
   1100} x radius in {0, 1, 32, n-1}, with anisotropic weights; B4 remap
   with -1 slots and a chained pair, and every kind of
   ``adversarial_remap_np`` table on three tile shapes);
4. main path: ``make_ws_ccl_split`` at the benchmark's headline config
   (``(1, 512, 512, 512)`` synthetic volume, halo 32, threshold 0.45, EDT
   cap 32, min seed distance 2, sparse seed CCL): one warm-up (host syncs
   counted) and three timed runs; the median run's per-stage ms and
   voxels/s, and per run the kernel launches, remap rungs and peak memory
   (the input volume and the run's own buffers); a fourth run records each
   launch's inputs;
   ``overflow`` must be False, ``n_foreground`` must count the cc labels
   and the cc labels must be ``scipy.ndimage.label``'s partition;
5. main-path twins: the same step with ``impl="torch"`` on the same volume
   must equal the kernels' output bit for bit;
6. main-path kernels: every launch of the main path replayed on the inputs
   it was given, against its twin (exact), timed beside its twin and its
   bound; a kernel's ``ms``/``plain_ms``/``bound_ms`` are sums over its
   launches in one run; each B4 launch prints its tables' mean and maximum
   live slots per tile.  B1d is not on the main path (as in the
   reference): it is replayed on B1's cc-stage input, held exactly against
   the CCL twins, prints its iterations per tile, and its row reports 0
   launches;
7. flow worst: B2 timed at the main path's flow shape with every tile one
   adversarial tile, each of the eight in turn, beside its main-path time;
   the slowest is held against the jump twin;
8. ccl worst: B1 and B1d timed at the cc stage's shape with every tile one
   adversarial CCL tile, each of the eight in turn, with B1d's iterations;
   each kernel's slowest kind is held against the other kernel and, on a
   crop of whole tiles, against the unit-step twin;
9. tiled seeds: the whole step with ``seed_mode="tiled"`` at 128x256x256
   (B1 and B4 also run in the seeds stage), ``impl="cuda"`` against
   ``impl="torch"`` bit for bit, with its own launch counts;
10. blockwise: BASELINE configs 1-3 through the port's workflows on the
    main path's volume in ``memory://`` (block 128^3): connected components
    (against ``scipy.ndimage.label``), single- and two-pass watershed (halo
    32, ``CT_FILL_MODE=capacity``, ``CT_TIER_MODE=cond``; each against its
    ``impl="torch"`` run bit for bit, every kernel launch of one run
    replayed against its twin and timed), relabel of the two-pass output
    (``1..K``, same partition), and the cc workflow at 256^3 through the
    port's zarr on local disk against its ``memory://`` run.  Per workflow:
    a warm-up and two timed runs (fresh ``tmp_folder`` each), the median
    wall time, voxels/s and blocks/s, peak device memory, the executor's
    summed load / h2d / kernel (synced) / d2h / store ms, kernel launches
    and remap rungs.  The kernel rows gain ``blockwise_launches`` and
    ``blockwise_ms`` (sums over one run's launches, replayed).  The tasks'
    default ``sweep_mode="auto"`` runs these sweeps sharded, 8 blocks a
    call;
11. sweeps (``phase_sweeps``): the executor's sweep plane on the same
    volume (64 blocks, batch 8): the single- and two-pass watershed and cc
    with ``sweep_mode="per_block"`` beside phase 10's runs, which must
    have run sharded with the lane-batched kernels (rung ``batched``);
    every file equal bit for bit; per mode the wall (median of two after a
    warm-up), blocks/s, calls to the device, summed kernel s, peak GB and
    the fixed cost a block; then a ragged tail (``sharded_batch=12``: one
    ragged batch, 8 padding lanes) and one ragged sweep run twice through
    the device page pool (the second sends fewer bytes to the card), each
    equal to the per-block file.  The kernel rows gain ``sweep_launches``;
12. multicut: BASELINE config 4 (``phase_multicut``): the fused RAG and the
    torch-rung GAEC on the first 256^3 of the main path's watershed labels
    against the numpy oracle; ``MulticutSegmentationWorkflow`` and
    ``AgglomerativeClusteringWorkflow`` on the 512^3 single-pass watershed
    output of phase 10 (per-task times; the merged graph against the numpy
    oracle, the segmentation against the assignment table); the default
    workflow (watershed, Kernighan-Lin) on the first 128^3, and the
    agglomerating watershed on the first 256^3 against its
    ``impl="torch"`` run.  The kernel rows gain ``multicut_launches``;
13. fusion (``phase_fusion``): task-graph fusion from the port's zarr on
    local disk: ``MulticutSegmentationWorkflow`` with its own watershed on
    the main path's 512^3 volume and ``ConnectedComponentsWorkflow`` on it,
    each with ``memory_handoffs`` off and on (walls, per-task seconds,
    launches, handoff counters, peak and reserved device memory and the
    intermediate bytes written to storage; outputs and B1-B4 launches
    equal between the arms), and the device rung (a CUDA tensor handed
    from a producer task to a consumer's slab sweep of B3 with no host
    byte, then staged to and demoted to the memory rung under small device
    budgets, each equal).  The kernel rows gain ``fusion_launches``;
14. inference (``phase_inference``): ``InferenceWorkflow`` with the
    full-width U-Net (base 16, depth 2, GroupNorm, bfloat16; seeded weights
    saved with the port's ``save_checkpoint`` and read back from the npz) on
    the main path's 512^3 volume (block 128^3, halo 8: 64 blocks of 144^3),
    then ``IlastikPredictionWorkflow`` (block 128^3, halo 12) with a seeded
    linear classifier on the default feature bank and with a seeded forest
    (16 trees of depth 8) on all six ilastik feature ids.  Per workflow a
    warm-up and two timed runs with the "blockwise" columns; the U-Net's
    FLOP count and bound and one block's synced forward; gates: the
    U-Net's output finite in [0, 1], two blocks (interior, far corner)
    equal to the port's CPU forward of the same npz within 2e-2, a float32
    model on one block equal to its CPU forward within 2e-4 (TF32 off),
    the probabilities summing to 1 within 1e-5, one block of each
    classifier equal to its CPU run within 2e-3 (the forest on voxels clear
    of its split thresholds), and the forest's descent on the card's
    features equal to its CPU descent within 1e-6.  The kernel rows gain
    ``inference_launches`` (0: this path runs no hand kernel).

Prints the kernels' JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero (and prints no result)
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM3 rate; 67 TFLOP/s float32 outside the
# tensor cores counts an FMA as two operations, so plain adds and mins issue
# at half of it, and int32 compares and selects (64 INT32 lanes per SM
# against 128 FP32 lanes) at a quarter
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = 67e12 / 4

MAIN_SHAPE = (1, 512, 512, 512)

KERNELS = {
    # name: (id, source, replaces)
    "tile_ccl": ("B1", "cluster_tools_tpu_torch/csrc/tile_ccl.cu", "cluster_tools_tpu/ops/pallas_kernels.py:185"),
    "tile_ccl_doubling": ("B1d", "cluster_tools_tpu_torch/csrc/tile_ccl_doubling.cu",
                          "cluster_tools_tpu/ops/pallas_kernels.py:76"),
    "tile_ws_propagate": ("B2", "cluster_tools_tpu_torch/csrc/tile_ws.cu", "cluster_tools_tpu/ops/pallas_kernels.py:277"),
    "edt_cascade": ("B3", "cluster_tools_tpu_torch/csrc/edt_cascade.cu", "cluster_tools_tpu/ops/pallas_kernels.py:332"),
    "apply_remap": ("B4", "cluster_tools_tpu_torch/csrc/apply_remap.cu", "cluster_tools_tpu/ops/pallas_kernels.py:384"),
}
# the config-4 shape: the fused RAG + parallel GAEC on this crop of the main
# path's watershed labels; the agglomerating watershed on the same crop
CONFIG4_CROP = 256
# the default multicut workflow (Kernighan-Lin global solve) with its watershed
MC_DEFAULT_CROP = 128
# the kernels the main path must launch (B1d is a variant nothing selects)
MAIN_PATH_KERNELS = ("tile_ccl", "tile_ws_propagate", "edt_cascade", "apply_remap")
# tiles of B2's adversarial fields: small, unaligned rows and odd ty, the main tile
FLOW_TILES = ((4, 8, 32), (4, 5, 30), (8, 8, 64), (16, 16, 128))
# CCL tiles beside the main one: an axis of extent 1 (no z pass; one voxel
# a row), columns longer than B1d holds in registers, rows that span a warp
CCL_TILES = ((1, 16, 128), (16, 16, 1), (40, 24, 16), (1, 4, 512))


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` launches after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require_equal(what: str, a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if not torch.equal(a, b):
        bad = (a != b).nonzero()[:3].tolist()
        raise AssertionError(f"{what}: kernel and twin differ at {bad}")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_b1d(K, what: str, mask: torch.Tensor, tile):
    """B1d against both formulations of its twin (exact), labels and
    per-tile iteration counts; returns both."""
    b1d, iters = K.tile_ccl(mask, tile, impl="cuda", doubling=True, return_iterations=True)
    for form in ("doubling", "runs"):
        want, want_iters = K.tile_ccl_doubling_torch(mask, tile, form, return_iterations=True)
        require_equal(f"B1d tile_ccl_doubling {what} ({form} twin)", b1d, want)
        require_equal(f"B1d iterations per tile {what} ({form} twin)", iters, want_iters)
    return b1d, iters


def check_ccl(K, what: str, mask: torch.Tensor, tile) -> None:
    """B1 and B1d against the CCL twins (exact)."""
    unit = K.tile_ccl_torch(mask, tile)
    require_equal(f"B1 tile_ccl {what}", K.tile_ccl(mask, tile, impl="cuda"), unit)
    require_equal(f"B1d tile_ccl_doubling {what} (unit-step twin)", check_b1d(K, what, mask, tile)[0], unit)


def phase_kernels(K, gen) -> None:
    from cluster_tools_tpu_torch.ops.tile_ws import descent_directions
    from cluster_tools_tpu_torch.utils.synthetic import (
        REMAP_KINDS,
        adversarial_flow_np,
        adversarial_remap_np,
        adversarial_tiles_np,
        flow_edits_np,
        synthetic_boundaries,
    )

    dev = "cuda"
    shape = (64, 128, 256)
    tile = (16, 16, 128)
    v = synthetic_boundaries(shape, gen, passes=4)
    mask = (v < v.median()).contiguous()
    check_ccl(K, "smooth mask", mask, tile)
    for atile in (tile,) + CCL_TILES:
        check_ccl(K, f"adversarial tiles {atile}", torch.from_numpy(adversarial_tiles_np(atile)).to(dev), atile)
    # small tiles (rows of 40 voxels are not whole 32-bit words), and tiles
    # with an axis of extent 1
    for nshape, ntile in (((32, 40, 96), (4, 5, 32)), ((32, 40, 120), (4, 5, 40)),
                          ((4, 64, 256), CCL_TILES[0]), ((64, 64, 4), CCL_TILES[1])):
        noise = torch.rand(nshape, generator=gen, device=dev)
        for p in (0.2, 0.5, 0.75):
            check_ccl(K, f"noise p={p}, tile {ntile}", (noise < p).contiguous(), ntile)

    seeds = torch.zeros(shape, dtype=torch.int32, device=dev)
    pts = torch.randint(0, 64, (200, 3), generator=gen, device=dev) * torch.tensor([1, 2, 4], device=dev)
    seeds[pts[:, 0], pts[:, 1], pts[:, 2]] = torch.arange(1, 201, dtype=torch.int32, device=dev)
    valid = torch.rand(shape, generator=gen, device=dev) < 0.97
    dirs = descent_directions(v, seeds > 0, valid)
    sv = torch.where(valid, seeds, -1).to(torch.int32).contiguous()
    flow = K.tile_ws_propagate(dirs, sv, tile, impl="cuda")
    require_equal("B2 tile_ws_propagate (jump twin)", flow, K.tile_ws_propagate_torch(dirs, sv, tile, "jump"))
    require_equal("B2 tile_ws_propagate (stepping twin)", flow, K.tile_ws_propagate_torch(dirs, sv, tile, "stepping"))
    # off the flow stage's domain: seeded and invalid non-terminals, seeded
    # exits, unknown codes; then the adversarial fields at each of FLOW_TILES
    flow_cases = [("edited field", flow_edits_np(dirs.cpu().numpy(), sv.cpu().numpy(), tile, tiles=range(8)), tile)]
    flow_cases += [(f"adversarial fields {t}", adversarial_flow_np(t), t) for t in FLOW_TILES]
    for what, (d_np, s_np), ftile in flow_cases:
        d_c, s_c = torch.from_numpy(d_np).to(dev), torch.from_numpy(s_np).to(dev)
        got = K.tile_ws_propagate(d_c, s_c, ftile, impl="cuda")
        for form in ("jump", "stepping"):
            require_equal(f"B2 tile_ws_propagate {what} ({form} twin)", got,
                          K.tile_ws_propagate_torch(d_c, s_c, ftile, form))

    f = torch.where(mask, torch.tensor(np.float32(1e12), device=dev), torch.tensor(0.0, device=dev)).contiguous()
    n_b3 = 0
    for axis in range(3):
        for radius in (32, shape[axis] - 1):
            for w in (1.0, 2.25, 1600.0):
                a = K.edt_cascade(f, axis, radius, w, 1e12, impl="cuda")
                require_equal(f"B3 edt_cascade axis {axis} r {radius} w {w}", a,
                              K.edt_cascade_torch(f, axis, radius, w, 1e12))
                n_b3 += 1
    # short, odd and long lines, radius 0 to n-1; anisotropic sampling (40, 4, 1.5)
    for axis, w in zip(range(3), (1600.0, 16.0, 2.25)):
        for n in (1, 7, 31, 33, 127, 576, 1100):  # 1100: the shared-memory branch
            dims = [6, 9, 45]
            dims[axis] = n
            r = torch.rand(dims, generator=gen, device=dev)
            g = torch.where(r < 0.8, torch.tensor(np.float32(1e12), device=dev), r * 100).contiguous()
            for radius in sorted({0, 1, min(32, n - 1), n - 1}):
                require_equal(f"B3 edt_cascade axis {axis} n {n} r {radius}",
                              K.edt_cascade(g, axis, radius, w, 1e12, impl="cuda"),
                              K.edt_cascade_torch(g, axis, radius, w, 1e12))
                n_b3 += 1

    n_tiles = (shape[0] // 16) * (shape[1] // 16) * (shape[2] // 128)
    old = torch.full((n_tiles, 64), -1, dtype=torch.int32, device=dev)
    new = old.clone()
    labels = flow.contiguous()
    present = torch.unique(labels)
    pick = present[torch.randint(0, present.numel(), (n_tiles, 8), generator=gen, device=dev)]
    old[:, 0:16:2] = pick
    new[:, 0:16:2] = pick + 7
    # a chain inside tile 0: a -> b in slot 20, b -> c in slot 21
    old[0, 20], new[0, 20] = present[0], present[1]
    old[0, 21], new[0, 21] = present[1], present[2]
    require_equal("B4 apply_remap", K.apply_remap(labels, old, new, tile, 64, impl="cuda"),
                  K.apply_remap_torch(labels, old, new, tile, 64))
    # adversarial tables on the main tile and on small ones (rows of 32 and,
    # unaligned, of 30 voxels)
    for rtile, lab_np in ((tile, labels.cpu().numpy()), ((4, 8, 32), labels.cpu().numpy()),
                          ((4, 8, 30), labels[:, :, :240].contiguous().cpu().numpy())):
        for kind in REMAP_KINDS + ("mixed",):
            lab_c, old_c, new_c = (torch.from_numpy(a).to(dev) for a in adversarial_remap_np(lab_np, rtile, kind))
            require_equal(f"B4 apply_remap {kind} tables, tile {rtile}",
                          K.apply_remap(lab_c, old_c, new_c, rtile, 64, impl="cuda"),
                          K.apply_remap_torch(lab_c, old_c, new_c, rtile, 64))
    torch.cuda.synchronize()
    log("kernels", f"B1 and B1d (smooth mask, 8 adversarial tiles on 16x16x128, "
                   f"{', '.join('x'.join(map(str, t)) for t in CCL_TILES)} tiles, noise at 3 densities on "
                   f"4x5x32, 4x5x40, 1x16x128 and 16x16x1 tiles; B1d "
                   f"against both twin formulations, iteration counts included), "
                   f"B2 (jump + stepping twins; descent field, edited field, adversarial fields on "
                   f"{', '.join('x'.join(map(str, t)) for t in FLOW_TILES)} tiles), "
                   f"B3 ({n_b3} axis/n/radius/weight cases), "
                   f"B4 (-1 slots, chained pair; {len(REMAP_KINDS) + 1} adversarial table kinds on "
                   f"16x16x128, 4x8x32, 4x8x30 tiles) equal their twins exactly")


def bound_ms(name: str, args, kwargs) -> tuple:
    """Least time for one launch's work on the card: bytes (inputs read
    once, output written once) over the memory rate, operations over their
    type's rate; returns (ms, 'bytes' or 'operations')."""
    x = args[0]
    n = x.numel()
    t_ops = 0.0
    if name in ("tile_ccl", "tile_ccl_doubling"):
        nbytes = n * (x.element_size() + 4)
    elif name == "tile_ws_propagate":
        nbytes = n * 12
    elif name == "edt_cascade":
        nbytes = n * 8
        # per step: min of the two neighbours, one float32 add, one min
        # (min(a + c, b + c) == min(a, b) + c exactly: rounding is monotone)
        t_ops = 3.0 * kwargs["radius"] * n / FP32_OPS_PER_S * 1e3
    else:  # apply_remap: one hashed lookup per voxel of a tile with a live slot
        old, new = args[1], args[2]
        nbytes = n * 8 + old.numel() * 8
        # hash (multiply, shift), compare the key, select: 4 int32 operations
        live_tiles = int((old != new).any(1).sum())
        t_ops = 4.0 * live_tiles * (n / old.shape[0]) / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def replay(K, name, args, kwargs):
    """(kernel call, twin call) on a kernel's captured inputs."""
    if name == "tile_ccl":
        kfn = lambda: K.tile_ccl(args[0], kwargs["tile"], impl="cuda")
        tfn = lambda: K.tile_ccl_torch(args[0], kwargs["tile"])
    elif name == "tile_ccl_doubling":
        kfn = lambda: K.tile_ccl(args[0], kwargs["tile"], impl="cuda", doubling=True)
        tfn = lambda: K.tile_ccl_doubling_torch(args[0], kwargs["tile"])
    elif name == "tile_ws_propagate":
        kfn = lambda: K.tile_ws_propagate(args[0], args[1], kwargs["tile"], impl="cuda")
        tfn = lambda: K.tile_ws_propagate_torch(args[0], args[1], kwargs["tile"])
    elif name == "edt_cascade":
        kw = (kwargs["axis"], kwargs["radius"], kwargs["w"], kwargs["big"])
        kfn = lambda: K.edt_cascade(args[0], *kw, impl="cuda")
        tfn = lambda: K.edt_cascade_torch(args[0], *kw)
    else:
        kfn = lambda: K.apply_remap(*args, kwargs["tile"], kwargs["cap"], impl="cuda")
        tfn = lambda: K.apply_remap_torch(*args, kwargs["tile"], kwargs["cap"])
    return kfn, tfn


def flow_worst(K, shape, main_ms: float) -> None:
    """B2 at the main path's flow shape with every tile one adversarial tile
    (each of the eight in turn); the slowest is held against the jump twin."""
    from cluster_tools_tpu_torch.utils.synthetic import adversarial_flow_tiles_np

    tile = K.DEFAULT_TILE
    reps = [s // t for s, t in zip(shape, tile)]
    times, worst = [], None
    for name, d_np, s_np in adversarial_flow_tiles_np(tile):
        d, s = (torch.from_numpy(x).cuda().repeat(*reps).contiguous() for x in (d_np, s_np))
        t = cuda_ms(lambda: K.tile_ws_propagate(d, s, tile, impl="cuda"), 5)
        times.append((t, name))
        if worst is None or t > worst[0]:
            worst = (t, name, d, s)
        del d, s
    t_worst, name, d, s = worst
    require_equal(f"B2 on {shape} of '{name}' tiles (jump twin)", K.tile_ws_propagate(d, s, tile, impl="cuda"),
                  K.tile_ws_propagate_torch(d, s, tile, "jump"))
    log("flow-worst", f"B2 at {shape}, every tile one adversarial tile: "
                      + ", ".join(f"{n} {t:.3f}" for t, n in times)
                      + f" ms; worst '{name}' {t_worst:.3f} ms (equals the jump twin) against "
                        f"the main path's {main_ms:.3f} ms")


def ccl_worst(K, shape) -> None:
    """B1 and B1d at the cc stage's shape with every tile one adversarial CCL
    tile (each of the eight in turn).  Each kernel's slowest kind is held
    against the other kernel at full size, and both kernels against the
    unit-step twin on a crop of 2 x 4 x 2 whole tiles."""
    from cluster_tools_tpu_torch.utils.synthetic import adversarial_ccl_tiles_np

    tile = K.DEFAULT_TILE
    reps = [s // t for s, t in zip(shape, tile)]
    crop = tuple(slice(0, n * t) for n, t in zip((2, 4, 2), tile))
    rows, worst = [], {}
    for kind, m_np in adversarial_ccl_tiles_np(tile):
        m = torch.from_numpy(m_np).cuda().repeat(*reps).contiguous()
        t1 = cuda_ms(lambda: K.tile_ccl(m, tile, impl="cuda"), 5)
        t1d = cuda_ms(lambda: K.tile_ccl(m, tile, impl="cuda", doubling=True), 5)
        _, iters = K.tile_ccl(m, tile, impl="cuda", doubling=True, return_iterations=True)
        rows.append((kind, t1, t1d, int(iters.max()), int(iters.min())))
        for name, t in (("B1", t1), ("B1d", t1d)):
            if name not in worst or t > worst[name][0]:
                worst[name] = (t, kind, m_np)
        del m
    for name, (_, kind, m_np) in worst.items():
        m = torch.from_numpy(m_np).cuda().repeat(*reps).contiguous()
        require_equal(f"ccl-worst '{kind}' B1 against B1d", K.tile_ccl(m, tile, impl="cuda"),
                      K.tile_ccl(m, tile, impl="cuda", doubling=True))
        c = m[crop].contiguous()
        unit = K.tile_ccl_torch(c, tile)
        require_equal(f"ccl-worst '{kind}' crop, B1 (unit-step twin)", K.tile_ccl(c, tile, impl="cuda"), unit)
        require_equal(f"ccl-worst '{kind}' crop, B1d (unit-step twin)",
                      check_b1d(K, f"ccl-worst '{kind}' crop", c, tile)[0], unit)
        del m
    if any(hi != lo for *_, hi, lo in rows):
        raise AssertionError(f"ccl-worst: tiles of one kind took different iteration counts: {rows}")
    log("ccl-worst", f"B1 / B1d at {shape}, every tile one adversarial tile: "
                     + "; ".join(f"{k} {a:.3f} / {b:.3f} ms, {it} iterations" for k, a, b, it, _ in rows)
                     + f"; slowest B1 '{worst['B1'][1]}', B1d '{worst['B1d'][1]}': B1 == B1d there, and both "
                       f"equal the unit-step twin on a 2x4x2-tile crop")


def partition_equal(cc: torch.Tensor, ref: torch.Tensor) -> bool:
    """Same foreground, and labels in bijection over it."""
    fg = cc > 0
    if not torch.equal(fg, ref > 0):
        return False
    a, b = cc[fg].long(), ref[fg].long()
    pairs = torch.unique((a << 32) | b).numel()
    return pairs == torch.unique(a).numel() == torch.unique(b).numel()


def bw_run(K, tmp_root: str, tag: str, workflow_cls, block_shape, global_config=None, **params) -> dict:
    """One run of a port workflow on the card (its default target), in a
    fresh ``tmp_folder``: wall seconds (ended by a device sync), peak
    device memory, kernel launches and remap rungs of that run, the
    executor's summed stage times and its sweep summaries (one a task)
    from the tasks' success manifests.  ``global_config`` adds keys to the
    workflow's global config (``sweep_mode``, ``sharded_batch``, ...)."""
    from cluster_tools_tpu_torch.runtime.task import build as run_dag

    d = tempfile.mkdtemp(prefix=f"{tag}-", dir=tmp_root)
    os.makedirs(os.path.join(d, "cfg"))
    with open(os.path.join(d, "cfg", "global.config"), "w") as f:
        json.dump(dict({"block_shape": list(block_shape)}, **(global_config or {})), f)
    tmp = os.path.join(d, "tmp")
    wf = workflow_cls(tmp_folder=tmp, config_dir=os.path.join(d, "cfg"), max_jobs=8,
                      block_shape=list(block_shape), **params)
    K.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = run_dag([wf])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, rungs = dict(K.LAUNCHES), dict(K.RUNGS)
    manifests = [json.load(open(os.path.join(tmp, f))) for f in sorted(os.listdir(tmp)) if f.endswith(".success.json")]
    if not ok:
        logs = "".join(open(os.path.join(tmp, f)).read()[-3000:] for f in sorted(os.listdir(tmp)) if f.endswith(".log"))
        raise AssertionError(f"blockwise {tag}: the workflow failed; task logs:\n{logs}")
    shutil.rmtree(d)
    sweep = Counter()
    for m in manifests:
        sweep.update({k: v for k, v in m.get("sweep", {}).items() if k.endswith("_s")})
    overflow = sorted(b for m in manifests for b in m.get("overflow_blocks", []))
    return dict(wall_s=wall, peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches, rungs=rungs,
                sweep=dict(sweep), overflow_blocks=overflow, sweeps=[m["sweep"] for m in manifests if "sweep" in m])


def bw_timed(K, tmp_root: str, tag: str, workflow_cls, block_shape, voxels: int, n_blocks: int,
             phase: str = "blockwise", global_config=None, **params) -> dict:
    """A warm-up and two timed runs; prints the workflow's line (under
    ``phase``) and returns the second timed run's record with ``wall_s``
    the median of the two."""
    bw_run(K, tmp_root, tag, workflow_cls, block_shape, global_config, **params)
    runs = [bw_run(K, tmp_root, tag, workflow_cls, block_shape, global_config, **params) for _ in range(2)]
    rec = dict(runs[-1], wall_s=float(np.median([r["wall_s"] for r in runs])))
    sw = rec["sweep"]
    log(phase, f"{tag}: {voxels} voxels, {n_blocks} blocks; wall "
                     + "/".join(f"{r['wall_s']:.3f}" for r in runs) + f" s, median {rec['wall_s']:.3f} s = "
                     f"{voxels / rec['wall_s']:.4g} voxels/s, {n_blocks / rec['wall_s']:.4g} blocks/s; "
                     f"peak {rec['peak_gb']:.2f} GB; executor load {sw.get('load_s', 0) * 1e3:.1f}, "
                     f"h2d {sw.get('h2d_s', 0) * 1e3:.1f}, kernel {sw.get('kernel_s', 0) * 1e3:.1f} (synced), "
                     f"d2h {sw.get('d2h_s', 0) * 1e3:.1f}, store {sw.get('store_s', 0) * 1e3:.1f} ms; "
                     f"launches {rec['launches']}; rungs {rec['rungs']}; overflow blocks {rec['overflow_blocks']}")
    return rec


def bw_replay(K, tmp_root: str, tag: str, workflow_cls, block_shape, **params) -> dict:
    """Every kernel launch of one run of a workflow replayed on the inputs
    it was given: equal to its twin, and timed as the "main-kernels" replay
    is.  Returns ``{kernel: (launches, ms summed, bound ms summed)}``."""
    with K.capture_inputs() as captured:
        bw_run(K, tmp_root, tag, workflow_cls, block_shape, **params)
    out = {}
    for i, (kname, kargs, kkw) in enumerate(captured):
        kfn, tfn = replay(K, kname, kargs, kkw)
        require_equal(f"blockwise {tag}: {kname} launch {i}", kfn(), tfn())
        n, ms, bound = out.get(kname, (0, 0.0, 0.0))
        out[kname] = (n + 1, ms + cuda_ms(kfn, 3), bound + bound_ms(kname, kargs, kkw)[0])
    captured.clear()
    log("blockwise-kernels", f"{tag}: every launch of one run equals its twin; "
        + "; ".join(f"{k} {n} launches, {ms:.3f} ms (bound {b:.3f} ms)" for k, (n, ms, b) in sorted(out.items())))
    return out


def phase_blockwise(K, vol: torch.Tensor, ref: np.ndarray, rows: list, block=(128, 128, 128)) -> str:
    """BASELINE configs 1-3 through the port's workflows on the card, on the
    main path's volume in ``memory://``: cc (block 128^3) against
    ``scipy.ndimage.label``; single- and two-pass watershed (block 128^3,
    halo 32) against their ``impl="torch"`` runs, bit for bit, every kernel
    launch replayed against its twin; relabel of the two-pass output; the cc
    workflow at 256^3 through the port's zarr on local disk against its
    ``memory://`` run (half the volume's extent per axis: 256^3).  Adds ``blockwise_launches`` / ``blockwise_ms`` to
    the kernel rows.  Returns the ``memory://`` container's path, which
    keeps the boundaries and the single-pass watershed output ("ws") for
    the "multicut" phase, and the timed records of the cc, ws and ws2 runs
    (the tasks' default ``sweep_mode="auto"``) for the "sweeps" phase."""
    from cluster_tools_tpu_torch.io.containers import MemoryContainer, open_container
    from cluster_tools_tpu_torch.tasks.connected_components import ConnectedComponentsWorkflow
    from cluster_tools_tpu_torch.tasks.relabel import RelabelWorkflow
    from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow

    t_phase = time.perf_counter()
    os.environ["CT_FILL_MODE"], os.environ["CT_TIER_MODE"] = "capacity", "cond"
    mem = "memory://blockwise"
    f = open_container(mem)
    b_np = vol.reshape(vol.shape[-3:]).cpu().numpy()
    shape = b_np.shape
    voxels = int(np.prod(shape))
    n_blocks = int(np.prod([-(-s // b) for s, b in zip(shape, block)]))
    f.require_dataset("boundaries", shape=shape, chunks=block, dtype="float32")[...] = b_np
    mask = (b_np < np.float32(0.45)).astype(np.uint8)
    f.require_dataset("mask", shape=shape, chunks=block, dtype="uint8")[...] = mask
    del b_np
    io = dict(input_path=mem, output_path=mem)
    ws_cfg = dict(halo=[32, 32, 32], threshold=0.45, dt_max_distance=32.0, min_seed_distance=2.0)
    bw_rows = {}
    with tempfile.TemporaryDirectory(prefix="blockwise-") as tmp_root:
        # config 1: connected components
        cc = bw_timed(K, tmp_root, "cc", ConnectedComponentsWorkflow, block, voxels, n_blocks,
                      input_key="mask", output_key="cc", connectivity=1, **io)
        got = torch.from_numpy(f["cc"][...].astype(np.int64)).cuda()
        if not partition_equal(got, torch.from_numpy(ref.astype(np.int64)).cuda()):
            raise AssertionError("blockwise cc: labels are not scipy.ndimage.label's partition")
        n_cc = int(got.max())
        del got
        bw_rows["cc"] = cc["launches"]
        auto = {"cc": cc}
        # configs 2 and 3: single- and two-pass watershed, each against its twins
        for tag, two_pass in (("ws", False), ("ws2", True)):
            rec = bw_timed(K, tmp_root, tag, WatershedWorkflow, block, voxels, n_blocks, input_key="boundaries",
                           output_key=tag, two_pass=two_pass, **ws_cfg, **io)
            auto[tag] = rec
            missing = [k for k in MAIN_PATH_KERNELS if rec["launches"].get(k, 0) == 0]
            if missing:
                raise AssertionError(f"blockwise {tag}: the workflow launched no {missing}")
            t0 = time.perf_counter()
            twin = bw_run(K, tmp_root, tag + "-torch", WatershedWorkflow, block, input_key="boundaries",
                          output_key=tag + "_torch", two_pass=two_pass, impl="torch", **ws_cfg, **io)
            if sum(twin["launches"].values()):
                raise AssertionError(f"blockwise {tag}: impl='torch' launched kernels: {twin['launches']}")
            if not np.array_equal(f[tag][...], f[tag + "_torch"][...]):
                raise AssertionError(f"blockwise {tag}: impl='torch' output differs from the kernels'")
            replayed = bw_replay(K, tmp_root, tag, WatershedWorkflow, block, input_key="boundaries",
                                 output_key=tag, two_pass=two_pass, **ws_cfg, **io)
            log("blockwise", f"{tag}: impl=torch run ({time.perf_counter() - t0:.1f} s with the replay) equals "
                             f"the kernels' output bit for bit; overflow blocks {rec['overflow_blocks']}")
            bw_rows[tag] = replayed
        # relabel the two-pass output to 1..K
        bw_timed(K, tmp_root, "relabel", RelabelWorkflow, block, voxels, n_blocks, input_key="ws2",
                 output_key="ws2_relabel", **io)
        a = torch.from_numpy(f["ws2"][...].astype(np.int64)).cuda()
        r = torch.from_numpy(f["ws2_relabel"][...].astype(np.int64)).cuda()
        k = int(torch.unique(a).numel()) - int(bool((a == 0).any()))
        if not partition_equal(r, a) or int(r.max()) != k or int(torch.unique(r[r > 0]).numel()) != k:
            raise AssertionError("blockwise relabel: labels are not 1..K with the two-pass partition")
        del a, r
        # the file path: cc on half the extent through the port's zarr (zlib) on local disk
        half = tuple(s // 2 for s in shape)
        sub = tuple(slice(0, h) for h in half)
        disk = os.path.join(tmp_root, "cc256.zarr")
        open_container(disk).require_dataset("mask", shape=half, chunks=block, dtype="uint8")[...] = mask[sub]
        f.require_dataset("mask256", shape=half, chunks=block, dtype="uint8")[...] = mask[sub]
        t0 = time.perf_counter()
        bw_run(K, tmp_root, "cc256-disk", ConnectedComponentsWorkflow, block, input_path=disk, input_key="mask",
               output_path=disk, output_key="cc")
        t_disk = time.perf_counter() - t0
        bw_run(K, tmp_root, "cc256-memory", ConnectedComponentsWorkflow, block, input_path=mem,
               input_key="mask256", output_path=mem, output_key="cc256")
        on_disk = open_container(disk)["cc"]
        meta = json.load(open(os.path.join(disk, "cc", ".zarray")))
        if meta["compressor"] != {"id": "zlib", "level": 1} or not np.array_equal(on_disk[...], f["cc256"][...]):
            raise AssertionError("blockwise cc256: the on-disk zarr run differs from the memory:// run")
        log("blockwise", f"cc at {half} through the port's zarr on local disk (zlib level 1, {t_disk:.2f} s) "
                         f"equals its memory:// run")
    for row in rows:
        name = row["name"]
        row["blockwise_launches"] = {t: (v.get(name, (0,))[0] if t != "cc" else v.get(name, 0))
                                     for t, v in bw_rows.items()}
        row["blockwise_ms"] = {t: v.get(name, (0, 0.0))[1] for t, v in bw_rows.items() if t != "cc"}
    log("blockwise", f"cc {n_cc} components = scipy partition; relabel 1..{k}; phase "
                     f"{time.perf_counter() - t_phase:.1f} s")
    return mem, auto


def sweep_stats(rec: dict) -> dict:
    """One run's sweep summaries folded over its tasks."""
    sw = rec["sweeps"]
    return dict(modes=sorted({x["sweep_mode"] for x in sw}),
                rungs=sorted({r for x in sw for r in x.get("batch_rungs", [])}),
                n_dispatches=sum(x["n_dispatches"] for x in sw),
                ragged_batches=sum(x["ragged_batches"] for x in sw),
                lanes_padded=sum(x["lanes_padded"] for x in sw),
                h2d_bytes=sum(x["h2d_bytes"] for x in sw),
                device_pool_hits=sum(x["device_pool_hits"] for x in sw),
                device_pool_misses=sum(x["device_pool_misses"] for x in sw),
                kernel_s=sum(x["kernel_s"] for x in sw))


def phase_sweeps(K, mem: str, auto: dict, main_s_per_voxel: float, rows: list, block=(128, 128, 128)) -> None:
    """The executor's sweep plane at full size: the "blockwise" phase's
    volume (512^3, block 128^3, 64 blocks, batch 8).  The single-pass
    watershed, the two-pass watershed and cc run with
    ``sweep_mode="per_block"`` beside the "blockwise" phase's runs, whose
    tasks' default ``"auto"`` must have resolved to ``sharded`` with the
    ``batched`` rung; the output files must be equal bit for bit.  Per mode:
    the wall (median of two after a warm-up), blocks/s, the calls to the
    device, the summed kernel seconds, peak memory and the fixed cost a
    block (wall a block minus the main path's per-voxel time over the
    block's outer voxels).  Then the ragged tail (``sharded_batch=12``: 64 =
    5 x 12 + 4) and the device page pool (one ragged sweep twice with
    ``device_pool="on"``: the second must send fewer bytes to the card),
    each equal to the per-block file.  The kernel rows gain
    ``sweep_launches`` (one batched run of each workflow)."""
    from cluster_tools_tpu_torch.io.containers import open_container
    from cluster_tools_tpu_torch.parallel import device_pool
    from cluster_tools_tpu_torch.tasks.connected_components import ConnectedComponentsWorkflow
    from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow

    t_phase = time.perf_counter()
    os.environ["CT_FILL_MODE"], os.environ["CT_TIER_MODE"] = "capacity", "cond"
    f = open_container(mem)
    shape = f["boundaries"].shape
    voxels = int(np.prod(shape))
    n_blocks = int(np.prod([-(-s // b) for s, b in zip(shape, block)]))
    io = dict(input_path=mem, output_path=mem)
    ws_cfg = dict(halo=[32, 32, 32], threshold=0.45, dt_max_distance=32.0, min_seed_distance=2.0)
    cases = {
        "ws": (WatershedWorkflow, dict(input_key="boundaries", two_pass=False, **ws_cfg), 32),
        "ws2": (WatershedWorkflow, dict(input_key="boundaries", two_pass=True, **ws_cfg), 32),
        "cc": (ConnectedComponentsWorkflow, dict(input_key="mask", connectivity=1), 0),
    }
    with tempfile.TemporaryDirectory(prefix="sweeps-") as tmp_root:
        for tag, (cls, params, halo) in cases.items():
            st = sweep_stats(auto[tag])
            if st["modes"] != ["sharded"] or st["rungs"] != ["batched"]:
                raise AssertionError(f"sweeps {tag}: sweep_mode='auto' ran {st['modes']} with rungs {st['rungs']}, "
                                     "expected sharded with the batched rung")
            pb = bw_timed(K, tmp_root, f"{tag}-per_block", cls, block, voxels, n_blocks, phase="sweeps",
                          global_config={"sweep_mode": "per_block"}, output_key=f"{tag}_pb", **params, **io)
            st_pb = sweep_stats(pb)
            if st_pb["modes"] != ["per_block"]:
                raise AssertionError(f"sweeps {tag}: per_block ran {st_pb['modes']}")
            if not np.array_equal(f[tag][...], f[f"{tag}_pb"][...]):
                raise AssertionError(f"sweeps {tag}: the sharded (auto) file differs from the per-block file")
            outer = int(np.prod([b + 2 * halo for b in block]))
            for mode, rec, stt in (("per_block", pb, st_pb), ("auto", auto[tag], st)):
                fixed_ms = (rec["wall_s"] / n_blocks - main_s_per_voxel * outer) * 1e3
                log("sweeps", f"{tag} {mode}: wall {rec['wall_s']:.3f} s, {n_blocks / rec['wall_s']:.4g} blocks/s, "
                              f"{stt['n_dispatches']} calls to the device, kernel {stt['kernel_s']:.3f} s (synced), "
                              f"peak {rec['peak_gb']:.2f} GB, fixed cost {fixed_ms:.1f} ms a block "
                              f"({rec['wall_s'] / n_blocks * 1e3:.1f} ms a block less "
                              f"{main_s_per_voxel * outer * 1e3:.1f} ms for {outer} voxels at the main path's "
                              f"rate); rungs {stt['rungs']}")
            log("sweeps", f"{tag}: auto -> sharded, rung batched, equal to per_block bit for bit; kernel launches "
                          f"of one batched run {auto[tag]['launches']} (per block {pb['launches']})")
        # the ragged tail: 64 = 5 x 12 + 4 blocks
        ws_case = cases["ws"][1]
        rag = bw_run(K, tmp_root, "ws-ragged", WatershedWorkflow, block, {"sharded_batch": 12},
                     output_key="ws_ragged", **ws_case, **io)
        st = sweep_stats(rag)
        if st["ragged_batches"] < 1 or st["lanes_padded"] != 8 or st["rungs"] != ["batched"]:
            raise AssertionError(f"sweeps ragged: {st}")
        if not np.array_equal(f["ws_ragged"][...], f["ws_pb"][...]):
            raise AssertionError("sweeps ragged: the file differs from the per-block file")
        log("sweeps", f"ws sharded_batch=12: wall {rag['wall_s']:.3f} s, {st['n_dispatches']} calls, "
                      f"{st['ragged_batches']} ragged batch(es), {st['lanes_padded']} padding lanes; equal to "
                      "per_block bit for bit")
        # the device page pool: the same ragged sweep twice
        device_pool.reset()
        gc = {"sharded_batch": 12, "device_pool": "on", "device_pool_bytes": 1 << 30}
        pool_runs = []
        for i in range(2):
            r = bw_run(K, tmp_root, f"ws-pool{i}", WatershedWorkflow, block, gc, output_key=f"ws_pool{i}",
                       **ws_case, **io)
            if not np.array_equal(f[f"ws_pool{i}"][...], f["ws_pb"][...]):
                raise AssertionError(f"sweeps device pool run {i}: the file differs from the per-block file")
            pool_runs.append(sweep_stats(r))
            log("sweeps", f"ws device_pool=on run {i + 1}: wall {r['wall_s']:.3f} s, h2d_bytes "
                          f"{pool_runs[-1]['h2d_bytes']}, device_pool_hits {pool_runs[-1]['device_pool_hits']}, "
                          f"misses {pool_runs[-1]['device_pool_misses']}; equal to per_block bit for bit")
        if not pool_runs[1]["h2d_bytes"] < pool_runs[0]["h2d_bytes"]:
            raise AssertionError(f"sweeps device pool: the warm run sent {pool_runs[1]['h2d_bytes']} bytes, "
                                 f"the cold run {pool_runs[0]['h2d_bytes']}")
        device_pool.reset()
        torch.cuda.empty_cache()
    for row in rows:
        row["sweep_launches"] = {t: auto[t]["launches"].get(row["name"], 0) for t in cases}
    log("sweeps", f"phase {time.perf_counter() - t_phase:.1f} s")


def oracle_graph(ds, shape, block):
    """The merged RAG of a label dataset by the plain numpy oracle: per
    block ``_block_rag_host`` on the block with its +1 upper halo, then one
    lexsort over all blocks' rows with the sizes summed, and the nodes from
    per-block ``np.unique``; ``(nodes, uv, sizes)``."""
    from concurrent.futures import ThreadPoolExecutor

    from cluster_tools_tpu_torch.ops.rag import _block_rag_host

    grid = [range(0, s, b) for s, b in zip(shape, block)]

    def one(begin):
        inner = tuple(min(b, s - o) for o, b, s in zip(begin, block, shape))
        seg = ds[tuple(slice(o, min(o + b + 1, s)) for o, b, s in zip(begin, block, shape))]
        uv, sizes, _ = _block_rag_host(seg, None, inner)
        return uv, sizes, np.unique(seg[tuple(slice(0, i) for i in inner)])

    with ThreadPoolExecutor(8) as pool:
        parts = list(pool.map(one, [(z, y, x) for z in grid[0] for y in grid[1] for x in grid[2]]))
    uv = np.concatenate([p[0] for p in parts])
    sizes = np.concatenate([p[1] for p in parts])
    order = np.lexsort((uv[:, 1], uv[:, 0]))
    uv, sizes = uv[order], sizes[order]
    first = np.ones(len(uv), bool)
    first[1:] = (uv[1:] != uv[:-1]).any(1)
    nodes = np.unique(np.concatenate([p[2] for p in parts]))
    return nodes[nodes != 0], uv[first], np.add.reduceat(sizes, np.flatnonzero(first))


def wf_run(K, tmp_folder: str, cfg_dir: str, workflow_cls, **params) -> dict:
    """One build of a workflow on the card in ``tmp_folder`` (kept, so a
    later workflow can reuse its finished tasks): wall seconds (ended by a
    device sync), peak device memory, kernel launches, and each task's
    success manifest by task name."""
    from cluster_tools_tpu_torch.runtime.task import build as run_dag

    before = set(os.listdir(tmp_folder)) if os.path.isdir(tmp_folder) else set()
    wf = workflow_cls(tmp_folder=tmp_folder, config_dir=cfg_dir, max_jobs=8, **params)
    K.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = run_dag([wf])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not ok:
        logs = "".join(open(os.path.join(tmp_folder, f)).read()[-3000:] for f in sorted(os.listdir(tmp_folder))
                       if f.endswith(".log"))
        raise AssertionError(f"multicut: {workflow_cls.__name__} failed; task logs:\n{logs}")
    tasks = {}
    for f in sorted(set(os.listdir(tmp_folder)) - before):
        if f.endswith(".success.json"):
            tasks[f.split(".")[0]] = json.load(open(os.path.join(tmp_folder, f)))
    return dict(wall_s=wall, peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=dict(K.LAUNCHES),
                tasks=tasks)


MC_TASKS = ("initial_sub_graphs", "merge_sub_graphs", "map_edge_ids", "block_edge_features", "merge_edge_features",
            "probs_to_costs", "solve_subproblems", "reduce_problem", "solve_global", "write")


def phase_multicut(K, vol: torch.Tensor, ws_crop: np.ndarray, mem: str, rows: list, block=(128, 128, 128)) -> None:
    """BASELINE config 4 on the card.

    1. The bench's config-4 shape: ``block_rag_fused`` + ``gaec_parallel``
       (torch rung) on the first ``CONFIG4_CROP``^3 of the main path's
       watershed labels, cold and warm (best of 3), extraction apart from
       solve, against the numpy oracle (``_block_rag_host`` + the numpy
       rung): edges and counts equal, and the torch rung's labels on the
       card equal its labels on the CPU and the numpy rung's, or else its
       energy is within 2% of the numpy rung's.
    2. ``MulticutSegmentationWorkflow`` on the "blockwise" phase's 512^3
       single-pass watershed (``skip_ws``, ``n_scales=1``,
       ``agglomerator="gaec_parallel"``, block 128^3): per-task wall times,
       graph size, energy, rounds, peak memory; the merged graph equals the
       numpy oracle's, ``seg > 0`` equals ``ws > 0`` and ``seg`` is the
       assignment table applied to ``ws``.  Then
       ``AgglomerativeClusteringWorkflow`` in the same ``tmp_folder``
       (graph and features reused).
    3. The default workflow (Kernighan-Lin global solve, its own
       watershed: B1-B4 launch) on the first ``MC_DEFAULT_CROP``^3 (block
       64^3); and the single-pass watershed with
       ``agglomerate_threshold=0.5`` on the first ``CONFIG4_CROP``^3
       (block 128^3) against its ``impl="torch"`` run, bit for bit.
    Adds ``multicut_launches`` (the kernels' launches in 3's watershed) to
    the kernel rows.
    """
    from cluster_tools_tpu_torch.io.containers import MemoryContainer, open_container
    from cluster_tools_tpu_torch.ops.contraction import gaec_parallel, solver_delta, solver_snapshot
    from cluster_tools_tpu_torch.ops.multicut import multicut_energy
    from cluster_tools_tpu_torch.ops.rag import _block_rag_host, block_rag_fused
    from cluster_tools_tpu_torch.tasks.graph import load_global_graph
    from cluster_tools_tpu_torch.tasks.multicut import assignments_path
    from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow
    from cluster_tools_tpu_torch.workflows import AgglomerativeClusteringWorkflow, MulticutSegmentationWorkflow

    t_phase = time.perf_counter()
    n = CONFIG4_CROP
    bnd = vol[0, :n, :n, :n].cpu().numpy()

    # ---- 1. the config-4 shape: fused RAG + parallel GAEC ----
    def fused_once():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nodes, edges, costs, sizes, _ = block_rag_fused(ws_crop, bnd, device="cuda")
        t1 = time.perf_counter()
        snap = solver_snapshot()
        labels = gaec_parallel(len(nodes), edges, costs, impl="torch", device="cuda")
        t2 = time.perf_counter()
        return t1 - t0, t2 - t1, (nodes, edges, costs, sizes, labels, solver_delta(snap)["solver_rounds"])

    cold_ex, cold_solve, _ = fused_once()
    warm = [fused_once() for _ in range(3)]
    warm_ex, warm_solve = min(w[0] for w in warm), min(w[1] for w in warm)
    nodes, edges, costs, sizes, lab_cuda, rounds = warm[-1][2]
    t0 = time.perf_counter()
    uv_h, sz_h, _ = _block_rag_host(ws_crop, bnd, ws_crop.shape)
    host_ex = time.perf_counter() - t0
    t0 = time.perf_counter()
    lab_np = gaec_parallel(len(nodes), edges, costs, impl="numpy")
    host_solve = time.perf_counter() - t0
    if not (np.array_equal(nodes[edges].astype(np.uint64), uv_h) and np.array_equal(sizes, sz_h)):
        raise AssertionError("config 4: the fused RAG's edges or counts differ from the numpy oracle's")
    lab_cpu = gaec_parallel(len(nodes), edges, costs, impl="torch", device="cpu")
    diff_cpu, diff_np = int((lab_cuda != lab_cpu).sum()), int((lab_cuda != lab_np).sum())
    e_cuda, e_np = multicut_energy(edges, costs, lab_cuda), multicut_energy(edges, costs, lab_np)
    if (diff_cpu or diff_np) and not e_cuda <= e_np + 0.02 * abs(e_np):
        raise AssertionError(f"config 4: torch-rung labels differ (CPU {diff_cpu}, numpy {diff_np} nodes) and "
                             f"its energy {e_cuda} is not within 2% of the numpy rung's {e_np}")
    log("multicut", f"config-4 shape: fused RAG + gaec_parallel (torch rung) on the main path's ws labels "
                    f"{ws_crop.shape}: {len(nodes)} nodes, {len(edges)} edges; cold {cold_ex + cold_solve:.3f} s "
                    f"(extract {cold_ex:.3f} + solve {cold_solve:.3f}); warm best of 3 "
                    f"{warm_ex + warm_solve:.3f} s (extract {warm_ex:.3f} + solve {warm_solve:.3f}, {rounds} rounds); "
                    f"numpy oracle "
                    f"extract {host_ex:.3f} + numpy rung {host_solve:.3f} s; edges and counts = oracle; labels "
                    f"differ from the CPU torch rung at {diff_cpu} and from the numpy rung at {diff_np} nodes; "
                    f"energy {e_cuda:.6g} (numpy rung {e_np:.6g}); {len(np.unique(lab_cuda))} segments")

    # ---- 2. the multicut and agglomerative workflows at 512^3 ----
    f = open_container(mem)
    shape = f["ws"].shape
    with tempfile.TemporaryDirectory(prefix="multicut-") as root:
        cfg_dir = os.path.join(root, "cfg")
        os.makedirs(cfg_dir)
        with open(os.path.join(cfg_dir, "global.config"), "w") as fh:
            json.dump({"block_shape": list(block)}, fh)
        tmp = os.path.join(root, "tmp")
        io = dict(input_path=mem, input_key="boundaries", ws_path=mem, ws_key="ws", skip_ws=True,
                  output_path=mem, block_shape=list(block))
        rec = wf_run(K, tmp, cfg_dir, MulticutSegmentationWorkflow, output_key="mc_seg", n_scales=1,
                     agglomerator="gaec_parallel", **io)
        t = rec["tasks"]
        missing = [k for k in MC_TASKS if k not in t]
        if missing:
            raise AssertionError(f"multicut: no success manifest for {missing}")
        rounds = t["solve_subproblems"]["solver"]["rounds"] + t["solve_global"]["solver"]["rounds"]
        log("multicut", f"MulticutSegmentationWorkflow {shape}, block {block}, skip_ws, n_scales 1, gaec_parallel: "
                        f"wall {rec['wall_s']:.3f} s; tasks "
                        + ", ".join(f"{k} {t[k]['runtime_s']:.3f}" for k in MC_TASKS)
                        + f" s; {t['merge_sub_graphs']['n_nodes']} nodes, {t['merge_sub_graphs']['n_edges']} edges, "
                        f"{t['solve_global']['n_segments']} segments, energy {t['solve_global']['energy']:.6g}, "
                        f"rounds {rounds} (subproblems {t['solve_subproblems']['solver']['rounds']} in "
                        f"{t['solve_subproblems']['solver']['solver_calls']} solve of {t['solve_subproblems']['n_subproblems']} "
                        f"blocks, global "
                        f"{t['solve_global']['solver']['rounds']}); peak {rec['peak_gb']:.2f} GB")
        t0 = time.perf_counter()
        nodes_g, uv_g, _, sizes_g = load_global_graph(tmp)
        nodes_o, uv_o, sizes_o = oracle_graph(f["ws"], shape, block)
        for what, a, b in (("nodes", nodes_g, nodes_o), ("uv", uv_g, uv_o), ("sizes", sizes_g, sizes_o)):
            if not np.array_equal(a, b):
                raise AssertionError(f"multicut: the merged graph's {what} differ from the numpy oracle's")
        t_oracle = time.perf_counter() - t0
        a = np.load(assignments_path(tmp))
        keys = torch.from_numpy(a["keys"].view(np.int64)).cuda()
        values = torch.from_numpy(a["values"].view(np.int64)).cuda()
        ws = torch.from_numpy(f["ws"][...].view(np.int64)).cuda()
        seg = torch.from_numpy(f["mc_seg"][...].view(np.int64)).cuda()
        if not torch.equal(seg > 0, ws > 0):
            raise AssertionError("multicut: seg > 0 differs from ws > 0")
        idx = torch.searchsorted(keys, ws).clamp_max(keys.numel() - 1)
        want = torch.where((keys[idx] == ws) & (ws != 0), values[idx], 0)
        if not torch.equal(seg, want):
            raise AssertionError("multicut: seg is not the assignment table applied to ws")
        del ws, seg, want, idx
        log("multicut", f"merged graph = the numpy oracle's (nodes, uv, sizes; {t_oracle:.1f} s); seg > 0 = ws > 0; "
                        f"seg = the assignment table applied to ws")
        rec = wf_run(K, tmp, cfg_dir, AgglomerativeClusteringWorkflow, output_key="ac_seg", **io)
        ac = rec["tasks"]["agglomerative_clustering"]
        log("multicut", f"AgglomerativeClusteringWorkflow in the same tmp_folder (graph and features reused): wall "
                        f"{rec['wall_s']:.3f} s, solve {ac['runtime_s']:.3f} s, {ac['n_clusters']} clusters of "
                        f"{ac['n_nodes']} nodes, rounds {ac['solver']['rounds']}, write "
                        f"{rec['tasks']['write']['runtime_s']:.3f} s")

        # ---- 3. the default solver, and the in-block agglomeration, on crops ----
        c = MC_DEFAULT_CROP
        sub = tuple(slice(0, c) for _ in range(3))
        f.require_dataset("boundaries_crop", shape=(c,) * 3, chunks=(c // 2,) * 3,
                          dtype="float32")[...] = f["boundaries"][sub]
        ws_cfg = dict(halo=[32, 32, 32], threshold=0.45, min_seed_distance=2.0)
        rec = wf_run(K, os.path.join(root, "default"), cfg_dir, MulticutSegmentationWorkflow,
                     input_path=mem, input_key="boundaries_crop", ws_path=mem, ws_key="ws_crop", output_path=mem,
                     output_key="mc_crop", block_shape=[c // 2] * 3, **ws_cfg)
        launches = rec["launches"]
        missing = [k for k in MAIN_PATH_KERNELS if launches.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"multicut: the default workflow's watershed launched no {missing}")
        seg, ws = f["mc_crop"][...], f["ws_crop"][...]
        if not np.array_equal(seg > 0, ws > 0):
            raise AssertionError("multicut (default): seg > 0 differs from ws > 0")
        t = rec["tasks"]
        log("multicut", f"default MulticutSegmentationWorkflow (watershed, Kernighan-Lin global solve) on {(c,) * 3}, "
                        f"block {(c // 2,) * 3}: wall {rec['wall_s']:.3f} s (watershed {t['watershed']['runtime_s']:.3f}, "
                        f"solve_global {t['solve_global']['runtime_s']:.3f} s); "
                        f"{t['merge_sub_graphs']['n_nodes']} fragments -> {t['solve_global']['n_segments']} segments; "
                        f"launches {launches}")
        for row in rows:
            row["multicut_launches"] = launches.get(row["name"], 0)

        half = tuple(slice(0, n) for _ in range(3))
        f.require_dataset("boundaries_half", shape=(n,) * 3, chunks=block, dtype="float32")[...] = \
            f["boundaries"][half]
        agg = dict(input_path=mem, input_key="boundaries_half", output_path=mem, block_shape=list(block),
                   agglomerate_threshold=0.5, dt_max_distance=32.0, **ws_cfg)
        recs = {impl: wf_run(K, os.path.join(root, f"agg-{impl}"), cfg_dir, WatershedWorkflow, output_key=f"agg_{impl}",
                             impl=impl, **agg) for impl in ("auto", "torch")}
        if sum(recs["torch"]["launches"].values()):
            raise AssertionError(f"multicut: impl='torch' launched kernels: {recs['torch']['launches']}")
        a, b = f["agg_auto"][...], f["agg_torch"][...]
        if not np.array_equal(a, b):
            raise AssertionError("multicut: the agglomerating watershed's impl='torch' output differs from the kernels'")
        log("multicut", f"single-pass watershed with agglomerate_threshold=0.5 on {(n,) * 3}, block {block}: "
                        f"{recs['auto']['wall_s']:.3f} s (impl=torch {recs['torch']['wall_s']:.3f} s), "
                        f"{len(np.unique(a)) - int((a == 0).any())} segments; equals its impl='torch' run bit for bit; "
                        f"launches {recs['auto']['launches']}")
    del MemoryContainer._registry[mem]
    log("multicut", f"phase {time.perf_counter() - t_phase:.1f} s")


# the fusion phase's cc arm: cut from the main path's 512 to 256, since the
# whole smoke at 512 passes half its time limit (the arm's line says so)
FUSION_CC_EDGE = 256
# tmp_folder files that are bookkeeping, not a producer -> consumer hop
FUSION_BOOKKEEPING = (".success.json", ".log", ".ckpt.npz", "failures.json", "io_metrics.json", ".lock")


def intermediate_bytes(container: str, keep, tmp_folder: str):
    """Bytes of the intermediate files a run wrote to storage, and the
    paths (relative) of the largest: every dataset of ``container`` but
    ``keep`` (the input and the final output), and every file under
    ``tmp_folder`` but the manifests, logs, ``failures.json``,
    ``io_metrics.json``, solver checkpoints (``*.ckpt.npz``) and the block
    markers."""
    files = []
    if os.path.isdir(container):
        for key in sorted(os.listdir(container)):
            if key in keep or not os.path.isdir(os.path.join(container, key)):
                continue
            for dirpath, _, names in os.walk(os.path.join(container, key)):
                files += [os.path.join(dirpath, n) for n in names]
    for dirpath, dirs, names in os.walk(tmp_folder):
        dirs[:] = [d for d in dirs if d != "markers"]
        files += [os.path.join(dirpath, n) for n in names if not n.endswith(FUSION_BOOKKEEPING)]
    sizes = {f: os.path.getsize(f) for f in files if os.path.exists(f)}
    top = sorted(sizes, key=sizes.get, reverse=True)[:3]
    return sum(sizes.values()), [os.path.relpath(f, os.path.dirname(tmp_folder)) for f in top]


def fusion_arm(K, root: str, tag: str, workflow_cls, memory_handoffs: bool, out_container: str, keep,
               block, **params) -> dict:
    """One cold build of a workflow on the card in a fresh ``tmp_folder``
    with ``memory_handoffs`` off or on: wall seconds (ended by a device
    sync), per-task seconds and sweep summaries from the manifests, kernel
    launches, peak and reserved device memory, the handoff and device-plane
    counters summed over ``io_metrics.json``, the handoffs that spilled
    (``degraded:spilled`` in ``failures.json``) and the intermediate bytes
    written to storage.  The handoff registry starts empty and is emptied
    after (its payloads are this process's RAM)."""
    from cluster_tools_tpu_torch.runtime import handoff
    from cluster_tools_tpu_torch.runtime.task import build as run_dag

    d = os.path.join(root, tag)
    os.makedirs(os.path.join(d, "cfg"))
    with open(os.path.join(d, "cfg", "global.config"), "w") as fh:
        json.dump({"block_shape": list(block), "memory_handoffs": memory_handoffs}, fh)
    tmp = os.path.join(d, "tmp")
    handoff.reset()
    wf = workflow_cls(tmp_folder=tmp, config_dir=os.path.join(d, "cfg"), max_jobs=8, block_shape=list(block),
                      **params)
    K.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = run_dag([wf])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak_gb, reserved_gb = torch.cuda.max_memory_allocated() / 1e9, torch.cuda.memory_reserved() / 1e9
    if not ok:
        logs = "".join(open(os.path.join(tmp, f)).read()[-3000:] for f in sorted(os.listdir(tmp)) if f.endswith(".log"))
        raise AssertionError(f"fusion {tag}: the workflow failed; task logs:\n{logs}")
    tasks = {}
    for f in sorted(os.listdir(tmp)):
        if f.endswith(".success.json") and not f.split(".")[0].endswith("_workflow"):
            tasks[f.split(".")[0]] = json.load(open(os.path.join(tmp, f)))
    counters = Counter()
    io_path = os.path.join(tmp, "io_metrics.json")
    if os.path.exists(io_path):
        for m in json.load(open(io_path))["tasks"].values():
            counters.update({k: v for k, v in m.items() if isinstance(v, (int, float))})
    spills = []
    fail_path = os.path.join(tmp, "failures.json")
    if os.path.exists(fail_path):
        spills = [(r["task"].split(".")[0], str(r["handoff"]).replace(root + os.sep, ""), r["reason"])
                  for r in json.load(open(fail_path))["records"] if r.get("resolution") == "degraded:spilled"]
    inter, top = intermediate_bytes(out_container, keep, tmp)
    handoff.reset()
    sweep = Counter()
    for m in tasks.values():
        sweep.update({k: v for k, v in m.get("sweep", {}).items() if k in ("load_s", "store_s")})
    return dict(wall_s=wall, tasks={k: m["runtime_s"] for k, m in tasks.items() if "runtime_s" in m},
                launches=launches, peak_gb=peak_gb, reserved_gb=reserved_gb, counters=dict(counters), spills=spills,
                inter_bytes=inter, inter_top=top, sweep=dict(sweep))


HANDOFF_COUNTERS = ("handoffs_published", "handoffs_served", "handoffs_spilled", "handoff_fallbacks",
                    "bytes_not_stored", "bytes_spilled")


def fusion_line(tag: str, rec: dict) -> str:
    c = rec["counters"]
    return (f"{tag}: wall {rec['wall_s']:.3f} s; tasks " + ", ".join(f"{k} {v:.3f}" for k, v in rec["tasks"].items())
            + f" s; launches {rec['launches']}; handoffs " + ", ".join(f"{k} {int(c.get(k, 0))}" for k in HANDOFF_COUNTERS)
            + f"; peak {rec['peak_gb']:.2f} GB allocated, {rec['reserved_gb']:.2f} GB reserved; intermediate bytes "
            f"written {rec['inter_bytes']} (largest {rec['inter_top']}); spilled {rec['spills']}")


def check_fusion_on(tag: str, rec: dict) -> None:
    """The on arm's gates: with nothing spilled, no fallback read and no
    intermediate byte on storage; a spill (the default budget is
    ``min(2 GiB, MemAvailable/4)``) is correct and only reported, and the
    reads of a spilled target are fallbacks."""
    c = rec["counters"]
    if int(c.get("handoffs_spilled", 0)) == 0:
        if int(c.get("handoff_fallbacks", 0)) or rec["inter_bytes"]:
            raise AssertionError(f"fusion {tag}: nothing spilled, yet {int(c.get('handoff_fallbacks', 0))} fallback "
                                 f"reads and {rec['inter_bytes']} intermediate bytes on storage ({rec['inter_top']})")
    elif not rec["spills"]:
        raise AssertionError(f"fusion {tag}: handoffs_spilled > 0 but no degraded:spilled record")
    if not int(c.get("handoffs_served", 0)):
        raise AssertionError(f"fusion {tag}: no handoff was served from memory")


def phase_fusion(K, vol: torch.Tensor, rows: list, block=(128, 128, 128)) -> None:
    """Task-graph fusion (ROADMAP item 9b) on the card, from the port's zarr
    on local disk (zlib level 1, chunks 128^3): the phases before this one
    read and write ``memory://``, which has neither zlib nor a filesystem,
    so they cannot show what the handoffs save.

    1. ``MulticutSegmentationWorkflow`` with its own watershed (halo 32,
       threshold 0.45, min seed distance 2, ``n_scales=1``, ``beta=0.5``,
       ``gaec_parallel``, block 128^3, ``max_jobs=8``) on the main path's
       512^3 boundary map, ``memory_handoffs`` off and on, each cold in a
       fresh ``tmp_folder``: ``seg`` equal bit for bit, B1-B4 launched in
       both arms with equal counts, and the on arm's gates
       (:func:`check_fusion_on`).
    2. ``ConnectedComponentsWorkflow`` (``bmap < 0.45``) on the same file,
       off and on, at ``FUSION_CC_EDGE``^3: equal labels.
    3. The device rung: a producer task publishes a 256^3 crop of the
       volume as a CUDA tensor (``save_handoff_device_arrays``); a consumer
       resolves it and runs ``sharded_slab_sweep(..., keep_on_device=True)``
       over axis-0 slabs with B3 as the slab function, publishing its output
       on the device rung too.  Served with no host byte
       (``device_handoffs_served == 1``, ``h2d_bytes == d2h_bytes == 0``)
       and equal to the ``CTT_DEVICE_POOL=0`` run's; then with
       ``CTT_DEVICE_POOL_BYTES`` below the payload (the publish falls to the
       memory rung, ``host_staged_fallbacks == 1``, ``d2h_bytes`` = the
       payload's bytes) and at 1.5 payloads with two payloads published (the
       elder demoted, ``device_handoffs_demoted == 1``), each equal.
    Adds ``fusion_launches`` (off / on arm of 1) to the kernel rows.
    """
    from concurrent.futures import ThreadPoolExecutor

    from cluster_tools_tpu_torch.io.containers import open_container
    from cluster_tools_tpu_torch.tasks.connected_components import ConnectedComponentsWorkflow
    from cluster_tools_tpu_torch.workflows import MulticutSegmentationWorkflow

    t_phase = time.perf_counter()
    b_np = vol.reshape(vol.shape[-3:]).cpu().numpy()
    shape = b_np.shape
    with tempfile.TemporaryDirectory(prefix="fusion-") as root:
        src_path = os.path.join(root, "in.zarr")
        src = open_container(src_path).require_dataset("bmap", shape=shape, chunks=block, dtype="float32")
        grid = [range(0, s, b) for s, b in zip(shape, block)]
        boxes = [tuple(slice(o, o + b) for o, b in zip(origin, block)) for origin in
                 [(z, y, x) for z in grid[0] for y in grid[1] for x in grid[2]]]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda bb: src.__setitem__(bb, b_np[bb]), boxes))
        t_write = time.perf_counter() - t0
        del b_np

        # ---- 1. the fused chain: watershed -> graph -> features -> costs -> multicut -> write ----
        mc = {}
        for arm, on in (("off", False), ("on", True)):
            out = os.path.join(root, f"mc-{arm}.zarr")
            mc[arm] = fusion_arm(K, root, f"mc-{arm}", MulticutSegmentationWorkflow, on, out, ("seg",), block,
                                 input_path=src_path, input_key="bmap", ws_path=out, ws_key="ws", output_path=out,
                                 output_key="seg", skip_ws=False, halo=[32, 32, 32], threshold=0.45,
                                 min_seed_distance=2.0, n_scales=1, beta=0.5, agglomerator="gaec_parallel")
            log("fusion", fusion_line(f"MulticutSegmentationWorkflow {shape} from disk, memory_handoffs {arm}",
                                      mc[arm]))
        seg_off = open_container(os.path.join(root, "mc-off.zarr"))["seg"][...]
        seg_on = open_container(os.path.join(root, "mc-on.zarr"))["seg"][...]
        if not np.array_equal(seg_off, seg_on):
            raise AssertionError("fusion: the multicut chain's seg differs between memory_handoffs off and on")
        n_seg = len(np.unique(seg_on)) - int((seg_on == 0).any())
        del seg_off, seg_on
        for arm in ("off", "on"):
            missing = [k for k in MAIN_PATH_KERNELS if mc[arm]["launches"].get(k, 0) == 0]
            if missing:
                raise AssertionError(f"fusion: the {arm} arm launched no {missing}")
        if mc["off"]["launches"] != mc["on"]["launches"]:
            raise AssertionError(f"fusion: launches differ, off {mc['off']['launches']} on {mc['on']['launches']}")
        if not mc["off"]["inter_bytes"]:
            raise AssertionError("fusion: the off arm wrote no intermediate bytes (the count is broken)")
        check_fusion_on("multicut on", mc["on"])
        for arm in ("off", "on"):
            shutil.rmtree(os.path.join(root, f"mc-{arm}"))
            shutil.rmtree(os.path.join(root, f"mc-{arm}.zarr"))
        from cluster_tools_tpu_torch.runtime.handoff import handoff_budget

        log("fusion", f"multicut chain: handoff budget {handoff_budget()} B (CTT_HANDOFF_BYTES, else min(2 GiB, "
                      f"MemAvailable/4)); "
                      f"spilled on the on arm {mc['on']['spills']}")
        log("fusion", f"multicut chain: seg equal bit for bit off/on ({n_seg} segments); launches equal "
                      f"{mc['on']['launches']}; wall off {mc['off']['wall_s']:.3f} s, on {mc['on']['wall_s']:.3f} s; "
                      f"intermediate bytes off {mc['off']['inter_bytes']}, on {mc['on']['inter_bytes']}; input "
                      f"written to disk in {t_write:.2f} s")

        # ---- 2. the store-bound case: cc from disk ----
        e = FUSION_CC_EDGE
        ccp = dict(input_path=src_path, input_key="bmap", threshold=0.45, threshold_mode="less", connectivity=1)
        if e != shape[0]:
            crop = open_container(src_path).require_dataset("bmap_crop", shape=(e,) * 3, chunks=block,
                                                            dtype="float32")
            crop[...] = src[tuple(slice(0, e) for _ in range(3))]
            ccp["input_key"] = "bmap_crop"
        cc = {}
        for arm, on in (("off", False), ("on", True)):
            out = os.path.join(root, f"cc-{arm}.zarr")
            cc[arm] = fusion_arm(K, root, f"cc-{arm}", ConnectedComponentsWorkflow, on, out, ("cc",), block,
                                 output_path=out, output_key="cc", **ccp)
            sw = cc[arm]["sweep"]
            log("fusion", fusion_line(f"ConnectedComponentsWorkflow {(e,) * 3} from disk"
                                      + ("" if e == shape[0] else f" (cut from {shape[0]}^3 to keep the smoke in time)")
                                      + f", memory_handoffs {arm}, summed load {sw.get('load_s', 0):.3f} s, "
                                      f"store {sw.get('store_s', 0):.3f} s", cc[arm]))
        a = open_container(os.path.join(root, "cc-off.zarr"))["cc"][...]
        b = open_container(os.path.join(root, "cc-on.zarr"))["cc"][...]
        if not np.array_equal(a, b):
            raise AssertionError("fusion: cc labels differ between memory_handoffs off and on")
        check_fusion_on("cc on", cc["on"])
        log("fusion", f"cc {(e,) * 3}: labels equal off/on ({int(a.max())} max label); wall off "
                      f"{cc['off']['wall_s']:.3f} s, on {cc['on']['wall_s']:.3f} s; summed store off "
                      f"{cc['off']['sweep'].get('store_s', 0):.3f} s, on {cc['on']['sweep'].get('store_s', 0):.3f} s")
        del a, b

        # ---- 3. the device rung ----
        device_rung(K, vol, root)
    for row in rows:
        row["fusion_launches"] = {arm: mc[arm]["launches"].get(row["name"], 0) for arm in ("off", "on")}
    log("fusion", f"phase {time.perf_counter() - t_phase:.1f} s")


def device_rung(K, vol: torch.Tensor, root: str, n: int = 256, extent: int = 32, halo: int = 8) -> None:
    """Part 3 of the "fusion" phase (see :func:`phase_fusion`)."""
    from cluster_tools_tpu_torch.parallel import device_pool
    from cluster_tools_tpu_torch.parallel.batch_shard import sharded_slab_sweep
    from cluster_tools_tpu_torch.runtime import handoff
    from cluster_tools_tpu_torch.runtime.task import BaseTask
    from cluster_tools_tpu_torch.runtime.task import build as run_dag

    big = 1e30
    crop = vol[0, :n, :n, :n].contiguous()
    payload_bytes = crop.numel() * crop.element_size()

    def slab_edt(x):
        # B3 on each halo'd slab: the capped squared EDT along z of the
        # foreground (boundaries < 0.45), the halo cropped off
        f = torch.where(x < 0.45, torch.zeros_like(x), torch.full_like(x, big))
        return K.edt_cascade(f, axis=0, radius=halo, w=1.0, big=big)[halo:-halo]

    class Producer(BaseTask):
        task_name = "fusion_producer"
        target = "gpu"

        def run_impl(self):
            self.save_handoff_device_arrays(self.get_config()["handoff_path"], vol=crop)
            return {}

    seen = {}

    class Consumer(BaseTask):
        task_name = "fusion_consumer"
        target = "gpu"

        def run_impl(self):
            cfg = self.get_config()
            got = handoff.resolve_device_arrays(cfg["handoff_path"])["vol"]
            seen["on_device"] = isinstance(got, torch.Tensor) and got.is_cuda
            seen["resolved"] = device_pool.snapshot()
            if not isinstance(got, torch.Tensor):
                got = np.array(got)  # the memory rung: the sweep uploads it
            out = sharded_slab_sweep(got, slab_edt, extent, halo, batch=8, fill=0.0, keep_on_device=True,
                                     device=self.device)
            self.save_handoff_device_arrays(cfg["final_path"], out=out)
            return {}

    def run(tag, env):
        d = os.path.join(root, f"device-{tag}")
        os.makedirs(os.path.join(d, "cfg"))
        with open(os.path.join(d, "cfg", "global.config"), "w") as fh:
            json.dump({"memory_handoffs": True, "device_handoffs": True}, fh)
        kw = dict(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"),
                  handoff_path=os.path.join(d, "vol.npz"), final_path=os.path.join(d, "out.npz"))
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        handoff.reset()
        try:
            K.reset_counts()
            snap, hsnap = device_pool.snapshot(), handoff.snapshot()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = run_dag([Producer(**kw)]) and run_dag([Consumer(**kw)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if not ok:
                raise AssertionError(f"fusion device rung {tag}: the DAG failed")
            # publish -> resolve: from before the producer to the consumer's resolve
            hop = {k: seen["resolved"][k] - snap[k] for k in snap}
            dev, hd = device_pool.delta(snap), handoff.delta(hsnap)
            launches = dict(K.LAUNCHES)
            on_device = seen["on_device"]
            final = handoff.resolve_device_arrays(kw["final_path"])["out"]
            final = final if isinstance(final, torch.Tensor) else torch.from_numpy(np.array(final))
            final = final.cuda()
        finally:
            handoff.reset()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        return dict(wall_s=wall, hop=hop, dev=dev, handoff=hd, launches=launches, on_device=on_device, final=final)

    fused = run("fused", {})
    d, h = fused["dev"], fused["hop"]
    if not fused["on_device"] or h["device_handoffs_served"] != 1 or h["h2d_bytes"] or h["d2h_bytes"] \
            or d["h2d_bytes"] or d["d2h_bytes"]:
        raise AssertionError(f"fusion device rung: payload on the card {fused['on_device']}, publish -> resolve "
                             f"{h}, whole DAG {d}")
    if not fused["launches"].get("edt_cascade"):
        raise AssertionError("fusion device rung: the slab sweep launched no B3")
    twin = run("kill-switch", {"CTT_DEVICE_POOL": "0"})
    require_equal("fusion device rung: fused vs CTT_DEVICE_POOL=0", fused["final"], twin["final"])
    # off the rung the producer's crop and the consumer's output each leave the card once
    if twin["dev"]["d2h_bytes"] != 2 * payload_bytes:
        raise AssertionError(f"fusion device rung (CTT_DEVICE_POOL=0): d2h {twin['dev']['d2h_bytes']} B, "
                             f"expected {2 * payload_bytes}")
    staged = run("small-budget", {"CTT_DEVICE_POOL_BYTES": str(payload_bytes // 2)})
    s = staged["hop"]
    if staged["on_device"] or s["host_staged_fallbacks"] != 1 or s["d2h_bytes"] != payload_bytes:
        raise AssertionError(f"fusion device rung (budget {payload_bytes // 2} B): not staged to the memory rung: {s}")
    require_equal("fusion device rung: small budget vs fused", staged["final"], fused["final"])
    # two payloads under 1.5 of them: publishing the second demotes the first
    os.environ["CTT_DEVICE_POOL_BYTES"] = str(payload_bytes * 3 // 2)
    try:
        handoff.reset()
        snap, hsnap = device_pool.snapshot(), handoff.snapshot()
        pa, pb = os.path.join(root, "a.npz"), os.path.join(root, "b.npz")
        handoff.publish_device_arrays(pa, {"vol": crop}, producer="fusion.0")
        handoff.publish_device_arrays(pb, {"vol": crop + 1}, producer="fusion.0")
        dem, hdem = device_pool.delta(snap), handoff.delta(hsnap)
        back = torch.from_numpy(np.array(handoff.resolve_device_arrays(pa)["vol"])).cuda()
        live = handoff.resolve_device_arrays(pb)["vol"]
    finally:
        os.environ.pop("CTT_DEVICE_POOL_BYTES", None)
        handoff.reset()
    if hdem["device_handoffs_demoted"] != 1 or dem["d2h_bytes"] != payload_bytes or not live.is_cuda:
        raise AssertionError(f"fusion device rung: no demotion under 1.5 payloads: {hdem}, {dem}")
    require_equal("fusion device rung: demoted payload", back, crop)
    log("fusion", f"device rung, {(n,) * 3} float32 ({payload_bytes} B) published on the card, resolved by the "
                  f"consumer's sharded_slab_sweep (extent {extent}, halo {halo}, B3 a slab, keep_on_device): publish "
                  f"-> resolve served {int(h['device_handoffs_served'])}, h2d {int(h['h2d_bytes'])}, d2h "
                  f"{int(h['d2h_bytes'])}; the whole DAG (the output published on the card too) bytes_not_staged "
                  f"{int(d['bytes_not_staged'])}, h2d {int(d['h2d_bytes'])}, d2h {int(d['d2h_bytes'])}, B3 launches "
                  f"{fused['launches'].get('edt_cascade', 0)}, {fused['wall_s']:.3f} s; equal to the "
                  f"CTT_DEVICE_POOL=0 run ({twin['wall_s']:.3f} s, h2d {int(twin['dev']['h2d_bytes'])}, d2h "
                  f"{int(twin['dev']['d2h_bytes'])}); budget {payload_bytes // 2} B: staged to the memory rung "
                  f"(host_staged_fallbacks {int(s['host_staged_fallbacks'])}, d2h {int(s['d2h_bytes'])}, h2d "
                  f"{int(s['h2d_bytes'])}), equal; budget {payload_bytes * 3 // 2} B, two payloads: "
                  f"device_handoffs_demoted {int(hdem['device_handoffs_demoted'])}, d2h {int(dem['d2h_bytes'])}, "
                  f"the demoted payload equal")


# the H100 SXM data sheet's dense bfloat16 tensor rate (the FLOP bound of the U-Net)
BF16_FLOPS_PER_S = 989e12
# one interior block and the far corner of the 4x4x4 grid of 128^3 blocks
INFERENCE_BLOCKS = (21, 63)


def conv_flops(model, x) -> int:
    """Multiply-add FLOPs (2 a MAC) of the convolutions of one forward of
    ``model`` on ``x``, counted from the shapes each convolution sees."""
    from cluster_tools_tpu_torch.models.unet import Conv

    total = [0]

    def hook(m, inp, out):
        k3 = m.weight.shape[2] * m.weight.shape[3] * m.weight.shape[4]
        if m.transpose:
            total[0] += 2 * inp[0].numel() * m.weight.shape[1] * k3
        else:
            total[0] += 2 * out.numel() * m.weight.shape[1] * k3

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, Conv)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def synthetic_forest(feats: torch.Tensor, columns, rng, n_trees: int = 16, depth: int = 8, n_classes: int = 2):
    """Complete trees of ``depth`` in breadth-first layout splitting on
    ``columns``, each threshold a feature value of a random voxel of
    ``feats`` (``[n, F]``); leaves point at themselves, with feature and
    threshold 0 (as the JAX package's vigra import leaves them) and random
    class distributions: the ``rf_*`` arrays of an ilastik checkpoint."""
    n = 2 ** (depth + 1) - 1
    inner = 2 ** depth - 1
    children = np.stack([2 * np.arange(n) + 1, 2 * np.arange(n) + 2], -1)
    children[inner:] = np.arange(inner, n)[:, None]
    feature = rng.choice(np.asarray(columns), (n_trees, n)).astype(np.int32)
    sample = feats[torch.from_numpy(rng.integers(0, feats.shape[0], (n_trees, n))).to(feats.device)].cpu().numpy()
    threshold = np.take_along_axis(sample, feature[..., None].astype(np.int64), -1)[..., 0].astype(np.float32)
    feature[:, inner:] = 0
    threshold[:, inner:] = 0.0
    probs = rng.random((n_trees, n, n_classes)).astype(np.float32)
    return dict(rf_feature=feature, rf_threshold=threshold,
                rf_children=np.broadcast_to(children, (n_trees, n, 2)).astype(np.int32).copy(),
                rf_leaf_probs=probs / probs.sum(-1, keepdims=True), rf_depth=np.int32(depth))


def split_margin(feature, threshold, children, X, depth: int) -> torch.Tensor:
    """Per sample of ``X`` (``[n, F]``), the least ``|feature - threshold|``
    over the splits its descent meets in every tree (the descent of
    ``forest_predict_proba``; a leaf points at itself and splits nothing)."""
    T, n = feature.shape[0], X.shape[0]
    feat, child = feature.long(), children.reshape(T, -1).long()
    xt = X.t()
    idx = torch.zeros((T, n), dtype=torch.long, device=X.device)
    margin = torch.full((T, n), float("inf"), device=X.device)
    for _ in range(depth):
        x = torch.gather(xt, 0, torch.gather(feat, 1, idx))
        t = torch.gather(threshold, 1, idx)
        leaf = torch.gather(child, 1, idx * 2) == idx
        margin = torch.where(leaf, margin, torch.minimum(margin, (x - t).abs()))
        idx = torch.gather(child, 1, idx * 2 + (x >= t).long())
    return margin.min(dim=0).values


def phase_inference(K, vol: torch.Tensor, rows: list, seed: int, block=(128, 128, 128)) -> None:
    """Phase 12: the prediction workflows on the card (see the module
    docstring).  Adds ``inference_launches`` to the kernel rows."""
    from cluster_tools_tpu_torch.io.containers import MemoryContainer, open_container
    from cluster_tools_tpu_torch.models import UNet3D
    from cluster_tools_tpu_torch.tasks import ilastik as il
    from cluster_tools_tpu_torch.tasks.inference import InferenceWorkflow, load_checkpoint, normalize, save_checkpoint
    from cluster_tools_tpu_torch.utils.volume_utils import Blocking, pad_block_to

    t_phase = time.perf_counter()
    mem = "memory://inference"
    f = open_container(mem)
    raw = vol.reshape(vol.shape[-3:]).cpu().numpy()
    shape = raw.shape
    voxels = int(np.prod(shape))
    n_blocks = int(np.prod([-(-s // b) for s, b in zip(shape, block)]))
    f.require_dataset("raw", shape=shape, chunks=block, dtype="float32")[...] = raw
    blocking = Blocking(shape, block)
    launches = Counter()
    with tempfile.TemporaryDirectory(prefix="inference-") as tmp_root:
        # ---- the U-Net ----
        halo = (8, 8, 8)
        model = UNet3D()
        model.reset_parameters(torch.Generator().manual_seed(seed))
        mult = 2 ** model.depth
        outer = tuple(-(-(b + 2 * h) // mult) * mult for b, h in zip(block, halo))
        ckpt = os.path.join(tmp_root, "unet.npz")
        save_checkpoint(ckpt, model)
        rec = bw_timed(K, tmp_root, "unet", InferenceWorkflow, block, voxels, n_blocks, phase="inference",
                       input_path=mem, input_key="raw", output_path=mem, output_key="pred", checkpoint_path=ckpt,
                       model={"name": "unet3d"}, halo=list(halo))
        launches.update(rec["launches"])
        pred = f["pred"]
        if pred.shape != (1,) + shape:
            raise AssertionError(f"inference: output shape {pred.shape}")
        p = torch.from_numpy(pred[...]).cuda()
        lo, hi, finite = float(p.min()), float(p.max()), bool(torch.isfinite(p).all())
        del p
        if not finite or lo < 0.0 or hi > 1.0:
            raise AssertionError(f"inference: output not finite in [0, 1] (finite {finite}, min {lo}, max {hi})")
        cpu_model = UNet3D()
        load_checkpoint(ckpt, cpu_model)
        card_model = UNet3D()
        load_checkpoint(ckpt, card_model)
        card_model.cuda().eval()
        errs = {}
        xs = {}
        for bid in INFERENCE_BLOCKS:
            b = blocking.get_block(bid, halo)
            xs[bid] = torch.from_numpy(pad_block_to(normalize(raw[b.outer_bb]), outer))[None, None]
            with torch.no_grad():
                want = torch.sigmoid(cpu_model(xs[bid]))[0].numpy()[(slice(None),) + b.inner_in_outer_bb]
            errs[bid] = float(np.abs(pred[(slice(None),) + b.bb] - want).max())
            if not errs[bid] <= 2e-2:
                raise AssertionError(f"inference: block {bid} differs from the CPU forward by {errs[bid]}")
        x = xs[INFERENCE_BLOCKS[0]].cuda()
        flops = conv_flops(card_model, x)
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: card_model(x), 5)
        bound_block = flops / BF16_FLOPS_PER_S * 1e3
        # float32 on one block, TF32 off for the convolutions
        m32_cpu = UNet3D(dtype=torch.float32)
        load_checkpoint(ckpt, m32_cpu)
        m32 = UNet3D(dtype=torch.float32)
        load_checkpoint(ckpt, m32)
        m32.cuda().eval()
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            got32 = m32(x).cpu().numpy()
            want32 = m32_cpu(xs[INFERENCE_BLOCKS[0]]).numpy()
        err32 = float(np.abs(got32 - want32).max())
        if not np.allclose(got32, want32, atol=2e-4, rtol=2e-4):
            raise AssertionError(f"inference: the float32 block differs from its CPU forward by {err32}")
        del card_model, m32, x
        log("inference", f"unet: {flops} FLOP a {outer} block ({flops / np.prod(outer):.5g} a voxel), "
                         f"{flops * n_blocks:.4g} in the {n_blocks} blocks; bound {bound_block:.3f} ms a block, "
                         f"{bound_block * n_blocks:.2f} ms in all at {BF16_FLOPS_PER_S:.3g} FLOP/s; one block's "
                         f"forward {fwd_ms:.2f} ms (synced; bound/time {bound_block / fwd_ms:.1%}); output in "
                         f"[{lo:.4f}, {hi:.4f}]; blocks {INFERENCE_BLOCKS} vs CPU max err "
                         + ", ".join(f"{e:.3g}" for e in errs.values())
                         + f" (atol 2e-2); float32 block vs CPU max err {err32:.3g} (atol 2e-4, TF32 off)")
        del pred

        # ---- ilastik: linear classifier and forest ----
        rng = np.random.default_rng(seed)
        ihalo = (12, 12, 12)
        iouter = tuple(b + 2 * h for b, h in zip(block, ihalo))
        linear = os.path.join(tmp_root, "linear.npz")
        n_feat = il.n_features()
        np.savez(linear, W=rng.normal(0, 1, (n_feat, 2)).astype(np.float32),
                 b=rng.normal(0, 0.1, 2).astype(np.float32), sigmas=np.array(il.DEFAULT_SIGMAS))
        selections = (("GaussianSmoothing", 0.7), ("LaplacianOfGaussian", 1.6), ("GaussianGradientMagnitude", 1.6),
                      ("DifferenceOfGaussians", 3.5), ("HessianOfGaussianEigenvalues", 1.6),
                      ("StructureTensorEigenvalues", 1.6))
        b0 = blocking.get_block(INFERENCE_BLOCKS[0], ihalo)
        xb = torch.from_numpy(pad_block_to(raw[b0.outer_bb], iouter, mode="edge"))
        feats_card = il.ilp_feature_bank(xb.cuda(), selections)
        feat_err = float((feats_card.cpu() - il.ilp_feature_bank(xb, selections)).abs().max())
        if not feat_err <= 2e-4:
            raise AssertionError(f"ilastik: the card's features differ from the CPU's by {feat_err}")
        flat = feats_card.reshape(-1, feats_card.shape[-1])
        # split only on columns whose spread is ten times the clear margin
        # below (the structure tensor's smaller eigenvalues are ~1e-5 here)
        spread = flat.std(0).cpu().numpy()
        columns = [c for c in range(flat.shape[1]) if spread[c] > 2e-3]
        if len(columns) < 6:
            raise AssertionError(f"ilastik: only columns {columns} of {flat.shape[1]} have a spread > 2e-3")
        forest_arrays = synthetic_forest(flat, columns, rng)
        forest = os.path.join(tmp_root, "forest.npz")
        np.savez(forest, W=np.zeros((0, 0), np.float32), b=np.zeros(0, np.float32), sigmas=np.zeros(0, np.float32),
                 ilp_features=np.array([f"{fid}:{s}" for fid, s in selections]), **forest_arrays)
        clf_card = il.load_classifier(forest, torch.device("cuda"))
        clf_cpu = il.load_classifier(forest, torch.device("cpu"))
        rf = [clf_card["forest"][k] for k in ("feature", "threshold", "children", "leaf_probs")]
        rf_cpu = [clf_cpu["forest"][k] for k in ("feature", "threshold", "children", "leaf_probs")]
        depth = clf_card["forest"]["depth"]
        descent_err = float((il.forest_predict_proba(*rf, flat, depth).cpu()
                             - il.forest_predict_proba(*rf_cpu, flat.cpu(), depth)).abs().max())
        if not descent_err <= 1e-6:
            raise AssertionError(f"ilastik: the forest's descent on the card differs from the CPU's by {descent_err}")
        # a voxel is clear when each split on its path through each tree
        # compares a feature 2e-4 (the features' tolerance) or more away
        # from the threshold
        clear = (split_margin(*rf[:3], flat, depth) > 2e-4).cpu().numpy()
        del feats_card, flat
        clear = clear.reshape(iouter)[b0.inner_in_outer_bb]
        for tag, ckpt_i in (("ilastik-linear", linear), ("ilastik-forest", forest)):
            key = tag.replace("-", "_")
            rec = bw_timed(K, tmp_root, tag, il.IlastikPredictionWorkflow, block, voxels, n_blocks,
                           phase="inference", input_path=mem, input_key="raw", output_path=mem, output_key=key,
                           checkpoint_path=ckpt_i)
            launches.update(rec["launches"])
            probs = f[key]
            s_err = float((torch.from_numpy(probs[...]).cuda().sum(0) - 1.0).abs().max())
            if not s_err <= 1e-5:
                raise AssertionError(f"{tag}: probabilities sum to 1 only within {s_err}")
            with torch.no_grad():
                want = il.predict_block(il.load_classifier(ckpt_i, torch.device("cpu")), xb).numpy()
            got = probs[(slice(None),) + b0.bb]
            want = want[(slice(None),) + b0.inner_in_outer_bb]
            sel = clear if tag == "ilastik-forest" else np.ones(clear.shape, bool)
            err = float(np.abs(got - want)[:, sel].max())
            if not err <= 2e-3:
                raise AssertionError(f"{tag}: block {INFERENCE_BLOCKS[0]} differs from its CPU run by {err}")
            log("inference", f"{tag}: sums to 1 within {s_err:.3g}; block {INFERENCE_BLOCKS[0]} vs CPU max err "
                             f"{err:.3g} (atol 2e-3) on {int(sel.sum())} of {sel.size} voxels"
                             + (f" (clear of the thresholds); forest {forest_arrays['rf_feature'].shape[0]} trees "
                                f"of depth {depth} on columns {columns}; descent on the card's features vs CPU "
                                f"{descent_err:.3g} (atol 1e-6); the card's {len(selections)}-id features vs CPU "
                                f"{feat_err:.3g} (atol 2e-4)" if tag == "ilastik-forest" else ""))
            del probs
    for row in rows:
        row["inference_launches"] = launches.get(row["name"], 0)
    if sum(launches.values()):
        raise AssertionError(f"inference: the prediction workflows launched hand kernels: {dict(launches)}")
    del MemoryContainer._registry[mem]
    log("inference", f"phase {time.perf_counter() - t_phase:.1f} s")


def main_phases(K, args, gen):
    """Phases 3-9 (kernels, main path, its twins and replays, worst
    cases, tiled seeds); returns the kernel rows, the main path's volume,
    scipy's labels of its foreground, the main path's watershed labels
    on the first ``CONFIG4_CROP``^3 and its seconds a voxel."""
    from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries

    phase_kernels(K, gen)

    # ---- main path at full width ----
    cfg = dict(halo=32, threshold=0.45, dt_max_distance=32.0, min_seed_distance=2.0, seed_mode="sparse")
    step = make_ws_ccl_split(device="cuda", **cfg)
    vol = synthetic_boundaries(MAIN_SHAPE, torch.Generator(device="cuda").manual_seed(args.seed))
    torch.cuda.synchronize()

    syncs = {}

    def count_syncs(stage, *_):
        torch.cuda.synchronize()
        syncs[stage] = len(caught) - sum(syncs.values())

    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step.run_staged(vol, count_syncs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    warm_s = time.perf_counter() - t0

    marks = {}

    def timed(stage, *_):
        torch.cuda.synchronize()
        marks[stage] = time.perf_counter()

    runs = []
    for _ in range(3):
        # counts and peak memory cover exactly one run of the main path
        ws = cc = None
        K.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ws, cc, n_fg, overflow = step.run_staged(vol, timed)
        total_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        rungs = dict(K.RUNGS)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prev, stage_ms = t0, {}
        for stage in ("seeds", "flow", "fill", "cc"):
            stage_ms[stage] = (marks[stage] - prev) * 1e3
            prev = marks[stage]
        runs.append((total_s, stage_ms))
    total_s, stage_ms = sorted(runs, key=lambda r: r[0])[1]
    # one more run records every launch's inputs for the replay below
    with K.capture_inputs() as captured:
        step.run_staged(vol, lambda *_: None)
    log("main", f"volume {MAIN_SHAPE} {cfg}; warm-up {warm_s:.2f}s; 3 timed runs "
                + "/".join(f"{r[0] * 1e3:.1f}" for r in runs) + f" ms; median {total_s * 1e3:.1f} ms = "
                + ", ".join(f"{k} {v:.1f}" for k, v in stage_ms.items())
                + f" ms; {vol.numel() / total_s:.4g} voxels/s; peak {peak_gb:.2f} GB; "
                f"launches per run {launches}; rungs per run {rungs}; host syncs per stage {syncs}")
    missing = [k for k in MAIN_PATH_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    if overflow:
        raise AssertionError("main path reported overflow")
    if ws.shape != vol.shape or ws.dtype != torch.int32 or bool((ws < 0).any()):
        raise AssertionError(f"ws labels malformed: {ws.shape} {ws.dtype}")
    if int(n_fg) != int((cc > 0).sum()):
        raise AssertionError(f"n_foreground {float(n_fg)} != {int((cc > 0).sum())}")
    import scipy.ndimage as ndi

    fg_np = (vol[0] < torch.tensor(np.float32(0.45), device="cuda")).cpu().numpy()
    ref, n_ref = ndi.label(fg_np)
    if not partition_equal(cc[0], torch.from_numpy(ref.astype(np.int32)).cuda()):
        raise AssertionError("cc labels are not scipy.ndimage.label's partition")
    log("main-check", f"overflow False; n_foreground {int(n_fg)}; cc = scipy partition "
                      f"({n_ref} components); ws segments {int(torch.unique(ws).numel()) - 1}")

    # ---- the same step on the twins ----
    K.reset_counts()
    t0 = time.perf_counter()
    out_t = make_ws_ccl_split(device="cuda", impl="torch", **cfg)(vol)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    for what, a, b in zip(("ws", "cc", "n_fg"), (ws, cc, n_fg), out_t[:3]):
        require_equal(f"main path twins {what}", a, b)
    if bool(out_t[3]) != bool(overflow):
        raise AssertionError("main path twins: overflow flags differ")
    if sum(K.LAUNCHES.values()):
        raise AssertionError(f"impl='torch' launched kernels: {dict(K.LAUNCHES)}")
    log("main-twins", f"{MAIN_SHAPE} impl=torch == impl=cuda on ws, cc, n_fg, overflow "
                      f"({twin_s * 1e3:.1f} ms, no kernel launched)")
    ws_crop = ws[0, :CONFIG4_CROP, :CONFIG4_CROP, :CONFIG4_CROP].cpu().numpy()
    del ws, cc, out_t

    # ---- every main-path launch on its own inputs ----
    n_captured = Counter(c[0] for c in captured)
    if n_captured != Counter({k: v for k, v in launches.items() if v}):
        raise AssertionError(f"captured launches {dict(n_captured)} != timed run's {launches}")
    rows = []
    for kname, (_, source, replaces) in KERNELS.items():
        ms = plain = err = 0.0
        bounds = []
        # B1d replays B1's cc-stage launch: the main path never selects it
        src = "tile_ccl" if kname == "tile_ccl_doubling" else kname
        for i, (_, kargs, kkw) in enumerate(c for c in captured if c[0] == src):
            kfn, tfn = replay(K, kname, kargs, kkw)
            out = kfn()
            err = max(err, require_equal(f"{kname} launch {i} on main-path inputs", out, tfn()))
            extra = ""
            if kname == "tile_ccl_doubling":
                require_equal(f"{kname} replay of tile_ccl launch {i} (unit-step twin)", out,
                              K.tile_ccl_torch(kargs[0], kkw["tile"]))
                b1d, iters = check_b1d(K, f"replay of tile_ccl launch {i}", kargs[0], kkw["tile"])
                require_equal(f"{kname} replay of tile_ccl launch {i} (with iterations)", out, b1d)
                extra = f"; iterations per tile: mean {float(iters.double().mean()):.3f}, max {int(iters.max())}"
            del out
            t, tp = cuda_ms(kfn, 5), cuda_ms(tfn, 1)
            b = bound_ms(kname, kargs, kkw)
            ms, plain = ms + t, plain + tp
            bounds.append(b)
            what = f"replay of tile_ccl launch {i}" if src != kname else f"launch {i}"
            if kname == "apply_remap":
                live = (kargs[1] != kargs[2]).sum(1).double()
                extra = f"; live slots per tile: mean {float(live.mean()):.2f}, max {int(live.max())}"
            log("main-kernels", f"{kname} {what} shape {tuple(kargs[0].shape)} "
                                f"{ {k: v for k, v in kkw.items() if k in ('axis', 'radius')} }: "
                                f"{t:.3f} ms (twin {tp:.3f} ms, bound {b[0]:.3f} ms by {b[1]}){extra}")
        rows.append(dict(name=kname, route="cuda", source=source, replaces=replaces,
                         launches=launches.get(kname, 0), max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=sum(b[0] for b in bounds), bound_by=max(bounds)[1], library_ms=None))
    flow_shape = next(tuple(c[1][0].shape) for c in captured if c[0] == "tile_ws_propagate")
    cc_shape = next(tuple(c[1][0].shape) for c in captured if c[0] == "tile_ccl")
    del captured
    flow_worst(K, flow_shape, next(r["ms"] for r in rows if r["name"] == "tile_ws_propagate"))
    ccl_worst(K, cc_shape)

    # ---- tiled seeds: impl=cuda vs impl=torch ----
    small = synthetic_boundaries((1, 128, 256, 256), torch.Generator(device="cuda").manual_seed(args.seed + 1))
    cfg_t = dict(cfg, seed_mode="tiled")
    K.reset_counts()
    out_c = make_ws_ccl_split(device="cuda", impl="cuda", **cfg_t)(small)
    torch.cuda.synchronize()
    launches_t, rungs_t = dict(K.LAUNCHES), dict(K.RUNGS)
    out_t = make_ws_ccl_split(device="cuda", impl="torch", **cfg_t)(small)
    for what, a, b in zip(("ws", "cc", "n_fg"), out_c[:3], out_t[:3]):
        require_equal(f"tiled seeds {what}", a, b)
    if bool(out_c[3]) != bool(out_t[3]):
        raise AssertionError("tiled seeds: overflow flags differ")
    log("tiled-seeds", f"(1,128,256,256) {cfg_t}: impl=cuda == impl=torch on ws, cc, n_fg, overflow "
                       f"({int(torch.unique(out_c[0]).numel()) - 1} ws segments); "
                       f"launches {launches_t}; rungs {rungs_t}")

    # the main path's seconds a voxel of its halo'd volume (z grows by 2 x 32)
    main_s_per_voxel = total_s / ((MAIN_SHAPE[1] + 2 * cfg["halo"]) * MAIN_SHAPE[2] * MAIN_SHAPE[3])
    return rows, vol, ref, ws_crop, main_s_per_voxel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from cluster_tools_tpu_torch import build
    from cluster_tools_tpu_torch.ops import kernels as K

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log("card", f"{name} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = build.build_all()
    log("build", "kernels " + ", ".join(
        f"{k} ({ident}) {secs[k]:.1f}s" for k, (ident, _, _) in KERNELS.items()
    ) + f"; wall {time.perf_counter() - t0:.1f}s")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows, vol, ref, ws_crop, main_s_per_voxel = main_phases(K, args, gen)
    mem, auto = phase_blockwise(K, vol, ref, rows)
    phase_sweeps(K, mem, auto, main_s_per_voxel, rows)
    phase_multicut(K, vol, ws_crop, mem, rows)
    phase_fusion(K, vol, rows)
    phase_inference(K, vol, rows, args.seed)

    log("done", f"{time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
