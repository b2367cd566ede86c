#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cluster_tools_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py [--seed 0] [--only faults|serve|fleet|analysis|lifted|shards|multicard]``

Phases, each one line of output, each raising on failure:

1. card: the device name and ``nvidia-smi`` name / power limit;
2. build: compile every kernel of ``cluster_tools_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once) and, beside them, the host C++ rung
   (``csrc/ct_native.cpp``, one ``g++``);
2a. lint (``phase_lint``): the port's ctlint
   (``python3 -m cluster_tools_tpu_torch.lint --json``, a subprocess) over
   its default walk of the tree this machine received: the package,
   ``scripts/torch_*.py`` and this script; its files, suppressions, counts
   and seconds, and any finding fails the smoke;
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
   ``adversarial_remap_np`` table on three tile shapes; the row scan's sum
   and max on rows of 0, 1 and a tile +- 1 elements and on long rows);
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
9b. sharded (``phase_sharded``): the ws+cc step on a mesh of shards on
    the card (ROADMAP item 10a).  ``(2, 512, 512, 512)`` (seeds 0 and 1)
    on a dp=2 x sp=4 mesh, 8 shards on the one card, the main path's
    configuration: the fused step once to warm up and once timed, the split
    step once to warm up and three times timed by stage (launches,
    collective counters and peak memory of each timed run), checked (1)
    fused == split bit for bit, (2) == the same 8-shard step with
    ``impl="torch"``, (3) each volume's cc = the single-device step's cc
    partition and ``n_foreground`` = its sum exactly; every launch of one
    split run replayed against its twin.  (4) One volume on sp = (z, y) =
    2 x 2 with ``exact_edt``, ``stitch_ws_threshold=0.5`` and
    ``max_labels_per_shard``, at 512^3: cc and ``n_foreground`` against
    the single-device step, ws, cc, ``n_foreground`` and overflow against
    its ``impl="torch"`` run, and every launch of one run replayed against
    its twin (the exact EDT is capped at ``dt_max_distance``: B3 at radius
    32 along the flipped axes).  (5) The mesh-exact squared EDT of a 256^3
    mask on 2 x 2 = ``round(scipy EDT ** 2)``, its B3 launches at full
    radius timed against their bound.  (6) ``launch_workers(2, ...,
    devices_per_process=2)``: two processes on the one card (gloo, host
    staging) run ``cc_pod_demo`` and the split step z-sharded on 256^3;
    its ws and cc = the in-process 4-shard mesh's bit for bit.  Times on
    one card show what sharding costs (halos, rendezvous, extra launches),
    not scaling.  The kernel rows gain ``sharded_launches``;
10. blockwise: BASELINE configs 1-3 through the port's workflows on the
    main path's volume in ``memory://`` (block 128^3): connected components
    (against ``scipy.ndimage.label``), single- and two-pass watershed (halo
    32, ``CT_FILL_MODE=capacity``, ``CT_TIER_MODE=cond``; each against its
    ``impl="torch"`` run bit for bit, every kernel launch of one run
    replayed against its twin and timed), relabel of the two-pass output
    (``1..K``, same partition), and the cc workflow at 256^3 through the
    port's zarr on local disk against its ``memory://`` run.  Per workflow:
    a warm-up (the watersheds only: cc and relabel are bound by the
    host's stores) and one timed run (fresh ``tmp_folder`` each), the wall
    time, voxels/s and blocks/s, peak device memory, the executor's
    summed load / h2d / kernel (synced) / d2h / store ms, kernel launches
    and remap rungs.  The kernel rows gain ``blockwise_launches`` and
    ``blockwise_ms`` (sums over one run's launches, replayed).  The tasks'
    default ``sweep_mode="auto"`` runs these sweeps sharded, 8 blocks a
    call;
11. sweeps (``phase_sweeps``): the executor's sweep plane on the same
    volume (64 blocks, batch 8): the single- and two-pass watershed and cc
    with ``sweep_mode="per_block"`` beside phase 10's runs, which must
    have run sharded with the lane-batched kernels (rung ``batched``);
    every file equal bit for bit; per mode the wall (one run after a
    warm-up), blocks/s, calls to the device, summed kernel s, peak GB and
    the fixed cost a block; then a ragged tail (``sharded_batch=12``: one
    ragged batch, 8 padding lanes) and one ragged sweep run twice through
    the device page pool (the second sends fewer bytes to the card), each
    equal to the per-block file.  The kernel rows gain ``sweep_launches``.
    Then the shards arm (``shards_arm``, ROADMAP item 10c; alone with
    ``--only shards``, which runs cc at 512^3 and adds k = 4 and a 1-shard
    control): the 512^3 watershed (``sharded_batch`` 8k) and the 256^3 cc
    of phase 10 (4k) with the executor on k = 2 shards of the one card
    (``CTT_MESH_SHARDS``; on two cards or more also k = the card count,
    with each card's calls): each file equal to the auto run's, the B1-B4
    launch totals equal to its; wall, device calls per shard, peak GB.
    The kernel rows gain ``shards_launches``;
11a. faults (``phase_faults``; alone with ``--only faults``): faults,
    traces and integrity on the card (ROADMAP item 11a).  The 512^3
    single-pass watershed of phase 10 (block 128^3, ``auto``) in turns
    plain (``CTT_CHECKSUMS=0``), with checksums (the default) and hardened
    (checksums, ``CTT_TRACE``, ``block_deadline_s``), once each (cut from
    twice to pay for the "fleet" phase): the
    checksum and tracing costs and the trace's top spans; under one
    ``CTT_FAULTS`` spec (a load hang far past the deadline, a kernel NaN,
    an ``io_write`` bit flip, a ``dispatch`` OOM): every fault's record and
    resolution in ``failures.json``, at least one speculative duplicate;
    from the port's zarr on local disk with checksums on (a sidecar a
    block) and off (none), on the first 256^3 (cut for time), then an
    ``io_read`` bit flip healed on read by lineage repair (the block
    recomputed on the card); each equal to phase 10's labels (the disk
    arms to their own 256^3 ``memory://`` run) bit for bit, each run
    launching B1-B4.  Then the U-Net
    without GroupNorm (bfloat16, halo 24, a 256^3 ROI, cut from 384^3 for time) with
    ``allow_block_split`` under a full-block ``compute`` OOM: every block
    split, equal to its unsplit run within 2e-2.  Each arm prints its wall,
    check and counters (speculated, split, repaired, sidecars written,
    trace events, dropped events).  The kernel rows gain
    ``faults_launches`` (by arm);
12. multicut: BASELINE config 4 (``phase_multicut``): the fused RAG and the
    torch-rung GAEC on the first 256^3 of the main path's watershed labels
    against the numpy oracle; ``MulticutSegmentationWorkflow`` and
    ``AgglomerativeClusteringWorkflow`` on the first ``MC_EDGE``^3 of the
    single-pass watershed output of phase 10 (per-task times on the host
    C++ rung beside the same workflow on the Python paths, same segmentation; the merged graph
    against the numpy oracle, the segmentation against the assignment
    table); the default workflow (its own watershed, ``gaec_parallel``
    subproblems, Kernighan-Lin on the host C++ rung) at ``MC_DEFAULT_CROP``^3,
    block 128^3, with per-task times and the same gates; and the
    agglomerating watershed on the first ``AGG_WS_CROP``^3 against its ``impl="torch"``
    run.  The kernel rows gain ``multicut_launches``;
12a. native (``phase_native``, in phase 12's ``tmp_folder``): the host C++
    rung.  Each of its eight functions against the port's Python path on
    the default workflow's ``NATIVE_CROP``^3 graph, features and reduced
    problem (labels and sums bit for bit; the EDT against scipy's within
    rtol 1e-5; the flood against its contract; the mutex watershed's
    partition on a ``MWS_EDGE``^3 affinity volume), both timed; then
    union-find, GAEC, Kernighan-Lin on the reduced problem and the feature
    merge alone on the multicut phase's ``MC_EDGE``^3 graph;
12b. reduce-tree (``phase_reduce_tree``, in phase 12's ``tmp_folder``):
    the sharded global solve (ROADMAP 10b) and the fused workflow (12a).
    (a) ``AgglomerativeClusteringWorkflow`` with ``solver_shards=8`` and
    the collective plane demanded, on 8 sibling shards on the card
    (``CTT_MESH_SHARDS=8``), the multicut phase's whole graph: collective on every
    level, no ``degraded:*`` record, a warm re-solve sending no byte to the
    card; the collective plane equal to the in-process packet plane bit for
    bit on the induced subgraph of the first eighth of the graph's nodes
    (cut from the whole graph to pay for the "fleet" phase); (b)
    ``SolveGlobal`` (``gaec_parallel``, 8 shards) on both planes, equal,
    energy within 0.1% of the unsharded solve; (c) the same over a
    two-process worker group (gloo, packet plane, the host C++ rung in the
    workers), equal to (b); per arm the
    wall, levels, rounds, boundary edges, hops, bytes gathered, host syncs
    and h2d bytes.  (d) ``FusedSegmentationWorkflow`` on the first
    ``FUSED_EDGE``^3 of the main path's volume in its configuration, fused
    and split, on 1 shard and 8: ws and cc
    = ``make_ws_ccl_step`` on the same mesh, cc = scipy's partition,
    ``n_foreground`` = the mesh's float32 sum of the exact per-shard
    counts, every launch of one 8-shard run replayed against its twin.
    (e) ``sharded_slab_sweep`` of B3 with ``n_ranks=4`` = ``n_ranks=1``.
    The kernel rows gain ``fused_launches``;
13. fusion (``phase_fusion``): task-graph fusion from the port's zarr on
    local disk: ``MulticutSegmentationWorkflow`` with its own watershed on
    the first ``FUSION_EDGE``^3 of the main path's volume and
    ``ConnectedComponentsWorkflow`` on it,
    each with ``memory_handoffs`` off and on (walls, per-task seconds,
    launches, handoff and chunk-cache counters, peak and reserved device
    memory and the intermediate bytes written to storage; outputs and B1-B4
    launches equal between the arms), the device rung (a CUDA tensor handed
    from a producer task to a consumer's slab sweep of B3 with no host
    byte, then staged to and demoted to the memory rung under small device
    budgets, each equal), and the chunk cache: the watershed task from the
    zarr with ``CTT_CHUNK_CACHE=0`` and with the cache on, and from the
    port's N5 with it on, each equal to the chain's watershed, the cached
    arms missing each distinct chunk of the sweep once.  The kernel rows
    gain ``fusion_launches`` and ``cache_launches``;
13a. serve (``phase_serve``; alone with ``--only serve``): the resident
    pipeline server on the card (ROADMAP item 11c), from the port's zarr
    on local disk holding the first ``SERVE_EDGE``^3 of the main path's
    boundary map and its mask.  Its yardstick (``serve_yardstick``): the
    cc workflow of the mask (against ``scipy.ndimage.label``) and the
    single-pass watershed in ``memory://``.  An in-process
    ``PipelineServer`` with tenants alice and bob: alice's single-pass
    watershed (no target: the card) beside bob's cc, both equal to the
    yardstick's labels bit for bit; alice's warm resubmission (chunk-cache hits,
    no miss, the same labels); a flipped voxel in one stored chunk of the
    watershed's output found and repaired from lineage by one scrubber
    pass (``scrub_state.json`` one finding, one repair); then
    ``python -m cluster_tools_tpu_torch.serve`` as a child, SIGTERM at its
    watershed's first block markers (exit 114) and a restart that replays
    the journal to ``done`` with the same labels; ``GET /status`` rc 0 and
    no live handoff entry on both servers.  Per request the wall,
    ``queued_s``, ``run_s``, voxels/s, peak GB and the launches counted
    under it (each watershed request launches B1-B4); the kernel rows
    gain ``serve_launches`` (by request);
13b. fleet (``phase_fleet``, in phase 13a's temporary root; alone with
    ``--only fleet``): the cluster targets and the serving fleet on the
    card (ROADMAP items 11b and 11d).  ``CopyVolumeWorkflow(target=
    "slurm")`` copies phase 13a's boundary map into a fresh zarr
    through stub ``sbatch``/``squeue``/``scancel`` (a job is a detached
    local process running the port's ``cluster_runner`` on the node's
    CPU), its first submission swallowed by a ``job_loss`` fault: the copy
    equals its source byte for byte, the task's ``supervisor.resubmits``
    is 1 and ``failures.json`` holds the resolved ``job_loss`` record.
    Then ``python -m cluster_tools_tpu_torch.fleet`` with two members on
    the one card: alice's watershed on the copy through the gateway,
    the owning member SIGKILLed at its first block marker, its journal
    claimed, fenced and adopted by the survivor; the request completes
    with no resubmission, its labels equal phase 13a's bit for bit, its
    launches are the yardstick watershed's (B1 4, B2 4, B3 12, B4 4),
    ``lifecycle.log`` records the
    crash and the respawn, and SIGTERM ends the fleet with exit 114.
    Prints the members' boot times, kill-to-adoption, the adopted
    request's ``run_s`` and ``queued_s``, each member's peak memory and the
    phase's wall.  The kernel rows gain ``fleet_launches``;
13c. analysis (``phase_analysis``; alone with ``--only analysis``):
    postprocessing, analysis and export on the card (ROADMAP items 12b
    and 12d) on the first 192^3 of the "blockwise" phase's watershed
    labels and boundary map in ``memory://`` (block 96^3): the size
    filter and the graph-watershed size filter, cc on a segmentation, hole
    filling, morphology, node labels, evaluation, statistics, downscaling,
    the affine transform, skeletons and meshes, and on the first 128^3
    paintera and bdv export, label multisets, pair distances and the
    debugging checks; every arm once on the card with its wall, peak GB
    and launches, each gated against scipy / numpy oracles or its CPU run
    (the gates in ``phase_analysis``).  The kernel rows gain
    ``analysis_launches``;
13d. lifted (``phase_lifted``; alone with ``--only lifted``, which adds
    its arm (a) at 512^3, ``lifted_full``): the lifted multicut, the
    mutex-watershed blocks and stitching (ROADMAP item 12c), each arm on
    the card and on the CPU, equal bit for bit: (a)
    ``LiftedMulticutSegmentationWorkflow`` with its own watershed (B1-B4
    launched) on the first ``LIFTED_CROP``^3 of the main path's map, the main path's
    cc labels as the attribution, and its global solve again with 2
    shards; (b) ``MwsWorkflow`` with and without its stitching on
    affinities of a ``synthetic_em_volume`` ground truth, scored by
    ``EvaluationWorkflow``; (c) ``StitchingWorkflow`` with
    ``merge_mode="multicut"`` on (b)'s independent blocks with 1 and 2
    shards.  Prints walls, per-task seconds, graph and lifted sizes,
    energies, peak device GB and peak host RSS by task (the gates in
    ``phase_lifted``).  The kernel rows gain ``lifted_launches``;
14. inference (``phase_inference``): ``InferenceWorkflow`` with the
    full-width U-Net (base 16, depth 2, GroupNorm, bfloat16; seeded weights
    saved with the port's ``save_checkpoint`` and read back from the npz) on
    the main path's 512^3 volume (block 128^3, halo 8: 64 blocks of 144^3),
    then ``train_pixel_classifier`` on the card (ROADMAP item 8b: the first
    128^3 of the map, 1% of it labelled by the main path's threshold; ``W``
    and ``b`` within 1e-3 of the same call on the CPU, relative to its
    largest entry, the classes of the labelled voxels equal; the training
    wall), then ``IlastikPredictionWorkflow`` (block 128^3, halo 12) with
    that trained linear classifier on the default feature bank and with a
    seeded forest
    (16 trees of depth 8) on all six ilastik feature ids.  Per workflow a
    warm-up and one timed run with the "blockwise" columns; the U-Net's
    FLOP count and bound and one block's synced forward; gates: the
    U-Net's output finite in [0, 1], two blocks (interior, far corner)
    equal to the port's CPU forward of the same npz within 2e-2, a float32
    model on one block equal to its CPU forward within 2e-4 (TF32 off),
    the probabilities summing to 1 within 1e-5, one block of each
    classifier equal to its CPU run within 2e-3 (the forest on voxels clear
    of its split thresholds), and the forest's descent on the card's
    features equal to its CPU descent within 1e-6.  The kernel rows gain
    ``inference_launches`` (0: this path runs no hand kernel).

Only with ``--only multicard`` (``multicard_alone``; two cards or more of
one host): the mesh, the collectives, the NCCL pod and
the executor with their shards or processes dealt over the cards, each
held bit for bit against the same grid on cuda:0 (ROADMAP item 10c's NCCL
leg).  (a) the split and fused steps on ``SHARDED_SHAPE`` at dp=1 x sp=4
and dp=2 x sp=4 (every B1-B4 kernel launched on every card; every launch
of a split run replayed on its card against its twin, B1d on B1's
inputs); (b) the mesh-exact EDT across card cuts against scipy; (c) NCCL
pods of 4 x 1 and 2 x 2 (each process on a card of its own, 0 bytes
staged through host memory) against the in-process mesh; (d) the
executor's shards arm at k = 1 and 4; (e) the collective reduce plane on
a sibling mesh over the cards against the same plane on cuda:0 and the
host plane; (f) ``FusedSegmentationWorkflow`` over the cards.  Prints the
peer-access matrix, ``nvidia-smi topo -m``, per stage ms, voxels/s,
collective counters and each card's peak GB, beside the cards' name and
power limit.  On one card the full smoke logs that this arm does not run.

Prints the kernels' JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero (and prints no result)
without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
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
# the main path's configuration (the JAX benchmark's headline)
MAIN_CFG = dict(halo=32, threshold=0.45, dt_max_distance=32.0, min_seed_distance=2.0, seed_mode="sparse")
# the "sharded" phase: a dp x sp mesh of 8 shards on the card
SHARDED_SHAPE = (2, 512, 512, 512)
# the uncapped mesh-exact EDT (radius edge - 1) against scipy, and the
# cross-process run, use this edge: above radius 160 the twin's EDT pass
# materialises (lines, n, n) (ops/edt.py), ~68 GB for a 512-long pass over
# a 512 x 128 shard.  The two-axis step's exact EDT is capped at
# dt_max_distance (radius 32), so its twin runs at full size.
SHARDED_TWIN_EDGE = 256

KERNELS = {
    # name: (id, source, replaces)
    "tile_ccl": ("B1", "cluster_tools_tpu_torch/csrc/tile_ccl.cu", "cluster_tools_tpu/ops/pallas_kernels.py:185"),
    "tile_ccl_doubling": ("B1d", "cluster_tools_tpu_torch/csrc/tile_ccl_doubling.cu",
                          "cluster_tools_tpu/ops/pallas_kernels.py:76"),
    "tile_ws_propagate": ("B2", "cluster_tools_tpu_torch/csrc/tile_ws.cu", "cluster_tools_tpu/ops/pallas_kernels.py:277"),
    "edt_cascade": ("B3", "cluster_tools_tpu_torch/csrc/edt_cascade.cu", "cluster_tools_tpu/ops/pallas_kernels.py:332"),
    "apply_remap": ("B4", "cluster_tools_tpu_torch/csrc/apply_remap.cu", "cluster_tools_tpu/ops/pallas_kernels.py:384"),
    # the stages' row scans: no Pallas kernel, XLA's lax.cumsum / lax.cummax
    "row_scan.sum": ("S1", "cluster_tools_tpu_torch/csrc/row_scan.cu", "none (lax.cumsum)"),
    "row_scan.max": ("S2", "cluster_tools_tpu_torch/csrc/row_scan.cu", "none (lax.cummax)"),
}
# the config-4 shape: the fused RAG + parallel GAEC on this crop of the main
# path's watershed labels
CONFIG4_CROP = 256
# the agglomerating watershed and its impl="torch" twin (block half of it):
# cut from 256^3 to 128^3 (~87 s at 256^3) to pay for the "reduce-tree"
# phase, then to 96^3 (22.4 s at 128^3 on a slow host) with the crops below
AGG_WS_CROP = 96
# the "reduce-tree" phase: sibling shards on the one card, and the device
# page pool's budget for the collective plane's lanes (a level of the 512^3
# graph's pages; the tasks' default of 256 MiB would hold none)
REDUCE_SHARDS = 8
REDUCE_POOL_BYTES = 8 << 30
# the default multicut workflow (its own watershed, gaec_parallel subproblems,
# the Kernighan-Lin global solve on the host C++ rung): cut from 512^3 to
# 384^3 (30.4 s at 512^3) to pay for the "serve" phase, then to 256^3 (17.4
# s at 384^3 on a slow host) with the crops below
MC_DEFAULT_CROP = 256
# the phases after "blockwise" that the host bounds (zlib and the digest
# sidecars, the graph solvers, the servers' processes) run on crops of the
# main path's volume: the whole smoke at 512^3 took 850.7-1141.1 s on H100
# hosts against its 1200 s limit, and a slower host ran past the limit.
# "multicut" runs its workflows on the first MC_EDGE^3 of the blockwise
# watershed (so "native" and "reduce-tree" solve that graph), and
# "reduce-tree" its fused workflow on the first FUSED_EDGE^3 of the volume
# (8 shards of 48 planes, above the halo of 32); "serve" and "fleet" run on
# the first SERVE_EDGE^3 (27 blocks of 128^3, four sweep calls: a request
# is still drained and adopted mid-sweep); "fusion" on the first
# FUSION_EDGE^3 (its cc arm at the same size)
MC_EDGE = 256
FUSED_EDGE = 384
SERVE_EDGE = 384
FUSION_EDGE = 256
# the "native" phase: each host C++ function against its Python path on the
# default workflow's graph, features and reduced problem at this crop (block
# half of it), the EDT and the flood on a block of this edge, and the mutex
# watershed on an affinity volume of MWS_EDGE^3
NATIVE_CROP = 128
MWS_EDGE = 64
# three attractive (unit) and three repulsive (long-range) offsets
MWS_OFFSETS = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [-4, 0, 0], [0, -4, 0], [0, 0, -4]]
# the reduce tree's worker group as this script measured it before the
# host C++ rung (one H100 80GB HBM3 at 700 W; PERF.md section 5)
BEFORE_RUNG_WORKERS_S = 16.241
# the "reduce-tree" phase holds the packet plane against the collective
# plane on the induced subgraph of the first 1/8 of the 512^3 graph's nodes
# (the whole graph took 48.9-63.4 s on the packet plane): cut to pay for the
# "fleet" phase
PACKET_NODE_FRACTION = 8
# the config-4 tasks whose host work the C++ rung takes
MC_HOST_TASKS = ("merge_sub_graphs", "merge_edge_features", "solve_subproblems", "reduce_problem", "solve_global")
# the kernels the main path must launch (B1d is a variant nothing selects)
MAIN_PATH_KERNELS = ("tile_ccl", "tile_ws_propagate", "edt_cascade", "apply_remap")
# tiles of B2's adversarial fields: small, unaligned rows and odd ty, the main tile
FLOW_TILES = ((4, 8, 32), (4, 5, 30), (8, 8, 64), (16, 16, 128))
# CCL tiles beside the main one: an axis of extent 1 (no z pass; one voxel
# a row), columns longer than B1d holds in registers, rows that span a warp
CCL_TILES = ((1, 16, 128), (16, 16, 1), (40, 24, 16), (1, 4, 512))


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def write_json(path: str, doc) -> None:
    """A config file for the port's tasks, written atomically (temp file +
    ``os.replace``) as the port writes its own."""
    from cluster_tools_tpu_torch.utils.function_utils import atomic_write_json

    atomic_write_json(path, doc)


def nvidia_smi_lines() -> list:
    """``nvidia-smi``'s name and power limit, one line a card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()


def nvidia_smi() -> str:
    return nvidia_smi_lines()[0]


def phase_lint(card: str) -> dict:
    """The port's ctlint over its default walk, run as a user would run it
    (``python3 -m cluster_tools_tpu_torch.lint --json`` from the tree's
    root); fails on any finding.  Returns the findings document."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "cluster_tools_tpu_torch.lint", "--json"], cwd=root,
                         capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    if out.returncode not in (0, 1):
        raise RuntimeError(f"lint: exit {out.returncode}: {out.stderr[-2000:]}")
    doc = json.loads(out.stdout)
    log("lint", f"ctlint: {doc['n_files']} files, {doc['n_suppressed']} suppressed, findings by rule "
                f"{doc['counts']}, {secs:.2f} s [{card}]")
    if out.returncode != 0 or doc["findings"]:
        raise AssertionError("lint: " + "; ".join(f"{f['file']}:{f['line']}: {f['rule']} {f['message']}"
                                                  for f in doc["findings"][:10]))
    return doc


def cuda_ms(fn, reps: int, device=None) -> float:
    """Mean ms of ``fn`` over ``reps`` launches after one warm-up (CUDA
    events on ``device``'s current stream, default the current card;
    ``fn`` must launch on that card)."""
    with torch.cuda.device(device) if device is not None else contextlib.nullcontext():
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


def card_kernel_launches(card_launches: dict) -> dict:
    """``{card: {kernel: launches}}`` of the B1-B4 kernels from
    ``K.CARD_LAUNCHES``."""
    out: dict = {}
    for (name, card), n in sorted(card_launches.items()):
        if name in MAIN_PATH_KERNELS:
            out.setdefault(card, {})[name] = n
    return out


def sync_cards() -> None:
    """Wait for every visible card: a wall time ends here (a bare
    ``torch.cuda.synchronize()`` waits for the current card only)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def reset_peaks() -> None:
    """Reset every visible card's peak of allocated memory."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)


def card_peaks_gb() -> list:
    """Each visible card's peak of allocated memory since :func:`reset_peaks`, GB."""
    return [torch.cuda.max_memory_allocated(i) / 1e9 for i in range(torch.cuda.device_count())]


def max_card_peak_gb() -> float:
    """The largest of :func:`card_peaks_gb` (on one card: its peak)."""
    return max(card_peaks_gb(), default=0.0)


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
    # the row scan: rows of 0, 1 and a tile +- 1 elements, long ragged rows
    # (odd lengths take the scalar form), bool rows, and all-(-1) max rows
    lengths = (0, 1, K.ROW_SCAN_TILE - 1, K.ROW_SCAN_TILE, K.ROW_SCAN_TILE + 1, 1_000_003, 1 << 22)
    for n in lengths:
        x = torch.randint(-(2**31), 2**31 - 1, (3, n), generator=gen, device=dev, dtype=torch.int32)
        flags = torch.rand((3, n), generator=gen, device=dev) < 0.3
        for what, op, xs in (("int32 sum", "sum", x), ("bool sum", "sum", flags), ("int32 max", "max", x),
                             ("-1 max", "max", torch.full_like(x, -1))):
            require_equal(f"row scan {what} of [3, {n}]", K.row_scan(xs, op, impl="cuda"), K.row_scan_torch(xs, op))
    sync_cards()
    log("kernels", f"B1 and B1d (smooth mask, 8 adversarial tiles on 16x16x128, "
                   f"{', '.join('x'.join(map(str, t)) for t in CCL_TILES)} tiles, noise at 3 densities on "
                   f"4x5x32, 4x5x40, 1x16x128 and 16x16x1 tiles; B1d "
                   f"against both twin formulations, iteration counts included), "
                   f"B2 (jump + stepping twins; descent field, edited field, adversarial fields on "
                   f"{', '.join('x'.join(map(str, t)) for t in FLOW_TILES)} tiles), "
                   f"B3 ({n_b3} axis/n/radius/weight cases), "
                   f"B4 (-1 slots, chained pair; {len(REMAP_KINDS) + 1} adversarial table kinds on "
                   f"16x16x128, 4x8x32, 4x8x30 tiles), the row scan (sum of int32 and bool, max, "
                   f"rows of {', '.join(map(str, lengths))}) equal their twins exactly")


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
    elif name.startswith("row_scan."):
        nbytes = n * (x.element_size() + 4)
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
    elif name.startswith("row_scan."):
        kfn = lambda: K.row_scan(args[0], kwargs["op"], impl="cuda")
        tfn = lambda: K.row_scan_torch(args[0], kwargs["op"])
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
    write_json(os.path.join(d, "cfg", "global.config"),
               dict({"block_shape": list(block_shape)}, **(global_config or {})))
    tmp = os.path.join(d, "tmp")
    wf = workflow_cls(tmp_folder=tmp, config_dir=os.path.join(d, "cfg"), max_jobs=8,
                      block_shape=list(block_shape), **params)
    K.reset_counts()
    reset_peaks()
    sync_cards()
    t0 = time.perf_counter()
    ok = run_dag([wf])
    sync_cards()
    wall = time.perf_counter() - t0
    launches, rungs, card_launches = dict(K.LAUNCHES), dict(K.RUNGS), dict(K.CARD_LAUNCHES)
    manifests = [json.load(open(os.path.join(tmp, f))) for f in sorted(os.listdir(tmp)) if f.endswith(".success.json")]
    if not ok:
        logs = "".join(open(os.path.join(tmp, f)).read()[-3000:] for f in sorted(os.listdir(tmp)) if f.endswith(".log"))
        raise AssertionError(f"blockwise {tag}: the workflow failed; task logs:\n{logs}")
    shutil.rmtree(d)
    sweep = Counter()
    for m in manifests:
        sweep.update({k: v for k, v in m.get("sweep", {}).items() if k.endswith("_s")})
    overflow = sorted(b for m in manifests for b in m.get("overflow_blocks", []))
    return dict(wall_s=wall, peak_gb=max_card_peak_gb(), peaks_gb=card_peaks_gb(), launches=launches, rungs=rungs,
                card_launches=card_launches, sweep=dict(sweep), overflow_blocks=overflow,
                sweeps=[m["sweep"] for m in manifests if "sweep" in m])


def bw_timed(K, tmp_root: str, tag: str, workflow_cls, block_shape, voxels: int, n_blocks: int,
             phase: str = "blockwise", global_config=None, warm_up: bool = True, **params) -> dict:
    """A warm-up (unless ``warm_up=False``: the per-block sweeps and the
    ilastik arms run without one since the "serve" phase needed the time,
    the blockwise cc and relabel since a slower host ran the smoke past
    its limit)
    and one timed run (two until the host C++ rung's phases needed the
    time); prints the workflow's line (under ``phase``) and returns the
    timed run's record."""
    if warm_up:
        bw_run(K, tmp_root, tag, workflow_cls, block_shape, global_config, **params)
    rec = bw_run(K, tmp_root, tag, workflow_cls, block_shape, global_config, **params)
    sw = rec["sweep"]
    log(phase, f"{tag}: {voxels} voxels, {n_blocks} blocks; wall {rec['wall_s']:.3f} s = "
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
        cc = bw_timed(K, tmp_root, "cc", ConnectedComponentsWorkflow, block, voxels, n_blocks, warm_up=False,
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
        bw_timed(K, tmp_root, "relabel", RelabelWorkflow, block, voxels, n_blocks, warm_up=False,
                 input_key="ws2", output_key="ws2_relabel", **io)
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
        auto["cc256"] = bw_run(K, tmp_root, "cc256-memory", ConnectedComponentsWorkflow, block, input_path=mem,
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
    the wall (one run after a warm-up), blocks/s, the calls to the
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
                          global_config={"sweep_mode": "per_block"}, warm_up=False, output_key=f"{tag}_pb",
                          **params, **io)
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
        # the watershed at 512^3, cc on the blockwise phase's 256^3 crop (its
        # eight blocks, four lanes a shard at k = 2): cc's wall is host-bound
        # stores, and the 512^3 cc stays in ``--only shards``
        shards_arm(K, tmp_root, f, auto, {"ws": (*cases["ws"][:2], "ws", 8),
                                          "cc256": (ConnectedComponentsWorkflow,
                                                    dict(input_key="mask256", connectivity=1), "cc256", 4)},
                   io, rows, block)
    for row in rows:
        row["sweep_launches"] = {t: auto[t]["launches"].get(row["name"], 0) for t in cases}
    log("sweeps", f"phase {time.perf_counter() - t_phase:.1f} s")


# the executor's shard counts of the "sweeps" phase's shards arm (on one
# card, several shards share it); ``--only shards`` runs SHARDS_ALONE and
# the 512^3 cc (the k = 4 arm and the 512^3 cc left the full smoke to keep
# it under 1200 s)
SHARDS = (2,)
SHARDS_ALONE = (2, 4)


def sweep_line(sweeps: list) -> str:
    """The executor's stage seconds and waits, summed over a run's sweeps."""
    tot = Counter()
    for x in sweeps:
        tot.update({k: x.get(k, 0) for k in ("load_s", "h2d_s", "kernel_s", "d2h_s", "store_s", "dispatch_wait_s",
                                            "n_backpressure_waits")})
    return (f"load {tot['load_s']:.2f} / h2d {tot['h2d_s']:.2f} / kernel {tot['kernel_s']:.2f} / d2h "
            f"{tot['d2h_s']:.2f} / store {tot['store_s']:.2f} s summed, dispatch waits {tot['dispatch_wait_s']:.2f} s, "
            f"{tot['n_backpressure_waits']} backpressure waits")


def shards_arm(K, tmp_root: str, f, auto: dict, cases: dict, io: dict, rows: list, block,
               shard_counts=SHARDS, control: bool = False) -> None:
    """The blockwise executor over a mesh of shards (ROADMAP item 10c):
    workflows of the "blockwise" phase (``sweep_mode`` auto, block 128^3)
    with ``BlockwiseExecutor`` on k shards, k in ``shard_counts`` (and the
    card count when there are two cards or more), set through
    ``CTT_MESH_SHARDS``, the count a task's executor takes.  ``cases`` maps
    a tag to ``(workflow class, params, the key of its 1-shard output,
    lanes a shard)``, ``auto[tag]`` is that 1-shard run's record.
    ``sharded_batch`` is k times the lanes a shard (8: the lanes of a
    1-shard call, so the launches are comparable): the output files must
    equal the 1-shard auto runs bit for bit, and the B1-B4 launch totals
    must equal theirs.  Prints each arm's wall, device calls per
    shard (per card with several), rung and peak device GB.  With
    ``control``, each workflow also runs on 1 shard at the largest batch of
    the arm (the same batches, unsplit): what the batch size costs apart
    from the split.  Adds ``shards_launches`` to the kernel rows."""
    n_cards = torch.cuda.device_count()
    ks = list(shard_counts) + ([n_cards] if n_cards >= 2 and n_cards not in shard_counts else [])
    if n_cards < 2:
        log("sweeps", f"shards: one card visible ({torch.cuda.get_device_name(0)}): every shard shares cuda:0; "
                      "the per-card arm does not run")
    saved = os.environ.get("CTT_MESH_SHARDS")
    shard_launches = {}
    want_files = {tag: f[ref][...] for tag, (_, _, ref, _) in cases.items()}
    t_arm = time.perf_counter()
    try:
        for k in ks:
            os.environ["CTT_MESH_SHARDS"] = str(k)
            for tag, (cls, params, _, lanes) in cases.items():
                key = f"{tag}_k{k}"
                rec = bw_run(K, tmp_root, f"{tag}-shards{k}", cls, block, {"sharded_batch": lanes * k},
                             output_key=key, **params, **io)
                sw = [x for x in rec["sweeps"] if x.get("n_devices")]
                if not sw or {x["n_devices"] for x in sw} != {k} or {x["sweep_mode"] for x in sw} != {"sharded"}:
                    raise AssertionError(f"sweeps shards {tag} k={k}: the sweeps ran "
                                         f"{[(x.get('sweep_mode'), x.get('n_devices')) for x in rec['sweeps']]}")
                if not np.array_equal(want_files[tag], f[key][...]):
                    raise AssertionError(f"sweeps shards {tag} k={k}: the file differs from the 1-shard auto run")
                got = {n: rec["launches"].get(n, 0) for n in MAIN_PATH_KERNELS}
                want = {n: auto[tag]["launches"].get(n, 0) for n in MAIN_PATH_KERNELS}
                if got != want:
                    raise AssertionError(f"sweeps shards {tag} k={k}: launches {got}, the 1-shard run's {want}")
                calls = np.sum([x["shard_calls"] for x in sw], axis=0).tolist()
                per_card = ""
                if n_cards >= 2:
                    per_card = ("; calls per card " + str([sum(c for s_, c in enumerate(calls) if s_ % n_cards == c_)
                                                           for c_ in range(n_cards)])
                                + "; B1-B4 launches per card " + str(card_kernel_launches(rec["card_launches"]))
                                + "; peak GB per card " + "/".join(f"{p:.2f}" for p in rec["peaks_gb"]))
                shard_launches[f"{tag} k={k}"] = got
                log("sweeps", f"shards {tag} k={k} (sharded_batch {lanes * k}): wall {rec['wall_s']:.3f} s, device "
                              f"calls per shard {calls}{per_card}, rungs "
                              f"{sorted({r for x in sw for r in x.get('batch_rungs', [])})}, peak "
                              f"{rec['peak_gb']:.2f} GB, {sweep_line(sw)}; equal to the 1-shard file bit for bit; "
                              f"launches {got} = the 1-shard run's (its wall {auto[tag]['wall_s']:.3f} s, "
                              f"{sweep_line(auto[tag]['sweeps'])})")
        if control:
            os.environ["CTT_MESH_SHARDS"] = "1"
            for tag, (cls, params, _, lanes) in cases.items():
                rec = bw_run(K, tmp_root, f"{tag}-control", cls, block, {"sharded_batch": lanes * max(ks)},
                             output_key=f"{tag}_control", **params, **io)
                if not np.array_equal(want_files[tag], f[f"{tag}_control"][...]):
                    raise AssertionError(f"sweeps shards {tag} control: the file differs from the auto run")
                log("sweeps", f"shards {tag} control, 1 shard, sharded_batch {lanes * max(ks)}: wall "
                              f"{rec['wall_s']:.3f} s, peak {rec['peak_gb']:.2f} GB, {sweep_line(rec['sweeps'])}, "
                              f"launches { {n: rec['launches'].get(n, 0) for n in MAIN_PATH_KERNELS} }")
    finally:
        if saved is None:
            os.environ.pop("CTT_MESH_SHARDS", None)
        else:
            os.environ["CTT_MESH_SHARDS"] = saved
    del want_files
    for row in rows:
        row["shards_launches"] = {t: v.get(row["name"], 0) for t, v in shard_launches.items()}
    log("sweeps", f"shards arm {time.perf_counter() - t_arm:.1f} s")


# the "faults" phase: the watchdog's deadline and the injected load hang
# (far past it), the blocks each fault targets on the 4 x 4 x 4 grid of
# 128^3 blocks (Morton batches of 8: block 8 leads the third batch), and
# the split inference arm's region of interest, halo and OOM gate
FAULTS_DEADLINE_S = 1.5
FAULTS_HANG_S = 4.0
FAULT_BLOCKS = dict(hang=21, nan=42, flip=7, dispatch=8, read_rot=5)
# the from-disk arm runs on the volume's first DISK_EDGE^3 (cut from 512^3
# to keep the smoke under 900 s), against its own memory:// run
DISK_EDGE = 256
DISPATCH_BATCH = [8, 9, 12, 13, 24, 25, 28, 29]
# (the U-Net without GroupNorm: its receptive radius is 22 at depth 2; the
# ROI, cut from 384^3 to 256^3 to keep the smoke under 900 s, keeps every
# block's halo in the volume, and sub-blocks of 64^3 have at most 112^3
# outer voxels against the full blocks' 152^3 or more)
SPLIT = dict(block=(128, 128, 128), roi=((0, 0, 0), (256, 256, 256)), halo=24, min_voxels=2_000_000,
             model={"name": "unet3d", "norm": None})


def fault_run(K, root: str, tag: str, workflow_cls, block, env=None, spec=None, global_config=None,
              **params) -> dict:
    """One run of a port workflow on the card under ``env`` (CTT_* names,
    restored after) and the fault ``spec`` (the injector reset after): wall
    (ended by a device sync), kernel launches, the sweep summaries, the
    ``failures.json`` records, the trace's summary and counters, and the
    ``tmp_folder`` (kept for the caller's checks)."""
    from cluster_tools_tpu_torch.runtime import faults, trace
    from cluster_tools_tpu_torch.runtime.task import build as run_dag
    from cluster_tools_tpu_torch.utils import function_utils as fu

    d = tempfile.mkdtemp(prefix=f"{tag}-", dir=root)
    os.makedirs(os.path.join(d, "cfg"))
    write_json(os.path.join(d, "cfg", "global.config"), dict({"block_shape": list(block)}, **(global_config or {})))
    tmp = os.path.join(d, "tmp")
    env = dict(env or {})
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    trace.reset()
    faults.configure(spec)
    try:
        wf = workflow_cls(tmp_folder=tmp, config_dir=os.path.join(d, "cfg"), max_jobs=8, block_shape=list(block),
                          **params)
        K.reset_counts()
        sync_cards()
        t0 = time.perf_counter()
        ok = run_dag([wf])
        sync_cards()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        tstats = trace.stats()
    finally:
        faults.reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        trace.reset()
    if not ok:
        logs = "".join(open(os.path.join(tmp, f)).read()[-3000:] for f in sorted(os.listdir(tmp)) if f.endswith(".log"))
        raise AssertionError(f"faults {tag}: the workflow failed; task logs:\n{logs}")
    manifests = [json.load(open(os.path.join(tmp, f))) for f in sorted(os.listdir(tmp)) if f.endswith(".success.json")]
    doc = fu.read_json_if_valid(fu.failures_path(tmp)) or {"records": []}
    summary_path = os.path.join(tmp, "trace_summary.json")
    return dict(wall_s=wall, launches=launches, sweeps=[m["sweep"] for m in manifests if "sweep" in m],
                records=doc["records"], tmp=tmp, trace_stats=tstats,
                trace_summary=json.load(open(summary_path)) if os.path.exists(summary_path) else None)


def fault_line(tag: str, rec: dict, check: str, sidecars: int, repaired: int = 0) -> None:
    sw = rec["sweeps"]
    ts = rec["trace_stats"]
    log("faults", f"{tag}: wall {rec['wall_s']:.3f} s; {check}; speculated "
                  f"{sum(x.get('n_speculated', 0) for x in sw)}, split {sum(x.get('n_split', 0) for x in sw)}, "
                  f"repaired {repaired}, sidecars written {sidecars}, trace events "
                  f"{ts['spans'] + ts['instants']}, dropped events {ts['dropped']}; launches {rec['launches']}")


def require_kernels(tag: str, launches: dict) -> None:
    missing = [k for k in MAIN_PATH_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"faults {tag}: the run launched no {missing}")


def phase_faults(K, vol: torch.Tensor, mem: str, rows: list, block=(128, 128, 128)) -> None:
    """Faults, traces and integrity on the card (ROADMAP item 11a): the
    512^3 ``WatershedWorkflow`` of the "blockwise" phase (block 128^3, halo
    32, ``sweep_mode`` auto: 8 blocks a call, B1-B4 on the card) in four
    arms, each equal to that phase's labels bit for bit:

    1. plain (``CTT_CHECKSUMS=0``), checksums on (the default), and
       hardened (checksums, ``CTT_TRACE`` and ``block_deadline_s``): the
       checksum and tracing costs;
    2. faults: one spec with a load hang far past the deadline, a kernel
       NaN, an ``io_write`` bit flip and a ``dispatch`` OOM; every fault
       attributed in ``failures.json`` with its resolution and at least
       one speculative duplicate;
    3. from disk (the first ``DISK_EDGE``^3 of the volume, against its own
       ``memory://`` run): the watershed from the port's zarr on local disk
       with checksums on (a sidecar a block) and off (none), then an
       ``io_read`` bit flip on a stored block that the verifying reader
       catches and lineage repair heals (the block recomputed on the card);
    4. split inference: ``InferenceWorkflow`` (the full-width U-Net without
       GroupNorm, bfloat16, block 128^3, halo 24 over its receptive radius
       of 22, an ROI of 256^3 whose halos hold data: ``SPLIT``) with
       ``allow_block_split`` under a full-block ``compute`` OOM, split into
       sub-blocks and equal to its unsplit run within 2e-2.

    Each arm prints its wall, check and counters; the phase prints the
    traced arm's top spans.  The kernel rows gain ``faults_launches``."""
    from cluster_tools_tpu_torch.io.containers import open_container
    from cluster_tools_tpu_torch.models import UNet3D
    from cluster_tools_tpu_torch.runtime import faults, repair
    from cluster_tools_tpu_torch.tasks.inference import InferenceWorkflow, save_checkpoint
    from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow
    from cluster_tools_tpu_torch.utils.volume_utils import Blocking

    t_phase = time.perf_counter()
    os.environ["CT_FILL_MODE"], os.environ["CT_TIER_MODE"] = "capacity", "cond"
    f = open_container(mem)
    yardstick = f["ws"][...]
    shape = yardstick.shape
    blocking = Blocking(shape, block)
    ws_cfg = dict(halo=[32, 32, 32], threshold=0.45, dt_max_distance=32.0, min_seed_distance=2.0)
    io = dict(input_path=mem, input_key="boundaries", output_path=mem)
    arm_launches = {}

    def equal(tag, key, container=f, want=yardstick, what="the blockwise phase's"):
        got = container[key][...]
        if not np.array_equal(got, want):
            raise AssertionError(f"faults {tag}: labels differ from {what} at {int((got != want).sum())} voxels")
        return f"labels equal {what} bit for bit"

    with tempfile.TemporaryDirectory(prefix="faults-") as root:
        # ---- 1. the costs of checksums and tracing, in turns ----
        arms = {"plain": ({"CTT_CHECKSUMS": "0"}, {}),
                "checksums": ({"CTT_CHECKSUMS": "1"}, {}),
                "hardened": ({"CTT_CHECKSUMS": "1", "CTT_TRACE": "1"}, {"block_deadline_s": FAULTS_DEADLINE_S})}
        walls = {tag: [] for tag in arms}
        for tag in ("plain", "checksums", "hardened"):
            env, gc = arms[tag]
            rec = fault_run(K, root, f"ws-{tag}", WatershedWorkflow, block, env, global_config=gc,
                            output_key=f"ws_{tag}", **ws_cfg, **io)
            require_kernels(tag, rec["launches"])
            # counted before the check's whole read, which adopts a digest
            # where a product store has none
            sidecars = len(f[f"ws_{tag}"].checksum_regions())
            check = equal(tag, f"ws_{tag}")
            if rec["records"]:
                raise AssertionError(f"faults {tag}: a fault-free run left records {rec['records']}")
            if sidecars != (0 if tag == "plain" else blocking.n_blocks):
                raise AssertionError(f"faults {tag}: {sidecars} sidecars for 64 blocks")
            fault_line(tag, rec, check, sidecars)
            walls[tag].append(rec["wall_s"])
            arm_launches[tag] = rec["launches"]
            if tag == "hardened":
                top = sorted(rec["trace_summary"]["sites"].items(), key=lambda kv: -kv[1]["total_s"])[:6]
                log("faults", "hardened trace top spans: " + "; ".join(
                    f"{k} n={v['count']} total {v['total_s']:.3f} s p50 {v['p50_ms']:.2f} ms "
                    f"p99 {v['p99_ms']:.2f} ms" for k, v in top))
            del f._data[f"ws_{tag}"]
        mean = {tag: sum(w) / len(w) for tag, w in walls.items()}
        log("faults", "walls in turns " + ", ".join(f"{t} {w}" for t, w in walls.items()) + f"; checksum cost "
                      f"{mean['checksums'] - mean['plain']:+.3f} s ({mean['checksums'] / mean['plain'] - 1:+.1%}) "
                      f"over plain {mean['plain']:.3f} s; tracing and the watchdog "
                      f"{mean['hardened'] - mean['checksums']:+.3f} s ({mean['hardened'] / mean['checksums'] - 1:+.1%})"
                      " (one run each)")

        # ---- 2. faults ----
        spec = {"faults": [
            {"site": "load", "kind": "hang", "blocks": [FAULT_BLOCKS["hang"]], "seconds": FAULTS_HANG_S,
             "fail_attempts": 1, "tasks": ["watershed"]},
            {"site": "kernel", "kind": "nan", "blocks": [FAULT_BLOCKS["nan"]], "tasks": ["watershed"]},
            {"site": "io_write", "kind": "corrupt", "blocks": [FAULT_BLOCKS["flip"]], "tasks": ["watershed"]},
            {"site": "dispatch", "kind": "oom", "blocks": [FAULT_BLOCKS["dispatch"]], "tasks": ["watershed"]},
        ]}
        rec = fault_run(K, root, "ws-faulted", WatershedWorkflow, block, {"CTT_TRACE": "1"}, spec,
                        {"block_deadline_s": FAULTS_DEADLINE_S}, output_key="ws_faulted", **ws_cfg, **io)
        require_kernels("faulted", rec["launches"])
        check = equal("faulted", "ws_faulted")
        by_block = {r["block_id"]: r for r in rec["records"] if r.get("block_id") is not None}
        want = {FAULT_BLOCKS["hang"]: "hung", FAULT_BLOCKS["nan"]: "validate", FAULT_BLOCKS["flip"]: "corrupt"}
        for b, site in want.items():
            if b not in by_block or site not in by_block[b]["sites"] or not by_block[b]["resolved"]:
                raise AssertionError(f"faults faulted: block {b} has no resolved {site!r} record: {by_block.get(b)}")
        if by_block[FAULT_BLOCKS["flip"]]["sites"] != {"corrupt": 1, "store": 1}:
            raise AssertionError(f"faults faulted: the flipped block's record {by_block[FAULT_BLOCKS['flip']]}")
        unsharded = sorted(b for b, r in by_block.items() if r.get("resolution") == "degraded:unsharded")
        if unsharded != DISPATCH_BATCH or any(by_block[b]["sites"] != {"dispatch": 1, "oom": 1} for b in unsharded):
            raise AssertionError(f"faults faulted: degraded:unsharded blocks {unsharded}, expected {DISPATCH_BATCH}")
        if not all(r["resolved"] for r in rec["records"]):
            raise AssertionError(f"faults faulted: unresolved records {rec['records']}")
        n_spec = sum(x.get("n_speculated", 0) for x in rec["sweeps"])
        if n_spec < 1:
            raise AssertionError("faults faulted: no speculative duplicate ran")
        fault_line("faulted", rec, check + f"; records: hung block {FAULT_BLOCKS['hang']} "
                   f"{by_block[FAULT_BLOCKS['hang']]['sites']}, NaN block {FAULT_BLOCKS['nan']} validate, flipped "
                   f"block {FAULT_BLOCKS['flip']} corrupt+store, batch {DISPATCH_BATCH} degraded:unsharded",
                   len(f["ws_faulted"].checksum_regions()))
        arm_launches["faulted"] = rec["launches"]
        del f._data["ws_faulted"]

        # ---- 3. from disk: sidecars on and off, and read rot healed ----
        dshape = (DISK_EDGE,) * 3
        dblocking = Blocking(dshape, block)
        crop = tuple(slice(0, e) for e in dshape)
        b_np = np.ascontiguousarray(vol.reshape(shape)[crop].cpu().numpy())
        f.require_dataset("boundaries_disk", shape=dshape, chunks=block, dtype="float32")[...] = b_np
        ref_rec = fault_run(K, root, "disk-yardstick", WatershedWorkflow, block, input_path=mem,
                            input_key="boundaries_disk", output_path=mem, output_key="ws_disk_ref", **ws_cfg)
        disk_ref = f["ws_disk_ref"][...]
        disk = os.path.join(root, "faults.zarr")
        t0 = time.perf_counter()
        src = open_container(disk).require_dataset("boundaries", shape=dshape, chunks=block, dtype="float32")
        # a chunk a write, 8 at a time (zlib drops the interpreter lock)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda i: src.__setitem__(dblocking.get_block(i).bb, b_np[dblocking.get_block(i).bb]),
                          range(dblocking.n_blocks)))
        del b_np
        t_write = time.perf_counter() - t0
        dio = dict(input_path=disk, input_key="boundaries", output_path=disk)
        repaired0 = repair.stats()["repaired"]
        for tag, env in (("disk-checksums", {"CTT_CHECKSUMS": "1"}), ("disk-plain", {"CTT_CHECKSUMS": "0"})):
            key = tag.replace("-", "_")
            rec = fault_run(K, root, tag, WatershedWorkflow, block, env, output_key=key, **ws_cfg, **dio)
            require_kernels(tag, rec["launches"])
            side_dir = os.path.join(disk, key, ".ctt_checksums")
            sidecars = len(os.listdir(side_dir)) if os.path.isdir(side_dir) else 0
            check = equal(tag, key, open_container(disk), disk_ref, f"its {DISK_EDGE}^3 memory:// run "
                                                                    f"({ref_rec['wall_s']:.3f} s)")
            if sidecars != (dblocking.n_blocks if tag == "disk-checksums" else 0):
                raise AssertionError(f"faults {tag}: {sidecars} sidecar files")
            fault_line(tag, rec, check + (f" (the zarr written in {t_write:.2f} s)" if tag == "disk-checksums" else ""),
                       sidecars)
            arm_launches[tag] = rec["launches"]
            if tag == "disk-checksums":
                checked = rec
        # the stored block rots at the read site; the verifying reader
        # catches it and lineage repair recomputes the block on the card
        out = open_container(disk)["disk_checksums"]
        b = dblocking.get_block(FAULT_BLOCKS["read_rot"])
        faults.configure({"faults": [{"site": "io_read", "kind": "corrupt", "blocks": [b.block_id]}]})
        K.reset_counts()
        t0 = time.perf_counter()
        try:
            with faults.block_context(b.block_id):
                healed = out[b.bb]
        finally:
            faults.reset()
        t_heal = time.perf_counter() - t0
        heal_launches = dict(K.LAUNCHES)
        if not np.array_equal(healed, disk_ref[b.bb]) or not np.array_equal(out[...], disk_ref):
            raise AssertionError("faults read-rot: the healed read differs from the memory:// run's labels")
        repaired = repair.stats()["repaired"] - repaired0
        from cluster_tools_tpu_torch.utils import function_utils as fu

        recs = [r for r in fu.read_json_if_valid(fu.failures_path(checked["tmp"]))["records"]
                if r.get("resolution") == "repaired:lineage"]
        if repaired != 1 or not recs or recs[0]["block_id"] != b.block_id:
            raise AssertionError(f"faults read-rot: repaired {repaired}, records {recs}")
        require_kernels("read-rot repair", heal_launches)
        log("faults", f"read-rot: block {b.block_id}'s stored bytes flipped at the read site, caught by the "
                      f"verifying reader and healed by lineage repair in {t_heal:.3f} s (the block recomputed "
                      f"on the card: launches {heal_launches}); repaired {repaired}, record repaired:lineage; the "
                      "whole file equals its memory:// run")
        arm_launches["read-rot"] = heal_launches
        del f._data["ws_disk_ref"], f._data["boundaries_disk"]

        # ---- 4. split inference ----
        spec_model = {k: v for k, v in SPLIT["model"].items() if k != "name"}
        model = UNet3D(**spec_model)
        model.reset_parameters(torch.Generator().manual_seed(0))
        ckpt = os.path.join(root, "unet_nonorm.npz")
        save_checkpoint(ckpt, model)
        (lo, hi), sblock = SPLIT["roi"], SPLIT["block"]
        inf = dict(input_path=mem, input_key="boundaries", output_path=mem, checkpoint_path=ckpt,
                   model=SPLIT["model"], halo=[SPLIT["halo"]] * 3, normalize_range=[0.0, 1.0],
                   allow_block_split=True, roi_begin=list(lo), roi_end=list(hi))
        ref_rec = fault_run(K, root, "unet-unsplit", InferenceWorkflow, sblock, output_key="pred_unsplit", **inf)
        split_spec = {"faults": [{"site": "compute", "kind": "oom", "min_voxels": SPLIT["min_voxels"],
                                  "fail_attempts": 10 ** 6, "tasks": ["inference"]}]}
        rec = fault_run(K, root, "unet-split", InferenceWorkflow, sblock, spec=split_spec, output_key="pred_split",
                        **inf)
        roi = (slice(None),) + tuple(slice(a, b) for a, b in zip(lo, hi))
        a, r = torch.from_numpy(f["pred_split"][roi]).cuda(), torch.from_numpy(f["pred_unsplit"][roi]).cuda()
        err = float((a - r).abs().max())
        del a, r
        n_roi = int(np.prod([(b - a) // s for a, b, s in zip(lo, hi, sblock)]))
        split_recs = [r for r in rec["records"] if r.get("resolution") == "degraded:split"]
        if not err <= 2e-2 or len(split_recs) != n_roi or ref_rec["records"]:
            raise AssertionError(f"faults split: max err {err}, {len(split_recs)} split records of {n_roi} blocks")
        fault_line("unet-split", rec, f"unsplit wall {ref_rec['wall_s']:.3f} s; {n_roi} blocks split into "
                   f"sub-blocks (degraded:split, depth {max(r['split_depth'] for r in split_recs)}), equal to the "
                   f"unsplit run within {err:.3g} (atol 2e-2, bfloat16)", len(f["pred_split"].checksum_regions()))
        del f._data["pred_split"], f._data["pred_unsplit"]
    for row in rows:
        row["faults_launches"] = {arm: n.get(row["name"], 0) for arm, n in arm_launches.items()}
    log("faults", f"phase {time.perf_counter() - t_phase:.1f} s")


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
    reset_peaks()
    sync_cards()
    t0 = time.perf_counter()
    ok = run_dag([wf])
    sync_cards()
    wall = time.perf_counter() - t0
    if not ok:
        logs = "".join(open(os.path.join(tmp_folder, f)).read()[-3000:] for f in sorted(os.listdir(tmp_folder))
                       if f.endswith(".log"))
        raise AssertionError(f"multicut: {workflow_cls.__name__} failed; task logs:\n{logs}")
    tasks = {}
    for f in sorted(set(os.listdir(tmp_folder)) - before):
        if f.endswith(".success.json"):
            tasks[f.split(".")[0]] = json.load(open(os.path.join(tmp_folder, f)))
    return dict(wall_s=wall, peak_gb=max_card_peak_gb(), launches=dict(K.LAUNCHES),
                tasks=tasks)


def check_assignments(what: str, tmp: str, ws: np.ndarray, seg: np.ndarray) -> None:
    """The multicut gates: ``seg > 0`` equals ``ws > 0``, and ``seg`` is the
    workflow's assignment table applied to ``ws`` (on the card)."""
    from cluster_tools_tpu_torch.tasks.multicut import assignments_path

    a = np.load(assignments_path(tmp))
    keys = torch.from_numpy(a["keys"].view(np.int64)).cuda()
    values = torch.from_numpy(a["values"].view(np.int64)).cuda()
    ws = torch.from_numpy(ws.view(np.int64)).cuda()
    seg = torch.from_numpy(seg.view(np.int64)).cuda()
    if not torch.equal(seg > 0, ws > 0):
        raise AssertionError(f"{what}: seg > 0 differs from ws > 0")
    idx = torch.searchsorted(keys, ws).clamp_max(keys.numel() - 1)
    want = torch.where((keys[idx] == ws) & (ws != 0), values[idx], 0)
    if not torch.equal(seg, want):
        raise AssertionError(f"{what}: seg is not the assignment table applied to ws")


def default_workflow(K, f, mem: str, root: str, cfg_dir: str, edge: int, block: list, ws_cfg: dict, tag: str) -> dict:
    """The default ``MulticutSegmentationWorkflow`` (its own watershed: B1-B4
    launch; ``gaec_parallel`` subproblems; Kernighan-Lin global solve) on the
    first ``edge``^3 of the "blockwise" phase's boundaries, in
    ``root/tag``: its record (``wf_run``) with the host C++ calls it made
    (``native``) and its ``tmp`` folder, after the multicut gates."""
    from cluster_tools_tpu_torch import native
    from cluster_tools_tpu_torch.workflows import MulticutSegmentationWorkflow

    sub = tuple(slice(0, edge) for _ in range(3))
    f.require_dataset(f"boundaries_{tag}", shape=(edge,) * 3, chunks=tuple(block),
                      dtype="float32")[...] = f["boundaries"][sub]
    tmp = os.path.join(root, tag)
    native.reset_counts()
    rec = wf_run(K, tmp, cfg_dir, MulticutSegmentationWorkflow, input_path=mem, input_key=f"boundaries_{tag}",
                 ws_path=mem, ws_key=f"ws_{tag}", output_path=mem, output_key=f"mc_{tag}", block_shape=block, **ws_cfg)
    rec["native"], rec["tmp"] = dict(native.COUNTS), tmp
    missing = [k for k in MAIN_PATH_KERNELS if rec["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"multicut ({tag}): the default workflow's watershed launched no {missing}")
    missing = [k for k in ("union_find", "merge_edge_features", "kernighan_lin", "greedy_additive")
               if not rec["native"][k]]
    if missing:
        raise AssertionError(f"multicut ({tag}): no call to the host C++ {missing}: {rec['native']}")
    check_assignments(f"multicut ({tag})", tmp, f[f"ws_{tag}"][...], f[f"mc_{tag}"][...])
    for key in (f"boundaries_{tag}", f"ws_{tag}", f"mc_{tag}"):
        f._data.pop(key)
    return rec


MC_TASKS = ("initial_sub_graphs", "merge_sub_graphs", "map_edge_ids", "block_edge_features", "merge_edge_features",
            "probs_to_costs", "solve_subproblems", "reduce_problem", "solve_global", "write")


def phase_multicut(K, vol: torch.Tensor, ws_crop: np.ndarray, mem: str, rows: list, block=(128, 128, 128),
                   then=None) -> None:
    """BASELINE config 4 on the card.

    1. The bench's config-4 shape: ``block_rag_fused`` + ``gaec_parallel``
       (torch rung) on the first ``CONFIG4_CROP``^3 of the main path's
       watershed labels, cold and warm (best of 3), extraction apart from
       solve, against the numpy oracle (``_block_rag_host`` + the numpy
       rung): edges and counts equal, and the torch rung's labels on the
       card equal its labels on the CPU and the numpy rung's, or else its
       energy is within 2% of the numpy rung's.
    2. ``MulticutSegmentationWorkflow`` on the first ``MC_EDGE``^3 of the
       "blockwise" phase's single-pass watershed and boundaries
       (``skip_ws``, ``n_scales=1``,
       ``agglomerator="gaec_parallel"``, block 128^3), first on the Python
       paths (``native.force_python()``), then on the host C++ rung: the
       host tasks' seconds side by side and the same segmentation; per-task
       wall times, graph size, energy, rounds, peak memory; the merged graph
       equals the numpy oracle's, ``seg > 0`` equals ``ws > 0`` and ``seg``
       is the assignment table applied to ``ws``.  Then
       ``AgglomerativeClusteringWorkflow`` in the same ``tmp_folder``
       (graph and features reused).
    3. The default workflow (Kernighan-Lin global solve on the host C++
       rung, its own watershed: B1-B4 launch) on the first
       ``MC_DEFAULT_CROP``^3 (block 128^3) with the same gates; and the
       single-pass watershed with
       ``agglomerate_threshold=0.5`` on the first ``AGG_WS_CROP``^3
       (block 64^3) against its ``impl="torch"`` run, bit for bit.
    Adds ``multicut_launches`` (the kernels' launches in 3's watershed) to
    the kernel rows.  ``then(context)`` runs before the workflows'
    ``tmp_folder`` goes (the "reduce-tree" phase reuses it).
    """
    from cluster_tools_tpu_torch import native
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
        sync_cards()
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

    # ---- 2. the multicut and agglomerative workflows on the first MC_EDGE^3 ----
    f = open_container(mem)
    sub = (slice(0, MC_EDGE),) * 3
    for key in ("boundaries", "ws"):
        f.require_dataset(f"{key}_mc", shape=(MC_EDGE,) * 3, chunks=tuple(block), dtype=f[key].dtype)[...] = \
            f[key][sub]
    ws_mc = f["ws_mc"]
    shape = ws_mc.shape
    with tempfile.TemporaryDirectory(prefix="multicut-") as root:
        cfg_dir = os.path.join(root, "cfg")
        os.makedirs(cfg_dir)
        write_json(os.path.join(cfg_dir, "global.config"), {"block_shape": list(block)})
        tmp = os.path.join(root, "tmp")
        io = dict(input_path=mem, input_key="boundaries_mc", ws_path=mem, ws_key="ws_mc", skip_ws=True,
                  output_path=mem, block_shape=list(block))
        # the same workflow on the Python paths (the port before the host C++
        # rung), then on the rung: per-task seconds side by side, same labels
        with native.force_python():
            rec_py = wf_run(K, os.path.join(root, "python-rung"), cfg_dir, MulticutSegmentationWorkflow,
                            output_key="mc_seg_py", n_scales=1, agglomerator="gaec_parallel", **io)
        native.reset_counts()
        rec = wf_run(K, tmp, cfg_dir, MulticutSegmentationWorkflow, output_key="mc_seg", n_scales=1,
                     agglomerator="gaec_parallel", **io)
        t = rec["tasks"]
        mc_counts = dict(native.COUNTS)
        if not np.array_equal(f["mc_seg"][...], f["mc_seg_py"][...]):
            raise AssertionError("multicut: the workflow's segmentation on the host C++ rung differs from its "
                                 "Python paths'")
        f._data.pop("mc_seg_py")
        missing = [k for k in ("union_find", "merge_edge_features") if not mc_counts[k]]
        if missing:
            raise AssertionError(f"multicut: the workflow made no call to the host C++ {missing}: {mc_counts}")
        t_py = rec_py["tasks"]
        log("multicut", "host tasks s, host C++ rung (Python paths, same call): "
                        + ", ".join(f"{k} {t[k]['runtime_s']:.3f} ({t_py[k]['runtime_s']:.3f})" for k in MC_HOST_TASKS)
                        + f"; wall {rec['wall_s']:.3f} ({rec_py['wall_s']:.3f}) s; segmentation equal; "
                        f"native calls {mc_counts}")
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
        nodes_o, uv_o, sizes_o = oracle_graph(ws_mc, shape, block)
        for what, a, b in (("nodes", nodes_g, nodes_o), ("uv", uv_g, uv_o), ("sizes", sizes_g, sizes_o)):
            if not np.array_equal(a, b):
                raise AssertionError(f"multicut: the merged graph's {what} differ from the numpy oracle's")
        t_oracle = time.perf_counter() - t0
        check_assignments("multicut", tmp, ws_mc[...], f["mc_seg"][...])
        log("multicut", f"merged graph = the numpy oracle's (nodes, uv, sizes; {t_oracle:.1f} s); seg > 0 = ws > 0; "
                        f"seg = the assignment table applied to ws")
        mc_energy = t["solve_global"]["energy"]
        rec = wf_run(K, tmp, cfg_dir, AgglomerativeClusteringWorkflow, output_key="ac_seg", **io)
        ac = rec["tasks"]["agglomerative_clustering"]
        log("multicut", f"AgglomerativeClusteringWorkflow in the same tmp_folder (graph and features reused): wall "
                        f"{rec['wall_s']:.3f} s, solve {ac['runtime_s']:.3f} s, {ac['n_clusters']} clusters of "
                        f"{ac['n_nodes']} nodes, rounds {ac['solver']['rounds']}, write "
                        f"{rec['tasks']['write']['runtime_s']:.3f} s")

        # ---- 3. the default workflow, and the in-block agglomeration on a crop ----
        ws_cfg = dict(halo=[32, 32, 32], threshold=0.45, min_seed_distance=2.0)
        default = default_workflow(K, f, mem, root, cfg_dir, MC_DEFAULT_CROP, list(block), ws_cfg, "default")
        launches, t = default["launches"], default["tasks"]
        log("multicut", f"default MulticutSegmentationWorkflow (watershed, gaec_parallel subproblems, Kernighan-Lin "
                        f"global solve on the host C++ rung) on {(MC_DEFAULT_CROP,) * 3}, block {tuple(block)}: wall "
                        f"{default['wall_s']:.3f} s; tasks " + ", ".join(f"{k} {t[k]['runtime_s']:.3f}"
                                                                        for k in ("watershed",) + MC_TASKS)
                        + f" s; {t['merge_sub_graphs']['n_nodes']} fragments, {t['merge_sub_graphs']['n_edges']} "
                        f"edges -> reduced {t['reduce_problem']['n_nodes']} nodes, {t['reduce_problem']['n_edges']} "
                        f"edges -> {t['solve_global']['n_segments']} segments, energy {t['solve_global']['energy']:.6g}; "
                        f"seg > 0 = ws > 0; seg = the assignment table applied to ws; native calls "
                        f"{default['native']}; launches {launches}")
        for row in rows:
            row["multicut_launches"] = launches.get(row["name"], 0)

        a_n = AGG_WS_CROP
        half = tuple(slice(0, a_n) for _ in range(3))
        f.require_dataset("boundaries_half", shape=(a_n,) * 3, chunks=(a_n // 2,) * 3, dtype="float32")[...] = \
            f["boundaries"][half]
        agg = dict(input_path=mem, input_key="boundaries_half", output_path=mem, block_shape=[a_n // 2] * 3,
                   agglomerate_threshold=0.5, dt_max_distance=32.0, **ws_cfg)
        recs = {impl: wf_run(K, os.path.join(root, f"agg-{impl}"), cfg_dir, WatershedWorkflow, output_key=f"agg_{impl}",
                             impl=impl, **agg) for impl in ("auto", "torch")}
        if sum(recs["torch"]["launches"].values()):
            raise AssertionError(f"multicut: impl='torch' launched kernels: {recs['torch']['launches']}")
        a, b = f["agg_auto"][...], f["agg_torch"][...]
        if not np.array_equal(a, b):
            raise AssertionError("multicut: the agglomerating watershed's impl='torch' output differs from the kernels'")
        log("multicut", f"single-pass watershed with agglomerate_threshold=0.5 on {(a_n,) * 3}, block "
                        f"{(a_n // 2,) * 3}: "
                        f"{recs['auto']['wall_s']:.3f} s (impl=torch {recs['torch']['wall_s']:.3f} s), "
                        f"{len(np.unique(a)) - int((a == 0).any())} segments; equals its impl='torch' run bit for bit; "
                        f"launches {recs['auto']['launches']}")
        log("multicut", f"phase {time.perf_counter() - t_phase:.1f} s")
        if then is not None:
            then(dict(root=root, tmp=tmp, io=io, block=block, mc_energy=mc_energy, cfg_dir=cfg_dir,
                      ws_cfg=ws_cfg, mc_counts=mc_counts, default_counts=default["native"]))
    del MemoryContainer._registry[mem]


def timed(fn):
    """``(fn(), seconds)`` on the host clock (the host C++ rung runs on the
    host: no device sync)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def config4_problem(tmp: str) -> dict:
    """A config-4 run's host problems from its ``tmp_folder``: the merged
    graph, costs and block feature parts, ReduceProblem's union-find pairs
    and the reduced (scale 1) problem that SolveGlobal solves."""
    import glob

    from cluster_tools_tpu_torch.runtime import handoff
    from cluster_tools_tpu_torch.tasks.costs import costs_path
    from cluster_tools_tpu_torch.tasks.features import features_path
    from cluster_tools_tpu_torch.tasks.graph import graph_dir, load_global_graph
    from cluster_tools_tpu_torch.tasks.multicut import cut_edges_path, problem_path

    nodes, uv, edges, sizes = load_global_graph(tmp)
    edges = edges.astype(np.int64)
    cut = handoff.load_arrays(cut_edges_path(tmp, 0))
    s1 = handoff.load_arrays(problem_path(tmp, 1))
    files = sorted(glob.glob(os.path.join(graph_dir(tmp), "features_block_*.npz")),
                   key=lambda x: int(x.rsplit("_", 1)[1].split(".")[0]))
    parts = []
    for fn in files:
        with np.load(fn) as z:
            parts.append((z["uv"], z["feats"]))
    return dict(n=len(nodes), uv=uv, edges=edges, sizes=sizes,
                costs=handoff.load_array(costs_path(tmp)).astype(np.float64),
                feats=handoff.load_array(features_path(tmp)), parts=parts,
                pairs=edges[cut["seen"] & ~cut["cut"]], s1_n=int(s1["node_labeling"].max()) + 1,
                s1_edges=s1["edges"].astype(np.int64), s1_costs=s1["costs"].astype(np.float64))


def flood_is_a_watershed(ws: np.ndarray, fg: np.ndarray, seeds: np.ndarray) -> None:
    """The seeded flood's contract (the reference's own test of it): seeds
    keep their labels, background stays 0, every foreground voxel of a
    seeded component is labelled and no other, and each label is one
    6-connected region."""
    from scipy import ndimage
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    if not (np.array_equal(ws[seeds > 0], seeds[seeds > 0]) and (ws[~fg] == 0).all()):
        raise AssertionError("native: ws_flood moved a seed or labelled background")
    cc, _ = ndimage.label(fg)
    seeded = np.isin(cc, np.unique(cc[seeds > 0])) & fg
    if not ((ws[seeded] > 0).all() and (ws[fg & ~seeded] == 0).all()):
        raise AssertionError("native: ws_flood left a seeded voxel unlabelled or labelled an unseeded one")
    idx = np.arange(ws.size).reshape(ws.shape)
    us, vs = [], []
    for ax in range(3):
        a = [slice(None)] * 3
        b = [slice(None)] * 3
        a[ax], b[ax] = slice(0, -1), slice(1, None)
        same = (ws[tuple(a)] == ws[tuple(b)]) & (ws[tuple(a)] > 0)
        us.append(idx[tuple(a)][same])
        vs.append(idx[tuple(b)][same])
    u, v = np.concatenate(us), np.concatenate(vs)
    n_comp, comp = connected_components(coo_matrix((np.ones(len(u), np.uint8), (u, v)), shape=(ws.size,) * 2),
                                        directed=False)
    labelled = ws.ravel() > 0
    if len(np.unique(comp[labelled])) != len(np.unique(ws[ws > 0])):
        raise AssertionError("native: a ws_flood label is not one connected region")


def phase_native(K, vol: torch.Tensor, mem: str, mc: dict) -> None:
    """The host C++ rung (``cluster_tools_tpu_torch/native.py`` over
    ``csrc/ct_native.cpp``; ROADMAP item 13), in the "multicut" phase's
    ``tmp_folder``:

    1. The default workflow on the first ``NATIVE_CROP``^3 (block half of
       it) makes the inputs.  On its graph, features and reduced problem,
       each of the eight functions against the port's Python path
       (``native.force_python()``), both timed: union-find (ReduceProblem's
       pairs), GAEC (the graph), parallel contraction (GAEC and average
       linkage on the graph), Kernighan-Lin (the reduced problem, GAEC
       start), the feature merge (the block parts); labels and sums bit for
       bit.  The squared EDT of a ``NATIVE_CROP``^3 block of the main
       path's foreground against scipy's EDT squared (rtol 1e-5, the
       reference test's tolerance); the flood on that block against the
       reference test's contract (its Python path, ``watershed_ift``, breaks
       plateau ties in another order), timed beside ``watershed_ift``; the
       mutex watershed's constraint loop on a seeded ``MWS_EDGE``^3
       affinity volume (``MWS_OFFSETS``), the same partition.
    2. The rung alone at full size on the "multicut" phase's ``MC_EDGE``^3 graph:
       union-find, Kernighan-Lin (its GAEC start included) and parallel
       contraction (beside the torch rung on the card) on the reduced global
       problem, the feature merge (union-find and the merge beside their
       Python paths).  GAEC on the whole graph (19.3 s on an H100 host)
       was cut to pay for the "analysis" phase.
    Raises on any inequality, and when a function made no call."""
    from scipy import ndimage

    from cluster_tools_tpu_torch import native
    from cluster_tools_tpu_torch.io.containers import open_container
    from cluster_tools_tpu_torch.ops import contraction, mws, rag
    from cluster_tools_tpu_torch.ops import multicut as pmc
    from cluster_tools_tpu_torch.ops.unionfind import union_find_host

    t_phase = time.perf_counter()
    c = NATIVE_CROP
    rec = default_workflow(K, open_container(mem), mem, mc["root"], mc["cfg_dir"], c, [c // 2] * 3, mc["ws_cfg"],
                           "native")
    pb = config4_problem(rec["tmp"])
    native.reset_counts()
    results = []

    def pair(name, run, equal, what):
        got, t_nat = timed(run)
        with native.force_python():
            want, t_py = timed(run)
        if not equal(got, want):
            raise AssertionError(f"native: {name} differs from its Python path on {what}")
        results.append(f"{name} {t_nat:.4f} s (Python {t_py:.4f} s) on {what}")
        return got

    def same(a, b):
        if isinstance(a, tuple):
            return all(np.array_equal(x, y) for x, y in zip(a, b))
        return np.array_equal(a, b)

    n, e, w = pb["n"], pb["edges"], pb["costs"]
    graph = f"{n} nodes, {len(e)} edges"
    pair("union_find", lambda: union_find_host(pb["pairs"], n), same, f"{len(pb['pairs'])} pairs of {n} labels")
    pair("greedy_additive", lambda: pmc.greedy_additive(n, e, w), same, graph)
    # the numpy rung is the contraction's Python path
    got, t_nat = timed(lambda: contraction.gaec_parallel(n, e, w, impl="native"))
    want, t_py = timed(lambda: contraction.gaec_parallel(n, e, w, impl="numpy"))
    s = np.maximum(pb["sizes"].astype(np.float64), 1e-12)
    probs = pb["feats"][:, 0].astype(np.float64)
    got_a, t_nat_a = timed(lambda: contraction.average_parallel(n, e, probs, s, 0.5, impl="native"))
    want_a, t_py_a = timed(lambda: contraction.average_parallel(n, e, probs, s, 0.5, impl="numpy"))
    if not (np.array_equal(got, want) and np.array_equal(got_a, want_a)):
        raise AssertionError("native: parallel_contract differs from the numpy rung")
    results.append(f"parallel_contract {t_nat:.4f} s (numpy rung {t_py:.4f} s) GAEC, {t_nat_a:.4f} s ({t_py_a:.4f} s) "
                   f"average linkage on {graph}")
    n1, e1, w1 = pb["s1_n"], pb["s1_edges"], pb["s1_costs"]
    kl = pair("kernighan_lin", lambda: pmc.kernighan_lin(n1, e1, w1), same,
              f"the reduced problem, {n1} nodes, {len(e1)} edges, GAEC start")
    merged = pair("merge_edge_features", lambda: rag.merge_feature_lists(pb["uv"], pb["parts"]), same,
                  f"{len(pb['parts'])} block parts onto {len(pb['uv'])} edges")
    if not np.array_equal(merged, pb["feats"]):
        raise AssertionError("native: merge_edge_features differs from the workflow's features")

    block = (vol[0, :c, :c, :c] < 0.45).cpu().numpy()
    d2, t_nat = timed(lambda: native.edt_sq(block))
    want, t_py = timed(lambda: ndimage.distance_transform_edt(block))
    np.testing.assert_allclose(d2, (want * want).astype(np.float32), rtol=1e-5)
    results.append(f"edt_sq {t_nat:.4f} s (scipy EDT {t_py:.4f} s) on {block.shape}, within rtol 1e-5 of scipy's "
                   f"squared")
    dist = np.sqrt(d2)
    seeds, _ = ndimage.label((ndimage.maximum_filter(dist, size=3) == dist) & block)
    hmap = np.clip(vol[0, :c, :c, :c].cpu().numpy() * 255, 0, 255).astype(np.uint8)
    ws, t_nat = timed(lambda: native.ws_flood(hmap, block, seeds.astype(np.int32)))
    _, t_py = timed(lambda: ndimage.watershed_ift(hmap, seeds.astype(np.int32)))
    flood_is_a_watershed(ws, block, seeds)
    results.append(f"ws_flood {t_nat:.4f} s (watershed_ift {t_py:.4f} s) on {block.shape}, {int(seeds.max())} "
                   f"seeds; the flood's contract holds")
    m = MWS_EDGE
    affs = np.random.default_rng(0).random((len(MWS_OFFSETS), m, m, m)).astype(np.float32)
    u, v, ch = mws.offset_edges((m,) * 3, MWS_OFFSETS)
    order = np.argsort(-mws._affinity_values(np.asarray(affs, np.float64), MWS_OFFSETS), kind="stable")
    roots, t_nat = timed(lambda: native.mutex_watershed(m ** 3, u, v, ch < 3, order))
    py, t_py = timed(lambda: mws.python_constraint_loop(m ** 3, u, v, ch < 3, order))
    inv_n, inv_p = (np.unique(r, return_inverse=True)[1] for r in (roots, py))
    if not np.array_equal(inv_n, inv_p):
        raise AssertionError("native: mutex_watershed's partition differs from the Python loop's")
    results.append(f"mutex_watershed {t_nat:.4f} s (Python {t_py:.4f} s) on {m}^3, {len(u)} edges, "
                   f"{len(MWS_OFFSETS)} offsets: {int(inv_n.max()) + 1} clusters, same partition")
    missing = [k for k, v in native.COUNTS.items() if not v]
    if missing:
        raise AssertionError(f"native: no call to {missing} in the comparisons: {native.COUNTS}")
    log("native", f"the host C++ rung against its Python paths ({NATIVE_CROP}^3 default workflow's graph; "
                  f"{len(np.unique(kl))} KL segments): " + "; ".join(results))

    # ---- 2. the rung alone at full size ----
    full = config4_problem(mc["tmp"])
    n, e = full["n"], full["edges"]
    native.reset_counts()
    _, t_uf = timed(lambda: union_find_host(full["pairs"], n))
    with native.force_python():
        _, t_uf_py = timed(lambda: union_find_host(full["pairs"], n))
    n1, e1, w1 = full["s1_n"], full["s1_edges"], full["s1_costs"]
    kl, t_kl = timed(lambda: pmc.kernighan_lin(n1, e1, w1))
    # the contraction's rungs on the reduced problem: why the card keeps the
    # torch rung where the device is the card
    pc, t_pc = timed(lambda: contraction.gaec_parallel(n1, e1, w1, impl="native"))
    sync_cards()
    pc_t, t_pc_t = timed(lambda: contraction.gaec_parallel(n1, e1, w1, impl="torch", device="cuda"))
    if not np.array_equal(pc, pc_t):
        raise AssertionError("native: parallel_contract differs from the torch rung on the reduced problem")
    feats, t_mf = timed(lambda: rag.merge_feature_lists(full["uv"], full["parts"]))
    with native.force_python():
        feats_py, t_mf_py = timed(lambda: rag.merge_feature_lists(full["uv"], full["parts"]))
    if not (np.array_equal(feats, feats_py) and np.array_equal(feats, full["feats"])):
        raise AssertionError("native: the full-size feature merge differs from its Python path or the workflow's")
    counts = dict(native.COUNTS)
    missing = [k for k in ("union_find", "greedy_additive", "kernighan_lin", "parallel_contract", "merge_edge_features")
               if not counts[k]]
    if missing:
        raise AssertionError(f"native: no call to {missing} at full size: {counts}")
    log("native", f"full size, the multicut phase's {MC_EDGE}^3 graph ({n} nodes, {len(e)} edges): union_find {t_uf:.3f} s "
                  f"(Python {t_uf_py:.3f}) on {len(full['pairs'])} pairs; kernighan_lin "
                  f"{t_kl:.3f} s (GAEC start included) on the reduced problem ({n1} nodes, {len(e1)} edges) -> "
                  f"{int(kl.max()) + 1} segments, energy {pmc.multicut_energy(e1, w1, kl):.6g}; parallel_contract "
                  f"(GAEC) on it {t_pc:.3f} s (the torch rung on the card {t_pc_t:.3f} s, same labels, "
                  f"{int(pc.max()) + 1} segments); merge_edge_features "
                  f"{t_mf:.3f} s (Python {t_mf_py:.3f}) over {len(full['parts'])} block parts, = the workflow's "
                  f"features; calls {counts}; phase {time.perf_counter() - t_phase:.1f} s")


def tree_line(info: dict, delta: dict, wall: float) -> str:
    """One arm of the "reduce-tree" phase: the solve's shape and counters."""
    return (f"wall {wall:.3f} s, plane {info.get('reduce_plane')}, levels {len(info.get('levels', []))}, "
            f"rounds {int(delta['tree_rounds'] + delta.get('solver_rounds', 0))}, boundary edges in "
            f"{int(delta['boundary_edges_in'])} out {int(delta['boundary_edges_out'])}, collective hops "
            f"{int(delta['collective_hops'])}, bytes gathered {int(delta['bytes_over_interconnect'])}, host syncs "
            f"{int(delta['host_syncs'])}"
            + ("" if not info.get("levels") or "solve_s" not in info["levels"][0] else
               "; levels (edges in, solve s) " + ", ".join(f"({lv['edges_in']}, {lv['solve_s']:.3f})"
                                                          for lv in info["levels"])))


def degraded_records(tmp: str) -> list:
    """The ``degraded:*`` records of the solve tasks in ``tmp``'s
    ``failures.json``."""
    path = os.path.join(tmp, "failures.json")
    if not os.path.exists(path):
        return []
    return [r for r in json.load(open(path))["records"] if str(r.get("resolution", "")).startswith("degraded:")
            and str(r.get("task", "")).split(".")[0] in ("agglomerative_clustering", "solve_global")]


def phase_reduce_tree(K, vol: torch.Tensor, mem: str, mc: dict, rows: list) -> None:
    """The sharded global solve and the fused workflow on the card (ROADMAP
    items 10b and 12a), in the "multicut" phase's ``tmp_folder`` (its
    ``MC_EDGE``^3 graph, its features and costs and the reduced problem):

    a. ``AgglomerativeClusteringWorkflow`` (threshold 0.5) with
       ``solver_shards=8`` and the collective plane demanded, on a sibling
       mesh of ``REDUCE_SHARDS`` shards on the card: labels equal the
       in-process packet plane's on the same problem bit for bit, the plane
       is ``collective`` on every level and no ``degraded:*`` record is
       written; a warm re-solve sends no bytes to the card.
    b. ``SolveGlobal`` (``gaec_parallel``) with ``solver_shards=8`` on both
       planes, equal to each other, its energy within 0.1% of the
       unsharded solve's (the reference's own claim).
    c. The same solve over a worker group (``solver_workers=2``: two CPU
       processes, gloo, the packet plane), equal to (b).
    d. ``FusedSegmentationWorkflow`` on the first ``FUSED_EDGE``^3 of the
       main path's volume (``memory://``, the main path's configuration),
       ``fused`` and
       ``split``, on 1 shard (the card count) and on 8: ws and cc equal
       ``make_ws_ccl_step`` on the same mesh bit for bit, cc is scipy's
       partition, ``n_foreground`` is the float32 mesh sum of the exact
       per-shard counts, rounded (the exact integer count wherever float32
       holds it); every kernel launch of one run replayed against its twin.
       Adds ``fused_launches`` to the kernel rows.
    e. ``sharded_slab_sweep`` of B3 over the 512^3 volume with
       ``n_ranks=4`` on the one card equals ``n_ranks=1``.
    """
    import scipy.ndimage as ndi

    from cluster_tools_tpu_torch.io.containers import open_container
    from cluster_tools_tpu_torch.parallel import device_pool
    from cluster_tools_tpu_torch.parallel import reduce_tree as rt
    from cluster_tools_tpu_torch.parallel.batch_shard import sharded_slab_sweep
    from cluster_tools_tpu_torch.parallel.mesh import make_mesh
    from cluster_tools_tpu_torch.parallel.pipeline import make_ws_ccl_step
    from cluster_tools_tpu_torch.runtime import handoff
    from cluster_tools_tpu_torch.runtime.task import build as run_dag
    from cluster_tools_tpu_torch.tasks.agglomerative_clustering import agglomerative_assignments_path
    from cluster_tools_tpu_torch.tasks.features import features_path
    from cluster_tools_tpu_torch.tasks.fused import FusedSegmentationWorkflow
    from cluster_tools_tpu_torch.tasks.graph import load_global_graph
    from cluster_tools_tpu_torch.tasks.multicut import SolveGlobalGPU, assignments_path
    from cluster_tools_tpu_torch.workflows import AgglomerativeClusteringWorkflow

    from cluster_tools_tpu_torch import native

    t_phase = time.perf_counter()
    tmp, block = mc["tmp"], mc["block"]
    native.reset_counts()
    saved_env = {k: os.environ.get(k) for k in ("CTT_MESH_SHARDS", "CT_SEED_CCL")}
    os.environ["CTT_MESH_SHARDS"] = str(REDUCE_SHARDS)
    cfg_dir = os.path.join(mc["root"], "cfg-tree")
    os.makedirs(cfg_dir)
    write_json(os.path.join(cfg_dir, "global.config"), {"block_shape": list(block)})
    write_json(os.path.join(cfg_dir, "agglomerative_clustering.config"),
               {"solver_shards": REDUCE_SHARDS, "reduce_plane": "collective", "device_pool_bytes": REDUCE_POOL_BYTES})
    if degraded_records(tmp):
        raise AssertionError(f"reduce-tree: degraded records before the phase: {degraded_records(tmp)}")

    # ---- (a) agglomerative clustering on the collective plane ----
    unsharded = np.load(agglomerative_assignments_path(tmp))["values"]
    for fn in os.listdir(tmp):  # the unsharded run's manifest: rerun the task
        if fn.split(".")[0] == "agglomerative_clustering" and fn.endswith(".success.json"):
            os.remove(os.path.join(tmp, fn))
    device_pool.reset()
    snap_t, snap_d = rt.solve_snapshot(), device_pool.snapshot()
    rec = wf_run(K, tmp, cfg_dir, AgglomerativeClusteringWorkflow, output_key="ac_tree", **mc["io"])
    d_tree, h2d_cold = rt.solve_delta(snap_t), device_pool.delta(snap_d)["h2d_bytes"]
    ac = rec["tasks"]["agglomerative_clustering"]
    solver = ac["solver"]
    if not (solver.get("sharded") and solver.get("reduce_plane") == "collective") or "degraded_plane" in solver \
            or any(lv["plane"] != "collective" for lv in solver["levels"]):
        raise AssertionError(f"reduce-tree (a): the collective plane did not carry the solve: "
                             f"{ {k: v for k, v in solver.items() if k != 'levels'} }")
    labels_c = np.load(agglomerative_assignments_path(tmp))["values"].astype(np.int64) - 1
    nodes, _, edges, sizes = load_global_graph(tmp)
    feats = handoff.load_array(features_path(tmp))
    s = np.maximum(np.asarray(sizes, np.float64), 1e-12)
    payload = np.stack([np.asarray(feats[:, 0], np.float64) * s, s], axis=1)
    edges = edges.astype(np.int64)
    node_shard = rt.contiguous_node_shards(len(nodes), REDUCE_SHARDS)
    solve_kw = dict(fanout=2, mode="min", threshold=0.5, max_workers=8, device="cuda",
                    device_pool_bytes=REDUCE_POOL_BYTES)
    snap_t, snap_d = rt.solve_snapshot(), device_pool.snapshot()
    sync_cards()
    t0 = time.perf_counter()
    labels_w, info_w = rt.sharded_solve(len(nodes), edges, payload, node_shard, reduce_plane="collective",
                                        **solve_kw)
    warm_s, d_warm, h2d_warm = time.perf_counter() - t0, rt.solve_delta(snap_t), device_pool.delta(snap_d)["h2d_bytes"]
    if not np.array_equal(labels_w, labels_c) or info_w["reduce_plane"] != "collective":
        raise AssertionError("reduce-tree (a): the warm collective re-solve differs")
    if h2d_warm:
        raise AssertionError(f"reduce-tree (a): the warm re-solve sent {h2d_warm} B to the card")
    pool_hits = int(device_pool.delta(snap_d)["device_pool_hits"])
    # the packet plane against the collective plane on the induced subgraph
    # of the first 1/PACKET_NODE_FRACTION of the nodes (cut from the whole
    # graph to pay for the "fleet" phase)
    n_sub = len(nodes) // PACKET_NODE_FRACTION
    inside = (edges < n_sub).all(1)
    sub = (n_sub, edges[inside], payload[inside], rt.contiguous_node_shards(n_sub, REDUCE_SHARDS))
    labels_sc, _ = rt.sharded_solve(*sub, reduce_plane="collective", **solve_kw)
    snap_t = rt.solve_snapshot()
    t0 = time.perf_counter()
    labels_p, info_p = rt.sharded_solve(*sub, reduce_plane="packet", **solve_kw)
    packet_s, d_packet = time.perf_counter() - t0, rt.solve_delta(snap_t)
    if not np.array_equal(labels_sc, labels_p):
        raise AssertionError(f"reduce-tree (a): the collective plane's labels differ from the packet plane's at "
                             f"{int((labels_sc != labels_p).sum())} of the subgraph's {n_sub} nodes")
    bad = degraded_records(tmp)
    if bad:
        raise AssertionError(f"reduce-tree (a): degraded records written: {bad}")
    log("reduce-tree", f"(a) AgglomerativeClusteringWorkflow, threshold 0.5, solver_shards {REDUCE_SHARDS}, "
                       f"collective plane on {REDUCE_SHARDS} sibling shards on cuda:0: {len(nodes)} nodes, "
                       f"{len(edges)} edges -> {len(np.unique(labels_c))} clusters (unsharded "
                       f"{len(np.unique(unsharded))}); workflow wall {rec['wall_s']:.3f} s, task "
                       f"{ac['runtime_s']:.3f} s; " + tree_line(solver, d_tree, ac["runtime_s"])
                       + f", h2d {h2d_cold} B cold; warm re-solve {warm_s:.3f} s, h2d {h2d_warm} B, pool hits "
                       f"{pool_hits}; on the induced subgraph of the first {n_sub} nodes ({len(sub[1])} edges) the "
                       f"collective plane = the in-process packet plane "
                       f"(max_workers 8; a group with no frontier on the torch rung) "
                       f"bit for bit: " + tree_line(info_p, d_packet, packet_s)
                       + "; no degraded record")

    # ---- (b) SolveGlobal on both planes, (c) over a worker group ----
    task_kw = dict(tmp_folder=tmp, config_dir=cfg_dir, max_jobs=8, input_path=mem, input_key=mc["io"]["ws_key"],
                   block_shape=list(block), scale=1, agglomerator="gaec_parallel", solver_shards=REDUCE_SHARDS,
                   device_pool_bytes=REDUCE_POOL_BYTES)
    solves = {}
    for arm, extra in (("collective", dict(reduce_plane="collective")), ("packet", dict(reduce_plane="packet")),
                       ("workers", dict(reduce_plane="packet", solver_workers=2))):
        task = SolveGlobalGPU(**task_kw, **extra)
        snap_t = rt.solve_snapshot()
        sync_cards()
        t0 = time.perf_counter()
        if not run_dag([task]):
            raise AssertionError(f"reduce-tree ({arm}): SolveGlobal failed; log:\n"
                                 + open(os.path.join(tmp, f"{task.uid}.log")).read()[-3000:])
        wall, delta = time.perf_counter() - t0, rt.solve_delta(snap_t)
        doc = task.output().read()
        solves[arm] = (np.load(assignments_path(tmp))["values"].copy(), doc, wall, delta)
    lab_c, doc_c = solves["collective"][:2]
    if doc_c["solver"]["reduce_plane"] != "collective" or "degraded_plane" in doc_c["solver"]:
        raise AssertionError(f"reduce-tree (b): the collective plane did not carry SolveGlobal: {doc_c['solver']}")
    for arm in ("packet", "workers"):
        if not np.array_equal(solves[arm][0], lab_c):
            raise AssertionError(f"reduce-tree ({arm}): SolveGlobal's labels differ from the collective plane's")
    if solves["workers"][1]["solver"].get("workers") != 2:
        raise AssertionError("reduce-tree (c): the solve did not run over the worker group")
    energy, e0 = doc_c["energy"], mc["mc_energy"]
    gap = abs(energy - e0) / abs(e0)
    if gap > 1e-3:
        raise AssertionError(f"reduce-tree (b): sharded energy {energy} is {100 * gap:.3f}% from the unsharded "
                             f"{e0} (> 0.1%)")
    bad = degraded_records(tmp)
    if bad:
        raise AssertionError(f"reduce-tree (b, c): degraded records written: {bad}")
    for arm, (_, doc, wall, delta) in solves.items():
        log("reduce-tree", f"({'c' if arm == 'workers' else 'b'}) SolveGlobal gaec_parallel, solver_shards "
                           f"{REDUCE_SHARDS}, {arm}"
                           f"{' (2 processes, gloo, packet plane, host C++ rung; before it %s s)' % BEFORE_RUNG_WORKERS_S if arm == 'workers' else ''}: "
                           f"{doc['solver']['edges_in']} edges -> {doc['n_segments']} segments, energy "
                           f"{doc['energy']:.6g}; task {doc['runtime_s']:.3f} s; " + tree_line(doc["solver"], delta, wall))
    log("reduce-tree", f"(b, c) the three arms' labels equal; energy {energy:.6g} against the unsharded "
                       f"{e0:.6g}: gap {100 * gap:.4f}% (<= 0.1%); no degraded record")

    # ---- (d) the fused workflow on the first FUSED_EDGE^3 of the main path's volume ----
    os.environ["CT_SEED_CCL"] = "sparse"
    f = open_container(mem)
    fused_cfg = {k: v for k, v in MAIN_CFG.items() if k != "seed_mode"}
    fvol = vol[:, :FUSED_EDGE, :FUSED_EDGE, :FUSED_EDGE].contiguous()
    fg = fvol[0] < torch.tensor(np.float32(fused_cfg["threshold"]), device="cuda")
    n_exact = int(fg.sum())
    ref_t = torch.from_numpy(ndi.label(fg.cpu().numpy())[0].astype(np.int32)).cuda()
    f.require_dataset("boundaries_fused", shape=fvol.shape[1:], chunks=tuple(block), dtype="float32")[...] = \
        fvol[0].cpu().numpy()
    fused_launches = {}
    for shards in (1, REDUCE_SHARDS):
        os.environ["CTT_MESH_SHARDS"] = str(shards)
        mesh = make_mesh(shards, axis_names=("dp", "sp"), grid=(1, shards), devices="cuda")
        ref_ws, ref_cc, _, ref_ovf = make_ws_ccl_step(mesh, **fused_cfg)(fvol)
        if ref_ovf:
            raise AssertionError(f"reduce-tree (d): make_ws_ccl_step overflowed on {shards} shard(s)")
        # the mesh's float32 sum of the exact per-shard counts, in rank order
        slabs = fg.reshape(shards, -1).sum(1).to(torch.float32)
        acc = slabs[0]
        for c in slabs[1:]:
            acc = acc + c
        want_n = int(round(float(acc)))
        for execution in ("fused", "split"):
            tag = f"{shards}-{execution}"
            d = tempfile.mkdtemp(prefix=f"fused-{tag}-", dir=mc["root"])
            wf = FusedSegmentationWorkflow(tmp_folder=os.path.join(d, "tmp"), config_dir=cfg_dir, max_jobs=8,
                                           input_path=mem, input_key="boundaries_fused", output_path=mem,
                                           ws_key=f"fws-{tag}", cc_key=f"fcc-{tag}", block_shape=list(block),
                                           execution=execution, **fused_cfg)
            replaying = shards == REDUCE_SHARDS and execution == "split"
            K.reset_counts()
            reset_peaks()
            sync_cards()
            t0 = time.perf_counter()
            with K.capture_inputs() if replaying else contextlib.nullcontext() as captured:
                ok = run_dag([wf])
            sync_cards()
            wall = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
            peak = max_card_peak_gb()
            if not ok:
                raise AssertionError(f"reduce-tree (d) {tag}: the fused workflow failed")
            doc = wf.output().read()
            if shards == REDUCE_SHARDS and execution == "fused":
                fused_launches = launches
            missing = [k for k in MAIN_PATH_KERNELS if launches.get(k, 0) == 0]
            if missing:
                raise AssertionError(f"reduce-tree (d) {tag}: no launch of {missing}")
            ws_got = torch.from_numpy(f[f"fws-{tag}"][...].view(np.int64)).cuda()
            cc_got = torch.from_numpy(f[f"fcc-{tag}"][...].view(np.int64)).cuda()
            for what, a, b in (("ws", ws_got, ref_ws[0]), ("cc", cc_got, ref_cc[0])):
                if not torch.equal(a, b.long()):
                    raise AssertionError(f"reduce-tree (d) {tag}: {what} differs from make_ws_ccl_step's")
            if not partition_equal(cc_got, ref_t):
                raise AssertionError(f"reduce-tree (d) {tag}: cc is not scipy.ndimage.label's partition")
            if doc["n_foreground"] != want_n or (float(np.float32(n_exact)) == n_exact and shards == 1
                                                 and doc["n_foreground"] != n_exact):
                raise AssertionError(f"reduce-tree (d) {tag}: n_foreground {doc['n_foreground']} != {want_n} "
                                     f"(exact count {n_exact})")
            f._data.pop(f"fws-{tag}")
            f._data.pop(f"fcc-{tag}")
            del ws_got, cc_got
            replayed = ""
            if replaying:
                out = {}
                for i, (kname, kargs, kkw) in enumerate(captured):
                    kfn, tfn = replay(K, kname, kargs, kkw)
                    require_equal(f"reduce-tree (d) {tag}: {kname} launch {i}", kfn(), tfn())
                    out[kname] = out.get(kname, 0) + 1
                captured.clear()
                replayed = f"; every launch of this run equals its twin ({out})"
            voxels = int(np.prod(fvol.shape))
            log("reduce-tree", f"(d) FusedSegmentationWorkflow {tuple(fvol.shape[1:])}, {execution}, mesh "
                               f"{doc['mesh']}: wall {wall:.3f} s = {voxels / wall:.4g} voxels/s, peak {peak:.2f} GB; "
                               f"ws, cc = make_ws_ccl_step on the same mesh; cc = scipy partition; n_foreground "
                               f"{doc['n_foreground']} (exact count {n_exact}); launches {launches}{replayed}")
        del ref_ws, ref_cc
    del fvol, fg, ref_t
    f._data.pop("boundaries_fused")
    for row in rows:
        row["fused_launches"] = fused_launches.get(row["name"], 0)

    # ---- (e) the slab sweep of B3 across ranks ----
    big, extent, halo = 1e30, 64, 32

    def slab_edt(x):
        f_ = torch.where(x < 0.45, torch.zeros_like(x), torch.full_like(x, big))
        return K.edt_cascade(f_, axis=0, radius=halo, w=1.0, big=big)[halo:-halo]

    outs = {}
    for n_ranks in (1, 4):
        K.reset_counts()
        sync_cards()
        t0 = time.perf_counter()
        out = sharded_slab_sweep(vol[0], slab_edt, extent, halo, batch=8, fill=0.0, keep_on_device=True,
                                 n_ranks=n_ranks)
        sync_cards()
        outs[n_ranks] = (out, time.perf_counter() - t0, dict(K.LAUNCHES))
    if not torch.equal(outs[1][0], outs[4][0]):
        raise AssertionError("reduce-tree (e): sharded_slab_sweep with n_ranks=4 differs from n_ranks=1")
    log("reduce-tree", f"(e) sharded_slab_sweep of B3 (extent {extent}, halo {halo}, batch 8) over "
                       f"{tuple(vol.shape[1:])}: n_ranks=4 == n_ranks=1 bit for bit; "
                       + "; ".join(f"n_ranks {r}: {s_:.3f} s, launches {ln}" for r, (_, s_, ln) in outs.items()))
    del outs
    # the plane's arenas (8 GiB budget) go: later phases size their own
    device_pool.reset()
    for k, v in saved_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    tree_counts = dict(native.COUNTS)
    log("reduce-tree", f"phase {time.perf_counter() - t_phase:.1f} s; host C++ calls in this phase {tree_counts} "
                       f"(worker processes' not counted); in the multicut phase's {MC_EDGE}^3 workflow {mc['mc_counts']} and "
                       f"its default workflow {mc['default_counts']}")


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
    after (its payloads are this process's RAM); the chunk cache starts
    empty (``configure()``), so every arm reads cold, and its counters come
    back summed (``counters``) and by task (``task_counters``)."""
    from cluster_tools_tpu_torch.io import chunk_cache
    from cluster_tools_tpu_torch.runtime import handoff
    from cluster_tools_tpu_torch.runtime.task import build as run_dag

    d = os.path.join(root, tag)
    os.makedirs(os.path.join(d, "cfg"))
    write_json(os.path.join(d, "cfg", "global.config"),
               {"block_shape": list(block), "memory_handoffs": memory_handoffs})
    tmp = os.path.join(d, "tmp")
    handoff.reset()
    chunk_cache.configure()
    wf = workflow_cls(tmp_folder=tmp, config_dir=os.path.join(d, "cfg"), max_jobs=8, block_shape=list(block),
                      **params)
    K.reset_counts()
    reset_peaks()
    sync_cards()
    t0 = time.perf_counter()
    ok = run_dag([wf])
    sync_cards()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak_gb, reserved_gb = max_card_peak_gb(), torch.cuda.memory_reserved() / 1e9
    if not ok:
        logs = "".join(open(os.path.join(tmp, f)).read()[-3000:] for f in sorted(os.listdir(tmp)) if f.endswith(".log"))
        raise AssertionError(f"fusion {tag}: the workflow failed; task logs:\n{logs}")
    tasks = {}
    for f in sorted(os.listdir(tmp)):
        if f.endswith(".success.json") and not f.split(".")[0].endswith("_workflow"):
            tasks[f.split(".")[0]] = json.load(open(os.path.join(tmp, f)))
    counters, task_counters = Counter(), {}
    io_path = os.path.join(tmp, "io_metrics.json")
    if os.path.exists(io_path):
        for uid, m in json.load(open(io_path))["tasks"].items():
            counters.update({k: v for k, v in m.items() if isinstance(v, (int, float))})
            task_counters[uid.split(".")[0]] = m
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
                launches=launches, peak_gb=peak_gb, reserved_gb=reserved_gb, counters=dict(counters),
                task_counters=task_counters, spills=spills, inter_bytes=inter, inter_top=top, sweep=dict(sweep))


HANDOFF_COUNTERS = ("handoffs_published", "handoffs_served", "handoffs_spilled", "handoff_fallbacks",
                    "bytes_not_stored", "bytes_spilled")
# the chunk cache's counters that the fusion phase prints
CACHE_COUNTERS = ("hits", "misses", "coalesced", "evictions", "bytes_from_storage", "direct_reads", "stall_fallbacks")


def cache_line(c: dict) -> str:
    return ", ".join(f"{k} {int(c.get(k, 0))}" for k in CACHE_COUNTERS)


def fusion_line(tag: str, rec: dict) -> str:
    c = rec["counters"]
    return (f"{tag}: wall {rec['wall_s']:.3f} s; tasks " + ", ".join(f"{k} {v:.3f}" for k, v in rec["tasks"].items())
            + f" s; launches {rec['launches']}; chunk cache {cache_line(c)}; handoffs "
            + ", ".join(f"{k} {int(c.get(k, 0))}" for k in HANDOFF_COUNTERS)
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
       ``gaec_parallel``, block 128^3, ``max_jobs=8``) on the first
       ``FUSION_EDGE``^3 of the main path's boundary map (the volume
       given), ``memory_handoffs`` off and on, each cold in a
       fresh ``tmp_folder``: ``seg`` equal bit for bit, B1-B4 launched in
       both arms with equal counts, and the on arm's gates
       (:func:`check_fusion_on`).
    2. ``ConnectedComponentsWorkflow`` (``bmap < 0.45``) on the same file,
       off and on: equal labels.
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
    4. The chunk cache (ROADMAP item 9c): ``WatershedWorkflow`` (halo 32,
       threshold 0.45, min seed distance 2, block 128^3, ``max_jobs=8``)
       three times, each cold (fresh ``tmp_folder``, cache emptied by
       ``configure()``): (a) ``CTT_CHUNK_CACHE=0``, (b) the cache on, (c) the
       cache on, from the same volume written by the port to N5 (gzip,
       blocks 128^3).  Per arm the watershed task's seconds, the wall, the
       task's cache counters and the launches.  Gates: the labels of every
       arm equal bit for bit to the chain's own watershed of part 1; in (b)
       and (c) one miss a distinct chunk of the sweep's cover, its bytes
       from storage, every other chunk read a hit or a coalesced wait and no
       direct read (computed from the cover, and only when the cache's
       budget holds the whole input: the phase fails otherwise); in (a) one
       direct read a block; no stall fallback; every arm's launches those of
       the chain.  Parts 1-3 run with the cache on and print its counters.
    Adds ``fusion_launches`` (off / on arm of 1) and ``cache_launches``
    (arms a, b, c) to the kernel rows.
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
        # the chain's own watershed, for part 4 (the off arm stores it)
        ws_chain = open_container(os.path.join(root, "mc-off.zarr"))["ws"][...]
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
        ccp = dict(input_path=src_path, input_key="bmap", threshold=0.45, threshold_mode="less", connectivity=1)
        cc = {}
        for arm, on in (("off", False), ("on", True)):
            out = os.path.join(root, f"cc-{arm}.zarr")
            cc[arm] = fusion_arm(K, root, f"cc-{arm}", ConnectedComponentsWorkflow, on, out, ("cc",), block,
                                 output_path=out, output_key="cc", **ccp)
            sw = cc[arm]["sweep"]
            log("fusion", fusion_line(f"ConnectedComponentsWorkflow {shape} from disk, memory_handoffs {arm}, "
                                      f"summed load {sw.get('load_s', 0):.3f} s, store {sw.get('store_s', 0):.3f} s",
                                      cc[arm]))
        a = open_container(os.path.join(root, "cc-off.zarr"))["cc"][...]
        b = open_container(os.path.join(root, "cc-on.zarr"))["cc"][...]
        if not np.array_equal(a, b):
            raise AssertionError("fusion: cc labels differ between memory_handoffs off and on")
        check_fusion_on("cc on", cc["on"])
        log("fusion", f"cc {shape}: labels equal off/on ({int(a.max())} max label); wall off "
                      f"{cc['off']['wall_s']:.3f} s, on {cc['on']['wall_s']:.3f} s; summed store off "
                      f"{cc['off']['sweep'].get('store_s', 0):.3f} s, on {cc['on']['sweep'].get('store_s', 0):.3f} s")
        del a, b

        # ---- 3. the device rung ----
        device_rung(K, vol, root)

        # ---- 4. the chunk cache ----
        cache = chunk_cache_arms(K, vol, root, src_path, ws_chain, mc["off"]["launches"], block)
        del ws_chain
    for row in rows:
        row["fusion_launches"] = {arm: mc[arm]["launches"].get(row["name"], 0) for arm in ("off", "on")}
        row["cache_launches"] = {arm: cache[arm]["launches"].get(row["name"], 0) for arm in cache}
    log("fusion", f"phase {time.perf_counter() - t_phase:.1f} s")


def chunk_cover(shape, block, halo, chunks):
    """``(chunk reads, distinct chunks, their bytes, blocks)`` of one sweep's
    outer reads (``block`` with ``halo``, clipped to the volume) over a
    float32 volume stored in ``chunks``; a chunk's bytes are its part
    inside the volume."""
    from cluster_tools_tpu_torch.utils.volume_utils import Blocking

    blocking = Blocking(shape, block)
    steps = []
    for b in range(blocking.n_blocks):
        blk = blocking.get_block(b, halo)
        steps += itertools.product(*[range(lo // c, (hi - 1) // c + 1)
                                     for lo, hi, c in zip(blk.outer_begin, blk.outer_end, chunks)])
    distinct = set(steps)
    nbytes = sum(int(np.prod([min(c, s - i * c) for i, c, s in zip(idx, chunks, shape)])) * 4 for idx in distinct)
    return len(steps), len(distinct), nbytes, blocking.n_blocks


def chunk_cache_arms(K, vol: torch.Tensor, root: str, src_path: str, ws_chain: np.ndarray, chain_launches: dict,
                     block, halo: int = 32) -> dict:
    """Part 4 of the "fusion" phase (see :func:`phase_fusion`); returns the
    arms' records."""
    from concurrent.futures import ThreadPoolExecutor

    from cluster_tools_tpu_torch.io import chunk_cache
    from cluster_tools_tpu_torch.io.containers import open_container
    from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow

    shape = tuple(vol.shape[-3:])
    n_steps, n_distinct, cover_bytes, n_blocks = chunk_cover(shape, block, [halo] * 3, block)
    budget = chunk_cache.configure().max_bytes
    in_bytes = int(np.prod(shape)) * 4
    log("fusion", f"chunk cache: budget {budget} B (CTT_CHUNK_CACHE_BYTES, else min(1 GiB, MemAvailable/8)); the "
                  f"watershed sweep's outer reads (block {tuple(block)}, halo {halo}) cover {n_steps} chunk reads of "
                  f"{n_distinct} distinct chunks ({cover_bytes} B decompressed)")
    if budget < in_bytes:
        raise AssertionError(f"fusion: the chunk cache's budget {budget} B is below the input's {in_bytes} B, so the "
                             "miss gate cannot hold (raise CTT_CHUNK_CACHE_BYTES)")
    # the same volume in the port's N5 (gzip, blocks of `block`)
    n5_path = os.path.join(root, "in.n5")
    n5 = open_container(n5_path).require_dataset("bmap", shape=shape, chunks=block, dtype="float32",
                                                  compression="gzip")
    b = vol.reshape(shape)
    boxes = [tuple(slice(o, o + c) for o, c in zip(origin, block))
             for origin in itertools.product(*[range(0, s, c) for s, c in zip(shape, block)])]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda bb: n5.__setitem__(bb, b[bb].cpu().numpy()), boxes))
    log("fusion", f"chunk cache: the input written to the port's N5 (gzip) in {time.perf_counter() - t0:.2f} s")

    recs = {}
    for arm, path, cache_on in (("a", src_path, False), ("b", src_path, True), ("c", n5_path, True)):
        out = os.path.join(root, f"ws-{arm}.zarr")
        saved = os.environ.get("CTT_CHUNK_CACHE")
        os.environ["CTT_CHUNK_CACHE"] = "1" if cache_on else "0"
        try:
            rec = fusion_arm(K, root, f"ws-{arm}", WatershedWorkflow, False, out, ("ws",), block, input_path=path,
                             input_key="bmap", output_path=out, output_key="ws", halo=[halo] * 3, threshold=0.45,
                             min_seed_distance=2.0)
        finally:
            if saved is None:
                del os.environ["CTT_CHUNK_CACHE"]
            else:
                os.environ["CTT_CHUNK_CACHE"] = saved
        recs[arm] = rec
        c = rec["task_counters"].get("watershed", {})
        src = "zarr" if path == src_path else "N5"
        log("fusion", f"chunk cache arm ({arm}) WatershedWorkflow {shape} from {src}, CTT_CHUNK_CACHE="
                      f"{1 if cache_on else 0}: watershed task {rec['tasks'].get('watershed', float('nan')):.3f} s, "
                      f"wall {rec['wall_s']:.3f} s, summed load {rec['sweep'].get('load_s', 0):.3f} s; watershed "
                      f"task counters {cache_line(c)}; launches {rec['launches']}")
        if not np.array_equal(open_container(out)["ws"][...], ws_chain):
            raise AssertionError(f"fusion: chunk cache arm ({arm}): the labels differ from the multicut chain's "
                                 "watershed")
        shutil.rmtree(os.path.join(root, f"ws-{arm}"))
        shutil.rmtree(out)
        missing = [k for k in MAIN_PATH_KERNELS if rec["launches"].get(k, 0) == 0]
        if missing or rec["launches"] != chain_launches:
            raise AssertionError(f"fusion: chunk cache arm ({arm}) launched {rec['launches']}, the chain's watershed "
                                 f"{chain_launches}")
        if int(c.get("stall_fallbacks", 0)):
            raise AssertionError(f"fusion: chunk cache arm ({arm}): {c['stall_fallbacks']} stall fallbacks")
        if cache_on:
            got = (int(c.get("misses", 0)), int(c.get("bytes_from_storage", 0)),
                   int(c.get("hits", 0)) + int(c.get("coalesced", 0)), int(c.get("direct_reads", 0)))
            if got != (n_distinct, cover_bytes, n_steps - n_distinct, 0):
                raise AssertionError(f"fusion: chunk cache arm ({arm}): misses, bytes from storage, hits + coalesced, "
                                     f"direct reads {got}; the chunk cover gives {n_distinct}, {cover_bytes}, "
                                     f"{n_steps - n_distinct}, 0")
        elif (int(c.get("direct_reads", 0)), int(c.get("hits", 0)) + int(c.get("misses", 0))) != (n_blocks, 0):
            raise AssertionError(f"fusion: chunk cache arm ({arm}) with the cache off: {cache_line(c)}; expected "
                                 f"{n_blocks} direct reads and no hit or miss")
    log("fusion", f"chunk cache: labels equal bit for bit in arms (a), (b), (c) and to the multicut chain's "
                  f"watershed; (b) and (c) missed each of the {n_distinct} distinct chunks once ({cover_bytes} B "
                  f"from storage) and served the other {n_steps - n_distinct} chunk reads from the cache; (a) "
                  f"{n_blocks} direct reads; no stall fallback; launches {chain_launches} in every arm; watershed "
                  "task " + ", ".join(f"({a}) {r['tasks'].get('watershed', float('nan')):.3f}" for a, r in recs.items())
                  + " s")
    return recs


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
        write_json(os.path.join(d, "cfg", "global.config"), {"memory_handoffs": True, "device_handoffs": True})
        kw = dict(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"),
                  handoff_path=os.path.join(d, "vol.npz"), final_path=os.path.join(d, "out.npz"))
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        handoff.reset()
        try:
            K.reset_counts()
            snap, hsnap = device_pool.snapshot(), handoff.snapshot()
            sync_cards()
            t0 = time.perf_counter()
            ok = run_dag([Producer(**kw)]) and run_dag([Consumer(**kw)])
            sync_cards()
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
        fails = os.path.join(root, "failures.json")
        handoff.publish_device_arrays(pa, {"vol": crop}, producer="fusion.0", failures_path=fails)
        handoff.publish_device_arrays(pb, {"vol": crop + 1}, producer="fusion.0", failures_path=fails)
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

        # ---- ilastik: training, then the linear classifier and the forest ----
        rng = np.random.default_rng(seed)
        ihalo = (12, 12, 12)
        iouter = tuple(b + 2 * h for b, h in zip(block, ihalo))
        linear = os.path.join(tmp_root, "linear.npz")
        W, b = train_on_the_card(il, raw, seed)
        np.savez(linear, W=W, b=b, sigmas=np.array(il.DEFAULT_SIGMAS))
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
                           phase="inference", warm_up=False, input_path=mem, input_key="raw", output_path=mem,
                           output_key=key, checkpoint_path=ckpt_i)
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


# the pixel classifier's training crop (its first TRAIN_EDGE^3), the share
# of its voxels labelled, and a trained W or b against its CPU run,
# relative to the largest entry of the CPU's: float32 glue rounds apart by
# ~1e-6 (PERF.md), a TF32 product (~5e-4 a product) fails it
TRAIN_EDGE = 128
TRAIN_SCRIBBLES = 0.01
TRAIN_RTOL = 1e-5


def train_on_the_card(il, raw: np.ndarray, seed: int):
    """``train_pixel_classifier`` (ROADMAP item 8b) on the card: the first
    ``TRAIN_EDGE``^3 of the map, ``TRAIN_SCRIBBLES`` of its voxels labelled
    by the main path's threshold (foreground 1, background 2), the default
    feature bank, 300 Adam steps.  ``W`` and ``b`` are held against the
    same call with ``device="cpu"`` within ``TRAIN_RTOL`` of the largest
    entry of the CPU's (the feature bank and the reductions round apart in
    float32 ulps), the classes they give the labelled voxels equal.
    Returns the card's ``(W, b)``."""
    crop = np.ascontiguousarray(raw[:TRAIN_EDGE, :TRAIN_EDGE, :TRAIN_EDGE])
    trng = np.random.default_rng(seed + 19)
    labels = np.zeros(crop.shape, np.uint8)
    scribble = trng.random(crop.shape) < TRAIN_SCRIBBLES
    labels[scribble] = np.where(crop[scribble] < np.float32(0.45), 1, 2).astype(np.uint8)
    sync_cards()
    t0 = time.perf_counter()
    W, b = il.train_pixel_classifier(crop, labels, device="cuda")
    sync_cards()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Wc, bc = il.train_pixel_classifier(crop, labels, device="cpu")
    cpu_s = time.perf_counter() - t0
    errs = {k: float(np.abs(g - w).max() / np.abs(w).max()) for k, g, w in (("W", W, Wc), ("b", b, bc))}
    if not max(errs.values()) <= TRAIN_RTOL:
        raise AssertionError(f"training: the card's W, b differ from the CPU's by {errs} (relative)")
    feats = il.feature_bank(torch.from_numpy(crop).cuda(), il.DEFAULT_SIGMAS)[torch.from_numpy(scribble).cuda()]
    cls_card = (feats @ torch.from_numpy(W).cuda() + torch.from_numpy(b).cuda()).argmax(1)
    cls_cpu = (feats @ torch.from_numpy(Wc).cuda() + torch.from_numpy(bc).cuda()).argmax(1)
    n_apart = int((cls_card != cls_cpu).sum())
    acc = float((cls_card.cpu().numpy() == labels[scribble] - 1).mean())
    del feats
    if n_apart:
        raise AssertionError(f"training: the card's classifier and the CPU's disagree on {n_apart} of the "
                             f"{int(scribble.sum())} labelled voxels (W, b relative max err {errs})")
    log("inference", f"training: {crop.shape} crop, {int(scribble.sum())} labelled voxels, {W.shape[0]} features; "
                     f"card {card_s:.3f} s, CPU {cpu_s:.3f} s; W, b vs CPU relative max err {errs['W']:.3g}, "
                     f"{errs['b']:.3g} (tolerance {TRAIN_RTOL:g}); the classes on the labelled voxels equal, "
                     f"{acc:.4f} of them right")
    return W, b


SERVE_BLOCK = (128, 128, 128)
# the chunk cache's budget in the "serve" phase: the resident working set
# of both tenants (inputs, 640 MiB, and the intermediates the handoff
# budget spills to disk) must fit for the warm request to miss nothing
SERVE_CACHE_BYTES = 8 << 30
# the watershed of the "blockwise" phase (halo 32, threshold 0.45, EDT cap 32,
# min seed distance 2) as a request's params
SERVE_WS = dict(halo=[32, 32, 32], threshold=0.45, dt_max_distance=32.0, min_seed_distance=2.0)


def serve_yardstick(K, vol: torch.Tensor) -> dict:
    """The reference labels of the "serve" and "fleet" phases on their
    volume (the first ``SERVE_EDGE``^3 of the main path's): the cc workflow
    of its mask (``< 0.45``), held against ``scipy.ndimage.label``'s
    partition, and the single-pass watershed (``SERVE_WS``), one run each
    in ``memory://`` (block ``SERVE_BLOCK``), kept as numpy, with the
    watershed's launches (each watershed request of this volume launches
    the same)."""
    import scipy.ndimage as ndi

    from cluster_tools_tpu_torch.io.containers import MemoryContainer, open_container
    from cluster_tools_tpu_torch.tasks.connected_components import ConnectedComponentsWorkflow
    from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow

    mem = "memory://serve-yardstick"
    f = open_container(mem)
    b_np = vol.reshape(vol.shape[-3:]).cpu().numpy()
    f.require_dataset("boundaries", shape=b_np.shape, chunks=SERVE_BLOCK, dtype="float32")[...] = b_np
    mask = (b_np < np.float32(0.45)).astype(np.uint8)
    f.require_dataset("mask", shape=b_np.shape, chunks=SERVE_BLOCK, dtype="uint8")[...] = mask
    with tempfile.TemporaryDirectory(prefix="serve-yardstick-") as root:
        cc = bw_run(K, root, "cc", ConnectedComponentsWorkflow, SERVE_BLOCK, input_path=mem, input_key="mask",
                    output_path=mem, output_key="cc", connectivity=1)
        ws = bw_run(K, root, "ws", WatershedWorkflow, SERVE_BLOCK, input_path=mem, input_key="boundaries",
                    output_path=mem, output_key="ws", **SERVE_WS)
    ref, _ = ndi.label(mask.astype(bool))
    if not partition_equal(torch.from_numpy(f["cc"][...].astype(np.int64)).cuda(),
                           torch.from_numpy(ref.astype(np.int64)).cuda()):
        raise AssertionError("serve yardstick: cc labels are not scipy.ndimage.label's partition")
    log("serve", f"yardstick {b_np.shape}: cc in {cc['wall_s']:.3f} s (= scipy partition), the single-pass "
                 f"watershed in {ws['wall_s']:.3f} s, launches {ws['launches']}")
    out = {"ws": f["ws"][...], "cc": f["cc"][...], "launches": ws["launches"]}
    del MemoryContainer._registry[mem]
    return out


def serve_payload(tenant: str, rid: str, workflow: str, out_key: str, block=SERVE_BLOCK, **params) -> dict:
    """A request naming no target (the card), ``max_jobs=8`` as the other
    phases run their workflows."""
    return dict(tenant=tenant, request_id=rid, workflow=workflow,
                config=dict(max_jobs=8, global_config={"block_shape": list(block)},
                            params=dict(params, output_key=out_key)))


def serve_line(tag: str, rec: dict, wall: float, voxels: int, peak: str, card: str) -> None:
    """One request's line; its tasks' seconds come from their success
    manifests, the rest of ``run_s`` is the build's own work and the
    flush of the request's handoffs to storage."""
    from cluster_tools_tpu_torch.utils.parse_utils import parse_runtimes

    tasks = {doc["task"]: doc.get("runtime_s", 0.0) for doc in parse_runtimes(rec["tmp_folder"]).values()}
    log("serve", f"{tag} ({rec['workflow']}, tenant {rec['tenant']}): {rec['state']}; wall {wall:.3f} s, "
                 f"queued {rec['queued_s']:.3f} s, run {rec['run_s']:.3f} s = {voxels / rec['run_s']:.4g} voxels/s "
                 f"(tasks {', '.join(f'{k} {v:.3f}' for k, v in tasks.items())} s; flush and the rest "
                 f"{rec['run_s'] - sum(tasks.values()):.3f} s); peak {peak}; launches "
                 f"{rec.get('kernel_launches', {})} [{card}]")


def spawn_server(base: str, log_path: str):
    """``python -m cluster_tools_tpu_torch.serve`` in ``base``, its output in
    ``log_path``; returns the process once its endpoint file exists."""
    endpoint = os.path.join(base, "server.json")
    if os.path.exists(endpoint):
        os.remove(endpoint)
    with open(log_path, "a") as out:
        proc = subprocess.Popen([sys.executable, "-m", "cluster_tools_tpu_torch.serve", "--base-dir", base,
                                 "--max-workers", "1"], cwd=os.path.dirname(os.path.abspath(__file__)),
                                stdout=out, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 180
    while not os.path.exists(endpoint):
        if proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError(f"serve: the server child never came up (rc {proc.poll()}):\n"
                                 + open(log_path).read()[-3000:])
        time.sleep(0.05)
    return proc


def serve_input(root: str, vol: torch.Tensor, block=SERVE_BLOCK) -> str:
    """The boundary map ``vol`` and its mask (``< 0.45``) in the
    port's zarr on local disk under ``root`` (zlib level 1, chunks
    ``block``, digest sidecars on); returns its path."""
    from cluster_tools_tpu_torch.io.containers import open_container

    b_np = vol.reshape(vol.shape[-3:]).cpu().numpy()
    data = os.path.join(root, "data.zarr")
    z = open_container(data)
    z.require_dataset("boundaries", shape=b_np.shape, chunks=block, dtype="float32")[...] = b_np
    z.require_dataset("mask", shape=b_np.shape, chunks=block, dtype="uint8")[...] = \
        (b_np < np.float32(0.45)).astype(np.uint8)
    if not os.path.isdir(os.path.join(data, "boundaries", ".ctt_checksums")):
        raise AssertionError("serve: the input was written without digest sidecars")
    return data


def phase_serve(K, vol: torch.Tensor, ref: dict, rows: list, block=SERVE_BLOCK, then=None) -> None:
    """The resident pipeline server on the card (ROADMAP item 11c), from the
    port's zarr on local disk (zlib level 1, chunks 128^3, digest sidecars
    on) holding the boundary map ``vol`` (the first ``SERVE_EDGE``^3 of the
    main path's) and its mask (``< 0.45``), in its own base directories
    under a temporary root; ``ref`` is its :func:`serve_yardstick`.

    1. An in-process ``PipelineServer`` (tenants alice and bob, two
       workers; the scrubber driven by hand): alice's single-pass watershed
       (block 128^3, ``auto``, no target: the card) and bob's connected
       components of the mask, submitted together; both ``done``, the
       watershed equal to the yardstick's bit for bit, the cc equal to its
       cc (held there against ``scipy.ndimage.label``) bit for bit.
       Then alice resubmits the watershed: chunk-cache hits and no miss in
       its ``io_metrics.json``, the same labels.
    2. The scrubber: a voxel of one stored chunk of the first watershed's
       output is flipped on disk (sidecar untouched); one scrubber pass
       finds it and repairs it from the in-process lineage (which moved to
       the stored copy when the request's namespace was flushed); the store
       reads back equal to the clean labels and ``scrub_state.json`` counts
       one finding and one repair.
    3. ``python -m cluster_tools_tpu_torch.serve`` as a child: a watershed
       submitted, SIGTERM at its first block markers, exit 114, a restart
       in the same base directory replays the journal (accepted, dispatched,
       drained) and the request ends ``done`` with the same labels.
    4. ``GET /status`` of both servers: rc 0, no live handoff entry, the
       tenants' counts.

    Prints per request the wall, ``queued_s``, ``run_s``, voxels/s, peak
    device memory and the kernel launches counted under the request; cold
    against warm; restart-to-done; the scrub seconds; each beside the
    card's name and power limit.  The kernel rows gain ``serve_launches``
    (by request).  ``then(root, data)``, when given, runs at the end in
    the phase's temporary root with the input's zarr path (the "fleet"
    phase)."""
    import signal

    from cluster_tools_tpu_torch.io import chunk_cache
    from cluster_tools_tpu_torch.io.containers import open_container
    from cluster_tools_tpu_torch.runtime import journal as journal_mod
    from cluster_tools_tpu_torch.runtime import scrub as scrub_mod
    from cluster_tools_tpu_torch.runtime.server import PipelineServer, ServeClient
    from cluster_tools_tpu_torch.runtime.supervision import REQUEUE_EXIT_CODE

    t_phase = time.perf_counter()
    card = nvidia_smi()
    # the earlier phases' stores are gone with their temporary directories:
    # the scrubber's pass covers this phase's
    scrub_mod.reset_targets()
    voxels = int(np.prod(vol.shape[-3:]))
    per_request = {}
    with tempfile.TemporaryDirectory(prefix="serve-") as root:
        data = serve_input(root, vol, block)
        z = open_container(data)
        ws_params = dict(input_path=data, input_key="boundaries", output_path=data, block_shape=list(block),
                         **SERVE_WS)

        def ws(rid, key):
            return serve_payload("alice", rid, "watershed", key, **ws_params)

        def same(key, want, what):
            # the stored bytes, past the chunk cache (which keeps the inputs
            # for the warm request; no request runs meanwhile)
            os.environ["CTT_CHUNK_CACHE"] = "0"
            try:
                got = z[key][...]
            finally:
                del os.environ["CTT_CHUNK_CACHE"]
            if not np.array_equal(got, want):
                raise AssertionError(f"serve: {what} differs from the yardstick's labels")

        chunk_cache.configure(SERVE_CACHE_BYTES)
        server = PipelineServer(base_dir=os.path.join(root, "srv"), tenants={"alice": {}, "bob": {}},
                                max_workers=2, scrub={"enabled": False}).start()
        client = ServeClient(server.host, server.port, timeout_s=60)
        try:
            # 1. two tenants at once on the card, then the warm resubmission
            K.reset_counts()
            reset_peaks()
            sync_cards()
            t0 = time.perf_counter()
            client.submit(**ws("a1", "ws_a1"))
            client.submit(**serve_payload("bob", "b1", "connected_components", "cc_b1", input_path=data,
                                          input_key="mask", output_path=data, connectivity=1))
            recs = {rid: client.wait(rid, timeout_s=900) for rid in ("a1", "b1")}
            # each request's wall: its submission to its end, on the host clock
            walls = {rid: rec["finished"] - rec["submitted"] for rid, rec in recs.items()}
            pair_launches, pair_peak = dict(K.LAUNCHES), max_card_peak_gb()
            for rid, rec in recs.items():
                if rec["state"] != "done":
                    raise AssertionError(f"serve {rid}: {rec['state']}: {rec.get('error')}")
            same("ws_a1", ref["ws"], "alice's watershed")
            same("cc_b1", ref["cc"], "bob's connected components")
            for rid, rec in recs.items():
                serve_line(f"cold {rid}", rec, walls[rid], voxels, f"{pair_peak:.2f} GB (both requests)", card)
            require_kernels("serve a1", recs["a1"].get("kernel_launches", {}))
            if sum(pair_launches.values()) != sum(sum(r.get("kernel_launches", {}).values()) for r in recs.values()):
                raise AssertionError(f"serve: the requests' launches {recs} do not add up to {pair_launches}")
            K.reset_counts()
            reset_peaks()
            cache_before = chunk_cache.snapshot()
            t0 = time.perf_counter()
            client.submit(**ws("a2", "ws_a2"))
            warm = client.wait("a2", timeout_s=900)
            warm_wall = time.perf_counter() - t0
            if warm["state"] != "done":
                raise AssertionError(f"serve a2: {warm['state']}: {warm.get('error')}")
            same("ws_a2", ref["ws"], "alice's warm watershed")
            serve_line("warm a2", warm, warm_wall, voxels, f"{max_card_peak_gb():.2f} GB", card)
            launches_a2 = warm.get("kernel_launches", {})
            if launches_a2 != dict(K.LAUNCHES) or launches_a2 != recs["a1"].get("kernel_launches", {}):
                raise AssertionError(f"serve a2: launches {warm.get('kernel_launches')} (counted {dict(K.LAUNCHES)}, "
                                     f"cold {recs['a1'].get('kernel_launches')})")
            io_doc = json.load(open(os.path.join(warm["tmp_folder"], "io_metrics.json")))
            hits = sum(t.get("hits", 0) for t in io_doc["tasks"].values())
            misses = sum(t.get("misses", 0) for t in io_doc["tasks"].values())
            if not hits or misses:
                raise AssertionError(f"serve a2: chunk cache hits {hits}, misses {misses} (want hits, no miss); "
                                     f"the cache before it {cache_before}")
            log("serve", f"cold against warm: watershed run {recs['a1']['run_s']:.3f} s (beside bob's cc) -> "
                         f"{warm['run_s']:.3f} s alone and warm; its tasks' chunk cache {hits} hits, {misses} "
                         f"misses; the cache before it {cache_before} [{card}]")
            per_request.update({"a1": recs["a1"].get("kernel_launches", {}), "b1": recs["b1"].get("kernel_launches", {}),
                                "a2": launches_a2})

            # 2. the scrubber: rot at rest, found and healed from lineage
            out = z["ws_a1"]
            bb = tuple(slice(0, c) for c in block)
            # rot at rest: the stored bytes as they are, past the verifying
            # reader, since planting what the scrubber must find is the point
            bad = out._read_back(bb).copy()  # ctlint: disable=CT011
            bad[tuple(c // 3 for c in block)] ^= 1
            out._write_raw(bb, bad)
            t0 = time.perf_counter()
            scanned = server.scrubber.scan_once(budget_bytes=1 << 62)
            scrub_s = time.perf_counter() - t0
            st = server.scrubber.stats()
            if (st["found_corrupt"], st["repaired"], st["unrepairable"]) != (1, 1, 0):
                raise AssertionError(f"serve scrub: found {st['found_corrupt']}, repaired {st['repaired']}, "
                                     f"unrepairable {st['unrepairable']} (want 1, 1, 0): {st['last_corrupt']}")
            same("ws_a1", ref["ws"], "the scrubbed watershed")
            state = json.load(open(os.path.join(root, "srv", "scrub_state.json")))
            if (state["found_corrupt"], state["repaired"]) != (1, 1):
                raise AssertionError(f"serve scrub: scrub_state.json counts {state['found_corrupt']} found, "
                                     f"{state['repaired']} repaired")
            log("serve", f"scrub: one pass over {scanned} regions ({st['scanned_bytes'] / 2**30:.2f} GiB, "
                         f"{st['targets']} registered targets, {st['errors']} errors) in {scrub_s:.3f} s found the flipped voxel of "
                         f"{st['last_corrupt']['dataset']} {st['last_corrupt']['region']} and repaired it from "
                         f"lineage; the store reads back equal to the clean labels [{card}]")

            # 4. status of the in-process server
            status = client.status()
            tenants = status["server"]["tenants"]
            if (status["rc"], status["server"]["handoffs"]["live_entries"], tenants["alice"]["completed"],
                    tenants["bob"]["completed"]) != (0, 0, 2, 1):
                raise AssertionError(f"serve status: rc {status['rc']}, handoffs {status['server']['handoffs']}, "
                                     f"tenants {tenants}")
            log("serve", f"GET /status: rc 0, live handoff entries 0, alice completed 2, bob completed 1")
        finally:
            server.stop()

        # 3. drain and replay through the entry point
        base = os.path.join(root, "child")
        log_path = os.path.join(root, "child.log")
        proc = None
        try:
            proc = spawn_server(base, log_path)
            client = ServeClient.from_endpoint_file(base, timeout_s=60)
            client.submit(**ws("c1", "ws_c1"))
            markers = os.path.join(base, "requests", "c1", "markers")
            t0 = time.perf_counter()
            while not any(f.startswith("block_") for d in (os.listdir(markers) if os.path.isdir(markers) else [])
                          for f in os.listdir(os.path.join(markers, d))):
                if proc.poll() is not None or time.perf_counter() - t0 > 600:
                    raise AssertionError("serve: the child wrote no block marker:\n" + open(log_path).read()[-3000:])
                time.sleep(0.02)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
            if rc != REQUEUE_EXIT_CODE:
                raise AssertionError(f"serve: the child exited {rc} on SIGTERM, not {REQUEUE_EXIT_CODE}:\n"
                                     + open(log_path).read()[-3000:])
            drained_after = time.perf_counter() - t0
            t_restart = time.perf_counter()
            proc = spawn_server(base, log_path)
            client = ServeClient.from_endpoint_file(base, timeout_s=60)
            rec = client.wait("c1", timeout_s=900, across_restarts=True)
            restart_to_done = time.perf_counter() - t_restart
            if rec["state"] != "done" or not rec.get("replayed"):
                raise AssertionError(f"serve c1 after the restart: {rec}")
            same("ws_c1", ref["ws"], "the replayed watershed")
            types = [r["type"] for r in journal_mod.scan(journal_mod.journal_path(base))[0] if r["request_id"] == "c1"]
            if "drained" not in types or types[-1] != "completed":
                raise AssertionError(f"serve c1: journal records {types}")
            require_kernels("serve c1", rec.get("kernel_launches", {}))
            per_request["c1"] = rec.get("kernel_launches", {})
            serve_line("replayed c1", rec, restart_to_done, voxels, "not measured (child process)", card)
            status = client.status()
            if (status["rc"], status["server"]["handoffs"]["live_entries"],
                    status["server"]["tenants"]["alice"]["completed"]) != (0, 0, 1):
                raise AssertionError(f"serve child status: rc {status['rc']}, handoffs "
                                     f"{status['server']['handoffs']}, tenants {status['server']['tenants']}")
            log("serve", f"child: SIGTERM {drained_after:.3f} s after the first block marker -> exit "
                         f"{REQUEUE_EXIT_CODE}; journal {types}; restart-to-done {restart_to_done:.3f} s "
                         f"(process start, replay, the whole watershed); labels equal; GET /status rc 0, "
                         f"live handoff entries 0, alice completed 1 [{card}]")
            proc.send_signal(signal.SIGTERM)
            if proc.wait(timeout=120) != REQUEUE_EXIT_CODE:
                raise AssertionError("serve: the restarted child did not drain with exit 114")
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        for row in rows:
            row["serve_launches"] = {rid: n.get(row["name"], 0) for rid, n in per_request.items()}
        log("serve", "launches by request: " + json.dumps(per_request))
        log("serve", f"phase {time.perf_counter() - t_phase:.1f} s")
        chunk_cache.configure()  # the default budget again for the later phases
        if then is not None:
            then(root, data)


# the "fleet" phase: stub scheduler binaries (a job is a detached local
# process, its id the pid; the same few lines as tests/helpers.py's)
SLURM_STUBS = {
    "sbatch": ('script="${@: -1}"\nout=/dev/null\nprev=""\n'
               'for a in "$@"; do if [ "$prev" = "-o" ]; then out="$a"; fi; prev="$a"; done\n'
               'setsid bash "$script" > "$out" 2>&1 &\necho $!\n'),
    "squeue": 'pid="${@: -1}"\nif kill -0 "$pid" 2>/dev/null; then echo "RUNNING"; fi\nexit 0\n',
    "scancel": 'pid="${@: -1}"\nkill -9 "-$pid" 2>/dev/null || kill -9 "$pid" 2>/dev/null\nexit 0\n',
}
# the slurm supervisor's knobs in the "fleet" phase: the lost first
# submission is found by its heartbeat going stale (the node's runner beats
# every 0.5 s, the boot beat comes from the batch script's shell)
FLEET_SLURM = dict(poll_interval_s=0.25, result_grace_s=2.0, heartbeat_interval_s=0.5, heartbeat_timeout_s=4.0,
                   submit_timeout_s=600)
# the fleet: two members on the one card, one worker each; the gateway's
# health tick and staleness, and the supervisor's poll
FLEET_CONFIG = {"members": 2, "gateway": {"health_interval_s": 0.25, "member_stale_s": 2.0},
                "server": {"max_workers": 1, "scrub": {"enabled": False}},
                "supervisor": {"poll_s": 0.25}}


def stub_slurm(bindir: str) -> str:
    os.makedirs(bindir, exist_ok=True)
    for name, body in SLURM_STUBS.items():
        path = os.path.join(bindir, name)
        with open(path, "w") as fh:
            fh.write("#!/bin/bash\n" + body)
        os.chmod(path, 0o755)
    return bindir


class HostMemorySampler:
    """Every 0.5 s on a thread, the largest resident host memory
    (``/proc/<pid>/statm``) of each watched process.  (The card's machine
    lists no process under ``nvidia-smi --query-compute-apps``, and a
    member's ``torch.cuda.max_memory_allocated`` stays inside it, so a
    member's device memory is not measured.)"""

    def __init__(self):
        import threading

        self.peak, self.pids = {}, set()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def watch(self, pid: int) -> None:
        self.pids.add(pid)
        self._sample()

    def _sample(self):
        page = os.sysconf("SC_PAGE_SIZE")
        for pid in list(self.pids):
            try:
                with open(f"/proc/{pid}/statm") as fh:
                    rss = int(fh.read().split()[1]) * page
            except (OSError, ValueError, IndexError):
                continue
            self.peak[pid] = max(self.peak.get(pid, 0), rss)

    def _run(self):
        while not self._stop.wait(0.5):
            self._sample()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=60)

    def line(self, pid: int) -> str:
        return f"{self.peak[pid] / 1e9:.2f} GB host" if pid in self.peak else "host not measured"


def fleet_ingest(root: str, data: str, block, card: str) -> str:
    """Step 1 of the "fleet" phase: ``CopyVolumeWorkflow(target="slurm")``
    copies the boundary map into a fresh zarr through stub ``sbatch``/
    ``squeue``/``scancel``, the first submission swallowed by a
    ``job_loss`` fault; returns the copy's path."""
    from cluster_tools_tpu_torch.io.containers import open_container
    from cluster_tools_tpu_torch.runtime import faults
    from cluster_tools_tpu_torch.runtime.task import build as run_dag
    from cluster_tools_tpu_torch.tasks.copy_volume import CopyVolumeWorkflow

    bindir = stub_slurm(os.path.join(root, "fleet-bin"))
    copy = os.path.join(root, "copy.zarr")
    tmp = os.path.join(root, "fleet-ingest")
    cfg_dir = os.path.join(tmp, "cfg")
    os.makedirs(cfg_dir)
    write_json(os.path.join(cfg_dir, "global.config"), dict(block_shape=list(block), **FLEET_SLURM))
    saved_path = os.environ["PATH"]
    os.environ["PATH"] = bindir + os.pathsep + saved_path
    faults.configure({"faults": [{"site": "submit", "kind": "job_loss", "fail_attempts": 1}]})
    wf = CopyVolumeWorkflow(tmp_folder=tmp, config_dir=cfg_dir, max_jobs=8, target="slurm", input_path=data,
                            input_key="boundaries", output_path=copy, output_key="boundaries")
    t0 = time.perf_counter()
    try:
        ok = run_dag([wf])
    finally:
        faults.configure(None)
        os.environ["PATH"] = saved_path
    wall = time.perf_counter() - t0
    cdir = os.path.join(tmp, "cluster")
    sup_log = open(os.path.join(cdir, "supervisor.log")).read() if os.path.exists(
        os.path.join(cdir, "supervisor.log")) else ""
    if not ok:
        outs = "".join(open(os.path.join(cdir, f)).read()[-2000:] for f in sorted(os.listdir(cdir)) if f.endswith(".out"))
        raise AssertionError(f"fleet ingest: the slurm copy failed; supervisor.log:\n{sup_log}\njob output:\n{outs}")
    (task,) = wf.requires()
    manifest = task.output().read()
    sup = manifest.get("supervisor") or {}
    if sup.get("resubmits") != 1:
        raise AssertionError(f"fleet ingest: supervisor {sup} (want resubmits 1); supervisor.log:\n{sup_log}")
    records = json.load(open(os.path.join(tmp, "failures.json")))["records"]
    loss = [r for r in records if r.get("task") == task.uid and "job_loss" in r.get("sites", {})]
    if len(loss) != 1 or not loss[0]["resolved"] or not loss[0]["job_ids"][0].startswith("lost:"):
        raise AssertionError(f"fleet ingest: failures.json holds no resolved job_loss record: {records}")
    src = open_container(data)["boundaries"][...]
    got = open_container(copy)["boundaries"][...]
    if got.dtype != src.dtype or got.shape != src.shape or got.tobytes() != src.tobytes():
        raise AssertionError("fleet ingest: the slurm copy differs from its source")
    log("fleet", f"ingest: CopyVolumeWorkflow(target='slurm') of the {src.shape} float32 map in {wall:.3f} s "
                 f"(copy task {manifest['runtime_s']:.3f} s on the node's CPU, {manifest['n_blocks']} blocks); the "
                 f"first submission lost (job_loss on submit), found by its stale heartbeat and resubmitted: "
                 f"supervisor {sup}; failures.json job_loss record resolved; supervisor.log: "
                 + " | ".join(line.split(" ", 1)[1] for line in sup_log.splitlines())
                 + f"; the copy equals its source byte for byte [{card}]")
    return copy


def phase_fleet(K, root: str, data: str, ref_ws: np.ndarray, ref_launches: dict, rows: list,
                block=SERVE_BLOCK) -> None:
    """The serving fleet and the cluster targets on the card (ROADMAP items
    11b and 11d), in the "serve" phase's temporary root, on its
    boundary map in the port's zarr (zlib level 1, chunks 128^3, sidecars):

    1. ingest through ``slurm`` (:func:`fleet_ingest`), while the fleet
       of step 2 boots: the copy equals its source byte for byte, the
       task's ``supervisor.resubmits`` is 1 and ``failures.json`` holds the
       resolved ``job_loss`` record;
    2. ``python -m cluster_tools_tpu_torch.fleet`` with two members on the
       one card: alice's watershed (block 128^3, no target: the
       card) on the copy through the gateway; once the owning member has
       written its first block marker it is SIGKILLed; the gateway claims
       its journal, mints a fence and the survivor adopts it.  Gates: the
       request completes with no resubmission by the client, its labels
       equal ``ref_ws`` (the "serve" phase's clean watershed) bit for bit,
       its record's ``kernel_launches`` are ``ref_launches`` (the
       yardstick watershed's: the survivor runs the whole sweep), the
       supervisor's ``lifecycle.log`` records the crash and the respawn,
       and SIGTERM to the supervisor ends the fleet with exit 114.

    Prints the members' boot times, kill-to-adoption, the adopted
    request's ``run_s`` and ``queued_s``, each member's peak resident host
    memory and the phase's wall, beside the card's name and power limit.  The kernel rows
    gain ``fleet_launches`` (the adopted request's)."""
    import signal

    from cluster_tools_tpu_torch.io.containers import open_container
    from cluster_tools_tpu_torch.runtime import journal as journal_mod
    from cluster_tools_tpu_torch.runtime.server import ServeClient
    from cluster_tools_tpu_torch.runtime.supervision import REQUEUE_EXIT_CODE
    from cluster_tools_tpu_torch.utils import function_utils as fu

    t_phase = time.perf_counter()
    card = nvidia_smi()
    fleet_dir = os.path.join(root, "fleet")
    cfg_path = os.path.join(root, "fleet.json")
    write_json(cfg_path, FLEET_CONFIG)
    log_path = os.path.join(root, "fleet.log")
    sampler = HostMemorySampler()
    t_spawn = time.time()
    with open(log_path, "w") as out:
        # its own session: the finally below kills the supervisor, the
        # gateway child and every member together
        sup = subprocess.Popen([sys.executable, "-m", "cluster_tools_tpu_torch.fleet", "--base-dir", fleet_dir,
                                "--config", cfg_path], cwd=os.path.dirname(os.path.abspath(__file__)),
                               stdout=out, stderr=subprocess.STDOUT, start_new_session=True)

    def fleet_log() -> str:
        return open(log_path).read()[-4000:]

    def wait_for(what: str, cond, timeout_s: float):
        deadline = time.monotonic() + timeout_s
        while True:
            got = cond()
            if got:
                return got
            if sup.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"fleet: {what} (supervisor rc {sup.poll()}):\n{fleet_log()}")
            time.sleep(0.05)

    def endpoint(base: str) -> dict:
        return fu.read_json_if_valid(os.path.join(base, "server.json")) or {}

    members = os.path.join(fleet_dir, "members")
    try:
        # the ingest runs while the fleet boots
        copy = fleet_ingest(root, data, block, card)
        wait_for("the gateway never came up", lambda: endpoint(fleet_dir).get("role") == "gateway", 300)
        boot = {m: endpoint(os.path.join(members, m))["time"] - t_spawn for m in ("m0", "m1")}
        for m in ("m0", "m1"):
            sampler.watch(endpoint(os.path.join(members, m))["pid"])
        gw_boot = endpoint(fleet_dir)["time"] - t_spawn
        client = ServeClient.from_endpoint_file(fleet_dir, timeout_s=60)
        payload = serve_payload("alice", "f1", "watershed", "ws_fleet", input_path=copy, input_key="boundaries",
                                output_path=copy, block_shape=list(block), **SERVE_WS)
        owner = client.submit(**payload)["member"]
        survivor = next(m for m in ("m0", "m1") if m != owner)
        owner_dir, survivor_dir = os.path.join(members, owner), os.path.join(members, survivor)
        markers = os.path.join(owner_dir, "requests", "f1", "markers")
        wait_for("the owning member wrote no block marker",
                 lambda: os.path.isdir(markers) and any(f.startswith("block_") for d in os.listdir(markers)
                                                        for f in os.listdir(os.path.join(markers, d))), 600)
        owner_pid, survivor_pid = endpoint(owner_dir)["pid"], endpoint(survivor_dir)["pid"]
        sampler.watch(owner_pid)
        sampler.pids.discard(owner_pid)  # sampled up to the kill
        t_kill = time.time()
        os.kill(owner_pid, signal.SIGKILL)
        rec = client.wait("f1", timeout_s=900, across_restarts=True)
        if rec["state"] != "done":
            raise AssertionError(f"fleet f1: {rec['state']}: {rec.get('error')}\n{fleet_log()}")
        if rec.get("adopted_from") != os.path.abspath(owner_dir):
            raise AssertionError(f"fleet f1: not adopted from {owner_dir}: {rec}")
        got = open_container(copy)["ws_fleet"][...]
        if not np.array_equal(got, ref_ws):
            raise AssertionError(f"fleet f1: the adopted watershed differs from the serve phase's at "
                                 f"{int((got != ref_ws).sum())} voxels")
        launches = rec.get("kernel_launches", {})
        if launches != ref_launches:
            raise AssertionError(f"fleet f1: the adopted request launched {launches}, not {ref_launches}")
        state = json.load(open(os.path.join(fleet_dir, "fleet_state.json")))
        event = next(e for e in state["adoptions"] if e["kind"] == "adopt" and e["member"] == owner)
        if event["adopter"] != survivor or state["members"][owner]["adopted_by"] != survivor:
            raise AssertionError(f"fleet: the adoption {event} is not the survivor's: {state['members']}")
        claim = fu.read_json_if_valid(os.path.join(owner_dir, "adoption.claim")) or {}
        if claim.get("by") != survivor or journal_mod.FenceGuard(owner_dir).current() < 1:
            raise AssertionError(f"fleet: no claim by {survivor} or no fence minted on {owner_dir}: {claim}")

        def ledger():
            recs = journal_mod.scan(os.path.join(fleet_dir, "lifecycle.log"))[0]
            crashed = any(r["type"] == "member_crashed" and r["request_id"] == owner for r in recs)
            respawn = next((r["request_id"] for r in recs if r["type"] == "member_respawn"
                            and r.get("replaces") == owner), None)
            if crashed and respawn and endpoint(os.path.join(members, respawn)).get("pid"):
                return recs, respawn

        recs, respawned = wait_for("the supervisor recorded no crash and respawn of the killed member", ledger, 300)
        sup.send_signal(signal.SIGTERM)
        rc = sup.wait(timeout=300)
        if rc != REQUEUE_EXIT_CODE:
            raise AssertionError(f"fleet: the supervisor exited {rc} on SIGTERM, not {REQUEUE_EXIT_CODE}:\n"
                                 f"{fleet_log()}")
    finally:
        sampler.stop()
        if sup.poll() is None:
            os.killpg(sup.pid, signal.SIGKILL)
            sup.wait(timeout=60)
    exits = [line for line in open(log_path).read().splitlines() if "exited rc" in line or "DRAINED" in line]
    log("fleet", f"boot: members {', '.join(f'{m} {s:.3f} s' for m, s in boot.items())}, gateway {gw_boot:.3f} s "
                 f"after the supervisor's spawn (beside the ingest) [{card}]")
    log("fleet", f"f1 (watershed, tenant alice) placed on {owner}; SIGKILL at its first block marker; adopted by "
                 f"{survivor} {event['time'] - t_kill:.3f} s after the kill (fence epoch {event['fence_epoch']}, "
                 f"{event['reenqueued']} re-enqueued); done {rec['finished'] - t_kill:.3f} s after the kill with no "
                 f"resubmission: queued {rec['queued_s']:.3f} s, run {rec['run_s']:.3f} s on {survivor}; labels "
                 f"equal the serve phase's bit for bit; launches {launches} [{card}]")
    log("fleet", f"peak resident memory (sampled every 0.5 s): {owner} {sampler.line(owner_pid)} to the kill, "
                 f"{survivor} {sampler.line(survivor_pid)}; device memory a member not measured [{card}]")
    log("fleet", f"lifecycle.log: {[(r['type'], r['request_id']) for r in recs]}; respawned {owner} as "
                 f"{respawned}; SIGTERM -> supervisor exit {rc}; " + "; ".join(exits))
    for row in rows:
        row["fleet_launches"] = launches.get(row["name"], 0)
    log("fleet", f"phase {time.perf_counter() - t_phase:.1f} s [{card}]")


def fleet_alone(K, args) -> None:
    """``--only fleet``: the first ``SERVE_EDGE``^3 of the main path's
    volume, its :func:`serve_yardstick`, its input in the port's zarr as
    the "serve" phase writes it, then the "fleet" phase."""
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries

    os.environ["CT_FILL_MODE"], os.environ["CT_TIER_MODE"] = "capacity", "cond"
    vol = synthetic_boundaries(MAIN_SHAPE, torch.Generator(device="cuda").manual_seed(args.seed))
    vol = vol[..., :SERVE_EDGE, :SERVE_EDGE, :SERVE_EDGE].contiguous()
    ref = serve_yardstick(K, vol)
    rows = [{"name": k} for k in KERNELS]
    with tempfile.TemporaryDirectory(prefix="fleet-") as root:
        phase_fleet(K, root, serve_input(root, vol), ref["ws"], ref["launches"], rows)
    log("fleet", "launches: " + json.dumps({r["name"]: r["fleet_launches"] for r in rows}))


# the "analysis" phase: its crop of the blockwise phase's watershed labels
# and boundary map (8 blocks of 96^3; cut from 256^3, 41.4 s on the card,
# to keep the phase within 45 s and the smoke within its limit on a slower
# host), the crop of part (i) and of the CPU twins (8 blocks of 64^3), the
# size filters' threshold and the objects skeletonized, meshed and
# measured for distances (the largest, by voxel count)
ANALYSIS_EDGE = 192
ANALYSIS_BLOCK = (96, 96, 96)
ANALYSIS_CROP = 128
ANALYSIS_CROP_BLOCK = (64, 64, 64)
ANALYSIS_MIN_SIZE = 100
ANALYSIS_TOP = 8
# (g): a rotation by 0.1 rad in the (y, x) plane about the crop's centre,
# shifted by (1.5, -3.25, 2.75) voxels
_ROT = np.array([[1.0, 0.0, 0.0], [0.0, np.cos(0.1), -np.sin(0.1)], [0.0, np.sin(0.1), np.cos(0.1)]])
ANALYSIS_AFFINE = dict(matrix=_ROT.tolist(),
                       offset=(np.full(3, (ANALYSIS_EDGE - 1) / 2) - _ROT @ np.full(3, (ANALYSIS_EDGE - 1) / 2)
                               + np.array([1.5, -3.25, 2.75])).tolist())


def an_run(K, root: str, tag: str, workflow_cls, target: str, block, tmp: str = None, **params) -> dict:
    """One run of a workflow with ``target`` in ``tmp`` (default: a fresh
    folder under ``root``, kept for the artifacts): wall seconds (ended by a
    device sync), peak device GB and the kernel launches of that run."""
    from cluster_tools_tpu_torch.runtime.task import build as run_dag
    from cluster_tools_tpu_torch.utils.parse_utils import parse_runtimes

    if tmp is None:
        tmp = tempfile.mkdtemp(prefix=f"{tag}-{target}-", dir=root)
    cfg = os.path.join(tmp, "cfg")
    os.makedirs(cfg, exist_ok=True)
    write_json(os.path.join(cfg, "global.config"), {"block_shape": list(block)})
    cuda = torch.cuda.is_available()
    K.reset_counts()
    if cuda:
        reset_peaks()
        sync_cards()
    t0 = time.perf_counter()
    wf = workflow_cls(tmp_folder=os.path.join(tmp, "tmp"), config_dir=cfg, max_jobs=8, target=target,
                      block_shape=list(block), **params)
    ok = run_dag([wf])
    if cuda:
        sync_cards()
    wall = time.perf_counter() - t0
    if not ok:
        logs = "".join(open(os.path.join(tmp, "tmp", f)).read()[-3000:]
                       for f in sorted(os.listdir(os.path.join(tmp, "tmp"))) if f.endswith(".log"))
        raise AssertionError(f"{tag} ({target}): the workflow failed; task logs:\n{logs}")
    tasks = Counter()
    for doc in parse_runtimes(os.path.join(tmp, "tmp")).values():
        tasks[doc["task"]] += doc.get("runtime_s", 0.0)
    return dict(tmp=os.path.join(tmp, "tmp"), wall_s=wall, launches=dict(K.LAUNCHES), tasks=tasks,
                peak_gb=max_card_peak_gb() if cuda else float("nan"))


def unique_counts(x: np.ndarray, dev) -> tuple:
    """``np.unique(x, return_counts=True)`` through ``torch.unique`` on ``dev``."""
    u, c = torch.unique(torch.from_numpy(x.astype(np.int64, copy=False)).to(dev), return_counts=True)
    return u.cpu().numpy(), c.cpu().numpy()


def npz_tree(folder: str) -> dict:
    """Every ``.npz`` array and every other file's bytes under ``folder``,
    keyed by relative path."""
    out = {}
    for fn in sorted(os.listdir(folder)):
        p = os.path.join(folder, fn)
        if fn.endswith(".npz"):
            with np.load(p) as f:
                out.update({f"{fn}/{k}": f[k] for k in f.files})
        else:
            out[fn] = np.frombuffer(open(p, "rb").read(), np.uint8)
    return out


def require_same(what: str, a: dict, b: dict) -> None:
    if sorted(a) != sorted(b):
        raise AssertionError(f"analysis {what}: artifacts {sorted(set(a) ^ set(b))[:5]} on one side only")
    for k in a:
        if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
            raise AssertionError(f"analysis {what}: {k} differs between the card's run and the CPU's")


def phase_analysis(K, vol: torch.Tensor, ref_ws: np.ndarray, rows: list, target: str = "gpu") -> None:
    """Postprocessing, analysis and export on the card (ROADMAP items 12b
    and 12d), on the first ``ANALYSIS_EDGE``^3 of the "blockwise" phase's
    single-pass watershed labels and boundary map in ``memory://`` (block
    ``ANALYSIS_BLOCK``).  Each arm runs its workflow once with ``target`` (the card) and
    prints its wall, peak device GB and kernel launches.  (h) also runs
    with ``target="local"`` (the CPU) and must equal the card's run bit for
    bit; (a), (b), (c) and (g)'s order 1 do so on the first
    ``ANALYSIS_CROP``^3 (block 64^3), where each runs on the card and on
    the CPU (at 256^3 their CPU twins took 4-9 s each: the cc chain, the
    region graph, the resample).  Gates:

    (a) ``SizeFilterWorkflow`` and ``GraphWatershedSizeFilterWorkflow``
        (``min_size`` 100): no kept segment below ``min_size``; the size
        filter keeps exactly the segments of 100 voxels or more; every
        resolved small segment maps to a kept segment that one of its
        graph neighbours maps to as well;
    (b) ``ConnectedComponentsOnSegmentationWorkflow`` of (a)'s size filter
        output: no output label spans two input labels, background kept;
    (c) ``FillHolesWorkflow`` of (a)'s size filter output: every
        background component touching the border stays 0
        (``scipy.ndimage.label``), every other background voxel is filled;
    (d) ``MorphologyWorkflow`` (sizes and centres of mass against
        ``scipy.ndimage`` at atol 1e-9), ``NodeLabelWorkflow`` (the
        watershed's segments onto (a)'s size filter output: each kept
        segment onto its own filtered label), ``EvaluationWorkflow`` (the
        watershed against itself: VI 0, Rand precision and recall 1; (a)'s
        graph-watershed output against the watershed printed);
    (e) ``DataStatisticsWorkflow`` of the map against numpy (rtol 1e-6,
        std 1e-5);
    (f) ``DownscalingWorkflow``: three levels of the map (``mean``, rtol
        1e-5) and of the labels (``nearest``, exact) against numpy block
        reductions;
    (g) ``TransformationsWorkflow`` (``ANALYSIS_AFFINE``): order 1 equal to
        ``scipy.ndimage.affine_transform`` at atol 1e-3 (and, on the crop,
        to the CPU run bit for bit); order 0 of the labels equal to scipy's;
    (h) ``SkeletonWorkflow`` and ``MeshWorkflow`` of the ``ANALYSIS_TOP``
        largest objects (``object_ids``): every artifact equal to the CPU
        run's, mesh volumes equal to the voxel counts;
    (i) on the first ``ANALYSIS_CROP``^3 (block 64^3):
        ``PainteraConversionWorkflow`` and ``PainteraToBdvWorkflow``
        (``maxId``, ``resolution``, ``offset``, the label-to-block index
        against per-block ``np.unique``, the bdv levels and attributes);
        ``CreateMultiset`` + ``DownscaleMultiset`` (per-block label counts
        against ``np.unique``, two levels); ``PairwiseDistanceWorkflow`` on
        the crop's largest object and the ``ANALYSIS_TOP`` - 1 largest
        segments touching it, against a brute-force minimum over every
        pair's boundary voxels; ``GraphWorkflow`` with
        ``CheckSubGraphs`` (the region graph re-extracted on the card) and
        ``CheckBlocks`` passing.

    The kernel rows gain ``analysis_launches`` (summed over the arms)."""
    import scipy.ndimage as ndi
    from scipy.spatial.distance import cdist

    from cluster_tools_tpu_torch.io.containers import MemoryContainer, open_container
    from cluster_tools_tpu_torch.runtime.task import build as run_dag
    from cluster_tools_tpu_torch.tasks import label_multisets as lms
    from cluster_tools_tpu_torch.tasks.debugging import CheckBlocksGPU, CheckBlocksLocal, CheckSubGraphsGPU, \
        CheckSubGraphsLocal
    from cluster_tools_tpu_torch.tasks.distances import PairwiseDistanceWorkflow, boundary_voxels, distances_path
    from cluster_tools_tpu_torch.tasks.downscaling import DownscalingWorkflow
    from cluster_tools_tpu_torch.tasks.evaluation import EvaluationWorkflow
    from cluster_tools_tpu_torch.tasks.graph import GraphWorkflow, load_global_graph
    from cluster_tools_tpu_torch.tasks.meshes import MeshWorkflow, mesh_signed_volume
    from cluster_tools_tpu_torch.tasks.morphology import MorphologyWorkflow, morphology_path
    from cluster_tools_tpu_torch.tasks.node_labels import NodeLabelWorkflow, node_labels_path
    from cluster_tools_tpu_torch.tasks.paintera import PainteraConversionWorkflow, PainteraToBdvWorkflow, \
        label_to_blocks_path
    from cluster_tools_tpu_torch.tasks.postprocess import ConnectedComponentsOnSegmentationWorkflow, \
        FillHolesWorkflow, GraphWatershedSizeFilterWorkflow, SizeFilterWorkflow
    from cluster_tools_tpu_torch.tasks.skeletons import SkeletonWorkflow
    from cluster_tools_tpu_torch.tasks.statistics import DataStatisticsWorkflow
    from cluster_tools_tpu_torch.tasks.transformations import TransformationsWorkflow

    t_phase = time.perf_counter()
    card = nvidia_smi()
    dev = torch.device("cuda" if target == "gpu" else "cpu")
    e, block = ANALYSIS_EDGE, ANALYSIS_BLOCK
    mem = "memory://analysis"
    f = open_container(mem)
    ws = np.ascontiguousarray(ref_ws[:e, :e, :e]).astype(np.uint64)
    bmap = vol.reshape(vol.shape[-3:])[:e, :e, :e].cpu().numpy()
    f.require_dataset("ws", shape=ws.shape, chunks=block, dtype="uint64")[...] = ws
    f.require_dataset("bmap", shape=bmap.shape, chunks=block, dtype="float32")[...] = bmap
    c, cb = ANALYSIS_CROP, ANALYSIS_CROP_BLOCK
    crop = np.ascontiguousarray(ws[:c, :c, :c])
    f.require_dataset("crop", shape=crop.shape, chunks=cb, dtype="uint64")[...] = crop
    f.require_dataset("crop_map", shape=crop.shape, chunks=cb, dtype="float32")[...] = bmap[:c, :c, :c]
    io = dict(input_path=mem, input_key="ws")
    launches = Counter()
    root = tempfile.mkdtemp(prefix="analysis-")

    def arm(tag, cls, tgt=target, tmp=None, **params):
        rec = an_run(K, root, tag, cls, tgt, params.pop("block", block), tmp=tmp, **params)
        if tgt == target:
            launches.update(rec["launches"])
        slow = ", ".join(f"{t} {x:.3f}" for t, x in rec["tasks"].most_common(3))
        log("analysis", f"{tag} ({tgt}): wall {rec['wall_s']:.3f} s (slowest tasks, s: {slow}), peak "
                        f"{rec['peak_gb']:.2f} GB, launches {rec['launches']} [{card}]")
        return rec

    def tasks_run(tasks, what):
        """Tasks built by hand (no workflow), as :func:`an_run` runs one."""
        cuda = torch.cuda.is_available()
        K.reset_counts()
        if cuda:
            reset_peaks()
        t0 = time.perf_counter()
        if not run_dag(tasks):
            raise AssertionError(f"analysis (i): {what} failed")
        if cuda:
            sync_cards()
        launches.update(K.LAUNCHES)
        return dict(wall_s=time.perf_counter() - t0, launches=dict(K.LAUNCHES),
                    peak_gb=max_card_peak_gb() if cuda else float("nan"))

    def crop_twin(tag, cls, out_key, **params):
        """The arm on the first ``ANALYSIS_CROP``^3 (``params`` name its crop
        datasets) on the card into ``<out_key>_c``, then on the CPU into
        ``<out_key>_c_local``: equal bit for bit."""
        tag, out_key = tag + " crop", out_key + "_c"
        arm(tag, cls, output_path=mem, output_key=out_key, block=cb, **params)
        arm(tag, cls, tgt="local", output_path=mem, output_key=out_key + "_local", block=cb, **params)
        got, want = f[out_key][...], f[out_key + "_local"][...]
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"analysis {tag}: the card's output differs from the CPU's at "
                                 f"{int((got != want).sum())} voxels")

    try:
        ws_ids, ws_sizes = unique_counts(ws, dev)
        kept_ids = ws_ids[(ws_sizes >= ANALYSIS_MIN_SIZE) & (ws_ids != 0)]
        log("analysis", f"input: the first {e}^3 of the blockwise watershed, {len(ws_ids)} segments "
                        f"({len(kept_ids)} of >= {ANALYSIS_MIN_SIZE} voxels), and of its boundary map")

        # (a) the size filters
        arm("(a) size_filter", SizeFilterWorkflow, **io, output_path=mem, output_key="sf",
            min_size=ANALYSIS_MIN_SIZE)
        crop_twin("(a) size_filter", SizeFilterWorkflow, "sf", input_path=mem, input_key="crop",
                  min_size=ANALYSIS_MIN_SIZE)
        sf = f["sf"][...]
        u, n = unique_counts(sf, dev)
        t_ws = torch.from_numpy(ws.astype(np.int64)).to(dev)
        if (n[u != 0] < ANALYSIS_MIN_SIZE).any() or not torch.equal(
                torch.from_numpy(sf > 0).to(dev), torch.isin(t_ws, torch.from_numpy(kept_ids).to(dev))):
            raise AssertionError("analysis (a): the size filter kept a segment below min_size or dropped a kept one")
        rec = arm("(a) graph_ws_size_filter", GraphWatershedSizeFilterWorkflow, **io, boundary_path=mem,
                  boundary_key="bmap", output_path=mem, output_key="gws", min_size=ANALYSIS_MIN_SIZE)
        crop_twin("(a) graph_ws_size_filter", GraphWatershedSizeFilterWorkflow, "gws", input_path=mem,
                  input_key="crop", boundary_path=mem, boundary_key="crop_map", min_size=ANALYSIS_MIN_SIZE)
        gws = f["gws"][...]
        with np.load(os.path.join(rec["tmp"], "graph_ws_assignments.npz")) as a:
            keys, values = a["keys"], a["values"]
        _, _, edges, _ = load_global_graph(rec["tmp"])
        small = ws_sizes[np.searchsorted(ws_ids, keys.astype(np.int64))] < ANALYSIS_MIN_SIZE
        same = (values[edges[:, 0]] == values[edges[:, 1]]) & (values[edges[:, 0]] != 0)
        has_peer = np.zeros(len(keys), bool)
        has_peer[edges[same, 0]] = has_peer[edges[same, 1]] = True
        resolved = small & (values != 0)
        u, n = unique_counts(gws, dev)
        if (not np.array_equal(values[~small], keys[~small]) or not np.isin(values[resolved], keys[~small]).all()
                or not has_peer[resolved].all() or (n[u != 0] < ANALYSIS_MIN_SIZE).any()):
            raise AssertionError("analysis (a): a graph-watershed assignment is not a kept neighbour's segment")
        log("analysis", f"(a): size filter kept {len(kept_ids)} segments; graph watershed resolved "
                        f"{int(resolved.sum())} of {int(small.sum())} small segments into kept neighbours, "
                        f"{int((small & (values == 0)).sum())} unresolved; no output segment below "
                        f"{ANALYSIS_MIN_SIZE} voxels")

        # (b) connected components of (a)'s size-filter output
        arm("(b) cc_on_segmentation", ConnectedComponentsOnSegmentationWorkflow, input_path=mem, input_key="sf",
            output_path=mem, output_key="cc")
        crop_twin("(b) cc_on_segmentation", ConnectedComponentsOnSegmentationWorkflow, "cc", input_path=mem,
                  input_key="sf_c")
        cc = f["cc"][...]
        t_cc, t_sf = torch.from_numpy(cc.astype(np.int64)).to(dev), torch.from_numpy(sf.astype(np.int64)).to(dev)
        fg = t_cc > 0
        if not torch.equal(fg, t_sf > 0) or torch.unique((t_cc[fg] << 32) | t_sf[fg]).numel() != \
                torch.unique(t_cc[fg]).numel():
            raise AssertionError("analysis (b): an output component spans two input labels, or background moved")
        log("analysis", f"(b): {torch.unique(t_cc[fg]).numel()} components of {torch.unique(t_sf[fg]).numel()} "
                        f"segments; none spans two")
        del t_cc, t_sf, fg

        # (c) hole filling of (a)'s size-filter output
        arm("(c) fill_holes", FillHolesWorkflow, input_path=mem, input_key="sf", output_path=mem,
            output_key="filled")
        crop_twin("(c) fill_holes", FillHolesWorkflow, "filled", input_path=mem, input_key="sf_c")
        filled = f["filled"][...]
        bg_cc, n_bg = ndi.label(sf == 0)
        faces = [bg_cc[0], bg_cc[-1], bg_cc[:, 0], bg_cc[:, -1], bg_cc[:, :, 0], bg_cc[:, :, -1]]
        border = np.isin(bg_cc, np.unique(np.concatenate([x.ravel() for x in faces]))) & (bg_cc > 0)
        if (filled[border] != 0).any() or (filled[(sf == 0) & ~border] == 0).any() or \
                not np.array_equal(filled[sf > 0], sf[sf > 0]):
            raise AssertionError("analysis (c): a border background component was filled, or a hole was not")
        log("analysis", f"(c): {n_bg} background components, {int(border.sum())} voxels on the border kept 0, "
                        f"{int(((sf == 0) & ~border).sum())} hole voxels filled")
        del bg_cc, border

        # (d) morphology, node labels, evaluation
        morph_gpu = tempfile.mkdtemp(prefix="morph-gpu-", dir=root)
        rec = arm("(d) morphology", MorphologyWorkflow, tmp=morph_gpu, **io)
        with np.load(morphology_path(rec["tmp"])) as m:
            ids, sizes, com = m["ids"], m["sizes"], m["com"]
        # scipy's oracles on the labels renumbered 1..n in id order (its
        # fast path; the ids themselves are checked against torch.unique)
        dense = torch.unique(torch.from_numpy(ws.astype(np.int64)).to(dev), return_inverse=True)[1]
        dense = (dense + int(ws_ids[0] != 0)).cpu().numpy().astype(np.int32)
        index = np.arange(1, len(ids) + 1)
        if not np.array_equal(ids, ws_ids[ws_ids != 0].astype(np.uint64)) or not np.array_equal(
                sizes, ndi.sum_labels(np.ones(ws.shape, np.int64), dense, index).astype(np.int64)):
            raise AssertionError("analysis (d): morphology sizes differ from scipy.ndimage.sum_labels")
        want_com = np.array(ndi.center_of_mass(np.ones(ws.shape, np.float64), dense, index))
        del dense
        if not np.allclose(com, want_com, rtol=0, atol=1e-9):
            raise AssertionError(f"analysis (d): centres of mass differ from scipy's by "
                                 f"{np.abs(com - want_com).max():.3g}")
        rec = arm("(d) node_labels", NodeLabelWorkflow, **io, labels_path=mem, labels_key="sf")
        with np.load(node_labels_path(rec["tmp"])) as t:
            nl_keys, nl_values = t["keys"], t["values"]
        t_sf = torch.from_numpy(sf.astype(np.int64)).to(dev)
        seg_ids, inv = torch.unique(t_ws[t_sf > 0], return_inverse=True)
        lab = t_sf[t_sf > 0]
        lo = torch.full_like(seg_ids, 2 ** 62).scatter_reduce(0, inv, lab, "amin")
        hi = torch.zeros_like(seg_ids).scatter_reduce(0, inv, lab, "amax")
        if not (torch.equal(lo, hi) and np.array_equal(nl_keys.astype(np.int64), seg_ids.cpu().numpy())
                and np.array_equal(nl_values.astype(np.int64), lo.cpu().numpy())):
            raise AssertionError("analysis (d): node labels are not each kept segment's own filtered label")
        del t_sf, t_ws, seg_ids, inv, lab
        metrics = {}
        for tag, key in (("self", "ws"), ("gws", "gws")):
            rec = arm(f"(d) evaluation {tag}", EvaluationWorkflow, input_path=mem, input_key=key, labels_path=mem,
                      labels_key="ws")
            metrics[tag] = json.load(open(os.path.join(rec["tmp"], "evaluation.json")))
        s = metrics["self"]
        if abs(s["vi_split"]) > 1e-9 or abs(s["vi_merge"]) > 1e-9 or abs(s["rand_precision"] - 1) > 1e-9 or \
                abs(s["rand_recall"] - 1) > 1e-9:
            raise AssertionError(f"analysis (d): the watershed against itself: {s}")
        log("analysis", f"(d): {len(ids)} objects, sizes = scipy, centres of mass within "
                        f"{np.abs(com - want_com).max():.3g} of scipy; node labels of {len(nl_keys)} segments; "
                        f"watershed vs itself {s}; graph-watershed filter vs watershed {metrics['gws']}")

        # (e) statistics of the boundary map
        rec = arm("(e) statistics", DataStatisticsWorkflow, input_path=mem, input_key="bmap")
        st = json.load(open(os.path.join(rec["tmp"], "statistics.json")))
        b64 = bmap.astype(np.float64)
        want = dict(count=float(bmap.size), mean=b64.mean(), std=b64.std(), min=float(bmap.min()),
                    max=float(bmap.max()))
        if st["count"] != want["count"] or any(not np.isclose(st[k], want[k], rtol=1e-5 if k == "std" else 1e-6,
                                                              atol=0) for k in ("mean", "std", "min", "max")):
            raise AssertionError(f"analysis (e): statistics {st} against numpy {want}")
        log("analysis", f"(e): {st}")

        # (f) three-level pyramids of the map and the labels
        factors = [[2, 2, 2]] * 3
        arm("(f) downscaling mean", DownscalingWorkflow, input_path=mem, input_key="bmap", output_path=mem,
            output_key_prefix="bmap_pyr", scale_factors=factors, mode="mean")
        arm("(f) downscaling nearest", DownscalingWorkflow, **io, output_path=mem, output_key_prefix="ws_pyr",
            scale_factors=factors, mode="nearest")
        want_b, want_l = bmap, ws
        for level in (1, 2, 3):
            n = want_b.shape[0] // 2
            want_b = want_b.reshape(n, 2, n, 2, n, 2).mean((1, 3, 5))
            want_l = want_l[::2, ::2, ::2]
            got_b, got_l = f[f"bmap_pyr/s{level}"][...], f[f"ws_pyr/s{level}"][...]
            if not np.allclose(got_b, want_b, rtol=1e-5, atol=0) or not np.array_equal(got_l, want_l):
                raise AssertionError(f"analysis (f): level {level} differs from numpy's block reduction")
            if f[f"bmap_pyr/s{level}"].attrs["downsamplingFactors"] != [2 ** level] * 3:
                raise AssertionError(f"analysis (f): level {level}'s downsamplingFactors")
        log("analysis", "(f): s1-s3 of the map (mean) and the labels (nearest) equal numpy's block reductions")

        # (g) the affine transform
        arm("(g) transformations order 1", TransformationsWorkflow, input_path=mem, input_key="bmap",
            output_path=mem, output_key="warped", order=1, fill_value=0.0, **ANALYSIS_AFFINE)
        crop_twin("(g) transformations order 1", TransformationsWorkflow, "warped", input_path=mem,
                  input_key="crop_map", order=1, fill_value=0.0, **ANALYSIS_AFFINE)
        warped = f["warped"][...]
        want = ndi.affine_transform(b64, np.asarray(ANALYSIS_AFFINE["matrix"]),
                                    offset=np.asarray(ANALYSIS_AFFINE["offset"]), order=1, mode="constant", cval=0.0)
        err = float(np.abs(warped.astype(np.float64) - want).max())
        if err > 1e-3:
            raise AssertionError(f"analysis (g): order 1 differs from scipy by {err:.3g}")
        arm("(g) transformations order 0", TransformationsWorkflow, **io, output_path=mem, output_key="warped0",
            order=0, **ANALYSIS_AFFINE)
        if not np.array_equal(f["warped0"][...], ndi.affine_transform(
                ws, np.asarray(ANALYSIS_AFFINE["matrix"]), offset=np.asarray(ANALYSIS_AFFINE["offset"]), order=0,
                mode="constant", cval=0)):
            raise AssertionError("analysis (g): order 0 of the labels differs from scipy's")
        log("analysis", f"(g): order 1 {err:.3g} from scipy, on the crop = the CPU run bit for bit; order 0 of "
                        f"the labels = scipy")
        del want, b64

        # (h) skeletons and meshes of the largest objects, beside (d)'s morphology
        top = [int(i) for i in ids[np.argsort(-sizes, kind="stable")[:ANALYSIS_TOP]]]
        morph_local = tempfile.mkdtemp(prefix="morph-local-", dir=root)
        for tag, cls, sub in (("(h) skeletons", SkeletonWorkflow, "skeletons"), ("(h) meshes", MeshWorkflow,
                                                                                   "meshes")):
            arts = {}
            for tgt, tmp in ((target, morph_gpu), ("local", morph_local)):
                rec = arm(tag, cls, tgt=tgt, tmp=tmp, **io, object_ids=top)
                arts[tgt] = npz_tree(os.path.join(rec["tmp"], sub))
            require_same(tag, arts[target], arts["local"])
        for obj in top:
            v, fc = (arts[target][f"{obj}.npz/{k}"] for k in ("vertices", "faces"))
            if mesh_signed_volume(v, fc) != float(sizes[ids == obj][0]):
                raise AssertionError(f"analysis (h): object {obj}'s mesh volume is not its voxel count")
        log("analysis", f"(h): objects {top} ({sizes[np.argsort(-sizes, kind='stable')[:ANALYSIS_TOP]].tolist()} "
                        f"voxels): skeletons and meshes = the CPU run's, mesh volumes = voxel counts")

        # (i) export and checks on the crop
        cio = dict(input_path=mem, input_key="crop", block=cb)
        rec = arm("(i) paintera_conversion", PainteraConversionWorkflow, **cio, output_path=mem,
                  output_key_prefix="paintera", scale_factors=[[2, 2, 2], [2, 2, 2]], resolution=[40.0, 4.0, 4.0])
        attrs = f["crop"].attrs
        if attrs["maxId"] != int(crop.max()) or attrs["resolution"] != [40.0, 4.0, 4.0] or \
                attrs["offset"] != [0.0, 0.0, 0.0]:
            raise AssertionError(f"analysis (i): paintera attributes {dict(attrs)}")
        with np.load(label_to_blocks_path(rec["tmp"])) as t:
            labels, offsets, blks = t["labels"], t["offsets"], t["blocks"]
        n_b = c // cb[0]
        want_pairs = sorted((int(lab), (bz * n_b + by) * n_b + bx) for bz in range(n_b) for by in range(n_b)
                            for bx in range(n_b) for lab in np.unique(crop[bz * cb[0]:(bz + 1) * cb[0],
                                                                           by * cb[1]:(by + 1) * cb[1],
                                                                           bx * cb[2]:(bx + 1) * cb[2]]) if lab)
        got_pairs = [(int(lab), int(b)) for i, lab in enumerate(labels) for b in blks[offsets[i]:offsets[i + 1]]]
        if got_pairs != want_pairs:
            raise AssertionError("analysis (i): the label-to-block index differs from per-block np.unique")
        bdv = "memory://analysis-bdv"
        arm("(i) paintera_to_bdv", PainteraToBdvWorkflow, **cio, input_key_prefix="paintera", output_path=bdv,
            scale_factors=[[2, 2, 2], [2, 2, 2]], resolution=[40.0, 4.0, 4.0])
        g = open_container(bdv)
        for level, key in enumerate(("crop", "paintera/s1", "paintera/s2")):
            ds = g[f"setup0/timepoint0/s{level}"]
            if not np.array_equal(ds[...], f[key][...]) or ds.attrs["downsamplingFactors"] != [2 ** level] * 3 or \
                    ds.attrs["resolution"] != [40.0 * 2 ** level, 4.0 * 2 ** level, 4.0 * 2 ** level]:
                raise AssertionError(f"analysis (i): bdv level {level}")

        ms_tmp = tempfile.mkdtemp(prefix="multisets-", dir=root)
        ms_cfg = os.path.join(ms_tmp, "cfg")
        os.makedirs(ms_cfg)
        write_json(os.path.join(ms_cfg, "global.config"), {"block_shape": [32, 32, 32]})
        common = dict(tmp_folder=os.path.join(ms_tmp, "tmp"), config_dir=ms_cfg, max_jobs=8, block_shape=[32] * 3,
                      scale_factor=[2, 2, 2])
        ms_cls = {"gpu": (lms.CreateMultisetGPU, lms.DownscaleMultisetGPU),
                  "local": (lms.CreateMultisetLocal, lms.DownscaleMultisetLocal)}[target]
        t1 = ms_cls[0](**common, input_path=mem, input_key="crop", output_path=mem, output_key="ms/s1")
        t2 = ms_cls[1](**common, dependencies=[t1], level=1, level_shape=[c // 2] * 3, output_path=mem,
                       output_key="ms/s2")
        rec = tasks_run([t2], "label multisets")
        log("analysis", f"(i) label_multisets ({target}): wall {rec['wall_s']:.3f} s, peak {rec['peak_gb']:.2f} GB, "
                        f"launches {rec['launches']} [{card}]")
        for level in (1, 2):
            edge, n_blk = 32 * 2 ** level, (c // 2 ** level) // 32
            for b in range(n_blk ** 3):
                bz, by, bx = np.unravel_index(b, (n_blk,) * 3)
                with np.load(os.path.join(lms.multiset_dir(common["tmp_folder"], level), f"block_{b}.npz")) as t:
                    lab, cnt = t["labels"], t["counts"]
                u_want, c_want = np.unique(crop[bz * edge:(bz + 1) * edge, by * edge:(by + 1) * edge,
                                                bx * edge:(bx + 1) * edge], return_counts=True)
                u_got, inv = np.unique(lab, return_inverse=True)
                if not (np.array_equal(u_got, u_want) and np.array_equal(np.bincount(inv, weights=cnt).astype(
                        np.int64), c_want)):
                    raise AssertionError(f"analysis (i): multiset s{level} block {b}'s counts differ from np.unique")

        cu, cn = np.unique(crop[crop > 0], return_counts=True)
        big = cu[np.argmax(cn)]
        touch = set()
        for axis in range(3):
            a, b = np.moveaxis(crop, axis, 0)[:-1], np.moveaxis(crop, axis, 0)[1:]
            touch.update(np.unique(np.concatenate([b[(a == big) & (b != big)], a[(b == big) & (a != big)]])).tolist())
        near = np.array(sorted(touch - {0}), np.uint64)
        near_n = cn[np.searchsorted(cu, near)]
        top_c = np.concatenate([[big], near[np.argsort(-near_n, kind="stable")[:ANALYSIS_TOP - 1]]])
        sparse = np.where(np.isin(crop, top_c), crop, np.uint64(0))
        f.require_dataset("sparse", shape=crop.shape, chunks=cb, dtype="uint64")[...] = sparse
        rec = arm("(i) distances", PairwiseDistanceWorkflow, input_path=mem, input_key="sparse", block=cb,
                  max_distance=10.0)
        with np.load(distances_path(rec["tmp"])) as t:
            table = {tuple(int(x) for x in p): float(d) for p, d in zip(t["pairs"], t["dists"])}
        bvox = boundary_voxels(sparse) & (sparse != 0)
        pts = {int(o): np.argwhere(bvox & (sparse == o)).astype(np.float64) for o in top_c}
        want_t = {}
        for i, a in enumerate(sorted(pts)):
            for b in sorted(pts)[i + 1:]:
                d = float(cdist(pts[a], pts[b]).min())
                if d <= 10.0:
                    want_t[(a, b)] = d
        if sorted(table) != sorted(want_t) or any(abs(table[k] - want_t[k]) > 1e-12 for k in table):
            raise AssertionError(f"analysis (i): distances {table} against brute force {want_t}")
        g_tmp = tempfile.mkdtemp(prefix="debugging-", dir=root)
        arm("(i) graph", GraphWorkflow, tmp=g_tmp, **cio)
        dbg = {"gpu": (CheckSubGraphsGPU, CheckBlocksGPU), "local": (CheckSubGraphsLocal, CheckBlocksLocal)}[target]
        dbg_common = dict(tmp_folder=os.path.join(g_tmp, "tmp"), config_dir=os.path.join(g_tmp, "cfg"), max_jobs=8,
                          block_shape=list(cb))
        rec = tasks_run([dbg[0](**dbg_common, input_path=mem, input_key="crop"),
                         dbg[1](**dbg_common, input_path=mem, input_key="crop_map")], "a debugging check")
        reports = [json.load(open(os.path.join(dbg_common["tmp_folder"], f"{n}.json")))
                   for n in ("check_sub_graphs", "check_blocks")]
        if any(r["violations"] for r in reports):
            raise AssertionError(f"analysis (i): debugging reports {reports}")
        log("analysis", f"(i) debugging checks ({target}): wall {rec['wall_s']:.3f} s, peak {rec['peak_gb']:.2f} GB, "
                        f"launches {rec['launches']}; {reports[0]['n_blocks']} block graphs re-extracted, no "
                        f"violation [{card}]")
        log("analysis", f"(i) on {c}^3: paintera maxId {attrs['maxId']}, {len(labels)} labels indexed, bdv levels "
                        f"s0-s2; multiset counts = np.unique per block at s1 and s2; {len(table)} object pairs "
                        f"within 10 voxels = brute force over {len(top_c)} objects")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        MemoryContainer._registry.pop(mem, None)
        MemoryContainer._registry.pop("memory://analysis-bdv", None)
    for row in rows:
        row["analysis_launches"] = launches.get(row["name"], 0)
    log("analysis", f"phase {time.perf_counter() - t_phase:.1f} s [{card}]")


def analysis_alone(K, args) -> None:
    """``--only analysis``: the main path's volume, the "blockwise" phase's
    single-pass watershed of it (one run), then the "analysis" phase."""
    from cluster_tools_tpu_torch.io.containers import MemoryContainer, open_container
    from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries

    os.environ["CT_FILL_MODE"], os.environ["CT_TIER_MODE"] = "capacity", "cond"
    vol = synthetic_boundaries(MAIN_SHAPE, torch.Generator(device="cuda").manual_seed(args.seed))
    mem = "memory://blockwise"
    f = open_container(mem)
    f.require_dataset("boundaries", shape=vol.shape[-3:], chunks=SERVE_BLOCK, dtype="float32")[...] = \
        vol.reshape(vol.shape[-3:]).cpu().numpy()
    with tempfile.TemporaryDirectory(prefix="analysis-yardstick-") as root:
        ws = bw_run(K, root, "ws", WatershedWorkflow, SERVE_BLOCK, input_path=mem, input_key="boundaries",
                    output_path=mem, output_key="ws", **SERVE_WS)
    log("analysis", f"yardstick: the single-pass watershed in {ws['wall_s']:.3f} s, launches {ws['launches']}")
    ref_ws = f["ws"][...]
    del MemoryContainer._registry[mem], f
    rows = [{"name": k} for k in KERNELS]
    phase_analysis(K, vol, ref_ws, rows)
    log("analysis", "launches: " + json.dumps({r["name"]: r["analysis_launches"] for r in rows}))


# the "lifted" phase: arm (a), the lifted multicut chain with its own
# watershed, on the first LIFTED_CROP^3 of the main path's map (block
# LIFTED_BLOCK; cut from 128^3, where its card and CPU runs took 28.8 and
# 30.6 s on a slow host, to keep the smoke within its limit), the main
# path's cc labels as the attribution; arms (b) and
# (c), the mutex watershed and stitching, on affinities of a synthetic EM
# ground truth of LIFTED_EM_SHAPE (block LIFTED_EM_BLOCK)
LIFTED_CROP = 96
LIFTED_BLOCK = (48, 48, 48)
LIFTED_EM_SHAPE = (32, 128, 128)
LIFTED_EM_BLOCK = (32, 64, 64)
LIFTED_EM_OBJECTS = 16
# the lifted tasks whose host memory the phase reports
LIFTED_HOST_TASKS = ("sparse_lifted_neighborhood", "costs_from_node_labels", "solve_lifted_subproblems",
                     "reduce_lifted_problem", "solve_lifted_global")


class RssPeak:
    """Peak resident set size of this process (``VmRSS`` of
    ``/proc/self/status``, sampled every ``period_s`` on a thread) over a
    ``with`` block, in all and by the task running at the sample
    (``runtime.faults.current_task``); ``base`` is the size at entry.  GB.

    Sampled, not ``VmHWM``: the process's high-water mark keeps the peak of
    the phases before this one and cannot be reset without writing to
    ``/proc``, and the phase reports the lifted neighbourhood's own peak."""

    def __init__(self, period_s: float = 0.02):
        import threading

        self.period_s = period_s
        self.peak = self.base = 0.0
        self.by_task = Counter()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    @staticmethod
    def rss_gb() -> float:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024 / 1e9
        return float("nan")

    def _sample(self):
        from cluster_tools_tpu_torch.runtime import faults

        while not self._stop.is_set():
            rss = self.rss_gb()
            self.peak = max(self.peak, rss)
            task = faults.current_task()
            if task is not None:
                name = task.split(".")[0]
                self.by_task[name] = max(self.by_task[name], rss)
            self._stop.wait(self.period_s)

    def __enter__(self):
        self.base = self.peak = self.rss_gb()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss_gb())

    def line(self) -> str:
        tasks = ", ".join(f"{t} {self.by_task[t]:.2f}" for t in LIFTED_HOST_TASKS if t in self.by_task)
        return f"peak host RSS {self.peak:.2f} GB (at entry {self.base:.2f}; by task: {tasks})"


def affinities_from_labels(gt: np.ndarray, offsets, noise: float, seed: int) -> np.ndarray:
    """Affinities of a label volume: attractive channels (the first ndim) 0.9
    inside an object and 0.1 across a boundary, long-range channels the
    reverse, plus normal noise from ``default_rng(seed)``, clipped."""
    affs = np.zeros((len(offsets),) + gt.shape, np.float32)
    for c, off in enumerate(offsets):
        src = tuple(slice(max(0, -o), n - max(0, o)) for o, n in zip(off, gt.shape))
        dst = tuple(slice(max(0, o), n - max(0, -o)) for o, n in zip(off, gt.shape))
        same = gt[src] == gt[dst]
        affs[c][src] = np.where(same, 0.9, 0.1) if c < gt.ndim else np.where(same, 0.1, 0.9)
    affs += np.random.default_rng(seed).normal(0, noise, affs.shape).astype(np.float32)
    return np.clip(affs, 0, 1)


def npz_arrays(path: str, prefix: str) -> dict:
    with np.load(path) as f:
        return {f"{prefix}/{k}": f[k] for k in f.files}


def solver_of(tmp: str, task: str) -> dict:
    """The ``solver`` block (and energy) of ``task``'s success manifest in ``tmp``."""
    for fn in sorted(os.listdir(tmp)):
        if fn.split(".")[0] == task and fn.endswith(".success.json"):
            doc = json.load(open(os.path.join(tmp, fn)))
            return dict(doc.get("solver", {}), n_segments=doc.get("n_segments"), n_components=doc.get("n_components"))
    raise AssertionError(f"lifted: no success manifest of {task} in {tmp}")


def solver_line(sv: dict) -> str:
    return (f"energy {sv.get('energy')!r}, sharded {sv.get('sharded')}, shards {sv.get('shards')}, "
            f"reduce_plane {sv.get('reduce_plane', '-')}, degraded {sv.get('degraded', 'no')}, "
            f"rounds {sv.get('rounds')}")


def lifted_chain(K, root: str, tag: str, target: str, block, **params) -> dict:
    """One ``LiftedMulticutSegmentationWorkflow`` run (:func:`an_run`) under
    :class:`RssPeak`; adds the graph's sizes, the lifted edges, the global
    solve's manifest and the host peak to the record."""
    from cluster_tools_tpu_torch.tasks.graph import load_global_graph
    from cluster_tools_tpu_torch.tasks.lifted_features import lifted_problem_path
    from cluster_tools_tpu_torch.workflows import LiftedMulticutSegmentationWorkflow

    with RssPeak() as rss:
        rec = an_run(K, root, tag, LiftedMulticutSegmentationWorkflow, target, block, **params)
    nodes, _, edges, _ = load_global_graph(rec["tmp"])
    with np.load(lifted_problem_path(rec["tmp"])) as f:
        n_lifted = len(f["edges"])
    rec.update(rss=rss, nodes=len(nodes), edges=len(edges), lifted=n_lifted,
               solver=solver_of(rec["tmp"], "solve_lifted_global"))
    slow = ", ".join(f"{t} {x:.3f}" for t, x in rec["tasks"].most_common(6))
    log("lifted", f"{tag} ({target}): wall {rec['wall_s']:.3f} s (tasks, s: {slow}); {rec['nodes']} nodes, "
                  f"{rec['edges']} edges, {n_lifted} lifted edges; {solver_line(rec['solver'])}; peak device "
                  f"{rec['peak_gb']:.2f} GB; {rss.line()}; launches {rec['launches']}")
    return rec


def sharded_global(K, rec: dict, target: str, block, shards: int, **io) -> dict:
    """SolveLiftedGlobal of ``rec``'s run again with ``solver_shards`` (its
    problem files as they are; the unsharded assignment table kept aside):
    returns the manifest's solver block and the assignment table."""
    from cluster_tools_tpu_torch.runtime.task import build as run_dag
    from cluster_tools_tpu_torch.tasks import lifted_multicut as lmc

    tmp = rec["tmp"]
    path = lmc.lmc_assignments_path(tmp)
    shutil.copy(path, path + ".s1")
    cls = lmc.SolveLiftedGlobalGPU if target == "gpu" else lmc.SolveLiftedGlobalLocal
    task = cls(tmp_folder=tmp, config_dir=os.path.join(os.path.dirname(tmp), "cfg"), max_jobs=8, scale=1,
               block_shape=list(block), solver_shards=shards, **io)
    t0 = time.perf_counter()
    if not run_dag([task]):
        raise AssertionError(f"lifted: the {shards}-shard global solve ({target}) failed")
    wall = time.perf_counter() - t0
    doc = json.load(open(os.path.join(tmp, f"{task.uid}.success.json")))
    table = npz_arrays(path, f"lmc_s{shards}")
    shutil.move(path + ".s1", path)
    return dict(doc["solver"], wall_s=wall, table=table)


def phase_lifted(K, vol: torch.Tensor, cc: np.ndarray, rows: list, target: str = "gpu") -> None:
    """Lifted multicut, mutex-watershed blocks and stitching on the card
    (ROADMAP item 12c).  Every arm runs its workflow with ``target`` (the
    card) and with ``target="local"`` (the CPU), equal bit for bit:

    (a) ``LiftedMulticutSegmentationWorkflow`` on the first
        ``LIFTED_CROP``^3 of the main path's map (block ``LIFTED_BLOCK``),
        with its own watershed (B1-B4 through the sweep: each launched) and
        the main path's cc labels (scipy's partition, held in "main") as
        the attribution; the CPU run takes the card's watershed
        (``skip_ws``).  Gates: labels, ``lmc_assignments.npz`` and
        ``lifted_problem.npz`` equal; then ``SolveLiftedGlobal`` again with
        ``solver_shards=2`` on both (the reduce tree, packet plane):
        assignment tables equal and the solve sharded, undegraded.  Prints
        wall, per-task s, nodes, edges, lifted edges, energies, peak device
        GB, peak host RSS by task and launches;
    (b) ``MwsWorkflow`` with its stitching, and without (the independent
        blocks), on ``affinities_from_labels`` of a ``synthetic_em_volume``
        ground truth (``LIFTED_EM_SHAPE``, default offsets): equal, every
        voxel labelled; the adapted-RAND error of the stitched labels
        against the ground truth through ``EvaluationWorkflow``;
    (c) ``StitchingWorkflow`` with ``merge_mode="multicut"`` on (b)'s
        independent blocks and the volume's boundary map, with
        ``solver_shards`` 1 and 2 (the contraction engine's torch rung on
        the card): equal, fewer labels than blocks' labels, energies and
        the solves' planes printed.

    The kernel rows gain ``lifted_launches`` (the card's runs, summed)."""
    from cluster_tools_tpu_torch.io.containers import MemoryContainer, open_container
    from cluster_tools_tpu_torch.tasks.evaluation import EvaluationWorkflow
    from cluster_tools_tpu_torch.tasks.lifted_features import lifted_problem_path
    from cluster_tools_tpu_torch.tasks.lifted_multicut import lmc_assignments_path
    from cluster_tools_tpu_torch.tasks.mutex_watershed import DEFAULT_OFFSETS, MwsWorkflow
    from cluster_tools_tpu_torch.tasks.stitching import StitchingWorkflow
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_em_volume

    t_phase = time.perf_counter()
    card = nvidia_smi()
    e, block = LIFTED_CROP, LIFTED_BLOCK
    mem = "memory://lifted"
    f = open_container(mem)
    bmap = vol.reshape(vol.shape[-3:])[:e, :e, :e].cpu().numpy()
    f.require_dataset("bmap", shape=bmap.shape, chunks=block, dtype="float32")[...] = bmap
    f.require_dataset("cc", shape=bmap.shape, chunks=block, dtype="uint64")[...] = cc[:e, :e, :e].astype(np.uint64)
    launches = Counter()
    root = tempfile.mkdtemp(prefix="lifted-")

    def same(what, a: dict, b: dict):
        if sorted(a) != sorted(b):
            raise AssertionError(f"lifted {what}: {sorted(set(a) ^ set(b))[:5]} on one side only")
        for k in a:
            if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
                raise AssertionError(f"lifted {what}: {k} differs between the card's run and the CPU's")

    def arm(tag, cls, tgt, blk, **params):
        rec = an_run(K, root, tag, cls, tgt, blk, **params)
        if tgt == target:
            launches.update(rec["launches"])
        log("lifted", f"{tag} ({tgt}): wall {rec['wall_s']:.3f} s, peak {rec['peak_gb']:.2f} GB, launches "
                      f"{rec['launches']}")
        return rec

    try:
        # (a) the lifted multicut chain with its watershed
        lio = dict(input_path=mem, input_key="bmap", ws_path=mem, ws_key="ws", labels_path=mem, labels_key="cc",
                   output_path=mem)
        got = lifted_chain(K, root, "(a) lifted_multicut", target, block, output_key="seg", **lio, **SERVE_WS)
        launches.update(got["launches"])
        if target == "gpu":
            missing = [k for k in MAIN_PATH_KERNELS if got["launches"].get(k, 0) == 0]
            if missing:
                raise AssertionError(f"lifted (a): the watershed launched no {missing}")
        want = lifted_chain(K, root, "(a) lifted_multicut, the card's watershed", "local", block,
                            output_key="seg_local", skip_ws=True, **lio)
        arrays = {}
        for tag, rec, key in (("card", got, "seg"), ("cpu", want, "seg_local")):
            arrays[tag] = dict(seg=f[key][...], **npz_arrays(lmc_assignments_path(rec["tmp"]), "lmc"),
                               **npz_arrays(lifted_problem_path(rec["tmp"]), "lifted"))
        same("(a) labels, lmc_assignments.npz, lifted_problem.npz", arrays["card"], arrays["cpu"])
        io = dict(input_path=mem, input_key="ws")
        s2 = sharded_global(K, got, target, block, 2, **io)
        s2_cpu = sharded_global(K, want, "local", block, 2, **io)
        same("(a) the 2-shard lmc_assignments.npz", s2["table"], s2_cpu["table"])
        if not s2["sharded"] or "degraded" in s2:
            raise AssertionError(f"lifted (a): the 2-shard solve did not run sharded: {s2}")
        log("lifted", f"(a) gates: labels, lmc_assignments.npz and lifted_problem.npz = the CPU's; the 2-shard "
                      f"tables = the CPU's; energy unsharded {got['solver']['energy']!r} | 2 shards "
                      f"{s2['energy']!r} ({s2['wall_s']:.3f} s; {solver_line(s2)}) [{card}]")

        # (b) the mutex watershed with and without its stitching
        em_bmap, gt, _ = synthetic_em_volume(shape=LIFTED_EM_SHAPE, n_objects=LIFTED_EM_OBJECTS, seed=5,
                                             with_mask=False)
        affs = affinities_from_labels(gt, DEFAULT_OFFSETS, 0.05, 5)
        eb = LIFTED_EM_BLOCK
        f.require_dataset("affs", shape=affs.shape, chunks=(len(DEFAULT_OFFSETS),) + eb, dtype="float32")[...] = affs
        f.require_dataset("em_bmap", shape=gt.shape, chunks=eb, dtype="float32")[...] = em_bmap
        f.require_dataset("gt", shape=gt.shape, chunks=eb, dtype="uint64")[...] = gt
        mws = dict(input_path=mem, input_key="affs", output_path=mem)
        for tgt in (target, "local"):
            arm("(b) mutex_watershed", MwsWorkflow, tgt, eb, output_key=f"mws_{tgt}", **mws)
            arm("(b) mutex_watershed, stitch=False", MwsWorkflow, tgt, eb, output_key=f"blocks_{tgt}", stitch=False,
                **mws)
        for key in ("mws", "blocks"):
            same(f"(b) {key}", {key: f[f"{key}_{target}"][...]}, {key: f[f"{key}_local"][...]})
        stitched, blocks = f[f"mws_{target}"][...], f[f"blocks_{target}"][...]
        if not (stitched > 0).all():
            raise AssertionError("lifted (b): the stitched MWS left voxels unlabelled")
        ev = arm("(b) evaluation", EvaluationWorkflow, target, eb, input_path=mem, input_key=f"mws_{target}",
                 labels_path=mem, labels_key="gt")
        measures = json.load(open(os.path.join(ev["tmp"], "evaluation.json")))
        log("lifted", f"(b) gates: stitched and independent blocks = the CPU's; {len(np.unique(blocks))} labels in "
                      f"the blocks -> {len(np.unique(stitched))} stitched, ground truth "
                      f"{len(np.unique(gt))} objects; adapted-RAND error {measures['adapted_rand_error']!r}, VI "
                      f"split {measures['vi_split']!r} merge {measures['vi_merge']!r} [{card}]")

        # (c) stitch-via-multicut on the independent blocks
        for shards in (1, 2):
            out = {}
            for tgt in (target, "local"):
                key = f"st{shards}_{tgt}"
                f.require_dataset(key, shape=gt.shape, chunks=eb, dtype="uint64")[...] = f[f"blocks_{tgt}"][...]
                rec = arm(f"(c) stitching multicut, {shards} shard(s)", StitchingWorkflow, tgt, eb, seg_path=mem,
                          seg_key=key, input_path=mem, input_key="em_bmap", merge_mode="multicut",
                          stitch_threshold=0.5, solver_shards=shards)
                out[tgt] = (f[key][...], solver_of(rec["tmp"], "merge_stitch_assignments"))
            same(f"(c) {shards} shard(s)", {"seg": out[target][0]}, {"seg": out["local"][0]})
            n_out = len(np.unique(out[target][0]))
            if n_out >= len(np.unique(blocks)):
                raise AssertionError(f"lifted (c): {shards} shard(s) merged nothing")
            log("lifted", f"(c) {shards} shard(s) gates: = the CPU's; {n_out} labels; card "
                          f"{solver_line(out[target][1])} | CPU energy {out['local'][1].get('energy')!r}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        MemoryContainer._registry.pop(mem, None)
    for row in rows:
        row["lifted_launches"] = launches.get(row["name"], 0)
    log("lifted", f"phase {time.perf_counter() - t_phase:.1f} s [{card}]")


def lifted_full(K, vol: torch.Tensor, cc: np.ndarray) -> None:
    """Arm (a) at full width (``--only lifted``): the config-4 shape, the
    main path's 512^3 map, the "blockwise" phase's single-pass watershed of
    it (block 128^3, ``skip_ws``) and the main path's cc labels as the
    attribution, on the card, unsharded and then the global solve with 2
    shards.  Prints what the phase's arm (a) prints."""
    from cluster_tools_tpu_torch.io.containers import MemoryContainer, open_container
    from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow

    t0 = time.perf_counter()
    card = nvidia_smi()
    mem = "memory://lifted-full"
    f = open_container(mem)
    b_np = vol.reshape(vol.shape[-3:]).cpu().numpy()
    f.require_dataset("boundaries", shape=b_np.shape, chunks=SERVE_BLOCK, dtype="float32")[...] = b_np
    f.require_dataset("cc", shape=b_np.shape, chunks=SERVE_BLOCK, dtype="uint64")[...] = cc.astype(np.uint64)
    root = tempfile.mkdtemp(prefix="lifted-full-")
    try:
        ws = bw_run(K, root, "ws", WatershedWorkflow, SERVE_BLOCK, input_path=mem, input_key="boundaries",
                    output_path=mem, output_key="ws", **SERVE_WS)
        log("lifted-full", f"the single-pass watershed in {ws['wall_s']:.3f} s, launches {ws['launches']}")
        rec = lifted_chain(K, root, "lifted_multicut 512^3", "gpu", SERVE_BLOCK, input_path=mem,
                           input_key="boundaries", ws_path=mem, ws_key="ws", labels_path=mem, labels_key="cc",
                           output_path=mem, output_key="seg", skip_ws=True)
        seg = f["seg"][...]
        if seg.shape != b_np.shape or int(seg.min()) < 1:
            raise AssertionError("lifted-full: the labels are malformed")
        log("lifted-full", f"{len(np.unique(seg))} segments from {rec['nodes']} supervoxels")
        s2 = sharded_global(K, rec, "gpu", SERVE_BLOCK, 2, input_path=mem, input_key="ws")
        log("lifted-full", f"global solve with 2 shards: {s2['wall_s']:.3f} s, {solver_line(s2)} | unsharded "
                           f"energy {rec['solver']['energy']!r}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        MemoryContainer._registry.pop(mem, None)
    log("lifted-full", f"{time.perf_counter() - t0:.1f} s [{card}]")


def lifted_alone(K, args) -> None:
    """``--only lifted``: the main path's volume and scipy's labels of its
    foreground (the main path's cc partition), the "lifted" phase, then its
    arm (a) at full width (:func:`lifted_full`)."""
    import scipy.ndimage as ndi

    from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries

    os.environ["CT_FILL_MODE"], os.environ["CT_TIER_MODE"] = "capacity", "cond"
    vol = synthetic_boundaries(MAIN_SHAPE, torch.Generator(device="cuda").manual_seed(args.seed))
    cc, n = ndi.label((vol[0] < torch.tensor(np.float32(0.45), device="cuda")).cpu().numpy())
    log("lifted", f"attribution: scipy's labels of the main path's foreground, {n} components")
    rows = [{"name": k} for k in KERNELS]
    phase_lifted(K, vol, cc, rows)
    log("lifted", "launches: " + json.dumps({r["name"]: r["lifted_launches"] for r in rows}))
    lifted_full(K, vol, cc)

def main_phases(K, args, gen):
    """Phases 3-9 (kernels, main path, its twins and replays, worst
    cases, tiled seeds); returns the kernel rows, the main path's volume,
    scipy's labels of its foreground, the main path's watershed labels
    on the first ``CONFIG4_CROP``^3 and its seconds a voxel."""
    from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries

    phase_kernels(K, gen)

    # ---- main path at full width ----
    cfg = dict(MAIN_CFG)
    step = make_ws_ccl_split(device="cuda", **cfg)
    vol = synthetic_boundaries(MAIN_SHAPE, torch.Generator(device="cuda").manual_seed(args.seed))
    sync_cards()

    syncs = {}

    def count_syncs(stage, *_):
        sync_cards()
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
        sync_cards()
        marks[stage] = time.perf_counter()

    runs = []
    for _ in range(3):
        # counts and peak memory cover exactly one run of the main path
        ws = cc = None
        K.reset_counts()
        sync_cards()
        # what is allocated before the run counts in its peak
        resident_gb = sum(torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count())) / 1e9
        reset_peaks()
        t0 = time.perf_counter()
        ws, cc, n_fg, overflow = step.run_staged(vol, timed)
        total_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        rungs = dict(K.RUNGS)
        peak_gb = max_card_peak_gb()
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
                + f" ms; {vol.numel() / total_s:.4g} voxels/s; peak {peak_gb:.2f} GB (allocated before the run "
                f"{resident_gb:.2f} GB); launches per run {launches}; rungs per run {rungs}; host syncs per stage "
                f"{syncs}")
    missing = [k for k in MAIN_PATH_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    if overflow:
        raise AssertionError("main path reported overflow")
    if ws.shape != vol.shape or ws.dtype != torch.int32 or bool((ws < 0).any()):
        raise AssertionError(f"ws labels malformed: {ws.shape} {ws.dtype}")
    # n_foreground is the count cast to float32, as the step promises (exact
    # below 2**24; past it float32 rounds): held exactly to that cast of the
    # exact integer count
    n_int = int((cc > 0).sum())
    if float(n_fg) != float(np.float32(n_int)):
        raise AssertionError(f"n_foreground {float(n_fg)} != float32({n_int}) = {float(np.float32(n_int))}")
    import scipy.ndimage as ndi

    fg_np = (vol[0] < torch.tensor(np.float32(0.45), device="cuda")).cpu().numpy()
    ref, n_ref = ndi.label(fg_np)
    if not partition_equal(cc[0], torch.from_numpy(ref.astype(np.int32)).cuda()):
        raise AssertionError("cc labels are not scipy.ndimage.label's partition")
    log("main-check", f"overflow False; n_foreground {float(n_fg):.0f} = float32 of the {n_int} foreground "
                      f"voxels; cc = scipy partition "
                      f"({n_ref} components); ws segments {int(torch.unique(ws).numel()) - 1}")

    # ---- the same step on the twins ----
    K.reset_counts()
    t0 = time.perf_counter()
    out_t = make_ws_ccl_split(device="cuda", impl="torch", **cfg)(vol)
    sync_cards()
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
    sync_cards()
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


def collective_summary(snapshot: dict) -> str:
    """``stage: kind calls/MB/wait s`` of a collective-counter snapshot."""
    return "; ".join(
        f"{stage}: " + ", ".join(f"{k} {c['calls']}/{c['bytes'] / 1e6:.1f} MB/{c['wait_s']:.3f} s"
                                 for k, c in kinds.items())
        for stage, kinds in snapshot.items()
    )


def phase_sharded(K, args, rows: list, main_s: float) -> None:
    """The "sharded" phase (9b in the module docstring)."""
    import tempfile

    import scipy.ndimage as ndi

    from cluster_tools_tpu_torch.parallel import spmd
    from cluster_tools_tpu_torch.parallel.distributed_edt import distributed_distance_transform_squared
    from cluster_tools_tpu_torch.parallel.mesh import make_mesh
    from cluster_tools_tpu_torch.parallel.multihost import ENV_DEMO, launch_workers
    from cluster_tools_tpu_torch.parallel.pipeline import make_ws_ccl_step
    from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries

    t_phase = time.perf_counter()
    cfg = dict(MAIN_CFG, fill_mode="capacity", tier_mode="cond")
    vol = torch.cat([synthetic_boundaries((1,) + SHARDED_SHAPE[1:],
                                          torch.Generator(device="cuda").manual_seed(args.seed + b))
                     for b in range(SHARDED_SHAPE[0])])
    mesh = make_mesh(8)
    if mesh.grid != (2, 4):
        raise AssertionError(f"8 shards factor as {mesh.grid}, not dp=2 x sp=4")
    fused = make_ws_ccl_step(mesh, **cfg)
    split = make_ws_ccl_split(mesh, **cfg)

    # ---- (1) the fused step and the split step on the kernels ----
    sync_cards()
    t0 = time.perf_counter()
    fused(vol)
    sync_cards()
    fused_warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_f = fused(vol)
    sync_cards()
    fused_s = time.perf_counter() - t0
    split(vol)
    marks = {}

    def timed(stage, *_):
        sync_cards()
        marks[stage] = time.perf_counter()

    runs = []
    for _ in range(3):
        out_s = None
        K.reset_counts()
        spmd.COUNTERS.reset()
        reset_peaks()
        sync_cards()
        t0 = time.perf_counter()
        out_s = split.run_staged(vol, timed)
        total_s = time.perf_counter() - t0
        prev, stage_ms = t0, {}
        for stage in ("seeds", "flow", "fill", "cc"):
            stage_ms[stage] = (marks[stage] - prev) * 1e3
            prev = marks[stage]
        runs.append((total_s, stage_ms, dict(K.LAUNCHES), spmd.COUNTERS.snapshot(),
                     max_card_peak_gb()))
    total_s, stage_ms, launches, collectives, peak_gb = sorted(runs, key=lambda r: r[0])[1]
    missing = [k for k in MAIN_PATH_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"the sharded step launched no {missing}")
    for what, a, b in zip(("ws", "cc", "n_fg"), out_f[:3], out_s[:3]):
        require_equal(f"sharded fused == split {what}", a, b)
    if out_f[3] or out_s[3]:
        raise AssertionError("the sharded step reported overflow")
    log("sharded", f"{SHARDED_SHAPE} on {mesh} {cfg}: fused warm-up {fused_warm_s * 1e3:.1f} ms, timed "
                   f"{fused_s * 1e3:.1f} ms; split 3 timed runs "
                   + "/".join(f"{r[0] * 1e3:.1f}" for r in runs) + f" ms, median {total_s * 1e3:.1f} ms = "
                   + ", ".join(f"{k} {v:.1f}" for k, v in stage_ms.items())
                   + f" ms; {vol.numel() / total_s:.4g} voxels/s (main, one volume on one shard: "
                     f"{main_s * 1e3:.1f} ms = {MAIN_SHAPE[1] * MAIN_SHAPE[2] * MAIN_SHAPE[3] / main_s:.4g} "
                     f"voxels/s); peak {peak_gb:.2f} GB; launches per run {launches}; fused == split on ws, cc, "
                     f"n_fg, overflow")
    log("sharded-collectives", collective_summary(collectives))

    # ---- (2) the same 8-shard step on the twins ----
    K.reset_counts()
    t0 = time.perf_counter()
    out_t = make_ws_ccl_step(mesh, impl="torch", **cfg)(vol)
    sync_cards()
    twin_s = time.perf_counter() - t0
    for what, a, b in zip(("ws", "cc", "n_fg"), out_f[:3], out_t[:3]):
        require_equal(f"sharded twins {what}", a, b)
    if out_t[3] or sum(K.LAUNCHES.values()):
        raise AssertionError(f"sharded twins: overflow {out_t[3]}, launches {dict(K.LAUNCHES)}")
    del out_t

    # ---- (3) cc partition and n_fg against the single-device step ----
    single = make_ws_ccl_split(device="cuda", **cfg)
    cc_single, single_ms, dp_sums = [], [], []
    sp = mesh.axis_size("sp")
    for b in range(SHARDED_SHAPE[0]):
        sync_cards()
        t0 = time.perf_counter()
        _, cc1, _, ovf1 = single(vol[b:b + 1])
        sync_cards()
        single_ms.append((time.perf_counter() - t0) * 1e3)
        if ovf1 or not partition_equal(out_s[1][b], cc1[0]):
            raise AssertionError(f"volume {b}: the sharded cc is not the single-device cc partition")
        # the float32 psum of the per-shard counts, in the mesh's order
        # (over sp, then over dp); past 2**24 a float32 sum rounds, as the
        # reference documents, so this order is the one to hold exactly
        slabs = (cc1[0] > 0).reshape(sp, -1).sum(1).to(torch.float32)
        acc = slabs[0]
        for c in slabs[1:]:
            acc = acc + c
        dp_sums.append(acc)
        cc_single.append(cc1[0])
    want_n = dp_sums[0]
    for c in dp_sums[1:]:
        want_n = want_n + c
    n_int = int((out_s[1] > 0).sum())
    if n_int != sum(int((c > 0).sum()) for c in cc_single) or float(out_s[2]) != float(want_n):
        raise AssertionError(f"sharded n_fg {float(out_s[2])} (count {n_int}) != the single-device "
                             f"step's {float(want_n)}")
    log("sharded-check", f"impl=torch == kernels on ws, cc, n_fg, overflow ({twin_s * 1e3:.1f} ms, no "
                         f"launch); cc = the single-device cc partition for each volume; {n_int} "
                         f"foreground voxels as single-device, n_fg {float(out_s[2]):.0f} = the float32 sum "
                         f"of its per-shard counts (single-device runs "
                         + "/".join(f"{t:.1f}" for t in single_ms) + " ms)")

    # every launch of one split run, replayed against its twin
    with K.capture_inputs() as captured:
        split(vol)
    n_replayed = Counter()
    for name, kargs, kkw in captured:
        kfn, tfn = replay(K, name, kargs, kkw)
        require_equal(f"sharded {name} launch {n_replayed[name]} replayed", kfn(), tfn())
        n_replayed[name] += 1
    if n_replayed != Counter({k: v for k, v in launches.items() if v}):
        raise AssertionError(f"replayed {dict(n_replayed)} != a run's launches {launches}")
    del captured, out_f, out_s
    log("sharded-kernels", f"every launch of one split run equals its twin: {dict(n_replayed)}")

    # ---- (4) two axes, exact EDT, stitch, compaction ----
    mesh2 = make_mesh(4, axis_names=("dp", "spz", "spy"), grid=(1, 2, 2))
    cfg2 = dict(cfg, sp_axis=("spz", "spy"), exact_edt=True, stitch_ws_threshold=0.5,
                max_labels_per_shard=1 << 22)
    step2 = make_ws_ccl_split(mesh2, **cfg2)
    step2(vol[:1])
    K.reset_counts()
    sync_cards()
    t0 = time.perf_counter()
    ws2, cc2, n2, ovf2 = step2(vol[:1])
    sync_cards()
    two_s = time.perf_counter() - t0
    launches2 = dict(K.LAUNCHES)
    if ovf2 or not partition_equal(cc2[0], cc_single[0]) or \
            int((cc2 > 0).sum()) != int((cc_single[0] > 0).sum()):
        raise AssertionError("two-axis step: overflow, or cc differs from the single-device step")
    n_seg = int(torch.unique(ws2).numel()) - 1
    # the same run on the twins, at full size: the exact EDT is capped at
    # dt_max_distance, so B3's twin takes the cascade form (radius 32)
    out_t = make_ws_ccl_split(mesh2, impl="torch", **cfg2)(vol[:1])
    for what, a, b in zip(("ws", "cc", "n_fg"), (ws2, cc2, n2), out_t[:3]):
        require_equal(f"two-axis twins {what}", a, b)
    if out_t[3]:
        raise AssertionError("two-axis twins: overflow")
    del ws2, cc2, out_t
    # every launch of one two-axis run, replayed against its twin
    with K.capture_inputs() as captured:
        step2(vol[:1])
    n_replayed2, b3_radii = Counter(), Counter()
    for name, kargs, kkw in captured:
        kfn, tfn = replay(K, name, kargs, kkw)
        require_equal(f"two-axis {name} launch {n_replayed2[name]} replayed", kfn(), tfn())
        n_replayed2[name] += 1
        if name == "edt_cascade":
            b3_radii[(kkw["axis"], kkw["radius"])] += 1
    if n_replayed2 != Counter({k: v for k, v in launches2.items() if v}):
        raise AssertionError(f"two-axis: replayed {dict(n_replayed2)} != a run's launches {launches2}")
    del captured
    log("sharded-2axis", f"{(1,) + SHARDED_SHAPE[1:]} on {mesh2} exact_edt, stitch 0.5, max_labels_per_shard "
                         f"{1 << 22}: {two_s * 1e3:.1f} ms, {n_seg} ws segments, n_fg {float(n2):.0f}, launches "
                         f"{launches2}; cc = the single-device partition; kernels == impl=torch on ws, cc, n_fg, "
                         f"overflow; every launch equals its twin; B3 (axis, radius): launches "
                         + ", ".join(f"{k}: {v}" for k, v in sorted(b3_radii.items())))
    e = SHARDED_TWIN_EDGE

    # ---- (5) the mesh-exact squared EDT against scipy ----
    mesh_e = make_mesh(4, axis_names=("spz", "spy"), grid=(2, 2))
    mask = (vol[0, :e, :e, :e] < torch.tensor(np.float32(0.45), device="cuda")).contiguous()
    K.reset_counts()
    with K.capture_inputs() as captured:
        dist = distributed_distance_transform_squared(mask, mesh_e, sp_axis=("spz", "spy"))
    want = np.round(ndi.distance_transform_edt(mask.cpu().numpy()) ** 2)
    if not np.array_equal(dist.cpu().numpy().astype(np.float64), want):
        raise AssertionError("the mesh-exact squared EDT differs from scipy's")
    b3 = []
    for _, kargs, kkw in captured:
        kfn, tfn = replay(K, "edt_cascade", kargs, kkw)
        require_equal(f"exact EDT B3 axis {kkw['axis']} radius {kkw['radius']} replayed", kfn(), tfn())
        b3.append((kkw["axis"], kkw["radius"], tuple(kargs[0].shape), cuda_ms(kfn, 3),
                   bound_ms("edt_cascade", kargs, kkw)))
    del captured
    log("sharded-edt", f"{e}^3 mask on {mesh_e}: squared EDT == round(scipy ** 2); B3 launches "
                       + "; ".join(f"axis {a} radius {r} shape {sh}: {t:.3f} ms (bound {bd[0]:.3f} ms by {bd[1]})"
                                   for a, r, sh, t, bd in b3))

    # ---- (6) across processes: 2 processes x 2 shards on the one card ----
    pod_vol = vol[:1, :e, :e, :e].contiguous()
    tmp = tempfile.mkdtemp(prefix="ct_pod_")
    try:
        np.save(os.path.join(tmp, "v.npy"), pod_vol.cpu().numpy())
        job = dict(volume=os.path.join(tmp, "v.npy"), cfg=cfg, out=os.path.join(tmp, "o.npz"))
        t0 = time.perf_counter()
        results = launch_workers(2, "cluster_tools_tpu_torch.parallel.multihost:ws_ccl_pod_demo",
                                 devices_per_process=2, timeout=400, extra_env={ENV_DEMO: json.dumps(job)})
        pod_s = time.perf_counter() - t0
        for pid, (rc, out, err) in enumerate(results):
            if rc != 0 or "CC_POD_OK" not in out or "WS_CCL_POD_OK" not in out:
                raise AssertionError(f"pod worker {pid} rc {rc}:\n{out[-800:]}\n{err[-2000:]}")
        backend = [ln for ln in results[0][2].splitlines() if "torch.distributed backend" in ln]
        pod = np.load(job["out"])
        ws4, cc4, n4, _ = make_ws_ccl_split(make_mesh(4, grid=(1, 4)), **cfg)(pod_vol)
        require_equal("pod ws == in-process 4-shard ws", torch.from_numpy(pod["ws"]), ws4.cpu())
        require_equal("pod cc == in-process 4-shard cc", torch.from_numpy(pod["cc"]), cc4.cpu())
        if float(pod["n_fg"]) != float(n4):
            raise AssertionError("pod n_fg differs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("sharded-pod", f"launch_workers(2, devices_per_process=2) on {e}^3: {pod_s:.1f} s wall; "
                       f"{backend[0].strip() if backend else 'backend line missing'}; "
                       + " | ".join(ln for ln in results[0][1].splitlines() if "POD_OK" in ln)
                       + "; ws, cc, n_fg == the in-process 4-shard mesh")
    for r in rows:
        r["sharded_launches"] = launches.get(r["name"], 0)
    log("sharded", f"phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------ multicard ----

# the "multicard" arm (``--only multicard``, two cards or more): the (dp,
# sp) grids of the "sharded" phase with their shards dealt over the cards
MULTICARD_GRIDS = ((1, 4), (2, 4))
# the pods: (processes, shards a process), each process on a card of its own
MULTICARD_PODS = ((4, 1), (2, 2))
# the collective reduce plane's node shards over the config-4 graph
MULTICARD_NODE_SHARDS = 8
# the agglomerative payload's threshold (the "reduce-tree" phase's (a))
MULTICARD_AGG_THRESHOLD = 0.5


def multicard_label() -> str:
    """Every card's ``nvidia-smi`` name and power limit, as one tag."""
    kinds = Counter(ln.strip() for ln in nvidia_smi_lines())
    return "[" + "; ".join(f"{n} x {k}" for k, n in kinds.items()) + "]"


def on_one_card(n: int) -> list:
    """``n`` shards all on card 0: the one-card placement of a grid."""
    return [torch.device("cuda", 0)] * n


def same_on(what: str, got, want) -> None:
    """``got`` and ``want`` (a step's ``(ws, cc, n_fg, overflow)``) equal bit
    for bit, wherever each lies."""
    for name, a, b in zip(("ws", "cc", "n_fg"), got[:3], want[:3]):
        require_equal(f"{what} {name}", a, b.to(a.device))
    if bool(got[3]) != bool(want[3]):
        raise AssertionError(f"{what}: overflow {got[3]} against {want[3]}")


def timed_step(K, step, vol, staged: bool):
    """One run of a ws+cc step after :func:`sync_cards`, ended by it:
    ``(outputs, seconds, stage ms, launches, launches by card, collective
    counters, peak GB by card)``."""
    from cluster_tools_tpu_torch.parallel import spmd

    marks = {}

    def timed(stage, *_):
        sync_cards()
        marks[stage] = time.perf_counter()

    K.reset_counts()
    spmd.COUNTERS.reset()
    reset_peaks()
    sync_cards()
    t0 = time.perf_counter()
    out = step.run_staged(vol, timed) if staged else step(vol)
    sync_cards()
    total = time.perf_counter() - t0
    stage_ms, prev = {}, t0
    for stage in ("seeds", "flow", "fill", "cc") if staged else ():
        stage_ms[stage] = (marks[stage] - prev) * 1e3
        prev = marks[stage]
    return (out, total, stage_ms, dict(K.LAUNCHES), dict(K.CARD_LAUNCHES), spmd.COUNTERS.snapshot(),
            card_peaks_gb())


def require_every_card(what: str, card_launches: dict, cards: list) -> dict:
    """Every card in ``cards`` launched every B1-B4 kernel; returns the
    launches by card."""
    by_card = card_kernel_launches(card_launches)
    for c in cards:
        missing = [k for k in MAIN_PATH_KERNELS if by_card.get(str(c), {}).get(k, 0) == 0]
        if missing:
            raise AssertionError(f"{what}: {c} launched no {missing} (launches by card {by_card})")
    return by_card


def multicard_grids(K, vol: torch.Tensor, cfg: dict, cards: list, tag: str) -> dict:
    """(a): the split and fused steps on each grid of
    ``MULTICARD_GRIDS``, shards dealt over the cards, equal bit for bit to
    the same grid on card 0; every launch of one split run on the cards
    replayed on the card that made it.  Returns the split runs' launches by
    card, by grid."""
    from cluster_tools_tpu_torch.parallel.mesh import make_mesh
    from cluster_tools_tpu_torch.parallel.pipeline import make_ws_ccl_step
    from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split

    voxels = vol.numel()
    launches_by_grid = {}
    for grid in MULTICARD_GRIDS:
        n = grid[0] * grid[1]
        spread = make_mesh(n, grid=grid)
        one = make_mesh(n, grid=grid, devices=on_one_card(n))
        per_card = Counter(str(d) for d in spread.devices)
        if set(per_card) != {str(c) for c in cards} or len(set(per_card.values())) != 1:
            raise AssertionError(f"grid {grid}: shards not dealt evenly over the cards: {dict(per_card)}")
        g = f"dp={grid[0]} x sp={grid[1]}"
        for builder in ("split", "fused"):
            make = make_ws_ccl_split if builder == "split" else make_ws_ccl_step
            staged = builder == "split"
            runs = {}
            for where, mesh in (("one card", one), ("cards", spread)):
                step = make(mesh, **cfg)
                step(vol)  # warm-up
                reps = 3 if where == "cards" and staged else 1
                rs = [timed_step(K, step, vol, staged) for _ in range(reps)]
                runs[where] = sorted(rs, key=lambda r: r[1])[len(rs) // 2]
                del step
            out_c, s_c, stages_c, l_c, cl_c, coll_c, peaks_c = runs["cards"]
            out_1, s_1, stages_1, l_1, _, coll_1, peaks_1 = runs["one card"]
            same_on(f"(a) {builder} {g}: cards == one card", out_c, out_1)
            if out_c[3]:
                raise AssertionError(f"(a) {builder} {g}: overflow")
            if l_c != l_1:
                raise AssertionError(f"(a) {builder} {g}: launches on the cards {l_c} != on one card {l_1}")
            by_card = require_every_card(f"(a) {builder} {g}", cl_c, cards)
            if staged:
                launches_by_grid[g] = by_card
            log("multicard", f"(a) {builder} {SHARDED_SHAPE} {g}, {n // len(cards)} shard(s) a card on {spread}: "
                             f"{s_c * 1e3:.1f} ms = {voxels / s_c:.4g} voxels/s"
                             + (f" (" + ", ".join(f"{k} {v:.1f}" for k, v in stages_c.items()) + " ms)" if staged else "")
                             + f"; the same grid on cuda:0 {s_1 * 1e3:.1f} ms = {voxels / s_1:.4g} voxels/s"
                             + (f" (" + ", ".join(f"{k} {v:.1f}" for k, v in stages_1.items()) + " ms)" if staged else "")
                             + f"; peak GB by card " + "/".join(f"{p:.2f}" for p in peaks_c)
                             + f" (one card: cuda:0 {peaks_1[0]:.2f}); ws, cc, n_fg, overflow equal bit for bit; "
                             f"launches {l_c} = one card's; by card {by_card} {tag}")
            log("multicard", f"(a) {builder} {g} collectives on the cards: {collective_summary(coll_c)}; host-staged "
                             f"0 B (one process) {tag}")
            del out_c, out_1, runs

        # every launch of one split run on the cards, on the card that made it
        step = make_ws_ccl_split(spread, **cfg)
        K.reset_counts()
        with K.capture_inputs() as captured:
            step(vol)
        sync_cards()
        run_launches = dict(K.CARD_LAUNCHES)
        replayed, ms, b1d = Counter(), Counter(), Counter()
        for name, kargs, kkw in captured:
            card = kargs[0].device
            what = f"(a) split {g}: {name} launch {replayed[(name, str(card))]} on {card} replayed"
            with torch.cuda.device(card):
                kfn, tfn = replay(K, name, kargs, kkw)
                want = tfn()
                require_equal(what, kfn(), want)
                ms[(name, str(card))] += cuda_ms(kfn, 2, device=card)
                if name == "tile_ccl":
                    # B1d, on no path, computes B1's function: each card's
                    # library runs it on B1's inputs too
                    dfn, _ = replay(K, "tile_ccl_doubling", kargs, kkw)
                    require_equal(f"{what} as B1d", dfn(), want)
                    b1d[str(card)] += 1
            replayed[(name, str(card))] += 1
        del captured, step
        if dict(replayed) != {k: v for k, v in run_launches.items() if v}:
            raise AssertionError(f"(a) split {g}: replayed {dict(replayed)} != the run's launches {run_launches}")
        if set(b1d) != {str(c) for c in cards}:
            raise AssertionError(f"(a) split {g}: B1d ran on {dict(b1d)} only")
        log("multicard", f"(a) split {g}: every launch of one run replayed on the card that made it equals its "
                         f"twin, and B1d on each B1 launch's input equals B1's twin ({dict(b1d)}); launches and "
                         f"kernel ms by card: "
                         + "; ".join(f"{c} " + ", ".join(f"{k} {replayed[(k, c)]}/{ms[(k, c)]:.3f} ms"
                                                          for k in MAIN_PATH_KERNELS)
                                     for c in sorted({c for _, c in replayed})) + f" {tag}")
    return launches_by_grid


def multicard_edt(K, vol: torch.Tensor, tag: str) -> None:
    """(b): the mesh-exact squared EDT of a ``SHARDED_TWIN_EDGE``^3 mask on
    2 x 2 shards dealt over the cards = the same mesh on card 0 = round(scipy
    EDT ** 2)."""
    import scipy.ndimage as ndi

    from cluster_tools_tpu_torch.parallel.distributed_edt import distributed_distance_transform_squared
    from cluster_tools_tpu_torch.parallel.mesh import make_mesh

    e = SHARDED_TWIN_EDGE
    mask = (vol[0, :e, :e, :e] < torch.tensor(np.float32(0.45), device=vol.device)).contiguous()
    got, secs = {}, {}
    for where, devices in (("cards", None), ("one card", on_one_card(4))):
        mesh = make_mesh(4, axis_names=("spz", "spy"), grid=(2, 2), devices=devices)
        distributed_distance_transform_squared(mask, mesh, sp_axis=("spz", "spy"))
        K.reset_counts()
        sync_cards()
        t0 = time.perf_counter()
        got[where] = distributed_distance_transform_squared(mask, mesh, sp_axis=("spz", "spy"))
        sync_cards()
        secs[where] = (time.perf_counter() - t0, dict(K.CARD_LAUNCHES), repr(mesh))
    require_equal("(b) exact EDT: cards == one card", got["cards"], got["one card"].to(got["cards"].device))
    want = np.round(ndi.distance_transform_edt(mask.cpu().numpy()) ** 2)
    if not np.array_equal(got["cards"].cpu().numpy().astype(np.float64), want):
        raise AssertionError("(b) the mesh-exact squared EDT across cards differs from scipy's")
    log("multicard", f"(b) mesh-exact squared EDT of a {e}^3 mask on {secs['cards'][2]}: "
                     f"{secs['cards'][0] * 1e3:.1f} ms = {mask.numel() / secs['cards'][0]:.4g} voxels/s, B3 "
                     f"launches by card {secs['cards'][1]}; on cuda:0 {secs['one card'][0] * 1e3:.1f} ms; equal bit "
                     f"for bit, and = round(scipy ** 2) {tag}")


def multicard_pods(vol: torch.Tensor, cfg: dict, cards: list, tag: str) -> None:
    """(c): ``ws_ccl_pod_demo`` over NCCL pods of ``MULTICARD_PODS``, each
    process on a card of its own, on the first volume (512^3): every
    worker's backend is ``nccl`` and its collectives staged no byte through
    host memory, and ws, cc, n_fg equal the in-process 1 x 4 mesh dealt over
    the cards."""
    from cluster_tools_tpu_torch.parallel.mesh import make_mesh
    from cluster_tools_tpu_torch.parallel.multihost import ENV_DEMO, launch_workers
    from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split

    pod_vol = vol[:1].contiguous()
    want = make_ws_ccl_split(make_mesh(4, grid=(1, 4)), **cfg)(pod_vol)
    want = tuple(w.cpu() if isinstance(w, torch.Tensor) else w for w in want)
    # the workers need the cards' memory: this process's cached blocks go back
    for c in cards:
        with torch.cuda.device(c):
            torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="ct_multicard_pod_")
    try:
        np.save(os.path.join(tmp, "v.npy"), pod_vol.cpu().numpy())
        for n_proc, per in MULTICARD_PODS:
            if n_proc > len(cards):
                log("multicard", f"(c) a pod of {n_proc} processes needs {n_proc} cards; {len(cards)} visible: "
                                 "not run")
                continue
            out = os.path.join(tmp, f"o{n_proc}.npz")
            job = dict(volume=os.path.join(tmp, "v.npy"), cfg=cfg, out=out)
            t0 = time.perf_counter()
            results = launch_workers(n_proc, "cluster_tools_tpu_torch.parallel.multihost:ws_ccl_pod_demo",
                                     devices_per_process=per, timeout=600, extra_env={ENV_DEMO: json.dumps(job)})
            wall = time.perf_counter() - t0
            oks = []
            for pid, (rc, so, se) in enumerate(results):
                if rc != 0 or "CC_POD_OK" not in so or "WS_CCL_POD_OK" not in so:
                    raise AssertionError(f"(c) pod {n_proc}x{per} worker {pid} rc {rc}:\n{so[-800:]}\n{se[-3000:]}")
                backend = [ln for ln in se.splitlines() if "torch.distributed backend" in ln]
                if not backend or "backend nccl" not in backend[0] or f"device cuda:{pid}" not in backend[0]:
                    raise AssertionError(f"(c) pod {n_proc}x{per} worker {pid}: not NCCL on cuda:{pid}: {backend}")
                ok = next(ln for ln in so.splitlines() if ln.startswith("WS_CCL_POD_OK"))
                if "host_staged_bytes=0 " not in ok or "collectives_supported=True" not in ok:
                    raise AssertionError(f"(c) pod {n_proc}x{per} worker {pid}: {ok}")
                oks.append(ok)
            pod = np.load(out)
            require_equal(f"(c) pod {n_proc}x{per} ws == the in-process mesh", torch.from_numpy(pod["ws"]), want[0])
            require_equal(f"(c) pod {n_proc}x{per} cc == the in-process mesh", torch.from_numpy(pod["cc"]), want[1])
            if float(pod["n_fg"]) != float(want[2]) or bool(pod["overflow"]) != bool(want[3]):
                raise AssertionError(f"(c) pod {n_proc}x{per}: n_fg {float(pod['n_fg'])} / overflow "
                                     f"{bool(pod['overflow'])} against {float(want[2])} / {want[3]}")
            counters = json.loads(next(ln for ln in results[0][1].splitlines()
                                       if ln.startswith("POD_COUNTERS "))[len("POD_COUNTERS "):])
            log("multicard", f"(c) launch_workers({n_proc}, devices_per_process={per}) on {tuple(pod_vol.shape)}: "
                             f"pod wall {wall:.1f} s; " + backend[0].strip() + "; " + " | ".join(oks)
                             + f"; worker 0's step collectives: {collective_summary(counters)}; ws, cc, n_fg, "
                             f"overflow == the in-process 1 x 4 mesh over the cards {tag}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def multicard_shards(K, vol: torch.Tensor, cards: list, tag: str):
    """(d): the "sweeps" phase's shards arm on the 512^3 ws and cc at k = 1
    (the auto yardsticks, ``CTT_MESH_SHARDS=1``) and k = 4 (and the card
    count): files and B1-B4 launch totals equal to k = 1.  Returns the
    memory container and the k = 1 watershed's record."""
    from cluster_tools_tpu_torch.io.containers import open_container
    from cluster_tools_tpu_torch.tasks.connected_components import ConnectedComponentsWorkflow
    from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow

    b_np = vol[0].cpu().numpy()
    mem = "memory://multicard"
    block = (128, 128, 128)
    f = open_container(mem)
    f.require_dataset("boundaries", shape=b_np.shape, chunks=block, dtype="float32")[...] = b_np
    f.require_dataset("mask", shape=b_np.shape, chunks=block, dtype="uint8")[...] = \
        (b_np < np.float32(0.45)).astype(np.uint8)
    voxels, n_blocks = int(b_np.size), int(np.prod([-(-s // b) for s, b in zip(b_np.shape, block)]))
    del b_np
    io = dict(input_path=mem, output_path=mem)
    cases = {"ws": (WatershedWorkflow, dict(input_key="boundaries", two_pass=False, halo=[32, 32, 32],
                                            threshold=0.45, dt_max_distance=32.0, min_seed_distance=2.0)),
             "cc": (ConnectedComponentsWorkflow, dict(input_key="mask", connectivity=1))}
    rows = [{"name": k} for k in KERNELS]
    saved = os.environ.get("CTT_MESH_SHARDS")
    os.environ["CTT_MESH_SHARDS"] = "1"
    with tempfile.TemporaryDirectory(prefix="multicard-shards-") as tmp_root:
        try:
            auto = {tag_: bw_timed(K, tmp_root, tag_, cls, block, voxels, n_blocks, phase="multicard",
                                   warm_up=tag_ == "ws", output_key=tag_, **params, **io)
                    for tag_, (cls, params) in cases.items()}
        finally:
            if saved is None:
                os.environ.pop("CTT_MESH_SHARDS", None)
            else:
                os.environ["CTT_MESH_SHARDS"] = saved
        for tag_ in cases:
            sw = [x for x in auto[tag_]["sweeps"] if x.get("n_devices")]
            if {x["n_devices"] for x in sw} != {1}:
                raise AssertionError(f"(d) {tag_}: the k = 1 yardstick ran on {[x.get('n_devices') for x in sw]}")
        shards_arm(K, tmp_root, f, auto, {t: (cls, params, t, 8) for t, (cls, params) in cases.items()}, io, rows,
                   block, shard_counts=(4,))
    log("multicard", "(d) shards launches: " + json.dumps({r["name"]: r["shards_launches"] for r in rows})
                     + f"; k = 1 peak GB by card " + "/".join(f"{p:.2f}" for p in auto["ws"]["peaks_gb"]) + f" {tag}")
    return f, mem


def multicard_reduce(K, vol: torch.Tensor, f, cards: list, tag: str) -> None:
    """(e): the collective reduce plane on a sibling mesh dealt over the
    cards (``visible_shards``: one shard a card) over the config-4 graph of
    the blockwise watershed's first ``MC_EDGE``^3, equal to the same plane
    on card 0 and to the host plane."""
    from cluster_tools_tpu_torch.ops.rag import block_rag_fused
    from cluster_tools_tpu_torch.parallel import reduce_tree as rt
    from cluster_tools_tpu_torch.parallel import spmd
    from cluster_tools_tpu_torch.parallel.mesh import sibling_mesh

    n = MC_EDGE
    ws_crop = f["ws"][(slice(0, n),) * 3]
    bnd = vol[0, :n, :n, :n].cpu().numpy()
    nodes, edges, _, sizes, mean = block_rag_fused(ws_crop, bnd, device="cuda:0")
    s = np.maximum(np.asarray(sizes, np.float64), 1e-12)
    payload = np.stack([np.asarray(mean, np.float64) * s, s], axis=1)
    node_shard = rt.contiguous_node_shards(len(nodes), MULTICARD_NODE_SHARDS)
    sib = sibling_mesh(devices="cuda")
    if {str(d) for d in sib.devices} != {str(c) for c in cards}:
        raise AssertionError(f"(e) the sibling mesh does not span the cards: {sib}")
    solved = {}
    for arm, plane, device in (("cards", "collective", "cuda"), ("one card", "collective", "cuda:0"),
                               ("host", "packet", "cuda:0")):
        kw = dict(fanout=2, mode="min", threshold=MULTICARD_AGG_THRESHOLD, max_workers=8, device=device,
                  device_pool_bytes=REDUCE_POOL_BYTES, reduce_plane=plane)
        rt.sharded_solve(len(nodes), edges, payload, node_shard, **kw)  # warm-up
        spmd.COUNTERS.reset()
        reset_peaks()
        snap = rt.solve_snapshot()
        sync_cards()
        t0 = time.perf_counter()
        labels, info = rt.sharded_solve(len(nodes), edges, payload, node_shard, **kw)
        sync_cards()
        solved[arm] = (labels, info, time.perf_counter() - t0, rt.solve_delta(snap), spmd.COUNTERS.snapshot(),
                       card_peaks_gb())
    for arm, want_plane in (("cards", "collective"), ("one card", "collective"), ("host", "host")):
        info = solved[arm][1]
        if info["reduce_plane"] != want_plane or "degraded_plane" in info:
            raise AssertionError(f"(e) {arm}: plane {info['reduce_plane']} "
                                 f"({info.get('degraded_plane', 'not degraded')}), expected {want_plane}")
    for arm in ("one card", "host"):
        if not np.array_equal(solved["cards"][0], solved[arm][0]):
            raise AssertionError(f"(e) the collective plane over the cards differs from {arm} at "
                                 f"{int((solved['cards'][0] != solved[arm][0]).sum())} of {len(nodes)} nodes")
    log("multicard", f"(e) collective reduce plane, agglomerative payload, threshold {MULTICARD_AGG_THRESHOLD}, "
                     f"{MULTICARD_NODE_SHARDS} node shards, on {sib}: the {n}^3 graph's {len(nodes)} nodes, "
                     f"{len(edges)} edges -> {len(np.unique(solved['cards'][0]))} clusters; "
                     + "; ".join(f"{arm}: " + tree_line(i, d, w) + f", collectives {collective_summary(c)}, peak GB by "
                                 "card " + "/".join(f"{p:.2f}" for p in pk)
                                 for arm, (_, i, w, d, c, pk) in solved.items())
                     + f"; labels equal bit for bit {tag}")


def multicard_fused(K, vol: torch.Tensor, f, mem: str, cards: list, tag: str) -> None:
    """(f): ``FusedSegmentationWorkflow`` on the first ``FUSED_EDGE``^3 on
    ``visible_shards`` (the card count) shards dealt over the cards,
    ``fused`` and ``split``, equal bit for bit to ``make_ws_ccl_step`` on the
    same grid on card 0; its cc and that of the 1-shard run are scipy's
    partition, and ``n_foreground`` is each mesh's float32 sum of the exact
    per-shard counts."""
    import scipy.ndimage as ndi

    from cluster_tools_tpu_torch.parallel.mesh import make_mesh, visible_shards
    from cluster_tools_tpu_torch.parallel.pipeline import make_ws_ccl_step
    from cluster_tools_tpu_torch.runtime.task import build as run_dag
    from cluster_tools_tpu_torch.tasks.fused import FusedSegmentationWorkflow

    block = (128, 128, 128)
    fused_cfg = {k: v for k, v in MAIN_CFG.items() if k != "seed_mode"}
    fvol = vol[:1, :FUSED_EDGE, :FUSED_EDGE, :FUSED_EDGE].contiguous()
    fg = fvol[0] < torch.tensor(np.float32(fused_cfg["threshold"]), device=fvol.device)
    n_exact = int(fg.sum())
    ref_t = torch.from_numpy(ndi.label(fg.cpu().numpy())[0].astype(np.int32)).to(fvol.device)
    f.require_dataset("boundaries_fused", shape=fvol.shape[1:], chunks=block, dtype="float32")[...] = \
        fvol[0].cpu().numpy()
    n_cards = visible_shards("cuda")
    saved = {k: os.environ.get(k) for k in ("CTT_MESH_SHARDS", "CT_SEED_CCL")}
    os.environ["CT_SEED_CCL"] = "sparse"
    try:
        with tempfile.TemporaryDirectory(prefix="multicard-fused-") as root:
            cfg_dir = os.path.join(root, "cfg")
            os.makedirs(cfg_dir)
            write_json(os.path.join(cfg_dir, "global.config"), {"block_shape": list(block)})
            for shards, executions in ((n_cards, ("fused", "split")), (1, ("fused",))):
                os.environ["CTT_MESH_SHARDS"] = str(shards)
                one = make_mesh(shards, axis_names=("dp", "sp"), grid=(1, shards), devices=on_one_card(shards))
                ref = make_ws_ccl_step(one, **fused_cfg)(fvol)
                slabs = fg.reshape(shards, -1).sum(1).to(torch.float32)
                acc = slabs[0]
                for c in slabs[1:]:
                    acc = acc + c
                want_n = int(round(float(acc)))
                for execution in executions:
                    t = f"{shards}-{execution}"
                    wf = FusedSegmentationWorkflow(tmp_folder=os.path.join(root, f"tmp-{t}"), config_dir=cfg_dir,
                                                   max_jobs=8, input_path=mem, input_key="boundaries_fused",
                                                   output_path=mem, ws_key=f"fws-{t}", cc_key=f"fcc-{t}",
                                                   block_shape=list(block), execution=execution, **fused_cfg)
                    K.reset_counts()
                    reset_peaks()
                    sync_cards()
                    t0 = time.perf_counter()
                    if not run_dag([wf]):
                        raise AssertionError(f"(f) {t}: the fused workflow failed")
                    sync_cards()
                    wall = time.perf_counter() - t0
                    by_card, peaks = card_kernel_launches(dict(K.CARD_LAUNCHES)), card_peaks_gb()
                    doc = wf.output().read()
                    if shards > 1:
                        require_every_card(f"(f) {t}", dict(K.CARD_LAUNCHES), cards)
                    ws_got = torch.from_numpy(f[f"fws-{t}"][...].view(np.int64)).to(fvol.device)
                    cc_got = torch.from_numpy(f[f"fcc-{t}"][...].view(np.int64)).to(fvol.device)
                    for what, a, b in (("ws", ws_got, ref[0][0]), ("cc", cc_got, ref[1][0])):
                        if not torch.equal(a, b.to(a.device).long()):
                            raise AssertionError(f"(f) {t}: {what} differs from make_ws_ccl_step on the same grid "
                                                 "on cuda:0")
                    if not partition_equal(cc_got, ref_t):
                        raise AssertionError(f"(f) {t}: cc is not scipy.ndimage.label's partition")
                    if doc["n_foreground"] != want_n:
                        raise AssertionError(f"(f) {t}: n_foreground {doc['n_foreground']} != {want_n} (exact "
                                             f"count {n_exact})")
                    f._data.pop(f"fws-{t}")
                    f._data.pop(f"fcc-{t}")
                    del ws_got, cc_got
                    log("multicard", f"(f) FusedSegmentationWorkflow {tuple(fvol.shape[1:])}, {execution}, mesh "
                                     f"{doc['mesh']} (shards dealt over the cards): wall {wall:.3f} s = "
                                     f"{fvol.numel() / wall:.4g} voxels/s, peak GB by card "
                                     + "/".join(f"{p:.2f}" for p in peaks)
                                     + f"; ws, cc = make_ws_ccl_step on the same grid on cuda:0 bit for bit; cc = "
                                     f"scipy partition; n_foreground {doc['n_foreground']} (exact count {n_exact}); "
                                     f"B1-B4 launches by card {by_card} {tag}")
                del ref
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    f._data.pop("boundaries_fused")


def multicard_alone(K, args) -> None:
    """``--only multicard`` (two cards or more of one host): the
    mesh, the collectives, the NCCL pod and the executor with their shards
    or processes dealt over the cards, each held bit for bit against the
    same grid on one card (cuda:0).  (a) the split and fused steps on
    ``SHARDED_SHAPE`` at dp=1 x sp=4 and dp=2 x sp=4, every launch of a
    split run replayed on its card; (b) the mesh-exact EDT across card
    cuts; (c) NCCL pods (``MULTICARD_PODS``); (d) the executor's shards arm
    at k = 1 and 4; (e) the collective reduce plane on a sibling mesh over
    the cards; (f) the fused workflow.  Prints the peer-access matrix, the
    topology, and beside every number the cards' name and power limit."""
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        raise RuntimeError(f"--only multicard needs two cards or more; {n_cards} visible")
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    tag = multicard_label()
    t_arm = time.perf_counter()
    peer = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(n_cards)] for i in range(n_cards)]
    log("multicard", f"{n_cards} cards {tag}; peer access (row: from, column: to) "
                     + " ".join("".join("1" if p else "0" for p in row) for row in peer)
                     + ("; every pair has peer access" if all(map(all, peer))
                        else "; a pair without peer access copies through host memory"))
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True, timeout=60)
    for ln in (topo.stdout or topo.stderr).splitlines():
        log("multicard-topo", ln)
    os.environ["CT_FILL_MODE"], os.environ["CT_TIER_MODE"] = "capacity", "cond"
    cfg = dict(MAIN_CFG, fill_mode="capacity", tier_mode="cond")
    vol = torch.cat([synthetic_boundaries((1,) + SHARDED_SHAPE[1:],
                                          torch.Generator(device="cuda:0").manual_seed(args.seed + b))
                     for b in range(SHARDED_SHAPE[0])])
    stage_s = {}

    def stage(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        stage_s[name] = time.perf_counter() - t0
        log("multicard", f"{name}: {stage_s[name]:.1f} s {tag}")
        return out

    launches = stage("(a) grids", multicard_grids, K, vol, cfg, cards, tag)
    stage("(b) exact EDT", multicard_edt, K, vol, tag)
    stage("(c) pods", multicard_pods, vol, cfg, cards, tag)
    f, mem = stage("(d) shards", multicard_shards, K, vol, cards, tag)
    stage("(e) reduce plane", multicard_reduce, K, vol, f, cards, tag)
    stage("(f) fused", multicard_fused, K, vol, f, mem, cards, tag)
    log("multicard", "launches by card of one split run: " + json.dumps(launches))
    log("multicard", f"arm {time.perf_counter() - t_arm:.1f} s: "
                     + ", ".join(f"{k} {v:.1f}" for k, v in stage_s.items()) + f" s {tag}")


def faults_alone(K, args) -> None:
    """``--only faults``: the main path's volume, the "blockwise" phase's
    single-pass watershed of it (the yardstick, one run) and the "faults"
    phase."""
    from cluster_tools_tpu_torch.io.containers import open_container
    from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries

    os.environ["CT_FILL_MODE"], os.environ["CT_TIER_MODE"] = "capacity", "cond"
    vol = synthetic_boundaries(MAIN_SHAPE, torch.Generator(device="cuda").manual_seed(args.seed))
    mem = "memory://blockwise"
    block = (128, 128, 128)
    f = open_container(mem)
    f.require_dataset("boundaries", shape=vol.shape[-3:], chunks=block, dtype="float32")[...] = \
        vol.reshape(vol.shape[-3:]).cpu().numpy()
    with tempfile.TemporaryDirectory(prefix="faults-yardstick-") as root:
        rec = bw_run(K, root, "ws", WatershedWorkflow, block, input_path=mem, input_key="boundaries",
                     output_path=mem, output_key="ws", halo=[32, 32, 32], threshold=0.45, dt_max_distance=32.0,
                     min_seed_distance=2.0)
    log("faults", f"yardstick: the single-pass watershed in {rec['wall_s']:.3f} s, launches {rec['launches']}")
    rows = [{"name": k} for k in KERNELS]
    phase_faults(K, vol, mem, rows)
    log("faults", "launches by arm: " + json.dumps({r["name"]: r["faults_launches"] for r in rows}))


def shards_alone(K, args) -> None:
    """``--only shards``: the main path's volume, the "blockwise" phase's
    cc and single-pass watershed of it (the 1-shard auto yardsticks, a
    warm-up and a timed run each), then the "sweeps" phase's shards arm at
    ``SHARDS_ALONE`` shards with its 1-shard control at the largest
    batch."""
    from cluster_tools_tpu_torch.io.containers import open_container
    from cluster_tools_tpu_torch.tasks.connected_components import ConnectedComponentsWorkflow
    from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries

    os.environ["CT_FILL_MODE"], os.environ["CT_TIER_MODE"] = "capacity", "cond"
    vol = synthetic_boundaries(MAIN_SHAPE, torch.Generator(device="cuda").manual_seed(args.seed))
    b_np = vol.reshape(vol.shape[-3:]).cpu().numpy()
    del vol
    mem = "memory://blockwise"
    block = (128, 128, 128)
    f = open_container(mem)
    f.require_dataset("boundaries", shape=b_np.shape, chunks=block, dtype="float32")[...] = b_np
    f.require_dataset("mask", shape=b_np.shape, chunks=block, dtype="uint8")[...] = \
        (b_np < np.float32(0.45)).astype(np.uint8)
    voxels, n_blocks = int(b_np.size), int(np.prod([-(-s // b) for s, b in zip(b_np.shape, block)]))
    del b_np
    io = dict(input_path=mem, output_path=mem)
    cases = {"ws": (WatershedWorkflow, dict(input_key="boundaries", two_pass=False, halo=[32, 32, 32],
                                            threshold=0.45, dt_max_distance=32.0, min_seed_distance=2.0), 32),
             "cc": (ConnectedComponentsWorkflow, dict(input_key="mask", connectivity=1), 0)}
    rows = [{"name": k} for k in KERNELS]
    with tempfile.TemporaryDirectory(prefix="shards-") as tmp_root:
        auto = {tag: bw_timed(K, tmp_root, tag, cls, block, voxels, n_blocks, phase="sweeps", output_key=tag,
                              **params, **io)
                for tag, (cls, params, _) in cases.items()}
        shards_arm(K, tmp_root, f, auto, {tag: (cls, params, tag, 8) for tag, (cls, params, _) in cases.items()},
                   io, rows, block, shard_counts=SHARDS_ALONE, control=True)
    log("sweeps", "shards launches: " + json.dumps({r["name"]: r["shards_launches"] for r in rows}))


def serve_alone(K, args) -> None:
    """``--only serve``: the first ``SERVE_EDGE``^3 of the main path's
    volume, its :func:`serve_yardstick`, then the "serve" phase."""
    from cluster_tools_tpu_torch.utils.synthetic import synthetic_boundaries

    os.environ["CT_FILL_MODE"], os.environ["CT_TIER_MODE"] = "capacity", "cond"
    vol = synthetic_boundaries(MAIN_SHAPE, torch.Generator(device="cuda").manual_seed(args.seed))
    vol = vol[..., :SERVE_EDGE, :SERVE_EDGE, :SERVE_EDGE].contiguous()
    rows = [{"name": k} for k in KERNELS]
    phase_serve(K, vol, serve_yardstick(K, vol), rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=["faults", "serve", "fleet", "analysis", "lifted", "shards", "multicard"],
                    default=None,
                    help="build the kernels and run one phase alone on its own blockwise yardstick (faults, "
                         "analysis: the 512^3 watershed; shards: the 512^3 cc and watershed; serve, fleet: cc and "
                         "the watershed at SERVE_EDGE^3; lifted: the main path's cc labels, then its arm (a) at "
                         "512^3; multicard: two cards or more, the mesh, the NCCL pod and the executor over the "
                         "cards against one card); prints no kernels or result line")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.only == "multicard" and torch.cuda.device_count() < 2:
        print(f"chip_smoke: --only multicard needs two cards or more; {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2

    from cluster_tools_tpu_torch import build
    from cluster_tools_tpu_torch.io.containers import open_container
    from cluster_tools_tpu_torch.ops import kernels as K

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log("card", f"{name} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = build.build_all()
    log("build", "kernels " + ", ".join(
        f"{k} ({ident}) {secs[k.partition('.')[0]]:.1f}s" for k, (ident, _, _) in KERNELS.items()
    ) + f"; host library {build.HOST_NAME} (g++) {secs[build.HOST_NAME]:.1f}s, {build.host_library_path().name}; "
        f"wall {time.perf_counter() - t0:.1f}s")

    if args.only is not None:
        {"faults": faults_alone, "serve": serve_alone, "fleet": fleet_alone, "analysis": analysis_alone,
         "lifted": lifted_alone, "shards": shards_alone, "multicard": multicard_alone}[args.only](K, args)
        log("done", f"{time.perf_counter() - t_start:.1f}s")
        print(nvidia_smi())
        return 0
    if torch.cuda.device_count() < 2:
        log("multicard", f"one card visible: the --only multicard arm (two cards or more) does not run [{smi}]")
    phase_lint(smi)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows, vol, ref, ws_crop, main_s_per_voxel = main_phases(K, args, gen)
    phase_sharded(K, args, rows, main_s_per_voxel * (MAIN_SHAPE[1] + 2 * MAIN_CFG["halo"]) * MAIN_SHAPE[2]
                  * MAIN_SHAPE[3])
    mem, auto = phase_blockwise(K, vol, ref, rows)
    # the "analysis" phase's crop of the blockwise watershed ("multicut" drops the container)
    an_ws = open_container(mem)["ws"][(slice(0, ANALYSIS_EDGE),) * 3]
    phase_sweeps(K, mem, auto, main_s_per_voxel, rows)
    phase_faults(K, vol, mem, rows)
    phase_multicut(K, vol, ws_crop, mem, rows,
                   then=lambda mc: (phase_native(K, vol, mem, mc), phase_reduce_tree(K, vol, mem, mc, rows)))
    phase_fusion(K, vol[..., :FUSION_EDGE, :FUSION_EDGE, :FUSION_EDGE], rows)
    svol = vol[..., :SERVE_EDGE, :SERVE_EDGE, :SERVE_EDGE].contiguous()
    serve_ref = serve_yardstick(K, svol)
    # the fleet's members share the card with this process: its cached blocks go back first
    phase_serve(K, svol, serve_ref, rows,
                then=lambda root, data: (torch.cuda.empty_cache(),
                                         phase_fleet(K, root, data, serve_ref["ws"], serve_ref["launches"], rows)))
    del serve_ref, svol
    phase_analysis(K, vol, an_ws, rows)
    del an_ws
    phase_lifted(K, vol, ref, rows)
    phase_inference(K, vol, rows, args.seed)

    log("done", f"{time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
