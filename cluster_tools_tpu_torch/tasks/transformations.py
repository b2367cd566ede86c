"""Blockwise affine volume transformation.

Port of ``cluster_tools_tpu/tasks/transformations.py``.  Semantics follow
``scipy.ndimage.affine_transform``: ``output[o] = input[matrix @ o +
offset]`` — ``matrix`` (3x3) and ``offset`` (3,) map OUTPUT coordinates to
INPUT coordinates, ``order`` in {0, 1} selects nearest/trilinear, and
out-of-volume samples read ``fill_value``.

``order=1`` runs on the task's device (:func:`resample_linear`: the card
for ``target="gpu"``, the CPU for ``local`` and the cluster targets): per
output block, the host computes the input coordinates in float64 as the
reference does and reads the block's input footprint into a buffer padded
with ``fill_value`` (its shape bounded by ``ceil(|matrix| @ block_shape) +
2`` per axis); the device gathers the eight corners and sums them in
float32 in the op order, fused multiply-adds included, of the reference's
``jax.scipy.ndimage.map_coordinates`` (constant mode) under XLA on the
CPU, so the port's samples equal the reference's CPU run bit for bit on
every device.  No ``grid_sample``: its border rule is not scipy's.

``order=0`` (nearest, the label case) is an exact host gather in the
ORIGINAL dtype, as in the reference: label ids survive at any integer
width (a float32 round trip would merge ids above 2^24).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..runtime.executor import region_verifier
from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for float32 tensors with ONE rounding (a fused
    multiply-add), the same on every device: the product is exact in
    float64, the sum is rounded to odd in float64 (TwoSum gives its error
    exactly; an inexact sum with an even last bit steps one ulp toward the
    exact value), and the one rounding to float32 is then the correctly
    rounded result (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")), torch.full_like(s, float("-inf")))
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def resample_linear(buf: torch.Tensor, coords: torch.Tensor, fill_value: float) -> torch.Tensor:
    """Trilinear samples of ``buf`` (float32 ``[Z, Y, X]``) at ``coords``
    (float32 ``[3, n]``, buffer-local) on ``buf``'s device, as the
    reference's ``jax.scipy.ndimage.map_coordinates`` (order 1, constant
    mode) computes them under XLA on the CPU: each axis's ``floor``, upper
    weight ``c - floor(c)`` and lower weight ``1 - upper``; the eight
    corners in ``itertools.product`` order (lower before upper, axis 0
    slowest), each a weight ``(w0 * w1) * w2`` and a value (the corner's
    voxel, or ``fill_value`` where any index falls outside ``buf``); the
    sum contracted into fused multiply-adds as XLA emits it:
    ``fma(w_0, v_0, w_1 * v_1)``, then ``fma(w_k, v_k, acc)`` for k = 2..7
    (:func:`fma_f32`)."""
    per_axis = []
    for c, size in zip(coords, buf.shape):
        lower = torch.floor(c)
        upper_weight = c - lower
        lower_weight = 1 - upper_weight
        index = lower.to(torch.int64)
        per_axis.append([(index, lower_weight, size), (index + 1, upper_weight, size)])
    flat = buf.reshape(-1)
    cval = torch.tensor(fill_value, dtype=buf.dtype, device=buf.device)
    _, ny, nx = buf.shape
    terms = []
    for (i0, w0, s0), (i1, w1, s1), (i2, w2, s2) in itertools.product(*per_axis):
        valid = (i0 >= 0) & (i0 < s0) & (i1 >= 0) & (i1 < s1) & (i2 >= 0) & (i2 < s2)
        lin = (i0.clamp(0, s0 - 1) * ny + i1.clamp(0, s1 - 1)) * nx + i2.clamp(0, s2 - 1)
        terms.append(((w0 * w1) * w2, torch.where(valid, flat[lin], cval)))
    acc = fma_f32(*terms[0], terms[1][0] * terms[1][1])
    for w, v in terms[2:]:
        acc = fma_f32(w, v, acc)
    return acc


class AffineTransformBase(BaseTask):
    """Params: ``input_path/input_key``, ``output_path/output_key``,
    ``matrix`` (3x3 nested list), ``offset`` (3,), ``out_shape``
    (defaults to the input shape), ``order`` (0 nearest / 1 trilinear,
    default 1), ``fill_value`` (default 0)."""

    task_name = "affine_transform"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "order": 1, "fill_value": 0, "out_shape": None}

    def run_impl(self):
        cfg = self.get_config()
        inp = file_reader(cfg["input_path"])[cfg["input_key"]]
        in_shape = tuple(inp.shape)
        if len(in_shape) != 3:
            raise ValueError(f"affine_transform expects a 3-D volume, got {in_shape}")
        matrix = np.asarray(cfg["matrix"], np.float64)
        offset = np.asarray(cfg["offset"], np.float64)
        if matrix.shape != (3, 3) or offset.shape != (3,):
            raise ValueError("matrix must be 3x3 and offset length-3 (scipy affine_transform semantics); got "
                             f"{matrix.shape} / {offset.shape}")
        order = int(cfg.get("order", 1))
        if order not in (0, 1):
            raise ValueError(f"order must be 0 or 1, got {order}")
        fill_value = float(cfg.get("fill_value", 0))
        out_shape = tuple(int(s) for s in (cfg.get("out_shape") or in_shape))
        block_shape = tuple(cfg["block_shape"])
        # the resample's device: the card for target "gpu" (raises without one)
        dev = self.device if order == 1 else None

        out = file_reader(cfg["output_path"]).require_dataset(cfg["output_key"], shape=out_shape, chunks=block_shape,
                                                              dtype=str(inp.dtype))
        blocking = Blocking(out_shape, block_shape)
        block_ids = blocks_in_volume(out_shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))

        # static input-footprint bound: the affine image of a block box has
        # per-axis extent <= |matrix| @ block_shape; +2 covers the floor/
        # ceil stencil of trilinear sampling at both ends
        buf_shape = tuple(int(np.ceil(np.abs(matrix[i]) @ np.asarray(block_shape))) + 2 for i in range(3))

        def process(block_id):
            bb = blocking.get_block(block_id).bb
            # input coordinates of every output voxel in the block
            grids = np.meshgrid(*[np.arange(b.start, b.stop, dtype=np.float64) for b in bb], indexing="ij")
            in_coords = matrix @ np.stack([g.ravel() for g in grids]) + offset[:, None]
            lo = np.floor(in_coords.min(axis=1)).astype(np.int64)
            # scipy semantics: a coordinate outside [0, dim-1] yields pure
            # fill_value, no partial blending into the outside region
            outside = ((in_coords < 0) | (in_coords > np.asarray(in_shape)[:, None] - 1)).any(axis=0)
            out_block_shape = [b.stop - b.start for b in bb]

            if order == 0:
                # nearest neighbour is a pure gather, on the host in the
                # ORIGINAL dtype; scipy rounds half UP (floor(x + 0.5))
                idx = np.floor(in_coords + 0.5).astype(np.int64)
                np.clip(idx, 0, np.asarray(in_shape)[:, None] - 1, out=idx)
                rd_lo, rd_hi = idx.min(axis=1), idx.max(axis=1) + 1
                blockdata = np.asarray(inp[tuple(slice(a, b) for a, b in zip(rd_lo, rd_hi))])
                samples = blockdata[tuple(idx - rd_lo[:, None])]
                samples = np.where(outside, np.asarray(fill_value, inp.dtype), samples).reshape(out_block_shape)
                out[bb] = samples.astype(inp.dtype)
                return

            # trilinear: the device gather over the fill-padded buffer
            read_lo = np.maximum(lo, 0)
            read_hi = np.minimum(lo + np.asarray(buf_shape), in_shape)
            buf = np.full(buf_shape, fill_value, dtype=np.float32)
            if (read_hi > read_lo).all():
                src = tuple(slice(a, b) for a, b in zip(read_lo, read_hi))
                dst = tuple(slice(a - l, a - l + (b - a)) for a, b, l in zip(read_lo, read_hi, lo))
                buf[dst] = np.asarray(inp[src], np.float32)
            local = (in_coords - lo[:, None]).astype(np.float32)
            samples = resample_linear(torch.from_numpy(buf).to(dev), torch.from_numpy(local).to(dev), fill_value)
            samples = samples.cpu().numpy().reshape(out_block_shape)
            samples = np.where(outside.reshape(out_block_shape), fill_value, samples)
            if np.issubdtype(inp.dtype, np.integer):
                info = np.iinfo(inp.dtype)
                samples = np.clip(np.round(samples), info.min, info.max)
            out[bb] = samples.astype(inp.dtype)

        n = self.host_block_map(block_ids, process, store_verify_fn=region_verifier(out), blocking=blocking)
        return {"n_blocks": n, "out_shape": list(out_shape), "order": order}


class AffineTransformLocal(AffineTransformBase):
    target = "local"


class AffineTransformGPU(AffineTransformBase):
    target = "gpu"


class TransformationsWorkflow(WorkflowBase):
    task_name = "transformations_workflow"

    def requires(self):
        from . import transformations as tf_mod

        return [get_task_cls(tf_mod, "AffineTransform", self.target)(
            tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs,
            dependencies=self.dependencies, **self.params)]
