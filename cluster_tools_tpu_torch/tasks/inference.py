"""Blockwise CNN inference: boundary/affinity prediction, block by block.

Port of ``cluster_tools_tpu/tasks/inference.py``: per block, read the
block with its halo, normalise it, pad it to the U-Net's multiple, run one
forward of the model on the task's device, crop the halo and write ``C``
float32 channels.  The model is built once per task on the task's device.

Params: ``input_path/input_key`` (raw), ``output_path/output_key``
(float32, shape ``(C,) + volume``), ``checkpoint_path``, ``model`` config
dict (``name`` + kwargs for :func:`..models.get_model`, or ``name: auto``
to infer the architecture from a torch checkpoint), ``halo``,
``normalize_percentile`` or fixed ``normalize_range`` (else min/max),
``activation`` (``sigmoid`` / ``softmax`` over channels / None).

Checkpoints: ``.npz`` is the JAX package's flat ``'/'``-joined flax
parameters (:mod:`..models.flax_import`), ``.pt``/``.pth`` a torch
``state_dict`` (:mod:`..models.torch_import`).  flax ``.msgpack`` files
are ROADMAP item 8b and refused.  Without a checkpoint the task runs on
the model's seeded random init ("smoke mode",
:meth:`..models.unet.UNet3D.reset_parameters`, seed 0): those weights are
not the JAX package's ``PRNGKey(0)`` init, and neither is meant to be
compared with the other.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models import get_model
from ..models.flax_import import flax_to_state_dict, state_dict_to_flax
from ..models.torch_import import import_torch_unet, load_torch_checkpoint
from ..runtime import handoff
from ..runtime.executor import BlockwiseExecutor, sweep_config
from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, pad_block_to


def load_checkpoint(path: str, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Load ``path`` into ``model``: ``.npz`` (flat ``'/'``-joined flax
    parameters) or ``.pt``/``.pth`` (a torch ``state_dict``).  Returns the
    loaded ``state_dict``.  Any other file is a flax msgpack checkpoint to
    the reference, which is not ported."""
    if path.endswith((".pt", ".pth")):
        return load_torch_checkpoint(path, model)
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: flax .msgpack checkpoints are not ported (ROADMAP Queue A item 8b); "
            "save the parameters as .npz with the JAX package's save_checkpoint"
        )
    with np.load(path) as f:
        sd = flax_to_state_dict({k: f[k] for k in f.files}, model)
    model.load_state_dict(sd)
    return sd


def save_checkpoint(path: str, model: torch.nn.Module) -> None:
    """Save ``model``'s parameters as the JAX package's flat npz
    (``params/``-prefixed flax paths; no pickle)."""
    np.savez(path, **state_dict_to_flax(model))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def normalize(data: np.ndarray, pct=None, rng_norm=None) -> np.ndarray:
    """The load's normalisation: a fixed ``rng_norm``, else the
    ``[100 - pct, pct]`` percentiles, else min/max; then
    ``(data - lo) / max(hi - lo, 1e-6)`` as float32."""
    if rng_norm is not None:
        lo, hi = float(rng_norm[0]), float(rng_norm[1])
    elif pct is not None:
        lo, hi = np.percentile(data, [100 - pct, pct])
    else:
        lo, hi = float(data.min()), float(data.max())
    return ((data - lo) / max(hi - lo, 1e-6)).astype(np.float32)


def build_model(cfg: Dict[str, Any], device: torch.device) -> torch.nn.Module:
    """The task's model with its weights, in eval mode on ``device``."""
    model_cfg: Dict[str, Any] = dict(cfg.get("model") or {})
    name = model_cfg.pop("name", "unet3d")
    ckpt = cfg.get("checkpoint_path")
    if name == "auto":
        # "bring your own torch U-Net": the architecture from the
        # checkpoint's tensor census; the remaining keys override it
        if not ckpt:
            raise ValueError("model name 'auto' infers the architecture from a torch checkpoint — "
                             "set checkpoint_path to a .pt/.pth")
        model, _ = import_torch_unet(ckpt, **model_cfg)
    else:
        model = get_model(name, **model_cfg)
        if ckpt:
            load_checkpoint(ckpt, model)
    return model.to(device).eval()


class InferenceBase(BaseTask):
    """Blockwise model prediction (reference: ``InferenceBase``)."""

    task_name = "inference"

    @staticmethod
    def default_task_config():
        return {
            "threads_per_job": 1,
            "device_batch": 1,
            "halo": [8, 8, 8],
            "model": {"name": "unet3d", "out_channels": 1},
            "checkpoint_path": None,
            "activation": "sigmoid",
            "normalize_percentile": None,
            "normalize_range": None,
        }

    def run_impl(self):
        cfg = self.get_config()
        inp = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"])
        shape = inp.shape
        block_shape = tuple(cfg["block_shape"])
        halo = tuple(cfg.get("halo") or [0] * len(shape))
        if not cfg.get("checkpoint_path"):
            self.logger.info("no checkpoint_path: using the seeded random init (smoke mode)")
        model = build_model(cfg, self.device)
        out_channels = int(getattr(model, "out_channels", 1))
        mult = 2 ** int(getattr(model, "depth", 0))
        # one kernel shape: the outer block rounded up to the U-Net multiple
        outer = tuple(_round_up(b + 2 * h, mult) for b, h in zip(block_shape, halo))

        out = self.handoff_dataset(cfg["output_path"], cfg["output_key"], shape=(out_channels,) + shape,
                                   chunks=(1,) + block_shape, dtype="float32")
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        done = set(self.blocks_done())
        blocks_all = [blocking.get_block(b, halo) for b in block_ids]
        todo = [b for b in blocks_all if b.block_id not in done]

        pct = cfg.get("normalize_percentile")
        rng_norm = cfg.get("normalize_range")
        activation = cfg.get("activation", "sigmoid")
        if bool(cfg.get("allow_block_split", False)) and rng_norm is None:
            # per-block statistics change with the read region: only a
            # fixed range is split-safe
            raise ValueError("allow_block_split=True requires normalize_range (per-block percentile/min-max "
                             "normalization is not split-safe)")

        def load(block):
            data = normalize(np.asarray(inp[block.outer_bb]).astype(np.float32), pct, rng_norm)
            return (pad_block_to(data, outer)[None],)

        def kernel(x):
            # any other activation returns the logits, as in the reference
            with torch.no_grad():
                logits = model(x[None])[0]
            if activation == "sigmoid":
                return torch.sigmoid(logits)
            if activation == "softmax":
                return torch.softmax(logits, dim=0)
            return logits

        def store(block, raw):
            rel = block.inner_in_outer_bb
            out[(slice(None),) + block.bb] = np.asarray(raw)[(slice(None),) + rel]

        # float outputs: the executor's NaN/inf check quarantines any block a
        # bad kernel or checkpoint corrupts
        sweep = BlockwiseExecutor.for_task(self.target, cfg, self.max_jobs).map_blocks(
            kernel, blocks_all, load, store, on_block_done=lambda b: self.log_block_success(b.block_id),
            done_block_ids=done, failures_path=self.failures_path, task_name=self.uid, **sweep_config(cfg),
        )
        return {"n_blocks": len(todo), "out_channels": out_channels,
                "model": (cfg.get("model") or {}).get("name", "unet3d"), "sweep": sweep}


class InferenceLocal(InferenceBase):
    target = "local"


class InferenceGPU(InferenceBase):
    target = "gpu"


class InferenceWorkflow(WorkflowBase):
    task_name = "inference_workflow"

    def requires(self):
        from . import inference as inf_mod

        return [get_task_cls(inf_mod, "Inference", self.target)(
            tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs,
            dependencies=self.dependencies, **self.params)]
