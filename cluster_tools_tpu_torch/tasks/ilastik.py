"""Pixel classification: filter bank + linear classifier or random forest,
blockwise.

Port of the prediction half of ``cluster_tools_tpu/tasks/ilastik.py``:
an ilastik-style feature bank (multi-scale gaussian smoothing, gradient
magnitude, laplacian of gaussian; or an ``.ilp`` project's feature
selections, eigenvalue features included) on each block, then softmax of a
linear classifier, or the mean class distribution of a dense random forest
(the JAX package's import of ilastik's vigra forests).

Checkpoint (npz, written by the JAX package's ``train_pixel_classifier`` /
``train_from_ilp`` / ``import_ilp`` callers): ``W`` [n_features,
n_classes], ``b`` [n_classes], ``sigmas``; optionally ``ilp_features``
(``"FeatureId:sigma"`` strings) and the forest tables ``rf_feature``,
``rf_threshold``, ``rf_children``, ``rf_leaf_probs``, ``rf_depth``.
Training (``fit_linear_classifier``, ``train_pixel_classifier``,
``train_from_ilp``) and the ``.ilp`` ingestion through h5py are ROADMAP
Queue A item 8b: they are not in the port.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.filters import (
    _gradient_magnitude_of,
    gaussian_smooth_tensor,
    gradient_magnitude_tensor,
    hessian_eigenvalues_tensor,
    structure_tensor_eigenvalues_tensor,
)
from ..runtime import handoff
from ..runtime.executor import BlockwiseExecutor, is_sub_block, region_verifier, sweep_config
from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, pad_block_to

DEFAULT_SIGMAS = (0.7, 1.6, 3.5)


def _laplacian(sm: torch.Tensor) -> torch.Tensor:
    """Second differences of ``sm`` summed over the axes, wrapping around
    the block at its borders (the reference's ``jnp.roll``)."""
    lap = torch.zeros_like(sm)
    for axis in range(sm.dim()):
        lap = lap + (torch.roll(sm, 1, axis) + torch.roll(sm, -1, axis) - 2 * sm)
    return lap


def feature_bank(x: torch.Tensor, sigmas: Tuple[float, ...] = DEFAULT_SIGMAS) -> torch.Tensor:
    """Per-voxel features of a float32 volume: the raw intensity, then for
    each sigma the gaussian smoothing, the gaussian gradient magnitude and
    the laplacian of gaussian.  Returns ``(*shape, n_features)``."""
    feats = [x]
    for s in sigmas:
        sm = gaussian_smooth_tensor(x, float(s))
        feats.append(sm)
        # the reference smooths again for the magnitude: the same values
        feats.append(_gradient_magnitude_of(sm, (1.0,) * x.dim()))
        feats.append(_laplacian(sm))
    return torch.stack(feats, dim=-1)


def n_features(sigmas: Sequence[float] = DEFAULT_SIGMAS) -> int:
    return 1 + 3 * len(sigmas)


def forest_predict_proba(feature: torch.Tensor, threshold: torch.Tensor, children: torch.Tensor,
                         leaf_probs: torch.Tensor, X: torch.Tensor, depth: int) -> torch.Tensor:
    """Ensemble class probabilities ``[n, K]`` for features ``X`` ``[n, F]``.

    Dense trees (``feature``/``threshold`` ``[T, N]``, ``children`` ``[T,
    N, 2]`` with leaves pointing at themselves, ``leaf_probs`` ``[T, N,
    K]``).  Every sample takes exactly ``depth`` gather steps in every tree,
    all trees at once (a sample goes right where its feature is ``>=`` the
    threshold); the result is the mean over the trees."""
    T, n = feature.shape[0], X.shape[0]
    feat = feature.long()
    child = children.reshape(T, -1).long()
    xt = X.t()
    idx = torch.zeros((T, n), dtype=torch.long, device=X.device)
    for _ in range(int(depth)):
        x = torch.gather(xt, 0, torch.gather(feat, 1, idx))
        go_right = (x >= torch.gather(threshold, 1, idx)).long()
        idx = torch.gather(child, 1, idx * 2 + go_right)
    rows = torch.arange(T, device=X.device)[:, None]
    return leaf_probs[rows, idx].mean(dim=0)


# ilastik feature ids -> filters; eigenvalue features give 3 channels each
ILP_SUPPORTED_FEATURES = (
    "GaussianSmoothing",
    "LaplacianOfGaussian",
    "GaussianGradientMagnitude",
    "DifferenceOfGaussians",
    "HessianOfGaussianEigenvalues",
    "StructureTensorEigenvalues",
)


def _ilp_single_feature(x: torch.Tensor, fid: str, sigma: float) -> torch.Tensor:
    """One selection's channels: ``(*shape, c)`` with c = 1 or 3."""
    if fid == "GaussianSmoothing":
        return gaussian_smooth_tensor(x, sigma)[..., None]
    if fid == "GaussianGradientMagnitude":
        return gradient_magnitude_tensor(x, sigma)[..., None]
    if fid == "LaplacianOfGaussian":
        return _laplacian(gaussian_smooth_tensor(x, sigma))[..., None]
    if fid == "DifferenceOfGaussians":
        # ilastik's DoG pairs sigma with 0.66 * sigma
        return (gaussian_smooth_tensor(x, sigma) - gaussian_smooth_tensor(x, 0.66 * sigma))[..., None]
    if fid == "HessianOfGaussianEigenvalues":
        return hessian_eigenvalues_tensor(x, sigma)
    if fid == "StructureTensorEigenvalues":
        return structure_tensor_eigenvalues_tensor(x, sigma)
    raise ValueError(f"unsupported ilastik feature id {fid!r}")


def ilp_feature_channels(selections) -> int:
    """Feature-bank column count of ``(feature_id, sigma)`` selections
    (eigenvalue features give 3 channels, the others 1)."""
    return sum(3 if fid.endswith("Eigenvalues") else 1 for fid, _ in selections)


def ilp_feature_bank(x: torch.Tensor, selections: Tuple[Tuple[str, float], ...]) -> torch.Tensor:
    """Features of an ``.ilp`` project's ``(feature_id, sigma)`` selections,
    in selection order (ilastik's feature-matrix layout)."""
    return torch.cat([_ilp_single_feature(x, fid, float(s)) for fid, s in selections], dim=-1)


def load_classifier(path: str, device: torch.device) -> dict:
    """The prediction checkpoint's arrays, as tensors on ``device``:
    ``W``, ``b``, ``sigmas``, ``selections`` (None without
    ``ilp_features``), ``forest`` (None without ``rf_feature``) and
    ``n_classes``."""
    with np.load(path) as f:
        W = torch.from_numpy(np.asarray(f["W"], np.float32)).to(device)
        b = torch.from_numpy(np.asarray(f["b"], np.float32)).to(device)
        sigmas = tuple(float(s) for s in f["sigmas"])
        selections = None
        if "ilp_features" in f and len(f["ilp_features"]):
            selections = tuple((s.rsplit(":", 1)[0], float(s.rsplit(":", 1)[1])) for s in f["ilp_features"].tolist())
        forest = None
        if "rf_feature" in f:
            forest = {k: torch.from_numpy(np.asarray(f["rf_" + k])).to(device)
                      for k in ("feature", "threshold", "children", "leaf_probs")}
            forest["depth"] = int(f["rf_depth"])
    n_classes = int(forest["leaf_probs"].shape[-1] if forest is not None else W.shape[1])
    return dict(W=W, b=b, sigmas=sigmas, selections=selections, forest=forest, n_classes=n_classes)


def predict_block(clf: dict, x: torch.Tensor) -> torch.Tensor:
    """Class probabilities ``(K, *shape)`` of one float32 block."""
    if clf["selections"] is not None:
        feats = ilp_feature_bank(x, clf["selections"])
    else:
        feats = feature_bank(x, clf["sigmas"])
    forest = clf["forest"]
    if forest is not None:
        flat = feats.reshape(-1, feats.shape[-1])
        probs = forest_predict_proba(forest["feature"], forest["threshold"], forest["children"],
                                     forest["leaf_probs"], flat, forest["depth"])
        probs = probs.reshape(feats.shape[:-1] + (clf["n_classes"],))
    else:
        probs = torch.softmax(feats @ clf["W"] + clf["b"], dim=-1)
    return torch.movedim(probs, -1, 0)


class IlastikPredictionBase(BaseTask):
    """Blockwise pixel-classification prediction (reference:
    ``IlastikPredictionBase``).

    Params: ``input_path/input_key`` (raw), ``output_path/output_key``
    (class probabilities, ``(K,) + volume`` float32), ``checkpoint_path``
    (the npz above), ``halo`` (filter support; the default covers the
    largest default sigma).  Blocks at the volume border are edge-padded.
    """

    task_name = "ilastik_prediction"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "halo": [12, 12, 12]}

    def run_impl(self):
        cfg = self.get_config()
        inp = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"])
        shape = inp.shape
        block_shape = tuple(cfg["block_shape"])
        halo = tuple(cfg.get("halo") or [0] * len(shape))
        clf = load_classifier(cfg["checkpoint_path"], self.device)
        n_classes = clf["n_classes"]

        out = self.handoff_dataset(cfg["output_path"], cfg["output_key"], shape=(n_classes,) + shape,
                                   chunks=(1,) + block_shape, dtype="float32")
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        done = set(self.blocks_done())
        blocks_all = [blocking.get_block(b, halo) for b in block_ids]
        todo = [b for b in blocks_all if b.block_id not in done]
        outer = tuple(b + 2 * h for b, h in zip(block_shape, halo))

        def load(block):
            data = np.asarray(inp[block.outer_bb]).astype(np.float32)
            if is_sub_block(block):
                # a degrade-split fragment keeps its own, smaller shape
                return (data,)
            return (pad_block_to(data, outer, mode="edge"),)

        def kernel(x):
            return predict_block(clf, x)

        def store(block, raw):
            rel = block.inner_in_outer_bb
            out[(slice(None),) + block.bb] = np.asarray(raw)[(slice(None),) + rel]

        # float outputs: the executor's NaN/inf check quarantines blocks
        # corrupted by a bad forest or a feature overflow
        sweep = BlockwiseExecutor.for_task(self.target, cfg, self.max_jobs).map_blocks(
            kernel, blocks_all, load, store, on_block_done=lambda b: self.log_block_success(b.block_id),
            done_block_ids=done, failures_path=self.failures_path, task_name=self.uid,
            store_verify_fn=region_verifier(out, bb_of=lambda b: (slice(None),) + b.bb),
            # opt-in OOM split: the filter bank and the per-voxel classifier
            # are shape-local, so the sub-block outputs tile the parent when
            # the halo covers the largest filter support
            splittable=bool(cfg.get("allow_block_split", False)), split_halo=halo,
            min_block_shape=cfg.get("min_block_shape"), **sweep_config(cfg),
        )
        return {"n_blocks": len(todo), "n_classes": int(n_classes), "sweep": sweep}


class IlastikPredictionLocal(IlastikPredictionBase):
    target = "local"


class IlastikPredictionGPU(IlastikPredictionBase):
    target = "gpu"


class IlastikPredictionWorkflow(WorkflowBase):
    task_name = "ilastik_prediction_workflow"

    def requires(self):
        from . import ilastik as il_mod

        return [get_task_cls(il_mod, "IlastikPrediction", self.target)(
            tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs,
            dependencies=self.dependencies, **self.params)]
