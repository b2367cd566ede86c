"""Pixel classification: filter bank + linear classifier or random forest,
blockwise, with its training and the ingestion of ilastik projects.

Port of ``cluster_tools_tpu/tasks/ilastik.py``: an ilastik-style feature
bank (multi-scale gaussian smoothing, gradient magnitude, laplacian of
gaussian; or an ``.ilp`` project's feature selections, eigenvalue features
included) on each block, then softmax of a linear classifier, or the mean
class distribution of a dense random forest (ilastik's vigra forests).

Training (:func:`fit_linear_classifier`, :func:`train_pixel_classifier`):
logistic regression on standardized features, ``torch.optim.Adam``'s
update (its functional form, ``torch.optim.adam.adam``) at optax's
defaults (b1 0.9, b2 0.999, eps 1e-8, no eps_root) on the caller's device
(the card unless ``device="cpu"``), the initial ``W`` the reference's
``0.01 * jax.random.normal(PRNGKey(seed), ...)`` from the port's own
Threefry (:mod:`..utils.jax_random`), equal to it bit for bit.  The
features and Adam's updates differ from XLA's in float32 ulps, so a
trained ``W`` and ``b`` agree with the reference's within a tolerance
(``tests/test_torch_training.py``), not bit for bit.

``.ilp`` ingestion (:func:`load_ilp_project`, :func:`load_ilp_forest`,
:func:`train_from_ilp`, :func:`import_ilp`) reads the project through
h5py, imported at the call: without h5py (the card's machine) each raises
an ``ImportError`` naming it.

Checkpoint (npz): ``W`` [n_features, n_classes], ``b`` [n_classes],
``sigmas``; optionally ``ilp_features`` (``"FeatureId:sigma"`` strings) and
the forest tables ``rf_feature``, ``rf_threshold``, ``rf_children``,
``rf_leaf_probs``, ``rf_depth``; the reference's files, read by either
package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

import torch.nn.functional as F
# torch.optim.Adam's update itself: the class's step imports torch._dynamo
# at its first call (seconds of start-up on a machine with triton)
from torch.optim.adam import adam as _adam

from ..device import resolve_device
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
from ..utils.jax_random import normal as jax_normal
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


def fit_linear_classifier(X: np.ndarray, y: np.ndarray, n_steps: int = 300, lr: float = 0.5, seed: int = 0,
                          device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Logistic regression on featurized examples ``X`` [n, F] with integer
    classes ``y`` [n]; returns ``(W, b)`` as float32 numpy.

    The features are standardized (``mean``, ``std + 1e-6``, numpy float32
    as in the reference), ``n_steps`` Adam steps at ``lr`` minimize the mean
    cross-entropy on ``device`` (``None``: the card), and the
    standardization is folded back into ``W`` and ``b``."""
    dev = resolve_device(device)
    X = np.asarray(X, np.float32)
    n_classes = int(y.max()) + 1
    mu, sd = X.mean(0), X.std(0) + 1e-6
    Xn = (X - mu) / sd
    W0 = np.float32(0.01) * jax_normal(seed, (X.shape[1], n_classes))
    params = [torch.tensor(W0, device=dev, requires_grad=True),
              torch.zeros(n_classes, dtype=torch.float32, device=dev, requires_grad=True)]
    Xt = torch.from_numpy(np.ascontiguousarray(Xn)).to(dev)
    yt = torch.from_numpy(np.asarray(y, np.int64)).to(dev)
    moments = [torch.zeros_like(p) for p in params]
    second = [torch.zeros_like(p) for p in params]
    steps = [torch.tensor(0.0) for _ in params]
    for _ in range(int(n_steps)):
        W, b = params
        grads = torch.autograd.grad(F.cross_entropy(Xt @ W + b, yt), params)
        with torch.no_grad():
            _adam(params, list(grads), moments, second, [], steps, amsgrad=False, beta1=0.9, beta2=0.999, lr=lr,
                  weight_decay=0.0, eps=1e-8, maximize=False, foreach=False)
    W_np = params[0].detach().cpu().numpy()
    b_np = params[1].detach().cpu().numpy()
    # un-standardize: ((x - mu) / sd) W + b = x (W / sd) + (b - (mu / sd) W)
    W_raw = W_np / sd[:, None]
    b_raw = b_np - (mu / sd) @ W_np
    return W_raw.astype(np.float32), b_raw.astype(np.float32)


def _labelled_examples(feats: torch.Tensor, labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The feature rows of the labelled voxels (``labels > 0``, row-major)
    and their classes ``labels - 1``."""
    mask = labels > 0
    X = feats[torch.from_numpy(mask).to(feats.device)].cpu().numpy().astype(np.float32)
    return X, labels[mask].astype(np.int32) - 1


def train_pixel_classifier(raw: np.ndarray, labels: np.ndarray, sigmas: Sequence[float] = DEFAULT_SIGMAS,
                           n_steps: int = 300, lr: float = 0.5, seed: int = 0,
                           device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Train logistic regression on sparse annotations (``labels``: 0 =
    unlabelled, 1..K = classes): the feature bank of ``raw`` on ``device``
    (``None``: the card), then :func:`fit_linear_classifier` there.
    Returns ``(W, b)`` as numpy arrays."""
    dev = resolve_device(device)
    feats = feature_bank(torch.from_numpy(np.ascontiguousarray(raw, np.float32)).to(dev), tuple(sigmas))
    X, y = _labelled_examples(feats, np.asarray(labels))
    del feats
    return fit_linear_classifier(X, y, n_steps=n_steps, lr=lr, seed=seed, device=dev)


# ---------------------------------------------------------------------------
# vigra RandomForest ingestion: the serialized classifier inside an .ilp.
# The blob is plain HDF5 in vigra's RF serialization: per tree an int32
# ``topology_`` (header ``[column_count, class_count]``, root at offset 2;
# interior threshold nodes are ``[type, param_addr, left_addr, right_addr,
# column]`` with ``parameters_[param_addr + 1]`` the split threshold; leaves
# carry the 0x40000000 tag and ``parameters_[param_addr + 1 : + 1 + K]`` the
# class histogram) and a float64 ``parameters_``.  Prediction is the mean
# over all trees of all ``Forest*`` groups of each leaf's normalized
# histogram (:func:`forest_predict_proba`).
# ---------------------------------------------------------------------------

_VIGRA_LEAF_TAG = 0x40000000
_VIGRA_THRESHOLD_NODE = 0  # the only interior node type ilastik produces


def _h5py(path: str):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{path!r}: reading an ilastik project needs the h5py package, which cannot be "
                          "imported here") from e
    return h5py


def parse_vigra_forest(group) -> dict:
    """Parse one vigra RandomForest HDF5 group into dense node tables.

    Returns numpy arrays (the trees padded to the widest): ``feature`` [T,
    N] int32, ``threshold`` [T, N] float32, ``children`` [T, N, 2] int32
    (self-loop on leaves), ``leaf_probs`` [T, N, K] float32 (normalized;
    zero rows on interior and padding nodes), ``is_leaf`` [T, N] bool, and
    ``class_count``, ``column_count``, ``depth``.  Raises ``ValueError``
    on layouts that are not a vigra RandomForest serialization and on node
    types other than threshold splits and constant-probability leaves."""
    try:
        ext = group["_ext_param"]
    except KeyError:
        raise ValueError(
            f"{group.name}: no _ext_param subgroup — present but not a vigra RandomForest serialization "
            "(a different classifier backend?)"
        ) from None
    class_count = int(np.asarray(ext["class_count_"]).ravel()[0])
    column_count = int(np.asarray(ext["column_count_"]).ravel()[0])
    tree_keys = sorted((k for k in group.keys() if k.startswith("Tree_")), key=lambda k: int(k.split("_")[-1]))
    if not tree_keys:
        raise ValueError("vigra forest group has no Tree_* entries")
    trees = []
    for tk in tree_keys:
        try:
            topo = np.asarray(group[tk]["topology_"]).ravel().astype(np.int64)
            par = np.asarray(group[tk]["parameters_"]).ravel().astype(np.float64)
        except KeyError:
            raise ValueError(
                f"{group.name}/{tk}: missing topology_/parameters_ — not a vigra RandomForest tree serialization"
            ) from None
        if topo[0] != column_count or topo[1] != class_count:
            raise ValueError(
                f"{tk}: topology header {topo[:2].tolist()} does not match _ext_param (columns={column_count}, "
                f"classes={class_count})"
            )
        # walk the addresses into dense node ids, depth first
        addr2id: dict = {}
        order = []
        stack = [2]
        while stack:
            a = int(stack.pop())
            if a in addr2id:
                continue
            addr2id[a] = len(order)
            order.append(a)
            t = int(topo[a])
            if not (t & _VIGRA_LEAF_TAG):
                if t != _VIGRA_THRESHOLD_NODE:
                    raise ValueError(
                        f"{tk}: unsupported vigra node type {t} at {a} (only threshold splits + const-prob leaves)"
                    )
                stack.append(int(topo[a + 3]))
                stack.append(int(topo[a + 2]))
        n = len(order)
        feat = np.zeros(n, np.int32)
        thr = np.zeros(n, np.float32)
        child = np.zeros((n, 2), np.int32)
        leafp = np.zeros((n, class_count), np.float32)
        leaf = np.zeros(n, bool)
        for a in order:
            i = addr2id[a]
            t = int(topo[a])
            pa = int(topo[a + 1])
            if t & _VIGRA_LEAF_TAG:
                leaf[i] = True
                child[i] = (i, i)  # self-loop: extra gather steps are no-ops
                h = par[pa + 1: pa + 1 + class_count]
                total = h.sum()
                leafp[i] = h / total if total > 0 else np.full(class_count, 1.0 / class_count)
            else:
                feat[i] = int(topo[a + 4])
                thr[i] = par[pa + 1]
                child[i] = (addr2id[int(topo[a + 2])], addr2id[int(topo[a + 3])])
        trees.append((feat, thr, child, leafp, leaf))
    width = max(len(t[0]) for t in trees)

    def pad(arr, fill=0):
        out = np.full((len(trees), width) + arr[0].shape[1:], fill, arr[0].dtype)
        for i, a in enumerate(arr):
            out[i, : len(a)] = a
        return out

    # the walk's fixed length: the longest root-to-leaf path
    depth = 0
    for feat, thr, child, leafp, leaf in trees:
        d = np.zeros(len(feat), np.int32)
        for i in range(len(feat)):  # ids are in DFS order: parents first
            if not leaf[i]:
                d[child[i, 0]] = d[child[i, 1]] = d[i] + 1
        depth = max(depth, int(d.max()) if len(d) else 0)
    return {
        "feature": pad([t[0] for t in trees]),
        "threshold": pad([t[1] for t in trees]),
        "children": pad([t[2] for t in trees]),
        "leaf_probs": pad([t[3] for t in trees]),
        "is_leaf": pad([t[4] for t in trees], fill=True),
        "class_count": class_count,
        "column_count": column_count,
        "depth": depth,
    }


def load_ilp_forest(path: str) -> dict:
    """Every ``ClassifierForests/Forest*`` of an ``.ilp``, parsed and
    stacked (ilastik's parallel-lane ensemble): the tables of
    :func:`parse_vigra_forest`.  Raises ``KeyError`` when the project
    carries no serialized classifier."""
    h5py = _h5py(path)
    with h5py.File(path, "r") as f:
        grp = f["PixelClassification/ClassifierForests"]
        forests = [parse_vigra_forest(grp[k]) for k in sorted(grp.keys()) if k.startswith("Forest")]
    if not forests:
        raise KeyError(f"{path}: ClassifierForests holds no Forest* groups")
    k0 = forests[0]
    for fo in forests[1:]:
        if fo["class_count"] != k0["class_count"] or fo["column_count"] != k0["column_count"]:
            raise ValueError("inconsistent class/column counts across lanes")
    width = max(f_["feature"].shape[1] for f_ in forests)

    def cat(key, fill=0):
        parts = []
        for fo in forests:
            a = fo[key]
            if a.shape[1] < width:
                pad_shape = (a.shape[0], width - a.shape[1]) + a.shape[2:]
                a = np.concatenate([a, np.full(pad_shape, fill, a.dtype)], axis=1)
            parts.append(a)
        return np.concatenate(parts, axis=0)

    return {
        "feature": cat("feature"),
        "threshold": cat("threshold"),
        "children": cat("children"),
        "leaf_probs": cat("leaf_probs"),
        "is_leaf": cat("is_leaf", fill=True),
        "class_count": k0["class_count"],
        "column_count": k0["column_count"],
        "depth": max(f_["depth"] for f_ in forests),
    }


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


def _parse_block_slice(s: str) -> Tuple[slice, ...]:
    """An ilastik ``blockSlice`` attribute, ``'[1:4,0:10,5:9]'`` (it may
    carry a channel axis), as slices."""
    s = s.strip().strip("[]")
    out = []
    for part in s.split(","):
        lo, hi = part.split(":")
        out.append(slice(int(lo), int(hi)))
    return tuple(out)


def _load_ilp_selections(f) -> Tuple[Tuple[str, float], ...]:
    """``(feature_id, sigma)`` pairs of an open ``.ilp``'s
    ``FeatureSelections`` (ids x scales masked by ``SelectionMatrix``) in
    ilastik's feature-major order, the column order of its forest and of a
    retrained classifier.  Raises on unsupported feature ids."""
    fs = f["FeatureSelections"]
    ids = [i.decode() if isinstance(i, bytes) else str(i) for i in fs["FeatureIds"][:]]
    scales = [float(s) for s in fs["Scales"][:]]
    matrix = np.asarray(fs["SelectionMatrix"][:], bool)
    selections = []
    for fi, fid in enumerate(ids):
        for si, sig in enumerate(scales):
            if matrix[fi, si]:
                if fid not in ILP_SUPPORTED_FEATURES:
                    raise ValueError(f"ilastik feature {fid!r} is not supported (supported: {ILP_SUPPORTED_FEATURES})")
                selections.append((fid, sig))
    return tuple(selections)


def load_ilp_project(path: str):
    """An ilastik pixel-classification project (``.ilp``) for retraining:
    ``(selections, label_blocks)``, the ``(feature_id, sigma)`` pairs of
    ``FeatureSelections`` and the sparse annotation blocks ``(slices,
    uint8 labels)`` of ``PixelClassification/LabelSets`` (0 = unlabelled).
    :func:`import_ilp` prefers the project's serialized forest
    (:func:`load_ilp_forest`); a project with neither cannot be
    ingested."""
    h5py = _h5py(path)
    with h5py.File(path, "r") as f:
        selections = _load_ilp_selections(f)
        label_blocks = []
        ls = f.get("PixelClassification/LabelSets")
        if ls is not None:
            for lane in ls.values():
                for blk in lane.values():
                    bs = blk.attrs.get("blockSlice")
                    if bs is None:
                        continue
                    if isinstance(bs, bytes):
                        bs = bs.decode()
                    data = np.asarray(blk[:], np.uint8)
                    sl = _parse_block_slice(bs)
                    # ilastik appends a channel axis to label blocks
                    if data.ndim == len(sl) and data.shape[-1] == 1:
                        data = data[..., 0]
                        sl = sl[:-1]
                    label_blocks.append((sl, data))
    if not label_blocks:
        raise ValueError(
            f"{path}: no label annotations to re-train from — if the project carries a trained classifier, "
            "ingest it directly with import_ilp/load_ilp_forest instead of this retraining path"
        )
    return tuple(selections), label_blocks


def _ilp_features(selections) -> np.ndarray:
    return np.array([f"{fid}:{s}" for fid, s in selections])


def train_from_ilp(ilp_path: str, raw: np.ndarray, checkpoint_path: str, n_steps: int = 300, lr: float = 0.5,
                   seed: int = 0, device=None) -> int:
    """Fit the linear classifier from an ``.ilp`` project's feature
    selections and annotations over ``raw`` (the annotated raw volume, which
    the caller resolves), on ``device`` (``None``: the card).  Writes the
    npz checkpoint of :class:`IlastikPredictionBase`, the selections
    recorded, and returns the class count."""
    selections, label_blocks = load_ilp_project(ilp_path)
    labels = np.zeros(raw.shape, np.uint8)
    for sl, data in label_blocks:
        labels[sl] = data
    dev = resolve_device(device)
    feats = ilp_feature_bank(torch.from_numpy(np.ascontiguousarray(raw, np.float32)).to(dev), selections)
    X, y = _labelled_examples(feats, labels)
    del feats
    W, b = fit_linear_classifier(X, y, n_steps=n_steps, lr=lr, seed=seed, device=dev)
    np.savez(checkpoint_path, W=W, b=b, sigmas=np.zeros(0, np.float32),  # unused on the ilp path
             ilp_features=_ilp_features(selections))
    return W.shape[1]


def import_ilp(ilp_path: str, checkpoint_path: str, raw: "np.ndarray | None" = None, n_steps: int = 300,
               lr: float = 0.5, seed: int = 0, device=None) -> int:
    """Ingest an ``.ilp`` for prediction; returns the class count.  The
    project's own vigra forest when it has one (no raw volume needed),
    else the linear classifier re-fitted from its annotations over
    ``raw`` (:func:`train_from_ilp`, on ``device``).  A present but
    unparseable forest raises: retraining over it would hide the fault and
    change the predictions."""
    h5py = _h5py(ilp_path)
    with h5py.File(ilp_path, "r") as f:
        grp = f.get("PixelClassification/ClassifierForests")
        has_classifier = grp is not None and any(k.startswith("Forest") for k in grp.keys())
    if has_classifier:
        forest = load_ilp_forest(ilp_path)
        with h5py.File(ilp_path, "r") as f:
            selections = _load_ilp_selections(f)
        n_feat = ilp_feature_channels(selections)
        if n_feat != forest["column_count"]:
            raise ValueError(
                f"forest expects {forest['column_count']} feature columns but the project's selections produce "
                f"{n_feat} — the .ilp was saved mid-edit; re-train or re-save it"
            )
        np.savez(checkpoint_path, W=np.zeros((0, 0), np.float32), b=np.zeros(0, np.float32),
                 sigmas=np.zeros(0, np.float32), ilp_features=_ilp_features(selections),
                 rf_feature=forest["feature"], rf_threshold=forest["threshold"], rf_children=forest["children"],
                 rf_leaf_probs=forest["leaf_probs"], rf_depth=np.int32(forest["depth"]))
        return int(forest["class_count"])
    if raw is None:
        raise ValueError(f"{ilp_path}: no serialized classifier and no raw volume given — pass raw= to re-fit "
                         "from the project's annotations")
    return train_from_ilp(ilp_path, raw, checkpoint_path, n_steps=n_steps, lr=lr, seed=seed, device=device)


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
