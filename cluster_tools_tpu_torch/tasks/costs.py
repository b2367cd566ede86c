"""Edge probabilities -> multicut costs.

Port of ``cluster_tools_tpu/tasks/costs.py``: the transform

    w(e) = log((1 - p_e) / p_e) + log((1 - beta) / beta)

with optional edge-size weighting, in torch float32 on the task's device.
One task in the main process: m edges is tiny next to the volume.

Artifact: ``tmp_folder/graph/costs.npy`` (float32 [m]), aligned with
``graph.npz``'s edge list.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from ..runtime import handoff
from ..runtime.task import BaseTask
from .features import features_path
from .graph import graph_dir, load_global_graph


def costs_path(tmp_folder: str) -> str:
    return os.path.join(graph_dir(tmp_folder), "costs.npy")


def compute_costs(probs: np.ndarray, beta: float = 0.5, edge_sizes: np.ndarray | None = None,
                  weighting_exponent: float = 1.0, eps: float = 1e-5, device=None) -> np.ndarray:
    """The probability->cost transform on ``device`` (float32).

    ``beta`` < 0.5 biases toward merging, > 0.5 toward splitting.  With
    ``edge_sizes``, costs are scaled by ``(size / max_size) ** exponent``.
    """
    dev = resolve_device(device)
    p = as_tensor(np.asarray(probs), dev, torch.float32).clamp(eps, 1.0 - eps)
    w = torch.log((1.0 - p) / p) + float(np.log((1.0 - beta) / beta))
    if edge_sizes is not None:
        sizes = as_tensor(np.asarray(edge_sizes), dev, torch.float32)
        top = sizes.max().clamp_min(1.0) if sizes.numel() else torch.ones((), device=dev)
        w = w * (sizes / top) ** weighting_exponent
    return w.cpu().numpy().astype(np.float32, copy=False)


class ProbsToCostsBase(BaseTask):
    """Transform merged edge features into signed multicut costs.  Params:
    ``beta``, ``weighting_scheme`` (None or 'size'), ``weighting_exponent``
    (label 0 never becomes a graph node, so there is no ignore label to
    handle here)."""

    task_name = "probs_to_costs"

    @staticmethod
    def default_task_config():
        return {"threads_per_job": 1, "device_batch": 1, "beta": 0.5, "weighting_scheme": None,
                "weighting_exponent": 1.0}

    def run_impl(self):
        cfg = self.get_config()
        feats = handoff.load_array(features_path(self.tmp_folder))
        _, _, _, sizes = load_global_graph(self.tmp_folder)
        costs = compute_costs(
            feats[:, 0], beta=float(cfg.get("beta", 0.5)),
            edge_sizes=sizes if cfg.get("weighting_scheme") == "size" else None,
            weighting_exponent=float(cfg.get("weighting_exponent", 1.0)), device=self.device,
        )
        self.save_handoff_array(costs_path(self.tmp_folder), costs)
        return {"n_edges": len(costs), "n_attractive": int((costs > 0).sum())}


class ProbsToCostsLocal(ProbsToCostsBase):
    target = "local"


class ProbsToCostsGPU(ProbsToCostsBase):
    target = "gpu"
