"""Task-to-task data handoffs: the storage rung only.

Port of the ``memory_handoffs=False`` rung of
``cluster_tools_tpu/runtime/handoff.py``: a consumer resolves a producer's
output as the plain storage dataset, and array artifacts are ``.npy`` /
``.npz`` files (``np.save`` / ``np.load``).  The memory and device rungs
(task-graph fusion) are ROADMAP Queue A items 9 and 11; a config that
turns them on is refused by :class:`..runtime.task.BaseTask`.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..utils.volume_utils import file_reader


def resolve_dataset(path: str, key: str):
    """The dataset a producer wrote at ``(path, key)``."""
    return file_reader(path)[key]


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    """The arrays of an ``.npy`` (as ``{"data": ...}``) or ``.npz`` artifact."""
    if path.endswith(".npy"):
        return {"data": np.load(path)}
    with np.load(path) as f:
        return {name: f[name] for name in f.files}


def load_array(path: str) -> np.ndarray:
    """The single array of an ``.npy`` artifact."""
    (arr,) = load_arrays(path).values()
    return arr


def array_exists(path: str) -> bool:
    return os.path.exists(path)
