"""Config serialization helpers (a copy of ``cluster_tools_tpu/utils/task_utils.py``).

Configs are JSON files in a ``config_dir``: one ``global.config`` plus one
``<task_name>.config`` per task, over each task's ``default_task_config()``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np


def _default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not json-serializable: {type(o)}")


def dump_config(path: str, config: Dict[str, Any]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(config, f, indent=2, sort_keys=True, default=_default)
    os.replace(tmp, path)


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_task_config(config_dir: str, task_name: str,
                     defaults: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Defaults <- global.config <- <task_name>.config, later wins."""
    config = dict(defaults or {})
    for fname in ("global.config", f"{task_name}.config"):
        path = os.path.join(config_dir, fname)
        if os.path.exists(path):
            config.update(load_config(path))
    return config
