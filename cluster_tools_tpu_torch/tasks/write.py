"""Generic blockwise assignment writer.

Port of ``cluster_tools_tpu/tasks/write.py``: apply an assignment table
(an ``npz`` of sorted ``keys`` and their ``values``) to a label volume,
blockwise, on the host IO threads.  Unmatched labels map to 0.
"""

from __future__ import annotations

import numpy as np

from ..runtime import handoff
from ..runtime.executor import region_verifier
from ..runtime.task import BaseTask
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


def apply_assignment_np(labels: np.ndarray, keys: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Map ``labels`` through the (sorted keys -> values) table; 0 stays 0,
    labels missing from the table map to 0."""
    idx = np.searchsorted(keys, labels)
    idx = np.clip(idx, 0, max(len(keys) - 1, 0))
    if len(keys) == 0:
        return np.zeros_like(labels)
    matched = keys[idx] == labels
    out = np.where(matched & (labels != 0), values[idx], 0)
    return out.astype(values.dtype if len(values) else labels.dtype)


class WriteBase(BaseTask):
    """Params: ``input_path/input_key`` (labels), ``output_path/output_key``
    (uint64 output), ``assignment_path`` (npz with keys/values)."""

    task_name = "write"

    def run_impl(self):
        cfg = self.get_config()
        inp = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"])
        shape = inp.shape
        block_shape = tuple(cfg["block_shape"])
        f = handoff.load_arrays(cfg["assignment_path"])
        keys, values = f["keys"], f["values"]
        out = file_reader(cfg["output_path"]).require_dataset(
            cfg["output_key"], shape=shape, chunks=block_shape, dtype="uint64"
        )
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))

        def process(block_id):
            block = blocking.get_block(block_id)
            out[block.bb] = apply_assignment_np(inp[block.bb], keys, values)

        # the output is the workflow's product: each block is verified
        # after its store and registers its lineage, so the verifying
        # reader and the scrubber can repair it
        n = self.host_block_map(block_ids, process, store_verify_fn=region_verifier(out), blocking=blocking)
        return {"n_blocks": n}


class WriteLocal(WriteBase):
    target = "local"


class WriteGPU(WriteBase):
    target = "gpu"
