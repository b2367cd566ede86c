"""Blockwise dataset copy.

Port of ``cluster_tools_tpu/tasks/copy_volume.py``'s ``CopyVolume`` as the
relabel workflow uses it: staging a label volume to a scratch dataset
before an in-place write.  Blocks in the ROI are copied clipped to it, in
the input's dtype, on the host IO threads.  (The reference's casts,
channel slicing, affine scaling and ``fit_to_roi`` have no caller in the
port yet.)
"""

from __future__ import annotations

from ..runtime.executor import region_verifier
from ..runtime.task import BaseTask
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader


class CopyVolumeBase(BaseTask):
    """Params: ``input_path/input_key``, ``output_path/output_key``."""

    task_name = "copy_volume"

    def run_impl(self):
        cfg = self.get_config()
        inp = file_reader(cfg["input_path"])[cfg["input_key"]]
        shape = inp.shape
        block_shape = tuple(cfg["block_shape"])
        out = file_reader(cfg["output_path"]).require_dataset(
            cfg["output_key"], shape=shape, chunks=block_shape, dtype=str(inp.dtype)
        )
        blocking = Blocking(shape, block_shape)
        roi_begin, roi_end = cfg.get("roi_begin"), cfg.get("roi_end")
        block_ids = blocks_in_volume(shape, block_shape, roi_begin, roi_end)
        roi_lo = tuple(int(b) for b in (roi_begin or [0] * len(shape)))
        roi_hi = tuple(int(e) for e in (roi_end if roi_end is not None else shape))

        def out_bb(block):
            # clipped to the ROI: blocks straddling its edge copy only the
            # inside, and the verifier checks the region that was written
            return tuple(slice(max(b.start, lo), min(b.stop, hi)) for b, lo, hi in zip(block.bb, roi_lo, roi_hi))

        def process(block_id):
            bb = out_bb(blocking.get_block(block_id))
            out[bb] = inp[bb]

        n = self.host_block_map(block_ids, process, store_verify_fn=region_verifier(out, bb_of=out_bb),
                                blocking=blocking)
        return {"n_blocks": n, "shape": list(shape), "dtype": str(inp.dtype)}


class CopyVolumeLocal(CopyVolumeBase):
    target = "local"


class CopyVolumeGPU(CopyVolumeBase):
    target = "gpu"
