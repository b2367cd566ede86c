"""The ws+cc step (``make_ws_ccl_split``) on one card in a closed loop over a
pool of boundary maps made on the card: one step in flight, the pool's
volumes taken in turn, each step ended by a sync of the card."""

from __future__ import annotations

import gc

import numpy as np
import torch

from compare import differing, partition_differing
from harness import Reservoir
from reference.ws_cc import step_reference
from volumes import synthetic_boundaries


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, trace: bool):
        self.cfg = config
        self.traffic = traffic
        self.seed = int(seed)
        self.trace = trace
        self.device = torch.device("cuda:0" if device == "cuda" else device)
        self.shape = (1,) + tuple(int(s) for s in config["volume_shape"])
        self.voxels_per_unit = int(np.prod(self.shape))
        self.keep = Reservoir(self.seed)
        self.stages = self.entries = None

    # -- the program -------------------------------------------------------
    def devices(self):
        return [self.device]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def make_inputs(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.pool = [synthetic_boundaries(self.shape, gen, int(self.traffic["passes"]))
                     for _ in range(int(self.traffic["pool"]))]

    def setup(self) -> None:
        from cluster_tools_tpu_torch.parallel.split_pipeline import make_ws_ccl_split
        from cluster_tools_tpu_torch.runtime import trace

        trace.configure(enabled=False)
        self.make_inputs()
        self.step = make_ws_ccl_split(device=self.device, **self.cfg["step"])
        # every volume of the pool once: the kernels load, and the caching
        # allocator sees the sizes each volume's data asks for
        for v in self.pool:
            self._run(v)
        if self.trace and self.device.type == "cuda":
            from trace_tools import EntryEvents, StageEvents

            self.stages = StageEvents(self.device)
            self.entries = EntryEvents()
            self.entries.install()

    def _run(self, vol):
        if self.stages is not None and self.entries.active:
            self.stages.start()
            out = self.step.run_staged(vol, self.stages)
        else:
            out = self.step(vol)
        self.sync()
        return out

    # -- the window --------------------------------------------------------
    def begin_window(self) -> None:
        from cluster_tools_tpu_torch.runtime import trace

        if self.trace:
            trace.configure(enabled=True)
        if self.entries is not None:
            self.entries.active = True

    def unit(self, i: int) -> bool:
        slot = i % len(self.pool)
        ws, cc, n_fg, overflow = self._run(self.pool[slot])
        self.keep.offer(slot, (ws, cc, n_fg, overflow))
        return bool(overflow)

    def end_window(self) -> dict:
        out = {}
        if self.entries is not None:
            self.entries.active = False
            self.entries.uninstall()
            out["stage_ms"] = self.stages.stage_ms()
            out["entries"] = self.entries.totals()
        return out

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.step = None
        gc.collect()
        torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------
    def _reference(self, vol):
        p = self.cfg["step"]
        return step_reference(vol, 1, p["halo"], p["threshold"], p["dt_max_distance"],
                              p["min_seed_distance"])

    def check(self):
        lim = self.cfg["limits"]
        ws_bad = cc_bad = n_err = over = 0
        for slot, (ws, cc, n_fg, overflow) in sorted(self.keep.kept.items()):
            ref_ws, ref_cc, ref_n = self._reference(self.pool[slot][0])
            ws_bad += differing(ws[0], ref_ws)
            del ref_ws
            cc_bad += partition_differing(cc[0], ref_cc)
            del ref_cc
            n_err += abs(float(n_fg) - ref_n)
            over += int(bool(overflow))
        return [("ws_mismatch_voxels", ws_bad, lim["ws_mismatch_voxels"]),
                ("cc_mismatch_voxels", cc_bad, lim["cc_mismatch_voxels"]),
                ("n_foreground_error", n_err, lim["n_foreground_error"]),
                ("overflow_steps", over, lim["overflow_steps"]),
                ("unchecked_volumes", len(self.pool) - len(self.keep.kept), 0)]

    def control(self):
        """The compared numbers with the reference in the program's place,
        computed on the maps rounded to bfloat16, against the reference at
        float32, over every map of the pool."""
        self.make_inputs()
        ws_bad = cc_bad = n_err = 0
        for vol in self.pool:
            low_ws, low_cc, low_n = self._reference(vol[0].to(torch.bfloat16).to(torch.float32))
            ref_ws, ref_cc, ref_n = self._reference(vol[0])
            ws_bad += differing(low_ws, ref_ws)
            cc_bad += differing(low_cc, ref_cc)
            n_err += abs(low_n - ref_n)
            del low_ws, low_cc, ref_ws, ref_cc
        return [("ws_mismatch_voxels", ws_bad), ("cc_mismatch_voxels", cc_bad), ("n_foreground_error", n_err)]

