"""The blockwise watershed workflow (``runtime/task.py::build`` of a
``WatershedWorkflow``) run back to back on one boundary map in
``memory://``: every run a fresh ``tmp_folder`` and a fresh output
container, the device page pool and the chunk cache emptied before it,
so no run is served from what an earlier one left behind."""

from __future__ import annotations

import gc
import json
import os
import resource
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from compare import differing
from harness import Reservoir
from reference.ws_cc import workflow_reference
from volumes import synthetic_boundaries

IN_PATH = "memory://port_bench/in"
OUT_PATH = "memory://port_bench/out-{}"


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, trace: bool):
        self.cfg = config
        self.traffic = traffic
        self.seed = int(seed)
        self.trace = trace
        self.device = torch.device("cuda:0" if device == "cuda" else device)
        self.shape = tuple(int(s) for s in config["volume_shape"])
        self.block = [int(b) for b in config["block_shape"]]
        self.voxels_per_unit = int(np.prod(self.shape))
        self.n_blocks = int(np.prod([-(-s // b) for s, b in zip(self.shape, self.block)]))
        self.keep = Reservoir(self.seed)
        self.pool_hits = 0

    def devices(self):
        return [self.device]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def make_inputs(self) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return synthetic_boundaries(self.shape, gen, int(self.traffic["passes"]))

    def setup(self) -> None:
        from cluster_tools_tpu_torch.io.containers import open_container
        from cluster_tools_tpu_torch.runtime import trace

        os.environ.update(self.cfg["env"])
        trace.configure(enabled=False)
        vol = self.make_inputs()
        ds = open_container(IN_PATH).require_dataset("boundaries", shape=self.shape, chunks=self.block,
                                                     dtype="float32")
        ds[...] = vol.cpu().numpy()
        del vol
        self.root = tempfile.mkdtemp(prefix="port_bench-")
        self._drop(self._run("warm-up")[0])

    def _run(self, tag):
        """One run of the workflow; returns ``(output path, overflow)``."""
        from cluster_tools_tpu_torch.io import chunk_cache
        from cluster_tools_tpu_torch.parallel import device_pool
        from cluster_tools_tpu_torch.runtime.task import build
        from cluster_tools_tpu_torch.tasks.watershed import WatershedWorkflow

        device_pool.reset()
        chunk_cache.configure()
        hits0 = device_pool.snapshot()["device_pool_hits"]
        d = os.path.join(self.root, f"run-{tag}")
        os.makedirs(os.path.join(d, "cfg"))
        with open(os.path.join(d, "cfg", "global.config"), "w") as f:
            json.dump({"block_shape": self.block}, f)
        out = OUT_PATH.format(tag)
        wf = WatershedWorkflow(tmp_folder=os.path.join(d, "tmp"), config_dir=os.path.join(d, "cfg"),
                               max_jobs=int(self.cfg["max_jobs"]), block_shape=self.block, input_path=IN_PATH,
                               input_key="boundaries", output_path=out, output_key="ws",
                               target="gpu" if self.device.type == "cuda" else "local", **self.cfg["workflow"])
        host0 = _host_clocks()
        t0 = time.perf_counter()
        ok = build([wf])
        self.sync()
        wall = time.perf_counter() - t0
        host = {k: round(v - host0[k], 3) for k, v in _host_clocks().items()}
        tmp = os.path.join(d, "tmp")
        manifests = [json.load(open(os.path.join(tmp, f))) for f in os.listdir(tmp) if f.endswith(".success.json")]
        overflow = any(m.get("overflow_blocks") for m in manifests)
        sweep = {k: round(v, 3) for m in manifests for k, v in m.get("sweep", {}).items()
                 if k.endswith("_s") and isinstance(v, (int, float))}
        print(f"port_bench: workflow run {tag}: {wall:.3f} s; executor {sweep}; host {host}", file=sys.stderr)
        shutil.rmtree(d)
        self.pool_hits += device_pool.snapshot()["device_pool_hits"] - hits0
        if not ok:
            raise RuntimeError(f"the watershed workflow failed in run {tag}")
        return out, overflow

    @staticmethod
    def _drop(path) -> None:
        from cluster_tools_tpu_torch.io.containers import MemoryContainer

        if path is not None:
            MemoryContainer._registry.pop(path, None)

    def begin_window(self) -> None:
        from cluster_tools_tpu_torch.runtime import trace

        if self.trace:
            trace.configure(enabled=True)

    def unit(self, i: int) -> bool:
        # every run starts from the same heap: the cycles an earlier run
        # left are collected here, inside the window, not at random inside
        # a later run
        gc.collect()
        out, overflow = self._run(i)
        self._drop(self.keep.offer(0, out))
        return overflow

    def end_window(self) -> dict:
        from cluster_tools_tpu_torch.runtime import trace

        print(f"port_bench: device page-pool hits in the window's runs: {self.pool_hits}", file=sys.stderr)
        spans = {}
        if self.trace:
            for ev in trace._get().snapshot_events():
                if ev["ph"] == "X" and ev["name"] in ("executor.store", "executor.dispatch"):
                    spans[ev["name"]] = spans.get(ev["name"], 0.0) + float(ev["dur"])
            trace.configure(enabled=False)
        return {"spans": spans, "blocks_per_unit": self.n_blocks}

    def release(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, vol):
        p = self.cfg["workflow"]
        return workflow_reference(vol, self.block, p["halo"], p["threshold"], p["dt_max_distance"],
                                  p["min_seed_distance"])

    def check(self):
        from cluster_tools_tpu_torch.io.containers import open_container

        vol = torch.from_numpy(open_container(IN_PATH)["boundaries"][...]).to(self.device)
        want = self._reference(vol)
        del vol
        bad = 0
        for path in self.keep.kept.values():
            got = torch.from_numpy(open_container(path)["ws"][...].astype(np.int64)).to(self.device)
            bad += differing(got, want)
            del got
        for path in list(self.keep.kept.values()) + [IN_PATH]:
            self._drop(path)
        return [("ws_mismatch_voxels", bad, self.cfg["limits"]["ws_mismatch_voxels"]),
                ("unchecked_runs", 1 - len(self.keep.kept), 0)]

    def control(self):
        """The compared number with the reference in the program's place,
        computed on the map rounded to bfloat16, against the reference at
        float32."""
        vol = self.make_inputs()
        low = self._reference(vol.to(torch.bfloat16).to(torch.float32))
        return [("ws_mismatch_voxels", differing(low, self._reference(vol)))]


def _host_clocks() -> dict:
    """This process's CPU seconds, page faults and involuntary context
    switches, and the whole machine's steal and iowait seconds: printed a
    run, so a slow run shows whether it waited for the host or worked more."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"user_s": ru.ru_utime, "sys_s": ru.ru_stime, "minflt": float(ru.ru_minflt),
           "nivcsw": float(ru.ru_nivcsw)}
    try:
        with open("/proc/stat") as f:
            cpu = [float(v) for v in f.readline().split()[1:]]
        tick = os.sysconf("SC_CLK_TCK")
        out["host_iowait_s"] = cpu[4] / tick
        out["host_steal_s"] = cpu[7] / tick if len(cpu) > 7 else 0.0
    except (OSError, ValueError, IndexError):
        pass
    return out
