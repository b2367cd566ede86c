"""Blockwise distance-transform watershed tasks (single- and two-pass).

Port of ``cluster_tools_tpu/tasks/watershed.py``: per-block DT watershed
with halo, labels offset for global uniqueness, and the two-pass
checkerboard where pass-two blocks seed from their labelled pass-one
neighbours, so basins continue across block faces with the same ids.

Label encoding: ``global = block_id * (n_outer + 1) + local`` (uint64),
``local`` being the kernel's flat-index label in the static outer block
(block + 2 * halo; border blocks are padded with 1.0, pure boundary).

Kernels: ``impl`` ``auto`` (the default), ``cuda`` or ``torch`` runs the
tiled watershed (``ops/tile_ws.py``: kernels B1-B4 on the card with
``auto``/``cuda``, their twins with ``torch``); ``legacy``, 2-D mode and
connectivity above 1 run ``ops/watershed.py``.  The reference's
``pallas``/``xla`` mean ``auto`` here.  ``host`` (single-pass, 3-D,
connectivity 1, no ``size_filter``, ``agglomerate_threshold`` or
``sigma_seeds``) runs :func:`..ops.host.host_dt_watershed` per block on a
thread pool: the original per-job compute, on the CPU by design even when a
card is present (the host C++ EDT and flood release the interpreter lock,
so ``max_jobs`` threads overlap).  On the tiled route without a
``size_filter`` the kernel carries a lane-batched form
(``kernel.batched``: :func:`..ops.tile_ws.dt_watershed_lanes`), so a
sharded sweep runs a whole batch of blocks in one call; the other routes
run the sweep's lane rung (one call per block of the batch).

``agglomerate_threshold`` (single-pass only) merges each block's fragments
by in-block average linkage over the block's RAG before the labels are
stored (:meth:`_WsTaskBase._agglomerate_block`).
"""

from __future__ import annotations

import numpy as np

from ..ops.tile_ws import dt_watershed_lanes, dt_watershed_seeded_tiled, dt_watershed_tiled
from ..ops.watershed import distance_transform_watershed, dt_watershed_seeded, filter_small_segments
from ..runtime import handoff
from ..runtime.executor import BlockwiseExecutor, sweep_config, validate_labels
from ..runtime.task import BaseTask, WorkflowBase, get_task_cls
from ..utils.volume_utils import Blocking, blocks_in_volume, file_reader, pad_block_to

_CAP_KNOBS = ("exit_cap", "fill_cap", "adj_cap", "fill_rounds", "seed_cap", "table_cap", "pair_cap", "edge_cap")


def _tiled_cap_knobs(cfg):
    """Config-set capacity knobs of the tiled kernels (None: the defaults)."""
    return {k: int(cfg[k]) for k in _CAP_KNOBS if cfg.get(k) is not None}


def _outer_shape(block_shape, halo):
    return tuple(b + 2 * h for b, h in zip(block_shape, halo))


class _WsTaskBase(BaseTask):
    """Shared machinery of the watershed tasks."""

    @staticmethod
    def default_task_config():
        return {
            "threads_per_job": 1,
            "device_batch": 1,
            "threshold": 0.25,
            "sigma_seeds": 0.0,
            "min_seed_distance": 0.0,
            "sampling": None,
            "size_filter": 0,
            # in-block average-linkage merge of the fragments (single-pass)
            "agglomerate_threshold": None,
            "two_d": False,
            "connectivity": 1,
            "halo": [4, 4, 4],
            # EDT cap in physical units; None derives it from the halo
            "dt_max_distance": None,
            # "auto"/"cuda"/"torch" (tiled), or "legacy"
            "impl": "auto",
            "exit_cap": None,
            "fill_cap": None,
            "adj_cap": None,
            "fill_rounds": None,
            "seed_cap": None,
            "table_cap": None,
            "pair_cap": None,
            "edge_cap": None,
        }

    def _setup(self):
        cfg = self.get_config()
        inp = handoff.resolve_dataset(cfg["input_path"], cfg["input_key"])
        shape = inp.shape
        block_shape = tuple(cfg["block_shape"])
        halo = tuple(cfg.get("halo") or [0] * len(shape))
        blocking = Blocking(shape, block_shape)
        block_ids = blocks_in_volume(shape, block_shape, cfg.get("roi_begin"), cfg.get("roi_end"))
        out = self.handoff_dataset(cfg["output_path"], cfg["output_key"], shape=shape, chunks=block_shape,
                                   dtype="uint64")
        mask_ds = file_reader(cfg["mask_path"])[cfg["mask_key"]] if cfg.get("mask_path") else None
        return cfg, inp, out, mask_ds, shape, block_shape, halo, blocking, block_ids

    def _impl(self, cfg) -> str:
        impl = str(cfg.get("impl", "auto"))
        if impl in ("pallas", "xla"):
            self.logger.info(f"impl={impl!r} is the reference's kernel route; the port runs 'auto'")
            impl = "auto"
        if impl not in ("auto", "cuda", "torch", "legacy", "host"):
            raise ValueError(f"unknown impl {impl!r} (expected auto, cuda, torch, legacy or host)")
        return impl

    def _kernel_params(self, cfg):
        sampling = cfg.get("sampling")
        dt_max = cfg.get("dt_max_distance")
        if dt_max is None:
            # halo-derived default with a floor of 8
            halo = cfg.get("halo") or [0]
            samp = sampling or [1.0] * len(halo)
            dt_max = max(8.0, max(float(h) * float(s) for h, s in zip(halo, samp)))
        return dict(
            threshold=float(cfg["threshold"]),
            sigma_seeds=float(cfg.get("sigma_seeds") or 0.0),
            min_seed_distance=float(cfg.get("min_seed_distance") or 0.0),
            sampling=None if sampling is None else tuple(sampling),
            connectivity=int(cfg.get("connectivity", 1)),
            dt_max_distance=float(dt_max),
        )

    def _agglomerate_block(self, lab: np.ndarray, bnd: np.ndarray, threshold: float) -> np.ndarray:
        """In-block average-linkage merge of the fragments (reference:
        ``_WsTaskBase._agglomerate_block``): fragments whose contact's
        size-weighted mean boundary value is below ``threshold`` fuse.  Runs
        on the padded-outer labels, so the halo takes part; the RAG is
        extracted on the task's device, the linkage is the host heap.
        Fragments without an edge keep distinct ids."""
        from ..ops.agglomeration import average_agglomeration
        from ..ops.rag import block_rag

        lab = np.ascontiguousarray(lab)
        uv, sizes, feats = block_rag(lab.astype(np.uint64), bnd, device=self.device)
        if len(uv) == 0:
            return lab
        nodes = np.unique(uv).astype(np.int64)
        remap = np.zeros(int(nodes.max()) + 1, np.int64)
        remap[nodes] = np.arange(len(nodes))
        merged = average_agglomeration(len(nodes), remap[uv.astype(np.int64)], feats[:, 0], sizes, threshold)
        all_labels = np.unique(lab[lab > 0]).astype(np.int64)
        table = np.zeros(int(all_labels.max()) + 1, lab.dtype)
        table[nodes] = (merged + 1).astype(lab.dtype)
        iso = np.setdiff1d(all_labels, nodes, assume_unique=True)
        k = int(merged.max()) + 1 if len(merged) else 0
        table[iso] = (np.arange(len(iso)) + k + 1).astype(lab.dtype)
        return table[lab]

    def _store_labels(self, out, block, raw, n_outer):
        """Crop the inner region from the padded-outer labels and globalize."""
        inner = raw[block.inner_in_outer_bb]
        glob = np.where(inner > 0, np.uint64(block.block_id) * np.uint64(n_outer + 1) + inner.astype(np.uint64),
                        np.uint64(0))
        out[block.bb] = glob
        return glob

    def _note_overflow(self, block, ovf, overflow_blocks) -> None:
        if bool(np.asarray(ovf)):
            # capacity-truncated labels are under-merged: record loudly
            overflow_blocks.add(block.block_id)
            self.logger.warning(f"block {block.block_id} overflowed a tiled-watershed capacity; labels may "
                                "be under-merged (raise the caps or use impl=legacy)")


class WatershedBase(_WsTaskBase):
    """Single-pass blockwise DT watershed (independent blocks).

    Params: ``input_path/input_key`` (boundary map), ``output_path/
    output_key``; kernel params per ``default_task_config``.  Optional
    ``pass_parity`` (0/1) restricts to checkerboard-even/odd blocks (pass
    one of the two-pass workflow).
    """

    task_name = "watershed"

    def run_impl(self):
        cfg, inp, out, mask_ds, shape, block_shape, halo, blocking, block_ids = self._setup()
        parity = cfg.get("pass_parity")
        if parity is not None:
            block_ids = [b for b in block_ids if sum(blocking.block_grid_position(b)) % 2 == int(parity)]
        done = set(self.blocks_done())
        blocks_all = [blocking.get_block(b, halo) for b in block_ids]
        outer = _outer_shape(block_shape, halo)
        n_outer = int(np.prod(outer))
        kp = self._kernel_params(cfg)
        two_d = bool(cfg.get("two_d", False))
        size_filter = int(cfg.get("size_filter") or 0)
        impl = self._impl(cfg)
        agg_thr = cfg.get("agglomerate_threshold")
        if agg_thr is not None and parity is not None:
            # pass one of the checkerboard seeds pass two, which cannot merge
            raise NotImplementedError("agglomerate_threshold is not supported with pass_parity "
                                      "(two-pass checkerboard)")
        # boundary blocks kept from load to store for the agglomeration
        # (unique keys; dict ops are atomic across the IO threads)
        bnd_stash = {}

        def load(block):
            # pad with 1.0 (pure boundary) so basins don't leak off-volume
            data = pad_block_to(inp[block.outer_bb].astype(np.float32), outer, constant_values=1.0)
            if agg_thr is not None:
                bnd_stash[block.block_id] = data
            m = pad_block_to(mask_ds[block.outer_bb] > 0, outer) if mask_ds is not None else np.ones(outer, bool)
            return data, m

        use_tiled = impl != "legacy" and not two_d and kp["connectivity"] == 1 and len(outer) == 3

        tk = {k: v for k, v in kp.items() if k != "connectivity"}
        tk.update(_tiled_cap_knobs(cfg))

        def kernel(b, m):
            if use_tiled:
                lab, ovf = dt_watershed_tiled(b, mask=m, impl=impl, device=b.device, **tk)
            else:
                lab = distance_transform_watershed(b, mask=m, two_d=two_d,
                                                   impl="auto" if impl == "legacy" else impl,
                                                   device=b.device, **kp)
                ovf = False
            if size_filter > 0:
                lab = filter_small_segments(lab, b, size_filter, connectivity=kp["connectivity"], device=b.device)
            return lab, ovf

        if use_tiled and size_filter == 0:
            kernel.batched = lambda b, m: dt_watershed_lanes(b, None, m, impl=impl, **tk)

        overflow_blocks = set()

        def store(block, raw):
            lab, ovf = raw
            self._note_overflow(block, ovf, overflow_blocks)
            if agg_thr is not None:
                # peek, don't pop: a store retry must find the stash
                lab = self._agglomerate_block(np.asarray(lab), bnd_stash[block.block_id], float(agg_thr))
            self._store_labels(out, block, lab, n_outer)

        def block_done(block):
            bnd_stash.pop(block.block_id, None)
            self.log_block_success(block.block_id)

        if impl == "host":
            self._run_host(cfg, kp, two_d, size_filter, agg_thr, [b for b in blocks_all if b.block_id not in done],
                           load, store)
            return {"n_blocks": len(block_ids), "n_outer": n_outer, "overflow_blocks": []}
        sweep = BlockwiseExecutor.for_task(self.target, cfg, self.max_jobs).map_blocks(
            kernel, blocks_all, load, store, on_block_done=block_done,
            done_block_ids=done, validate_fn=validate_labels, failures_path=self.failures_path,
            task_name=self.uid, **sweep_config(cfg),
        )
        return {"n_blocks": len(block_ids), "n_outer": n_outer, "overflow_blocks": sorted(overflow_blocks),
                "sweep": sweep}

    def _run_host(self, cfg, kp, two_d, size_filter, agg_thr, todo, load, store) -> None:
        """``impl="host"``: the reference's per-job host watershed
        (:func:`..ops.host.host_dt_watershed`), one block a thread of a
        ``max_jobs`` pool, with no device and no executor.  Options it has
        no counterpart for are refused, not approximated."""
        if two_d:
            raise NotImplementedError("impl='host' is 3-D only")
        if size_filter > 0 or agg_thr is not None:
            raise NotImplementedError("impl='host' does not support size_filter / agglomerate_threshold -- use the "
                                      "device impls")
        if float(kp.get("sigma_seeds") or 0.0) > 0:
            raise NotImplementedError("impl='host' does not support sigma_seeds")
        if int(kp.get("connectivity", 1)) != 1:
            raise NotImplementedError("impl='host' supports connectivity=1 only")
        from concurrent.futures import ThreadPoolExecutor

        from ..ops.host import host_dt_watershed

        def host_block(block):
            b, m = load(block)
            lab = host_dt_watershed(b, threshold=float(kp["threshold"]), dt_max_distance=kp.get("dt_max_distance"),
                                    min_seed_distance=float(kp.get("min_seed_distance", 0.0)), mask=m,
                                    sampling=kp.get("sampling"))
            store(block, (lab, False))
            self.log_block_success(block.block_id)

        with ThreadPoolExecutor(max(1, self.max_jobs)) as pool:
            # list() raises the first block's exception
            list(pool.map(host_block, todo))


class WatershedLocal(WatershedBase):
    target = "local"


class WatershedGPU(WatershedBase):
    target = "gpu"


class TwoPassWatershedBase(_WsTaskBase):
    """Pass two of the checkerboard: odd blocks seed from even neighbours.

    Reads the boundary map and the pass-one labels in the halo; the visible
    neighbour labels become external seeds (dense ids on the host), so
    basins continue across block faces with identical global ids.
    """

    task_name = "two_pass_watershed"

    def run_impl(self):
        cfg, inp, out, mask_ds, shape, block_shape, halo, blocking, block_ids = self._setup()
        if all(h == 0 for h in halo):
            raise ValueError("two-pass watershed requires a nonzero halo")
        if cfg.get("agglomerate_threshold") is not None:
            # pass-two labels carry immutable external seed ids from pass one
            raise NotImplementedError("agglomerate_threshold is not supported with the two-pass watershed")
        if cfg.get("two_d"):
            raise NotImplementedError("two_d=True is not supported for the two-pass watershed; use the "
                                      "single-pass watershed for per-slice segmentation")
        impl = self._impl(cfg)
        if impl == "host":
            # pass one would flood on the host while this pass runs the seeded
            # device kernel: two flood semantics in one label space
            raise NotImplementedError("impl='host' is not supported for two-pass watershed -- the seeded "
                                      "continuation only exists as a device kernel")
        block_ids = [b for b in block_ids if sum(blocking.block_grid_position(b)) % 2 == 1]
        done = set(self.blocks_done())
        blocks_all = [blocking.get_block(b, halo) for b in block_ids]
        outer = _outer_shape(block_shape, halo)
        n_outer = int(np.prod(outer))
        kp = self._kernel_params(cfg)
        size_filter = int(cfg.get("size_filter") or 0)
        # per-block external-seed tables, keyed by block id (host side; dict
        # ops are atomic across the IO threads)
        tables = {}

        def load(block):
            data = pad_block_to(inp[block.outer_bb].astype(np.float32), outer, constant_values=1.0)
            prev = pad_block_to(out[block.outer_bb], outer)
            # keep only voxels of even-parity (pass-one) blocks: those chunks
            # are complete; odd neighbours are being written concurrently
            grids = np.ix_(*(np.arange(b, b + o) // bs
                             for b, o, bs in zip(block.outer_begin, prev.shape, block_shape)))
            parity = sum(grids) % 2
            prev = np.where(parity == 0, prev, np.uint64(0))
            ext_labels = np.unique(prev[prev > 0])
            dense = np.zeros(outer, np.int32)
            if len(ext_labels):
                dense = np.searchsorted(ext_labels, prev).astype(np.int32) + 1
                dense[prev == 0] = 0
            tables[block.block_id] = ext_labels
            m = pad_block_to(mask_ds[block.outer_bb] > 0, outer) if mask_ds is not None else np.ones(outer, bool)
            return data, dense, m

        use_tiled = impl != "legacy" and kp["connectivity"] == 1

        tk = {k: v for k, v in kp.items() if k != "connectivity"}
        tk.update(_tiled_cap_knobs(cfg))

        def kernel(b, ext, m):
            if use_tiled:
                lab, ovf = dt_watershed_seeded_tiled(b, ext, mask=m, impl=impl, device=b.device, **tk)
            else:
                lab = dt_watershed_seeded(b, ext, mask=m, impl="auto" if impl == "legacy" else impl,
                                          device=b.device, **kp)
                ovf = False
            if size_filter > 0:
                # external ids live in (N, 2N]: widen the size-count domain
                lab = filter_small_segments(lab, b, size_filter, connectivity=kp["connectivity"],
                                            max_label=2 * n_outer, device=b.device)
            return lab, ovf

        if use_tiled and size_filter == 0:
            kernel.batched = lambda b, ext, m: dt_watershed_lanes(b, ext, m, impl=impl, **tk)

        overflow_blocks = set()

        def store(block, raw):
            raw, ovf = raw
            self._note_overflow(block, ovf, overflow_blocks)
            raw = raw[block.inner_in_outer_bb]
            ext_labels = tables[block.block_id]  # peek: a store retry needs it
            is_ext = raw > n_outer
            glob = np.zeros(raw.shape, np.uint64)
            if is_ext.any():
                glob[is_ext] = ext_labels[np.clip(raw[is_ext] - n_outer - 1, 0, len(ext_labels) - 1)]
            new = (raw > 0) & ~is_ext
            glob[new] = np.uint64(block.block_id) * np.uint64(n_outer + 1) + raw[new].astype(np.uint64)
            out[block.bb] = glob

        def block_done(block):
            tables.pop(block.block_id, None)
            self.log_block_success(block.block_id)

        sweep = BlockwiseExecutor.for_task(self.target, cfg, self.max_jobs).map_blocks(
            kernel, blocks_all, load, store, on_block_done=block_done,
            done_block_ids=done, validate_fn=validate_labels, failures_path=self.failures_path,
            task_name=self.uid, **sweep_config(cfg),
        )
        return {"n_blocks": len(block_ids), "n_outer": n_outer, "overflow_blocks": sorted(overflow_blocks),
                "sweep": sweep}


class TwoPassWatershedLocal(TwoPassWatershedBase):
    target = "local"


class TwoPassWatershedGPU(TwoPassWatershedBase):
    target = "gpu"


class WatershedWorkflow(WorkflowBase):
    """Watershed workflow: single-pass, or the two-pass checkerboard when
    ``two_pass=True``."""

    task_name = "watershed_workflow"

    def requires(self):
        from . import watershed as ws_mod

        p = dict(self.params)
        two_pass = bool(p.pop("two_pass", False))
        if two_pass and p.get("two_d"):
            raise NotImplementedError("two_d=True is not supported with two_pass=True")
        if two_pass and p.get("agglomerate_threshold") is not None:
            raise NotImplementedError("agglomerate_threshold is not supported with two_pass=True")
        common = dict(tmp_folder=self.tmp_folder, config_dir=self.config_dir, max_jobs=self.max_jobs)
        if not two_pass:
            return [get_task_cls(ws_mod, "Watershed", self.target)(**common, dependencies=self.dependencies, **p)]
        t1 = get_task_cls(ws_mod, "Watershed", self.target)(
            **common, dependencies=self.dependencies, pass_parity=0, **p)
        return [get_task_cls(ws_mod, "TwoPassWatershed", self.target)(**common, dependencies=[t1], **p)]
