"""The verifying reader: every block-product read checks its digest
sidecar, raises a *typed* ``corrupt:<site>`` instead of returning poisoned
bytes, and hands detected corruption to the lineage repair engine
(docs/SERVING.md "Self-healing").

Port (a copy) of ``cluster_tools_tpu/io/verified.py``, with the same
policy names, ``CTT_SIDECAR_POLICY`` and counters.  One deliberate
difference: an aligned product read that has no sidecar of its own but
covers recorded regions (a whole-volume read of a blockwise store) checks
each of them instead of adopting one digest for the whole read, which in
the reference drops every block sidecar it overlaps
(:func:`_recorded_within`).

At petabyte scale, silent bit-rot in stored products is a statistical
certainty, not an edge case — a system that only checks integrity at write
time (``store_verify_fn`` alone re-reads while the writer
still owns the block) eventually serves corrupt segmentations with a 200.
This module closes the read side of the loop.  It is not a new call for
callers to remember: the container read paths
(:meth:`~..io.containers._ChecksumOps._postread`) route
every ``ds[bb]`` / ``read_async().result()`` through :func:`postread`, and
ctlint CT011 forbids raw reads of product bytes (``_read_back`` /
``._store[...]`` / sidecar ``open()``) outside ``io/`` — going through the
dataset API *is* going through the verifying reader.

Behavior per read:

- **verify**: a region whose exact box has a recorded digest is CRC-checked
  (this part predates this module); a mismatch now first evicts any cached
  chunks, then asks :mod:`..runtime.repair` to recompute
  the block from its producing task's inputs.  A successful repair is
  re-read from storage, re-verified, and returned — the caller never sees
  the corruption.  A failed repair raises :class:`ProductCorruptionError`
  with ``code = "corrupt:<site>"`` (site: ``storage`` / ``memory`` /
  ``handoff`` / ``spill`` from the dataset kind).
- **missing-sidecar policy**, for datasets *marked as product stores*
  (:func:`mark_product` — the executor's ``region_verifier`` marks every
  hardened store): an exact, chunk-aligned region read with NO recorded
  digest is a hole in the integrity plane.  Policy ``adopt`` (default)
  warns and hash-and-adopts — the bytes just read become the recorded
  truth; ``strict`` raises :class:`MissingSidecarError` instead (for
  stores whose write path is known to record every block, where a missing
  sidecar can only mean sidecar loss).  Unmarked datasets (raw inputs,
  scratch) are never policed.  Non-aligned reads (halo slabs, thin faces)
  are never policed either — they have no sidecar identity.

``CTT_SIDECAR_POLICY`` sets the process default (``adopt`` / ``strict``);
:func:`mark_product` takes a per-store override.  Counters from
:func:`stats` feed ``/healthz``, ``scrub_state.json``, and
``failures_report.py --json`` (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import numpy as np

from . import containers as _c

POLICY_ADOPT = "adopt"
POLICY_STRICT = "strict"
_POLICIES = (POLICY_ADOPT, POLICY_STRICT)

#: cap on per-adoption warning log lines (the counter keeps the true total)
_ADOPT_LOG_CAP = 20

_lock = threading.Lock()
_counters: Dict[str, int] = {
    "corrupt_detected": 0,
    "repaired_reads": 0,
    "unrepairable_reads": 0,
    "sidecars_adopted": 0,
    "strict_missing": 0,
}


def default_policy() -> str:
    """Process-wide missing-sidecar policy (``CTT_SIDECAR_POLICY``)."""
    pol = os.environ.get("CTT_SIDECAR_POLICY", POLICY_ADOPT).lower()
    return pol if pol in _POLICIES else POLICY_ADOPT


def mark_product(dataset, policy: Optional[str] = None):
    """Mark ``dataset`` as a block-product store: its exact chunk-aligned
    region reads fall under the missing-sidecar policy, and the scrubber
    may enlist it.  Called by ``executor.region_verifier`` for every
    hardened store, so call sites never wire it separately.  Returns the
    dataset.  No-op for datasets without digest support (HDF5)."""
    if getattr(dataset, "_checksums", None) is None:
        return dataset
    pol = (policy or default_policy()).lower()
    if pol not in _POLICIES:
        raise ValueError(
            f"sidecar policy must be one of {_POLICIES}, got {policy!r}"
        )
    dataset._product_policy = pol
    return dataset


class ProductCorruptionError(_c.ChunkCorruptionError):
    """A block product's bytes failed digest verification at a read site
    and could not be repaired from lineage.  ``code`` is the typed
    resolution string (``corrupt:storage`` / ``corrupt:memory`` /
    ``corrupt:handoff`` / ``corrupt:spill`` / ``corrupt:scrub``) the
    failure report attributes."""

    def __init__(self, site: str, cause: _c.ChunkCorruptionError):
        super().__init__(cause.label, cause.region, cause.expected,
                         cause.actual)
        self.site = str(site)
        self.code = f"corrupt:{self.site}"
        self.args = (f"{self.code}: {cause}",)


class MissingSidecarError(RuntimeError):
    """Strict missing-sidecar policy: a product store's exact region read
    found no digest sidecar — on a store whose write path records every
    block, that can only be sidecar loss, and serving unverifiable bytes
    is refused."""

    def __init__(self, label: str, region, site: str):
        self.label = label
        self.region = tuple(region)
        self.site = str(site)
        self.code = f"corrupt:{self.site}:missing_sidecar"
        super().__init__(
            f"{self.code}: no digest sidecar for {label} region "
            + "x".join(f"[{a}:{b}]" for a, b in self.region)
            + " (strict policy refuses unverifiable product bytes)"
        )


def _bump(key: str, n: int = 1) -> None:
    with _lock:
        _counters[key] = _counters.get(key, 0) + n


def stats() -> Dict[str, int]:
    """Verifying-reader counters (docs/OBSERVABILITY.md): corruption
    detected at read, reads healed by lineage repair, reads that stayed
    corrupt, sidecars hash-and-adopted, strict-policy refusals."""
    with _lock:
        return dict(_counters)


def reset_stats() -> None:
    with _lock:
        for k in _counters:
            _counters[k] = 0


def _chunk_aligned(dataset, region) -> bool:
    """True when every region edge sits on a chunk boundary (or the
    volume edge) — the write contract for parallel block stores, and the
    only reads the missing-sidecar policy may judge (halo slabs and thin
    faces legitimately have no sidecar identity)."""
    chunks = getattr(dataset, "chunks", None)
    shape = dataset.shape
    if not chunks or len(chunks) != len(region):
        return False
    for (a, b), c, s in zip(region, chunks, shape):
        c = int(c)
        if c <= 0 or a % c != 0 or (b % c != 0 and b != int(s)):
            return False
    return True


def _policy_check(dataset, region, arr: np.ndarray, policy: str) -> None:
    """Apply the missing-sidecar policy to one product read whose exact
    region has no recorded digest."""
    if tuple(arr.shape) != _c._region_shape(region):
        return  # not an exact region read; nothing to judge
    if not _chunk_aligned(dataset, region):
        return
    site = getattr(dataset, "_read_site", "storage")
    if policy == POLICY_STRICT:
        _bump("strict_missing")
        raise MissingSidecarError(
            getattr(dataset, "_label", "<dataset>"), region, site
        )
    # adopt: the bytes just read become the recorded truth — warn so an
    # operator can tell adoption (first contact) from sidecar loss
    dataset._checksums.record(region, np.asarray(arr))
    _bump("sidecars_adopted")
    with _lock:
        n = _counters["sidecars_adopted"]
    if n <= _ADOPT_LOG_CAP:
        from ..utils import function_utils as fu

        fu.log(
            f"verified reader: adopted missing digest sidecar for "
            f"{getattr(dataset, '_label', '<dataset>')} region "
            + "x".join(f"[{a}:{b}]" for a, b in region)
            + (" (further adoptions logged only in counters)"
               if n == _ADOPT_LOG_CAP else "")
        )


def _repair_or_raise(dataset, bb, err: _c.ChunkCorruptionError) -> np.ndarray:
    """Detected corruption: hand the region to the lineage repair engine;
    on success re-read from the backing store and re-verify, else raise
    the typed error."""
    site = getattr(dataset, "_read_site", "storage")
    from ..runtime import repair as repair_mod

    if repair_mod.attempt_repair(dataset, err.region, site):
        arr = np.asarray(dataset._read_back(bb))
        try:
            dataset._verify_read(bb, arr)
        except _c.ChunkCorruptionError as still_bad:
            _bump("unrepairable_reads")
            raise ProductCorruptionError(site, still_bad) from err
        _bump("repaired_reads")
        return arr
    _bump("unrepairable_reads")
    raise ProductCorruptionError(site, err) from err


def postread(dataset, bb, arr: np.ndarray, evict=None) -> np.ndarray:
    """The verifying-reader tail of a region read (called by the container
    read paths — not by tasks).  Verifies, repairs, or raises typed; then
    applies the missing-sidecar policy for product stores.  Returns the
    array the caller may use (the repaired re-read on a healed region)."""
    if not _c.checksums_enabled():
        return arr
    try:
        dataset._verify_read(bb, arr)
    except _c.ChunkCorruptionError as err:
        _bump("corrupt_detected")
        if evict is not None:
            # bad chunks must not stay resident: the repair re-read (and
            # every later reader) has to see storage, not the cache
            evict()
        return _repair_or_raise(dataset, bb, err)
    policy = getattr(dataset, "_product_policy", None)
    if policy is not None:
        region = _c._norm_region(bb, dataset.shape)
        if region is not None and dataset._checksums.lookup(region) is None:
            inner = _recorded_within(dataset, region, arr)
            if inner is None:
                _policy_check(dataset, region, arr, policy)
            else:
                arr = _verify_within(dataset, region, arr, inner, evict)
    return arr


def _recorded_within(dataset, region, arr: np.ndarray):
    """For an exact, chunk-aligned product read with no sidecar of its own:
    the recorded regions it overlaps, or None when it overlaps none (the
    missing-sidecar policy's case).

    The reference judges such a read by the policy alone, so ``adopt``
    records one digest for, say, the whole volume, and that record drops
    every block sidecar it overlaps.  The port instead checks each block
    sidecar inside the read against its slice of the bytes read and adopts
    nothing: a whole-volume read of a product store is verified block by
    block and keeps the store's integrity record."""
    if tuple(arr.shape) != _c._region_shape(region) or not _chunk_aligned(dataset, region):
        return None
    # the read's own region is listed when its sidecar is torn: that one is
    # the policy's to judge
    inner = [r for r in dataset._checksums.regions() if r != region and _c._regions_overlap(r, region)]
    return inner or None


def _verify_within(dataset, region, arr: np.ndarray, inner, evict) -> np.ndarray:
    """Verify each recorded region inside ``region`` against its slice of
    ``arr``; a mismatch is caught, evicted and repaired as on an exact read,
    and the repaired bytes replace the slice."""
    for r in inner:
        if any(a < ra or b > rb for (a, b), (ra, rb) in zip(r, region)):
            continue  # overlaps the read without lying inside it
        sub_bb = tuple(slice(a, b) for a, b in r)
        local = tuple(slice(a - ra, b - ra) for (a, b), (ra, _) in zip(r, region))
        try:
            dataset._verify_read(sub_bb, arr[local])
        except _c.ChunkCorruptionError as err:
            _bump("corrupt_detected")
            if evict is not None:
                evict()
            if not arr.flags.writeable:
                arr = arr.copy()
            arr[local] = _repair_or_raise(dataset, sub_bb, err)
    return arr
