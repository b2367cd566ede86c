"""Parse run artifacts into runtime/throughput reports.

Port (a copy) of ``cluster_tools_tpu/utils/parse_utils.py``; ``python -m
cluster_tools_tpu_torch.cli report`` prints its :func:`report`.

Re-design of the reference's ``cluster_tools/utils/parse_utils.py``
(SURVEY.md §2a "Utils": "parse job logs -> runtimes"; §5.1 tracing).  The
rebuild's tasks write structured success manifests (``<uid>.success.json``
with ``runtime_s``) and per-block JSON markers with timestamps, so the
report comes from parsing those instead of grepping free-form log lines.

``parse_runtimes`` -> per-task wall-clock table; ``parse_block_timeline``
-> per-block completion times (for stragglers); ``report`` -> a printable
summary with voxels/sec when a volume size is given.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional


def parse_runtimes(tmp_folder: str) -> Dict[str, Dict]:
    """Per-task entries from every success manifest in ``tmp_folder``:
    {uid: {task, runtime_s, target, ...extra manifest fields}}."""
    out: Dict[str, Dict] = {}
    for path in sorted(glob.glob(os.path.join(tmp_folder, "*.success.json"))):
        uid = os.path.basename(path)[: -len(".success.json")]
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        doc["task"] = uid.rsplit(".", 1)[0]
        out[uid] = doc
    return out


def parse_block_timeline(tmp_folder: str, uid: str) -> List[Dict]:
    """Per-block completion records of one task (sorted by time); useful
    for straggler analysis (the reference's per-job runtime parsing)."""
    d = os.path.join(tmp_folder, "markers", uid)
    if not os.path.isdir(d):
        return []
    records = []
    for fname in os.listdir(d):
        if not (fname.startswith("block_") and fname.endswith(".json")):
            continue
        try:
            with open(os.path.join(d, fname)) as f:
                records.append(json.load(f))
        except (OSError, json.JSONDecodeError):
            continue
    return sorted(records, key=lambda r: r.get("time", ""))


def report(tmp_folder: str, n_voxels: Optional[int] = None) -> str:
    """Printable per-task runtime summary, slowest first; with ``n_voxels``
    adds voxels/sec per blockwise task."""
    rows = parse_runtimes(tmp_folder)
    lines = [f"{'task':40s} {'runtime_s':>10s} {'voxels/s':>12s}"]
    for uid, doc in sorted(
        rows.items(), key=lambda kv: -kv[1].get("runtime_s", 0.0)
    ):
        rt = doc.get("runtime_s", 0.0)
        vps = (
            f"{n_voxels / rt:12.3g}"
            if n_voxels and rt > 0 and doc.get("n_blocks")
            else f"{'-':>12s}"
        )
        lines.append(f"{doc['task']:40s} {rt:10.2f} {vps}")
    total = sum(d.get("runtime_s", 0.0) for d in rows.values())
    lines.append(f"{'TOTAL':40s} {total:10.2f}")
    return "\n".join(lines)
