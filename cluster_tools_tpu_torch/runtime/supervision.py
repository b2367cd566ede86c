"""Host resource probes: memory and disk headroom.

Port (a copy) of the probes of ``cluster_tools_tpu/runtime/supervision.py``
that the executor's admission gate and the handoff registry's byte budget
read.  They read ``/proc/meminfo`` and ``shutil.disk_usage``; each returns
None where the figure is unavailable, and callers treat None as "no
admission control possible", never as 0.  The supervisor itself
(heartbeats, drain, the cluster watchdog) is ROADMAP Queue A item 11.
"""

from __future__ import annotations

import shutil
from typing import Optional


def host_mem_available_bytes() -> Optional[int]:
    """``MemAvailable`` from /proc/meminfo, or None."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def host_mem_available_fraction() -> Optional[float]:
    """MemAvailable / MemTotal, or None where /proc/meminfo is absent."""
    try:
        avail = total = None
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1])
        if avail is not None and total:
            return avail / total
    except (OSError, ValueError, IndexError):
        pass
    return None


def disk_free_fraction(path: str) -> Optional[float]:
    """Free / total of the filesystem holding ``path``, or None."""
    try:
        usage = shutil.disk_usage(path)
        if usage.total:
            return usage.free / usage.total
    except (OSError, ValueError):
        pass
    return None
