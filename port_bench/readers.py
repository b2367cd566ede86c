"""Formulas that several metrics share.  Each metric keeps a file of its own
under ``metrics/``, which names one of these as its ``read``."""


def voxels_per_s(ctx):
    """All the voxels of the window's units over all the time of the window
    (host clock; every unit ends with a sync of the cards it used)."""
    return ctx["voxels"] / ctx["window_s"]


def idle_share(ctx):
    """The device's idle share of the profiled part of the window: 1 - the
    union of device activity (averaged over the cards used) over the
    profiled window, from ``torch.profiler``, in %; None without a profile."""
    p = ctx.get("profile") or {}
    if not p.get("busy_s") or not p.get("window_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
