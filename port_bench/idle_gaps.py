"""The profiled window's idle gaps by what the host was doing, as
``trace_tools.reduce_trace`` names them (its ten longest), read back from
``ctx["profile"]`` for the metrics that share them."""

from trace_tools import SHORT_GAP_NS

# the names of the gaps that no host event explains
UNNAMED = ("no torch op on the host", f"gaps under {SHORT_GAP_NS // 1000} us")


def gaps(ctx):
    """``{name: seconds}`` of the idle gaps, or None where the profile is
    empty; a name not among them reads 0."""
    p = ctx.get("profile") or {}
    if not p.get("busy_s") or not p.get("window_s"):
        return None
    return {name: float(s) for name, s in p.get("idle_gaps") or []}


def named_share(ctx):
    """The % of the card's idle time during which a named host event was
    open; None where the profile is empty or the card never idled."""
    g = gaps(ctx)
    if g is None:
        return None
    p = ctx["profile"]
    idle = p["window_s"] - p["busy_s"]
    if idle <= 0:
        return None
    return 100.0 * (1.0 - sum(g.get(n, 0.0) for n in UNNAMED) / idle)


def window_share(ctx, names):
    """The gaps named one of ``names``, as a % of the profiled window; None
    where the profile is empty, and where most of the idle time is named by
    no host event (the executor's phases did not reach the profile, so a
    phase's share would read as low as it can)."""
    g = gaps(ctx)
    if g is None:
        return None
    named = named_share(ctx)
    if named is not None and named < 50.0:
        return None
    return 100.0 * sum(g.get(n, 0.0) for n in names) / ctx["profile"]["window_s"]
