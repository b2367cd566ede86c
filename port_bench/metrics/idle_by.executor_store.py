"""The card's idle gaps while the host was in the executor's store phase
(``executor.store``), as a % of the profiled window."""

from idle_gaps import window_share


def read(ctx):
    return window_share(ctx, ("executor.store",))
