"""The card's idle gaps while the host was in the executor's load phase
(``executor.load``), as a % of the profiled window."""

from idle_gaps import window_share


def read(ctx):
    return window_share(ctx, ("executor.load",))
