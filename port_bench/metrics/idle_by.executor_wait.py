"""The card's idle gaps while the host waited in the executor
(``executor.batch_wait`` for a batch's loads, ``executor.lock_wait`` for a
card's lock), as a % of the profiled window."""

from idle_gaps import window_share


def read(ctx):
    return window_share(ctx, ("executor.batch_wait", "executor.lock_wait"))
