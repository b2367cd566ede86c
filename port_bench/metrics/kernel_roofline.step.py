"""The kernel entries' share of their roofline in the step: the sum over
every call of its least time (``work_counts.py``, counted from the call's
arguments) over the sum of the calls' device time (CUDA events around each
entry call), in %."""


def read(ctx):
    tot = ctx.get("entries")
    if not tot or tot[1] <= 0:
        return None
    return 100.0 * tot[0] / tot[1]
