"""The kernel entries' share of the step's device time: their calls' device
time (CUDA events around each entry call) over the steps' device time
(CUDA events at each step's start and end), in %."""


def read(ctx):
    tot = ctx.get("entries")
    steps = ctx.get("stage_ms", {}).get("step")
    if not tot or not steps:
        return None
    return 100.0 * tot[1] * 1e3 / sum(steps)
