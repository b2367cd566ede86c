"""Device ms of the step's fill stage: the CUDA events that the step's stage
callback recorded around it, averaged over the traced steps."""


def read(ctx):
    ms = ctx.get("stage_ms", {}).get("fill")
    return sum(ms) / len(ms) if ms else None
