"""ms a block in the executor's ``executor.dispatch`` spans, summed over the
window's runs and all threads (so not a share of the wall)."""


def read(ctx):
    spans = ctx.get("spans", {})
    if "executor.dispatch" not in spans or not ctx["units"]:
        return None
    return 1e3 * spans["executor.dispatch"] / (ctx["units"] * ctx["blocks_per_unit"])
