"""cg_iters_per_pair: PCG iterations over the traced calls, per pair, from the port's iteration counter."""


def read(ctx):
    trace, iters = ctx.get("trace"), ctx.get("cg_iters")
    if trace is None or iters is None or not trace["pairs"]:
        return None
    return iters / trace["pairs"]
