"""pair_ms: the window's seconds x 1000 over the frame pairs completed in it (host clock)."""


def read(ctx):
    w = ctx["window"]
    return 1000.0 * w["seconds"] / w["pairs"] if w["pairs"] else None
