"""device_idle_share: 100 x (1 - the union of kernel and copy intervals / the traced window)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
