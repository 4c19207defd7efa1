"""nonlevel_idle_ms_per_pair: device idle time inside `flowbench.entry` under no `oftpu.level` span (prepare,
preprocess, pyramids, readback, the caller) over the traced calls, per pair."""
from flowbench.lib.spans import per_pair_ms


def read(ctx):
    return per_pair_ms(ctx, "nonlevel_idle_s")
