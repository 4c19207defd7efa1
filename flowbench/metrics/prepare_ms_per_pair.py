"""prepare_ms_per_pair: wall time of the port's `oftpu.prepare` spans (upload, cast, gray and Lab conversion)
on the profiler's clock over the traced calls, per pair."""
from flowbench.lib.spans import per_pair_ms


def read(ctx):
    return per_pair_ms(ctx, "prepare_s")
