"""h2d_ms_per_pair: device time of host-to-device copies over the traced calls, per pair."""
from flowbench.lib.readings import per_pair


def read(ctx):
    return per_pair(ctx, "h2d_s", 1000.0)
