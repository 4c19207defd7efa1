"""launches_per_pair: device kernels over the traced calls, per pair (the benchmark's own probes left out)."""
from flowbench.lib.readings import per_pair


def read(ctx):
    return per_pair(ctx, "kernels")
