"""rof_roofline_share: the rof operation's least time (flowbench/roofline/rof.py) over the device
time of everything launched inside the benchmark's ranges around the port's calls to it."""
from flowbench.lib.readings import roofline_share


def read(ctx):
    return roofline_share(ctx, "rof")
