"""median_roofline_share: the median operation's least time (flowbench/roofline/median.py) over the device
time of everything launched inside the benchmark's ranges around the port's calls to it."""
from flowbench.lib.readings import roofline_share


def read(ctx):
    return roofline_share(ctx, "median")
