"""wmedian_b8_roofline_share: the wmedian operation's least time (flowbench/roofline/wmedian.py) over the device
time of everything launched inside the benchmark's ranges around the port's calls to it, at the batched
launch of eight VGA items a call."""
from flowbench.lib.readings import roofline_share


def read(ctx):
    return roofline_share(ctx, "wmedian")
