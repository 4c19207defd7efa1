"""plain_ops_device_ms: device time outside the four named operations' ranges (kernels, memsets and
device-to-device copies), per pair."""
from flowbench.lib.readings import per_pair


def read(ctx):
    return per_pair(ctx, "plain_s", 1000.0)
