"""pyramid_device_ms: kernels, memsets and device-to-device copies launched under the port's `oftpu.pyramid`
and `oftpu.resample` spans, outside the four `flowbench.<op>` ranges, per pair."""
from flowbench.lib.spans import per_pair_ms


def read(ctx):
    return per_pair_ms(ctx, "pyramid_s")
