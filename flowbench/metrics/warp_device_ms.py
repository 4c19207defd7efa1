"""warp_device_ms: kernels, memsets and device-to-device copies launched under the port's `oftpu.warp` span,
outside the four `flowbench.<op>` ranges (`plain_ops_device_ms`'s rule), per pair."""
from flowbench.lib.spans import per_pair_ms


def read(ctx):
    return per_pair_ms(ctx, "warp_s")
