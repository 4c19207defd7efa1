"""level_idle_ms_per_pair: device idle time whose gap's midpoint lies under the port's `oftpu.level` span
(dispatch inside the solver loop, every plane already on the card) over the traced calls, per pair."""
from flowbench.lib.spans import per_pair_ms


def read(ctx):
    return per_pair_ms(ctx, "level_idle_s")
