"""The port's attributes that the benchmark's ranges wrap exist, and the ranges record every call."""
import importlib

import numpy as np
import torch

from flowbench.lib import port


def test_wrapped_attributes_and_counters_exist():
    for mod_name, attr in port.TARGETS.values():
        assert callable(getattr(importlib.import_module(mod_name), attr)), (mod_name, attr)
    kernel = importlib.import_module("optical_flow_tpu_torch.ops.cuda.cg_kernel")
    assert isinstance(kernel._iters, dict) and callable(kernel.iteration_counts) and callable(kernel.reset_stats)


def test_ranges_record_each_operation_call_and_restore():
    from optical_flow_tpu_torch import estimate_flow

    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
    b = np.roll(a, 1, axis=1)
    saved = {op: getattr(importlib.import_module(m), attr) for op, (m, attr) in port.TARGETS.items()}
    with port.OpRanges() as ranges:
        estimate_flow(a, b, "classic+nl-fast", {"display": False, "solver": "pcg"}, device="cpu")
        estimate_flow(a, b, "classic++", {"display": False, "max_iters": 1}, device="cpu")
    for op, (m, attr) in port.TARGETS.items():
        assert getattr(importlib.import_module(m), attr) is saved[op]
    calls = ranges.calls
    # classic+nl-fast at 32x40: 2 + 2 levels x 3 warps; classic++: 2 + 2 + 2 levels x 1 warp
    assert len(calls["wmedian"]) == 12 and len(calls["cg"]) == 12 + 6 and len(calls["median"]) == 6
    assert len(calls["rof"]) == 2 and calls["rof"][0] == {"planes": 2, "H": 32, "W": 40, "iters": 100}
    assert calls["wmedian"][-1] == {"B": 1, "H": 32, "W": 40, "C": 3, "hsz": 7}
    assert calls["cg"][-1]["H"] == 32 and calls["cg"][-1]["iters"] is None  # the CPU has no kernel counter
