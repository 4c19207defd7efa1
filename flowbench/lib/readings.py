"""Arithmetic shared by the metric readers (``flowbench/metrics/<name>.py``).

Every reader takes the run's context: ``window`` (the measured calls),
``setup_s``, and in a traced run ``trace`` (``lib/trace.py::analyse``),
``ops`` (each operation's recorded calls), ``cg_iters`` (the port's
iteration counter over the traced calls) and ``peak`` (``lib/peaks.py``).
A reader that finds nothing to read returns None, and the metric is left
out of the result.
"""
from __future__ import annotations

import importlib


class ShareAbove100(ValueError):
    """A roofline share above 100%: the work is counted too high or the time misses part of it."""


def roofline_share(ctx, op: str):
    """100 x (the op's least time over the traced calls) / (device time launched inside its ranges)."""
    trace, peak = ctx.get("trace"), ctx.get("peak")
    calls = (ctx.get("ops") or {}).get(op) or []
    if trace is None or peak is None or not calls:
        return None
    device_s = trace["op_device_s"].get(op, 0.0)
    if device_s <= 0.0:
        return None
    work = importlib.import_module(f"flowbench.roofline.{op}").work
    least = importlib.import_module("flowbench.roofline").least_seconds
    total = 0.0
    for call in calls:
        if call.get("iters", 0) is None:  # a solve whose iterations the counter did not give
            return None
        total += least(*work(call), peak)
    share = 100.0 * total / device_s
    if share > 100.0:
        raise ShareAbove100(f"{op}_roofline_share reads {share}%: {total} s of least time in {device_s} s")
    return share


def per_pair(ctx, key: str, scale: float = 1.0):
    """A traced quantity ``trace[key]`` divided by the traced pairs."""
    trace = ctx.get("trace")
    if trace is None or not trace["pairs"]:
        return None
    return trace[key] * scale / trace["pairs"]


def percentile(values, q: float):
    """The ``q``-th percentile (0-100) of ``values``, linear between order statistics."""
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
