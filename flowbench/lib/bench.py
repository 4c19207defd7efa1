"""One run of one cell: set-up, an optional traced stretch, the measured window, the check, the metrics.

The order: import the port and load its kernel library, make the cell's
calls from the seed, warm up with one call of the cell's own shape (all
of that is ``setup_s``); in a traced run, trace a few calls; then run the
closed loop for ``seconds``, one call in flight, keeping every call's
latency and the flows of a seeded sample of the calls; read the memory
peak; free the program's device memory; recompute the sample's pairs with
the reference; and read the cell's metrics by name.
"""
from __future__ import annotations

import gc
import math
import time
import traceback

import numpy as np

from flowbench.lib import check, frames, manifest, port, trace, traffic
from flowbench.lib.peaks import peak_of


def _window(entry, calls, seconds: float, keep: int, seed: int):
    """Closed loop over ``calls`` for ``seconds``: (elapsed s, latencies s of the calls that returned, calls
    that raised, {call index: flows} of a seeded reservoir sample of ``keep`` calls).  The other calls'
    flows are dropped once returned, as a user's loop drops them once consumed."""
    rng = np.random.Generator(np.random.PCG64([int(seed), 11]))
    lat, kept, raised = [], {}, 0
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        try:
            out = entry(calls[k % len(calls)])
        except Exception:  # a failed call: counted, and the loop goes on
            raised += 1
            traceback.print_exc()
        else:
            lat.append(time.perf_counter() - t)
            if len(kept) < keep:
                kept[k] = out
            else:
                slot = int(rng.integers(0, k + 1))
                if slot < keep:
                    del kept[sorted(kept)[slot]]
                    kept[k] = out
        k += 1
    return time.perf_counter() - t0, lat, raised, kept


def _pairs_of(call) -> int:
    return 1 if call.im1.ndim == 3 else call.im1.shape[0]


def run_cell(spec: dict, seed: int, seconds: float, traced: bool, device: str, t0: float, pairs=None,
             wrap_entry=None, reference_dtype: str = "float32") -> dict:
    """The result of one run of the cell ``spec`` (:func:`manifest.resolve_cell`).  ``pairs`` replaces the
    traffic's pool, ``wrap_entry`` wraps the entry call and ``reference_dtype`` sets the reference's
    precision: all three for tests on the CPU, where the port runs its plain twins."""
    import torch

    config, mix, chk = spec["config"], spec["traffic"], spec["check"]
    cell = spec["workload"]["name"]
    if device != "cpu":
        port.load_port()
    if pairs is None:
        pairs = frames.load_pool(mix["pool"])
    calls = traffic.make_calls(mix, pairs, seed, device)
    entry = port.make_entry(config, mix, device)
    if wrap_entry is not None:
        entry = wrap_entry(entry)
    entry(calls[0])
    setup_s = time.time() - t0

    ctx = {"cell": cell, "setup_s": setup_s}
    kind = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    if traced:
        stretch = [calls[(1 + i) % len(calls)] for i in range(int(mix.get("trace_calls", 2)))]
        port.reset_counters()
        ranges = port.OpRanges()
        events = trace.record(stretch, entry, ranges) if device != "cpu" else []
        ctx["trace"] = trace.analyse(events, sum(_pairs_of(c) for c in stretch))
        ctx["cg_iters"] = port.cg_iterations_total(device) if device != "cpu" else None
        ops = {op: list(c) for op, c in ranges.calls.items()}
        for call, iters in zip(ops["cg"], ranges.cg_iterations()):
            call["iters"] = iters
        ctx["ops"] = ops
        ctx["peak"] = peak_of(kind)
        del events, ranges

    batch = _pairs_of(calls[0])
    k = int(chk["sample_pairs"])
    seconds_done, lat, failed, kept = _window(entry, calls, seconds, k, seed)
    attempted = len(lat) + failed
    ctx["window"] = {"seconds": seconds_done, "calls": len(lat), "pairs": len(lat) * batch, "latencies_s": lat}
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if device != "cpu" else 0

    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    judged = []
    for ci, item in check.sample_items(sorted(kept), batch, k, seed):
        c = calls[ci % len(calls)]
        uv = kept[ci].numpy()
        if c.im1.ndim == 4:
            judged.append((c.im1[item], c.im2[item], uv[item]))
        else:
            judged.append((c.im1, c.im2, uv))
    checks = check.compare(judged, config["settings"], chk["numbers"], device, reference_dtype)
    correct = failed == 0 and all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in checks.values())

    metrics = {}
    for m in spec["per_layer"] if traced else spec["end_to_end"]:
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu", "kind": kind, "count": int(spec["workload"]["chips"]),
           "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if traced and ctx.get("trace"):
        dev["busy_s"] = ctx["trace"]["busy_s"]
        dev["window_s"] = ctx["trace"]["window_s"]
        result["breakdown"] = {"device_ops": ctx["trace"]["device_ops"], "idle_gaps": ctx["trace"]["idle_gaps"]}
    result["checks"] = checks
    return result


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the JAX package's, whole names compared."""
    banned = {"jax", "jaxlib", "flax", "optical_flow_tpu"}
    return sorted({name.split(".")[0] for name in modules} & banned)
