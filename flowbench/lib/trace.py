"""A traced stretch of calls and what the device did in it, read from ``torch.profiler``'s Chrome trace.

Device activity is every ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
event.  Each is tied by its correlation id to the host's launch call, and
through it to the innermost ``flowbench.<op>`` range open on that thread
at the launch: that is how device time is attributed to an operation,
never by kernel name.  The traced window runs from the first call's issue
to the last call's end (each call ends with its flows on the host).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
PREFIX = "flowbench."


def record(calls, entry, ranges):
    """Run ``entry`` on each prepared call under the profiler, inside ``ranges`` (a :class:`OpRanges`);
    returns the trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with ranges, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for c in calls:
            with record_function(PREFIX + "entry"):
                entry(c)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="flowbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _index(spans):
    """Per thread: span starts, the spans sorted by start, and the running maximum of their ends."""
    by_tid = defaultdict(list)
    for tid, s, e, name in spans:
        by_tid[tid].append((s, e, name))
    out = {}
    for tid, lst in by_tid.items():
        lst.sort()
        ends, m = [], float("-inf")
        for _, e, _ in lst:
            m = max(m, e)
            ends.append(m)
        out[tid] = ([s for s, _, _ in lst], lst, ends)
    return out


def _innermost(index, tid, t):
    """The name of the innermost (latest-starting) span of ``tid`` open at time ``t``, or None."""
    starts, spans, max_end = index.get(tid, ([], [], []))
    for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if max_end[j] < t:  # every earlier span has ended
            return None
        if spans[j][1] >= t:
            return spans[j][2]
    return None


def analyse(events, n_pairs: int):
    """Per-op device time, launches, copies, busy time and idle gaps of a traced stretch."""
    ranges, host_ops, launches, device = [], [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(PREFIX):
            ranges.append((ev["tid"], s, s + d, name[len(PREFIX):]))
        elif cat in HOST_CATS:
            host_ops.append((ev["tid"], s, s + d, name))
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev["tid"], s)
        elif cat in DEVICE_CATS:
            device.append((cat, name, s, d, ev.get("args", {}).get("correlation")))
    entries = sorted((s, e) for _, s, e, n in ranges if n == "entry")
    if not entries:
        return None
    w0, w1 = entries[0][0], max(e for _, e in entries)
    op_ranges = _index([r for r in ranges if r[3] != "entry"])
    entry_ranges = _index([r for r in ranges if r[3] == "entry"])

    by_op = defaultdict(float)
    by_name = defaultdict(float)
    kernels = h2d = 0
    h2d_us = plain_us = 0.0
    intervals = []
    for cat, name, s, d, corr in device:
        if s + d < w0 or s > w1:
            continue
        intervals.append((s, s + d))
        op = None
        if corr in launches:
            op = _innermost(op_ranges, *launches[corr])
        if op == "probe":
            continue
        by_name[name] += d
        if cat == "gpu_memcpy" and "HtoD" in name:
            h2d += 1
            h2d_us += d
            continue
        if cat == "kernel":
            kernels += 1
        if op is None:
            if cat != "gpu_memcpy" or "DtoD" in name:
                plain_us += d
        else:
            by_op[op] += d

    busy = _union(intervals)
    busy_us = sum(min(e, w1) - max(s, w0) for s, e in busy if e > w0 and s < w1)
    host_index = _index(host_ops)
    gaps = defaultdict(float)
    prev = w0
    main_tids = {tid for tid, _, _, n in ranges if n == "entry"}
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            mid = (prev + s) / 2.0
            label = None
            for tid in main_tids:
                inner = _innermost(entry_ranges, tid, mid) and (_innermost(op_ranges, tid, mid) or "entry")
                if inner:
                    label = f"{inner}/{_innermost(host_index, tid, mid) or 'python'}"
                    break
            gaps[label or "between_calls"] += (s - prev) / 1e6
        prev = max(prev, e)

    window_s = (w1 - w0) / 1e6
    return {
        "pairs": n_pairs,
        "window_s": window_s,
        "busy_s": busy_us / 1e6,
        "kernels": kernels,
        "h2d_copies": h2d,
        "h2d_s": h2d_us / 1e6,
        "plain_s": plain_us / 1e6,
        "op_device_s": {k: v / 1e6 for k, v in by_op.items()},
        "device_ops": sorted(([n, v / 1e6] for n, v in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, v] for n, v in gaps.items()), key=lambda x: -x[1])[:10],
    }
