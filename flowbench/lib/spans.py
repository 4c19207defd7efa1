"""The port's own spans (``oftpu.<name>``) in a traced stretch: device time and idle gaps by layer.

The port opens a ``record_function`` range ``oftpu.<name>`` at each layer
boundary while a profiler records (``optical_flow_tpu_torch/utils/
profiling.py::annotate``).  Over the events of :func:`flowbench.lib.trace.record`:

* each device operation goes to the innermost ``oftpu.*`` span open on its
  launching thread at the launch (tied by correlation id, as
  ``lib/trace.py`` ties it to the benchmark's own ranges);
* each idle gap of the device goes to the innermost ``oftpu.*`` span open on
  the calling thread at the gap's midpoint.  A gap inside ``flowbench.entry``
  with no port span open is ``readback`` after the port's ``entry`` span of
  that call has ended, else ``caller``; a gap outside every
  ``flowbench.entry`` is ``between_calls`` and counts in neither sum.

``warp``, ``system`` and ``pyramid`` (with ``resample``) device time counts
what ``plain_ops_device_ms`` counts: kernels, memsets and device-to-device
copies launched outside the four ``flowbench.<op>`` ranges.  A program
without the spans (no ``oftpu.entry`` event) reads None.
"""
from __future__ import annotations

import bisect
import importlib
from collections import defaultdict

from flowbench.lib.trace import DEVICE_CATS, LAUNCH_CATS, PREFIX, _index, _innermost, _union

SPAN_PREFIX = "oftpu."
PORT_PROFILING = "optical_flow_tpu_torch.utils.profiling"
PLAIN_LAYERS = {"warp": "warp", "system": "system", "pyramid": "pyramid", "resample": "pyramid"}


def port_records():
    """The port's span records of the traced calls, or None where the port keeps none."""
    try:
        return importlib.import_module(PORT_PROFILING).span_records()
    except (ImportError, AttributeError):
        return None


def _sorted_spans(spans):
    """Per thread: the (start, end) of ``spans`` [(tid, start, end, name)] sorted by start."""
    out = defaultdict(list)
    for tid, s, e, _ in spans:
        out[tid].append((s, e))
    return {tid: sorted(v) for tid, v in out.items()}


def _last_started(sorted_spans, tid, t):
    """The (start, end) of the latest span of ``tid`` that started at or before ``t``, or None."""
    lst = sorted_spans.get(tid, [])
    j = bisect.bisect_right(lst, (t, float("inf"))) - 1
    return lst[j] if j >= 0 else None


def _levels(ports, records, launches, device, gaps):
    """{(stage, level, H, W): [wall s, device s, idle s, launches]} over the ``oftpu.level`` spans, their
    attributes joined from ``records`` by start order; None where the spans lie on more than one thread
    or names or counts disagree."""
    if not records or len({tid for tid, _, _, _ in ports}) != 1 or len(records) != len(ports):
        return None
    ordered = sorted(ports, key=lambda p: (p[1], -p[2]))
    if any(name != r["name"] for (_, _, _, name), r in zip(ordered, records)):
        return None
    levels = [(tid, s, e, (r["attrs"]["stage"], r["attrs"]["level"], r["attrs"]["H"], r["attrs"]["W"]))
              for (tid, s, e, name), r in zip(ordered, records) if name == "level"]
    table = defaultdict(lambda: [0.0, 0.0, 0.0, 0])
    index = _index([(tid, s, e, k) for k, (tid, s, e, _) in enumerate(levels)])
    for tid, s, e, key in levels:
        table[key][0] += (e - s) / 1e6
    for cat, _, _, d, corr in device:
        if corr in launches:
            k = _innermost(index, *launches[corr])
            if k is not None:
                row = table[levels[k][3]]
                row[1] += d / 1e6
                row[3] += cat == "kernel"
    for tid, mid, length in gaps:
        k = _innermost(index, tid, mid)
        if k is not None:
            table[levels[k][3]][2] += length / 1e6
    return dict(table)


def analyse(events, n_pairs: int, records=None):
    """Device time and idle time by port span over a traced stretch of ``n_pairs`` pairs; None without
    the benchmark's ``flowbench.entry`` ranges or the port's ``oftpu.entry`` spans.  ``records`` (the
    port's span records of the same calls) adds the per-level table."""
    ports, entries, ops, launches, device = [], [], [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            ports.append((ev["tid"], s, s + d, name[len(SPAN_PREFIX):]))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            (entries if name == PREFIX + "entry" else ops).append((ev["tid"], s, s + d, name[len(PREFIX):]))
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev["tid"], s)
        elif cat in DEVICE_CATS:
            device.append((cat, name, s, d, ev.get("args", {}).get("correlation")))
    if not entries or not any(n == "entry" for _, _, _, n in ports):
        return None
    w0, w1 = min(s for _, s, _, _ in entries), max(e for _, _, e, _ in entries)
    port_index, op_index = _index(ports), _index(ops)
    entry_index = _index(entries)
    level_index = _index([p for p in ports if p[3] == "level"])
    port_entries = _sorted_spans([p for p in ports if p[3] == "entry"])
    bench_entries = _sorted_spans(entries)

    device_s = defaultdict(float)  # plain device time by layer (PLAIN_LAYERS)
    in_entry = deep = 0.0
    intervals = []
    for cat, name, s, d, corr in device:
        if s + d < w0 or s > w1:
            continue
        intervals.append((s, s + d))
        if corr not in launches:
            continue
        tid, t = launches[corr]
        span = _innermost(port_index, tid, t)
        if span is not None:
            in_entry += d
            deep += d if span != "entry" else 0.0
        op = _innermost(op_index, tid, t)
        if op is None and span in PLAIN_LAYERS and (cat != "gpu_memcpy" or "DtoD" in name):
            device_s[PLAIN_LAYERS[span]] += d

    idle = defaultdict(float)  # idle s by the innermost port span (or readback / caller / between_calls)
    level_idle = nonlevel_idle = 0.0
    gaps = []  # (tid, midpoint, length) of the gaps inside a flowbench.entry
    main_tids = sorted({tid for tid, _, _, _ in entries})
    prev = w0
    for s, e in _union(intervals) + [[w1, w1]]:
        if s > prev:
            mid, length = (prev + s) / 2.0, s - prev
            label = "between_calls"
            for tid in main_tids:
                if _innermost(entry_index, tid, mid) is None:
                    continue
                gaps.append((tid, mid, length))
                label = _innermost(port_index, tid, mid)
                if label is None:
                    call0 = _last_started(bench_entries, tid, mid)[0]
                    port = _last_started(port_entries, tid, mid)
                    label = "readback" if port is not None and port[0] >= call0 and port[1] < mid else "caller"
                if _innermost(level_index, tid, mid) is not None:
                    level_idle += length
                else:
                    nonlevel_idle += length
                break
            idle[label] += length / 1e6
        prev = max(prev, e)

    prepare = sum(e - s for _, s, e, n in ports if n == "prepare")
    return {
        "pairs": n_pairs,
        "prepare_s": prepare / 1e6,
        "level_idle_s": level_idle / 1e6,
        "nonlevel_idle_s": nonlevel_idle / 1e6,
        "warp_s": device_s["warp"] / 1e6,
        "system_s": device_s["system"] / 1e6,
        "pyramid_s": device_s["pyramid"] / 1e6,
        "deep_share": deep / in_entry if in_entry else None,
        "idle_by_span": sorted(([n, v] for n, v in idle.items()), key=lambda x: -x[1]),
        "levels": _levels(ports, records, launches, device, gaps),
    }


def per_pair_ms(ctx, key: str):
    """``ctx["spans"][key]`` (seconds over the traced stretch) in ms a pair, or None."""
    spans = ctx.get("spans")
    if spans is None or not spans["pairs"]:
        return None
    return spans[key] * 1000.0 / spans["pairs"]


def level_table(spans) -> list:
    """Lines of the per-level table, ms and launches a pair by (stage, level, H x W); [] without one."""
    if spans is None or not spans.get("levels"):
        return []
    n = spans["pairs"]
    lines = [f"{'stage':>5} {'level':>5} {'H x W':>11} {'wall ms':>9} {'device ms':>9} {'idle ms':>9} "
             f"{'launches':>9}"]
    for (stage, level, H, W), (wall, dev, idle, launches) in sorted(spans["levels"].items(),
                                                                    key=lambda kv: (kv[0][0], -kv[0][1])):
        lines.append(f"{stage:>5} {level:>5} {f'{H}x{W}':>11} {1000 * wall / n:9.3f} {1000 * dev / n:9.3f} "
                     f"{1000 * idle / n:9.3f} {launches / n:9.1f}")
    return lines
