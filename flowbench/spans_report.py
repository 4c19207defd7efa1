"""The port's spans over a cell's traced stretch: six per-layer numbers and the per-level table.

    python3 flowbench/spans_report.py --workload <cell> --seed <n> [--calls k]

from the root of a checkout, on one CUDA card.  Set-up as ``run.py``'s
(the port, the cell's calls from the seed, one warm-up call), then ``k``
calls (default: the traffic's ``trace_calls``) under ``lib/trace.py::record``
with the benchmark's ranges.  Standard error gets the per-level table
(``lib/spans.py::level_table``); the last line of standard output is one
JSON object: the six span readers' values, ``plain_ops_device_ms``, the
traced window and idle time a pair, the port's spans a pair, the share of
device time inside the port's spans that falls under a span deeper than
``entry``, and the idle time by innermost span.  A program without the
spans reads null for the six.  Without a CUDA card it exits 2.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
READERS = ("prepare_ms_per_pair", "level_idle_ms_per_pair", "nonlevel_idle_ms_per_pair", "warp_device_ms",
           "system_device_ms", "pyramid_device_ms", "plain_ops_device_ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=None)
    args = ap.parse_args(argv)

    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    from flowbench.lib import frames, manifest, port, spans, trace, traffic

    spec = manifest.resolve_cell(manifest.load_manifest(), args.workload)
    if not torch.cuda.is_available():
        print("spans_report: needs a CUDA card", file=sys.stderr)
        return 2
    mix = spec["traffic"]
    port.load_port()
    calls = traffic.make_calls(mix, frames.load_pool(mix["pool"]), args.seed, "cuda")
    entry = port.make_entry(spec["config"], mix, "cuda")
    entry(calls[0])
    n = int(mix.get("trace_calls", 2)) if args.calls is None else args.calls
    stretch = [calls[(1 + i) % len(calls)] for i in range(n)]
    pairs = sum(1 if c.im1.ndim == 3 else c.im1.shape[0] for c in stretch)
    port.reset_counters()
    events = trace.record(stretch, entry, port.OpRanges())
    records = spans.port_records()
    ctx = {"trace": trace.analyse(events, pairs), "spans": spans.analyse(events, pairs, records)}
    del events
    out = {name: manifest.reader(name)(ctx) for name in READERS}
    t, s = ctx["trace"], ctx["spans"]
    out.update({
        "pairs": pairs,
        "window_ms_per_pair": 1000.0 * t["window_s"] / pairs,
        "idle_ms_per_pair": 1000.0 * (t["window_s"] - t["busy_s"]) / pairs,
        "spans_per_pair": None if records is None else len(records) / pairs,
        "deep_share": None if s is None else s["deep_share"],
        "idle_by_span": None if s is None else s["idle_by_span"],
        "setup_s": time.time() - T0,
        "card": torch.cuda.get_device_name(0),
    })
    for line in spans.level_table(s):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
