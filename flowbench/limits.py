"""Readings that the correctness limits are set from, at a cell's own sizes.

    python3 flowbench/limits.py --workload <cell> --seeds 11 12 13 [--pairs 4] [--control-seeds 3] [--twin-seeds 2]

For each seed: the cell's calls, the check's seeded sample of their pairs,
the program's flows through the cell's own entry point and the reference
(float32 planes, float64 sums).  On the first ``--control-seeds`` seeds
also the control, the same reference on bfloat16 planes; on the first
``--twin-seeds`` seeds also the port with its kernels' plain twins in
their place (float32 sums in another order: a second sound reading).
Prints one JSON line a pair with the gap statistics against the reference
(``lib/check.py::gap_stats``) and the seconds each took, and one line a
seed with the worst over its pairs, as a run's check takes it.
"""
import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def plain_twins():
    """The port's PCG and weighted-median calls sent to their plain twins, restored after."""
    cg = importlib.import_module("optical_flow_tpu_torch.solvers.cg")
    wm = importlib.import_module("optical_flow_tpu_torch.ops.wmedian")
    cgk = importlib.import_module("optical_flow_tpu_torch.ops.cuda.cg_kernel")
    wmk = importlib.import_module("optical_flow_tpu_torch.ops.cuda.wmedian_kernel")
    saved = cg.cg_solve, wm.wmedian
    cg.cg_solve, wm.wmedian = cgk.cg_solve_plain, wmk.wmedian_plain
    try:
        yield
    finally:
        cg.cg_solve, wm.wmedian = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--pairs", type=int, default=None, help="pairs a seed (default: the check's sample)")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--twin-seeds", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from flowbench.lib import check, frames, manifest, port, traffic

    spec = manifest.resolve_cell(manifest.load_manifest(), args.workload)
    mix, settings = spec["traffic"], spec["config"]["settings"]
    k = args.pairs or int(spec["check"]["sample_pairs"])
    if args.device != "cpu":
        port.load_port()
    pairs = frames.load_pool(mix["pool"])
    entry = port.make_entry(spec["config"], mix, args.device)
    for i, seed in enumerate(args.seeds):
        calls = traffic.make_calls(mix, pairs, seed, args.device)
        batch = 1 if calls[0].im1.ndim == 3 else calls[0].im1.shape[0]
        sample = check.sample_items(list(range(len(calls))), batch, k, seed)
        flows, twins, t_prog = {}, {}, 0.0
        for ci in sorted({ci for ci, _ in sample}):
            t = time.perf_counter()
            flows[ci] = entry(calls[ci]).numpy()
            t_prog += time.perf_counter() - t
            if i < args.twin_seeds:
                with plain_twins():
                    twins[ci] = entry(calls[ci]).numpy()
        worst = {}
        for ci, item in sample:
            c = calls[ci]
            a, b = (c.im1[item], c.im2[item]) if batch > 1 else (c.im1, c.im2)
            pick = (lambda f: f[item]) if batch > 1 else (lambda f: f)
            t = time.perf_counter()
            ref = check.reference_of(a, b, settings, args.device)
            t_ref = time.perf_counter() - t
            line = {"seed": seed, "call": ci, "item": item, "pair": c.items[item],
                    "program": check.gap_stats(pick(flows[ci]), ref)}
            if ci in twins:
                line["twins"] = check.gap_stats(pick(twins[ci]), ref)
            if i < args.control_seeds:
                line["control"] = check.gap_stats(check.reference_of(a, b, settings, args.device, control=True), ref)
            line |= {"program_s": t_prog, "reference_s": t_ref}
            print(json.dumps(line), flush=True)
            for side in ("program", "twins", "control"):
                for stat, v in line.get(side, {}).items():
                    worst.setdefault(side, {})[stat] = max(worst.get(side, {}).get(stat, 0.0), v)
        print(json.dumps({"seed": seed, "worst": worst}), flush=True)
        del calls, flows, twins
        if args.device != "cpu":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
