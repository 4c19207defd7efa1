"""The benchmark of ``optical_flow_tpu_torch`` on one NVIDIA card: one run of one cell.

    python3 flowbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cells; each
names a configuration (``flowbench/configs``) and a traffic mix
(``flowbench/traffic``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, the cell's end-to-end
metrics (``--trace 0``) or its per-layer metrics (``--trace 1``), the
device, in a traced run the breakdown, and last the numbers of the
correctness check beside their limits, which also end standard error.
Without a CUDA card, or with fewer cards than the cell asks for, it
exits 2 and prints no result; with JAX or the JAX package loaded, 3.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["OMP_NUM_THREADS"] = "1"  # one process, one host thread: the port's host work is dispatch
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    from flowbench.lib import bench, manifest

    spec = manifest.resolve_cell(manifest.load_manifest(), args.workload)
    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"flowbench: the cell needs {chips} CUDA card(s); "
              f"available {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = bench.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = bench.forbidden_modules(sys.modules)
    if found:
        print(f"flowbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"card: {_card_line()}; memory_peak_bytes {result['device']['memory_peak_bytes']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
