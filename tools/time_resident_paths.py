#!/usr/bin/env python
"""Time the PCG and ROF kernels' resident and large-image (streaming, tiled) paths on one GPU.

    python3 tools/time_resident_paths.py

For each main-path level shape, a seeded random flow system solved with
rtol 0 (the loop runs until the residual is exactly 0 or 200 iterations):
the streaming kernel, the resident plan ``cg_plan`` chooses, and one block
per row band with 8 pixels a thread, in turns, with iterations and
microseconds per iteration.  Then the RubberWhale IRLS system (rtol 1e-3,
200 iterations), the grid-wide exchange alone (132 one-row bands of 8
pixels, next to no work), and ROF at 2x388x584 on both paths.  Every time
is a CUDA-event mean after one warm-up; the card's name and power limit
come first.  It prints only; ``chip_smoke.py`` holds the kernels to their
twins.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from optical_flow_tpu_torch.io.flo import read_flow_file  # noqa: E402
from optical_flow_tpu_torch.ops.cuda import build, cg_kernel, rof_kernel  # noqa: E402
from optical_flow_tpu_torch.ops.stencil import FlowSystem  # noqa: E402

LEVELS = [(388, 584), (310, 467), (194, 292), (97, 146), (49, 73), (25, 37)]


def main():
    if not torch.cuda.is_available():
        print("time_resident_paths: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"card: {chip_smoke.card_line()}")
    limits = build.device_limits(dev)
    rng = np.random.default_rng(0)

    def per_iteration(planes, rtol, plan):
        ms = chip_smoke.cuda_ms(torch, lambda: cg_kernel.launch(planes, rtol, 200, plan), 10)
        it = cg_kernel.iteration_counts(dev)[0]
        return f"{ms:.4f} ms / {it} it = {1e3 * ms / max(it, 1):.2f} us"

    for H, W in LEVELS:
        planes = list(chip_smoke._random_flow_system(torch, dev, rng, H, W))
        plan = cg_kernel.cg_plan(1, H, W, *limits)
        streaming = cg_kernel.streaming_plan(H, W, limits[0])
        nb = min(limits[0], H)
        rows = -(-H // nb)
        bands = cg_kernel.CgPlan("resident", nb, 8, cg_kernel.resident_smem(rows, W))
        runs = [("streaming", streaming), (plan.path, plan), ("bands, 8 px", bands), (plan.path, plan),
                ("streaming", streaming)]
        print(f"cg {H}x{W} rtol 0 ({plan}): "
              + "; ".join(f"{name} {per_iteration(planes, 0.0, p)}" for name, p in runs), flush=True)

    rgb1, rgb2, tu, tv = read_flow_file("RubberWhale", 10)
    irls = [f.contiguous() for f in chip_smoke._irls_system(torch, dev, rgb1, rgb2, tu, tv)]
    plan = cg_kernel.cg_plan(1, 388, 584, *limits)
    streaming = cg_kernel.streaming_plan(388, 584, limits[0])
    runs = [("streaming", streaming), ("resident", plan), ("resident", plan), ("streaming", streaming)]
    print("cg irls 388x584 rtol 1e-3: " + "; ".join(f"{n} {per_iteration(irls, 1e-3, p)}" for n, p in runs))

    floor = list(chip_smoke._random_flow_system(torch, dev, rng, limits[0], 8))
    bands = cg_kernel.CgPlan("resident", limits[0], 1, cg_kernel.resident_smem(1, 8))
    print(f"cg {limits[0]} one-row bands of 8 px, rtol 0: {per_iteration(floor, 0.0, bands)}")

    im = torch.as_tensor(rng.uniform(-1, 1, (2, 388, 584)), dtype=torch.float32, device=dev)
    plan = rof_kernel.rof_plan(*im.shape, *limits)
    runs = [("tiled", rof_kernel.tiled_plan(100)), ("resident", plan), ("resident", plan),
            ("tiled", rof_kernel.tiled_plan(100))]
    print("rof 2x388x584, 100 iterations: " + "; ".join(
        f"{n} {chip_smoke.cuda_ms(torch, lambda p=p: rof_kernel.launch(im, 1.0 / 8, 100, p), 10):.4f} ms" for n, p in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
