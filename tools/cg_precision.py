#!/usr/bin/env python
"""How far each PCG solve of a main-path frame lands from exact arithmetic.

    python3 tools/cg_precision.py

Records the 21 PCG systems of one RubberWhale classic+nl-fast frame on the
GPU and solves each with: the resident kernel, the streaming kernel, the
plain twin (float32 state, float32 sums), the plain twin with its dot
products in float64 (float32 state, the kernels' summation type), and the
plain twin in float64 throughout.  For each it prints the iterations and
max |x - x_float64| over the limit chip_smoke.py uses (1e-5 x max(|x|, 1)),
so one can tell whether a kernel's distance comes from its summation type
or from its own arithmetic.
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from optical_flow_tpu_torch import estimate_flow  # noqa: E402
from optical_flow_tpu_torch.io.flo import read_flow_file  # noqa: E402
from optical_flow_tpu_torch.ops.cuda import cg_kernel  # noqa: E402
from optical_flow_tpu_torch.ops.stencil import FlowSystem  # noqa: E402
from optical_flow_tpu_torch.solvers import cg as cg_solvers  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("cg_precision: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"card: {chip_smoke.card_line()}")
    rgb1, rgb2, _, _ = read_flow_file("RubberWhale", 10)
    recorded, call = [], cg_solvers.cg_solve

    def recording(sysm, rtol, maxiter):
        recorded.append((FlowSystem(*[f.contiguous().clone() for f in sysm]), rtol, maxiter))
        return call(sysm, rtol, maxiter)

    cg_solvers.cg_solve = recording
    try:
        estimate_flow(rgb1, rgb2, "classic+nl-fast", chip_smoke.PARAMS, device=dev)
    finally:
        cg_solvers.cg_solve = call
    for n, (sysm, rtol, maxiter) in enumerate(recorded, 1):
        H, W = sysm.a11.shape
        x64, k64 = chip_smoke.cg_twin(torch, FlowSystem(*[f.double() for f in sysm]), rtol, maxiter)
        limit = 1e-5 * max(float(x64.abs().max()), 1.0)
        runs = {}
        runs["resident"] = (cg_kernel.cg_solve(sysm, rtol, maxiter), cg_kernel.iteration_counts(dev)[0])
        runs["streaming"] = (cg_kernel.launch(list(sysm), rtol, maxiter, cg_kernel.CgPlan("streaming")),
                             cg_kernel.iteration_counts(dev)[0])
        runs["twin f32 sums"] = chip_smoke.cg_twin(torch, sysm, rtol, maxiter)
        runs["twin f64 sums"] = chip_smoke.cg_twin(torch, sysm, rtol, maxiter, sums=torch.float64)
        parts = [f"{name} {k} it {float((x.double() - x64).abs().max()) / limit:.3f}" for name, (x, k) in runs.items()]
        print(f"system {n} {H}x{W}: float64 twin {k64} it; max|x - x_float64| / limit: " + ", ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
