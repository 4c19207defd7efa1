#!/usr/bin/env python
"""Demo of the PyTorch / CUDA port: flow on a Middlebury pair, two ways.

    python examples/torch_demo.py [sequence] [method] [--device cuda|cpu] [--out flow.png]

1. ``estimate_flow(im1, im2, method, params, device)``, the one-call surface;
2. the method object, as the JAX package's callers hold it: set
   ``ope.images`` (the gray pair) and ``ope.color_images`` (the Lab guide),
   call ``ope.compute_flow()``, then warm-start ``ope.compute_flow(init=uv)``.

Both run on the card by default (no GPU: the call raises); the CPU runs only
when asked for by name (``--device cpu``), in float32, with the kernels' plain
versions.  With matplotlib installed the flow is saved as a Middlebury
colour image.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence", nargs="?", default="RubberWhale")
    ap.add_argument("method", nargs="?", default="classic+nl-fast")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default=None, help="optional colour-coded flow image (needs matplotlib)")
    args = ap.parse_args()

    import torch

    from optical_flow_tpu_torch import estimate_flow, flow_angular_error, load_of_method, read_flow_file
    from optical_flow_tpu_torch.interface import prepare_pair, resolve_device

    dev = resolve_device(args.device, "torch_demo")
    params = {"display": False}
    im1, im2, tu, tv = read_flow_file(args.sequence, 10)
    print(f"{args.sequence}: {im1.shape[1]}x{im1.shape[0]}, method {args.method}, device {dev}")

    def report(label, uv, seconds):
        uv = uv.cpu().numpy()
        aae, stdae, aepe = flow_angular_error(tu, tv, uv[:, :, 0], uv[:, :, 1])
        print(f"{label}: {seconds:.2f} s, AAE {aae:.3f}  STD {stdae:.3f}  AEPE {aepe:.4f}")
        return uv

    t0 = time.time()
    uv = estimate_flow(im1, im2, args.method, params, device=dev)
    report("estimate_flow", uv, time.time() - t0)

    ope = load_of_method(args.method)
    ope.parse_input_parameter(params)
    with torch.no_grad():
        ope.images, color = prepare_pair(ope, im1, im2, dev)
        if ope.color_images is not None:
            ope.color_images = color
        t0 = time.time()
        uv_obj = ope.compute_flow()
        report("ope.compute_flow()", uv_obj, time.time() - t0)
        print(f"  equal to estimate_flow's: {torch.equal(uv_obj, uv)}")
        t0 = time.time()
        flow = report("ope.compute_flow(init=uv)", ope.compute_flow(init=uv_obj), time.time() - t0)

    if args.out:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from optical_flow_tpu_torch.viz import plot_flow

        fig, ax = plt.subplots(figsize=(8, 6))
        plot_flow(flow, style="color", ax=ax)
        fig.savefig(args.out, dpi=120)
        print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
