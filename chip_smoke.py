#!/usr/bin/env python
"""Smoke test of the PyTorch / CUDA port (``optical_flow_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results; any failed check exits non-zero:

1. the card (name and power limit from nvidia-smi), torch and CUDA versions,
   the float32 matmul settings, and the build of the three CUDA kernels
   from ``optical_flow_tpu_torch/csrc`` (ptxas registers and spills);
2. each kernel against its plain PyTorch twin on the card at main-path
   shapes, with both times (CUDA events); for the weighted median also
   window half-sizes 0, 1 and 12, the coarsest main-path level and a
   repeat run (determinism); for PCG and ROF both paths (resident at the
   main path's shapes, streaming above the resident limit), repeat runs,
   and the streaming kernels (the previous design, unchanged) timed in
   turns with the resident ones on the same input;
3. the main path, ``estimate_flow(rgb1, rgb2, "classic+nl-fast",
   {"display": False, "solver": "pcg"}, device="cuda")`` on RubberWhale
   584x388: finite output, AAE / AEPE against the ground truth within the
   classic+nl-fast gate, the kernels' launch counts for one frame (by
   path), and the per-frame latency;
4. the weighted median on the inputs the main path gave it (recorded in a
   warm-up frame): kernel against twin at the finest level, one call's
   time at each level shape, the 21 calls' sum, and each call's bound;
5. the 21 PCG systems of that warm-up frame: each against the twin (max
   |dx|, residual, iterations), one solve's time, microseconds per
   iteration and the bound at each level shape, and the 21 solves' sum;
6. one frame under torch.profiler: device busy time, idle share, the
   device time of each kernel and the ROF kernel's device launches.

The last line is one JSON object ``{"ok": true, "device": {...}}``; the
line before it is nvidia-smi's name and power limit; before that, one
JSON object lists each kernel with its time, its plain twin's time and
its bound (the larger of bytes over 3.35 TB/s and operations over the
67 TFLOP/s float32 peak of an H100 SXM), all from phase 2.  The weighted
median's and PCG's entries add phases 4 and 5 under ``main_path_*`` and
``frame_sum_*`` (the 21 calls summed); PCG's and ROF's add the previous
(streaming) kernel's time on phase 2's input as ``streaming_ms``.  Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.  It imports neither JAX nor the JAX package.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the classic+nl-fast gate of the JAX package on RubberWhale (float32 main path)
TARGET_AAE, TARGET_AEPE = 2.500, 0.0813
GATE_AAE, GATE_AEPE = 0.2, 0.01
PARAMS = {"display": False, "solver": "pcg"}
SEED = 0
# an H100 SXM's published peaks (float32 outside the tensor cores; HBM3)
PEAK_F32_OPS, PEAK_BYTES = 67e12, 3.35e12
INT32_MIN = -(2**31)


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0 and out.stdout.strip(), f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_setup(torch):
    from optical_flow_tpu_torch.ops.cuda import build

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device 0: {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(torch.get_float32_matmul_precision() == "highest", "float32 matmul precision is not 'highest'")
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    t0 = time.time()
    build.load_library()
    print(f"kernel build + load: {time.time() - t0:.1f} s (key {build.build_key()})")
    for name, regs, spill in ptxas_report(build.build_log):
        print(f"  ptxas: {name}: {regs} registers, {spill} bytes spill stores")
    return card


def ptxas_report(log):
    """[(kernel, registers, spill-store bytes)] from nvcc's -Xptxas -v log."""
    import re

    out, name, spill = [], "?", 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            rest = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "", m.group(1))
            args = re.findall(r"Li(\d+)E", rest)
            name = re.match(r"[a-z_]+", rest).group(0) + (f"<{','.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((name, int(m.group(1)), spill))
    return out


def _pad(torch, x, hsz, dev):
    from optical_flow_tpu_torch.ops.filters import pad2d

    return pad2d(torch.as_tensor(x, device=dev), hsz, hsz, hsz, hsz, "mirror").contiguous()


def sm_clock_during(torch, fn, seconds=1.0):
    """nvidia-smi's SM clock, its maximum and the power draw, sampled every
    100 ms while ``fn`` runs back to back; the median sample."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t_end = time.time() + seconds
        while time.time() < t_end:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    rows = [[float(x) for x in line.split(",")] for line in out.strip().splitlines() if line.count(",") == 2]
    if not rows:
        return "not measured"
    clock, clock_max, power = rows[len(rows) // 2]
    return f"{clock:.0f} MHz (max {clock_max:.0f} MHz), {power:.1f} W drawn, median of {len(rows)} samples"


def bound(ops, nbytes):
    """The least time the card could take: operations over the float32 peak or
    bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _keys(torch, x):
    """float32 -> order-isomorphic int32 keys (as int64), as the kernel encodes them."""
    b = x.contiguous().view(torch.int32)
    return torch.where(b < 0, torch.bitwise_not(b) ^ INT32_MIN, b).long()


def wmedian_rounds(torch, args, out):
    """Bisection rounds the kernel ran for ``out``, summed over pixels and fields.

    The path from (min - 1, max) to the result key m is fixed by m, since
    S(mid) >= total/2 exactly when mid >= m."""
    u_pad, v_pad, _, _, (H, W), hsz, _ = args
    k = 2 * hsz + 1
    total = 0
    for c, field in enumerate((u_pad, v_pad)):
        win = _keys(torch, field).unfold(0, k, 1).unfold(1, k, 1)
        lo, hi = win.amin((-2, -1)) - 1, win.amax((-2, -1))
        m = _keys(torch, out[..., c])
        for _ in range(32):
            active = hi - lo > 1
            mid = torch.div(lo + hi, 2, rounding_mode="floor")
            ge = mid >= m
            hi = torch.where(active & ge, mid, hi)
            lo = torch.where(active & ~ge, mid, lo)
            total += int(active.sum())
    return total


def wmedian_bound(args):
    """Bound of one call, whatever the selection method: per pixel, K2 weights
    at 3C + 5 operations, then for each field a sort's K2 log2 K2 compares and
    K2 adds for the running sum."""
    u_pad, _, _, guide_pad, (H, W), hsz, _ = args
    C = guide_pad.shape[0]
    K2 = (2 * hsz + 1) ** 2
    ops = H * W * (K2 * (3 * C + 5) + 2 * (K2 * math.log2(K2) + K2))
    nbytes = 4 * ((3 + C) * u_pad.numel() + 2 * H * W)
    return bound(ops, nbytes)


def _wmedian_case(torch, dev, rng, H, W, hsz, C, ties=False, color_hi=255.0):
    uv = (3 * rng.standard_normal((H, W, 2))).astype(np.float32)
    if ties:
        uv = (np.round(rng.standard_normal((H, W, 2)) * 4) / 4).astype(np.float32)
    color = rng.uniform(0, color_hi, (C, H, W)).astype(np.float32)
    occ = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    return (_pad(torch, uv[..., 0], hsz, dev), _pad(torch, uv[..., 1], hsz, dev), _pad(torch, occ, hsz, dev),
            _pad(torch, color, hsz, dev), (H, W), hsz, 7.0)


def wmedian_agreement(torch, args, out, ref):
    """(values that differ, share identical, every difference is an adjacent sample).

    A differing value must be its window's sample adjacent (in sorted order)
    to the twin's choice: the two sums' orders can only move the total/2
    crossing across one sample."""
    u_pad, v_pad, _, _, _, hsz, _ = args
    diff = out != ref
    n_diff = int(diff.sum())
    adjacent = True
    k = 2 * hsz + 1
    for y, x, c in diff.nonzero().tolist():
        win = (u_pad if c == 0 else v_pad)[y : y + k, x : x + k].reshape(-1)
        a, b = out[y, x, c], ref[y, x, c]
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        present = bool((win == a).any()) and bool((win == b).any())
        between = int(((win > lo) & (win < hi)).sum())
        adjacent = adjacent and present and between == 0
    return n_diff, 1.0 - n_diff / out.numel(), adjacent


def check_wmedian(torch, dev, card, rng):
    from optical_flow_tpu_torch.ops.cuda.wmedian_kernel import wmedian, wmedian_plain

    cases = [((19, 23), 3, 3, False), ((40, 300), 7, 3, False), ((16, 260), 2, 1, False), ((12, 140), 4, 3, True)]
    for (H, W), hsz, C, ties in cases:
        args = _wmedian_case(torch, dev, rng, H, W, hsz, C, ties)
        out = wmedian(*args)
        ref = wmedian_plain(*args)
        torch.cuda.synchronize()
        n_diff = int((out != ref).sum())
        print(f"wmedian {H}x{W} hsz {hsz} C {C}{' ties' if ties else ''}: {n_diff} differing values (bit-exact required)")
        check(n_diff == 0, "weighted median is not bit-exact with its twin on the test shapes")

    # the main path's finest level: 388x584, hsz 7, C 3
    H, W, hsz = 388, 584, 7
    args = _wmedian_case(torch, dev, rng, H, W, hsz, 3)
    out = wmedian(*args)
    ref = wmedian_plain(*args)
    torch.cuda.synchronize()
    n_diff, frac, adjacent = wmedian_agreement(torch, args, out, ref)
    print(f"wmedian {H}x{W} hsz {hsz} C 3: {n_diff} of {out.numel()} values differ "
          f"({100 * frac:.4f}% identical), all adjacent samples: {adjacent}")
    check(frac >= 0.9999 and adjacent, "weighted median outside the adjacent-sample criterion at 388x584")
    ms = cuda_ms(torch, lambda: wmedian(*args), 10)
    plain_ms = cuda_ms(torch, lambda: wmedian_plain(*args), 3)
    print(f"wmedian 388x584 hsz 7: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms  [{card}]")
    again = wmedian(*args)
    torch.cuda.synchronize()
    print(f"wmedian 388x584 hsz 7, run twice: torch.equal {torch.equal(again, out)}")
    check(torch.equal(again, out), "weighted median differs between two runs on the same input")
    b = wmedian_bound(args)
    rounds = wmedian_rounds(torch, args, out) / (2 * H * W)
    print(f"wmedian 388x584 hsz 7 random fields: {rounds:.2f} rounds per pixel and field, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    result = {"max_abs_err": float((out - ref).abs().max()), "ms": ms, "plain_ms": plain_ms, **b}

    # window half-sizes 0, 1 and 12 (1, 1 and 32 lanes a pixel) with the
    # kernels for C 3 and for any other C, and the coarsest main-path levels,
    # on shapes that are no multiple of a tile; a narrow colour range spreads
    # the weights
    rng_new = np.random.default_rng(SEED + 1)
    for (H, W), hsz, C in [((27, 41), 0, 1), ((27, 41), 0, 3), ((23, 45), 1, 1), ((23, 45), 1, 3),
                           ((29, 43), 12, 1), ((29, 43), 12, 3), ((24, 37), 7, 3), ((25, 37), 7, 3)]:
        args = _wmedian_case(torch, dev, rng_new, H, W, hsz, C, color_hi=24.0)
        out = wmedian(*args)
        ref = wmedian_plain(*args)
        torch.cuda.synchronize()
        n_diff = int((out != ref).sum())
        print(f"wmedian {H}x{W} hsz {hsz} C {C} (colours 0-24): {n_diff} differing values (bit-exact required)")
        check(n_diff == 0, f"weighted median is not bit-exact with its twin at {H}x{W} hsz {hsz} C {C}")
    return result


def _irls_system(torch, dev, rgb1, rgb2, tu, tv):
    """The stage-2 (alpha 0) IRLS system of RubberWhale's finest level, at the GT flow."""
    from optical_flow_tpu_torch.config import load_of_method
    from optical_flow_tpu_torch.methods.ba import _preprocess_traced
    from optical_flow_tpu_torch.ops.derivatives import precompute_warp, warp_deriv
    from optical_flow_tpu_torch.ops.stencil import blend_systems, build_irls_system
    from optical_flow_tpu_torch.utils.compat import preprocess_color_pair

    ope = load_of_method("classic+nl-fast")
    ope.parse_input_parameter(PARAMS)
    cfg = ope._nl_cfg(True).irls
    f32 = torch.float32
    gray, _ = preprocess_color_pair(torch.as_tensor(rgb1, dtype=f32, device=dev), torch.as_tensor(rgb2, dtype=f32, device=dev))
    proc = _preprocess_traced("texture", gray, 0.95)
    gt = np.stack([tu, tv], -1)
    gt = np.where(np.abs(gt) < 1e9, gt, 0.0)
    uv = torch.as_tensor(gt, dtype=f32, device=dev)
    It, Ix, Iy = warp_deriv(precompute_warp(proc, cfg.interp, np.array(cfg.deriv_filter), cfg.blend), uv)
    duv = torch.zeros_like(uv)
    sys_q = build_irls_system(uv, duv, It, Ix, Iy, cfg.qua_rho_spatial_u, cfg.qua_rho_spatial_v, cfg.qua_rho_data, cfg.lambda_q)
    sys_r = build_irls_system(uv, duv, It, Ix, Iy, cfg.rho_spatial_u, cfg.rho_spatial_v, cfg.rho_data, cfg.lambda_)
    return blend_systems(0.0, sys_q, sys_r)


def cg_twin(torch, sysm, rtol, maxiter, sums=None):
    """The plain twin on ``sysm`` in its dtype: ((H, W, 2) solution, iterations).

    ``sums`` (a dtype) takes its dot products in that type, rounded back to
    the state's: with float64 it is the kernels' own summation type."""
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.ops.stencil import system_apply_split, weighted_laplacian_diag

    du = sysm.a11 + weighted_laplacian_diag(sysm.wu_h, sysm.wu_v)
    dv = sysm.a22 + weighted_laplacian_diag(sysm.wv_h, sysm.wv_v)
    dot = cg_kernel._dot2
    if sums is not None:
        def dot(au, av, bu, bv):
            return (au.to(sums) * bu.to(sums) + av.to(sums) * bv.to(sums)).sum().to(au.dtype)
    saved, cg_kernel._dot2 = cg_kernel._dot2, dot
    try:
        xu, xv, it_t = cg_kernel.pcg_solve_split(
            lambda a, b: system_apply_split(sysm, a, b),
            sysm.b_u, sysm.b_v, du, dv, rtol, maxiter, a12=sysm.a12, return_iters=True)
    finally:
        cg_kernel._dot2 = saved
    return torch.stack([xu, xv], -1), it_t


def cg_compare(torch, sysm, rtol, maxiter, x_k, it_k):
    """The kernel's solution against the plain twin's on the same system:
    (max |dx|, its limit 1e-5 x scale, relative residual in float64,
    iterations of the twin)."""
    from optical_flow_tpu_torch.ops.stencil import FlowSystem, system_apply

    x_t, it_t = cg_twin(torch, sysm, rtol, maxiter)
    scale = max(float(x_t.abs().max()), 1.0)
    err = float((x_k - x_t).abs().max())
    b = torch.stack([sysm.b_u, sysm.b_v], -1).double()
    res = float(torch.linalg.norm(system_apply(FlowSystem(*[f.double() for f in sysm]), x_k.double()) - b)
                / torch.linalg.norm(b))
    return err, 1e-5 * scale, res, it_t


def cg_bound(H, W, iters):
    """Per pixel: setup ~33 operations (preconditioner, z, two dots), then per
    iteration ~58 (A p 28, p.Ap 4, x 4, r 4, z 6, r.z 4, r.r 4, p 4); bytes:
    the 9 system planes in, the (H, W, 2) solution out."""
    return bound(H * W * (33 + 58 * iters), 4 * 11 * H * W)


def _random_flow_system(torch, dev, rng, H, W):
    from optical_flow_tpu_torch.ops.stencil import FlowSystem

    def u(*s):
        return rng.uniform(0.1, 1.0, s).astype(np.float32)

    w = [u(H, W) for _ in range(4)]
    w[0][:, -1] = 0
    w[2][:, -1] = 0
    w[1][-1, :] = 0
    w[3][-1, :] = 0
    fields = [u(H, W) + 1.0, 0.5 * u(H, W), u(H, W) + 1.0, *w, u(H, W), u(H, W)]
    return FlowSystem(*[torch.as_tensor(f, device=dev) for f in fields])


def check_cg(torch, dev, card, rng, rgb1, rgb2, tu, tv):
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits
    from optical_flow_tpu_torch.ops.stencil import FlowSystem

    limits = device_limits(dev)
    random_sys = _random_flow_system(torch, dev, rng, 388, 584)
    irls_sys = FlowSystem(*[f.contiguous() for f in _irls_system(torch, dev, rgb1, rgb2, tu, tv)])
    # above the resident limit: the streaming kernel (the previous design)
    big_sys = _random_flow_system(torch, dev, rng, 1200, 1600)
    result = None
    for name, sysm, rtol, maxiter, path in (("random", random_sys, 1e-6, 1000, "resident"),
                                           ("irls", irls_sys, 1e-3, 200, "resident"),
                                           ("random", big_sys, 1e-6, 100, "streaming")):
        H, W = sysm.a11.shape
        plan = cg_kernel.cg_plan(H, W, *limits)
        check(plan.path == path, f"cg {H}x{W}: path {plan.path}, expected {path}")
        x_k = cg_kernel.cg_solve(sysm, rtol, maxiter)
        it_k = cg_kernel.iteration_counts(dev)[0]
        again = cg_kernel.cg_solve(sysm, rtol, maxiter)
        err, limit, res, it_t = cg_compare(torch, sysm, rtol, maxiter, x_k, it_k)
        torch.cuda.synchronize()
        same = torch.equal(again, x_k)
        print(f"cg {name} {H}x{W} rtol {rtol:g} ({plan.path}, {plan.blocks} blocks, {plan.ppt} px a thread): "
              f"iterations kernel {it_k} / plain {it_t}, max|dx| {err:.3e} (limit {limit:.3e}), "
              f"relative residual {res:.3e} (limit {10 * rtol:g}), run twice: torch.equal {same}")
        check(err <= limit, f"cg {name} {H}x{W}: kernel differs from its twin")
        check(res <= 10 * rtol, f"cg {name} {H}x{W}: residual above 10 x rtol")
        check(same, f"cg {name} {H}x{W}: two runs differ")
        if name == "irls":
            planes = list(sysm)
            streaming = cg_kernel.CgPlan("streaming")
            # the previous kernel and the resident one in turns: s, r, r, s
            t = [cuda_ms(torch, lambda p=p: cg_kernel.launch(planes, rtol, maxiter, p), 10)
                 for p in (streaming, plan, plan, streaming)]
            ms, streaming_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            plain_ms = cuda_ms(torch, lambda: cg_kernel.cg_solve_plain(sysm, rtol, maxiter), 3)
            b = cg_bound(H, W, it_k)
            print(f"cg irls {H}x{W} rtol 1e-3 ({it_k} iterations): resident {t[1]:.3f} / {t[2]:.3f} ms "
                  f"({1e3 * ms / it_k:.2f} us an iteration), streaming (previous design) {t[0]:.3f} / {t[3]:.3f} ms "
                  f"({1e3 * streaming_ms / it_k:.2f} us), plain {plain_ms:.3f} ms, "
                  f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})  [{card}]")
            check(ms < streaming_ms, "cg: the resident kernel is not faster than the streaming one at 388x584")
            result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b, "streaming_ms": streaming_ms}
    return result


def check_rof(torch, dev, card, rgb1, rgb2):
    from optical_flow_tpu_torch.ops.cuda import rof_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits
    from optical_flow_tpu_torch.ops.cuda.rof_kernel import rof_structure, rof_structure_2d
    from optical_flow_tpu_torch.utils.compat import preprocess_color_pair, scale_image

    f32 = torch.float32
    limits = device_limits(dev)
    gray, _ = preprocess_color_pair(torch.as_tensor(rgb1, dtype=f32, device=dev), torch.as_tensor(rgb2, dtype=f32, device=dev))
    im = scale_image(gray, -1, 1).permute(2, 0, 1).contiguous()  # (2, 388, 584), the texture stage's input
    rng = np.random.default_rng(SEED + 2)
    cases = [("main-path input", im, "resident", 0.0),
             ("ragged bands", torch.as_tensor(rng.uniform(-1, 1, (2, 33, 47)), dtype=f32, device=dev), "resident", 0.0),
             ("ragged bands", torch.as_tensor(rng.uniform(-1, 1, (2, 100, 47)), dtype=f32, device=dev), "resident", 0.0),
             ("above the resident limit", torch.as_tensor(rng.uniform(-1, 1, (2, 1080, 1920)), dtype=f32, device=dev),
              "streaming", 1e-6)]
    for name, x, path, limit in cases:
        plan = rof_kernel.rof_plan(*x.shape, *limits)
        check(plan.path == path, f"rof {tuple(x.shape)}: path {plan.path}, expected {path}")
        out = rof_structure(x, 1.0 / 8, 100)
        ref = rof_structure_2d(x, 1.0 / 8, 100)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        print(f"rof {'x'.join(map(str, x.shape))} {name}, 100 iterations ({plan.path}): max|d| {err:.3e} (limit {limit:g})")
        check(err <= limit, f"ROF kernel differs from its twin at {tuple(x.shape)}")
        if x is im:
            result_err = err
    plan = rof_kernel.rof_plan(*im.shape, *limits)
    streaming = rof_kernel.RofPlan("streaming")
    # the previous kernel and the resident one in turns: s, r, r, s
    t = [cuda_ms(torch, lambda p=p: rof_kernel.launch(im, 1.0 / 8, 100, p), 10) for p in (streaming, plan, plan, streaming)]
    ms, streaming_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    plain_ms = cuda_ms(torch, lambda: rof_structure_2d(im, 1.0 / 8, 100), 3)
    # per pixel and iteration ~28 operations (the primal at three points 15,
    # the gradient 2, the dual step 4, the norm 5, the division 2), then 5 for
    # the final primal; bytes: the image in, the structure out
    n = im.numel()
    b = bound(n * (28 * 100 + 5), 8 * n)
    print(f"rof 2x388x584: resident {t[1]:.3f} / {t[2]:.3f} ms, streaming (previous design) {t[0]:.3f} / {t[3]:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})  [{card}]")
    return {"max_abs_err": result_err, "ms": ms, "plain_ms": plain_ms, **b, "streaming_ms": streaming_ms}


def phase_main_path(torch, dev, card, rgb1, rgb2, tu, tv):
    from optical_flow_tpu_torch import estimate_flow, flow_angular_error
    from optical_flow_tpu_torch.ops import wmedian as wmedian_op
    from optical_flow_tpu_torch.ops.cuda import cg_kernel, rof_kernel, wmedian_kernel
    from optical_flow_tpu_torch.solvers import cg as cg_solvers

    # warm-up (allocator, cuBLAS), keeping a copy of each weighted median's
    # and each PCG solve's inputs
    recorded, recorded_cg = [], []
    kernel_call, cg_call = wmedian_op.wmedian, cg_solvers.cg_solve

    def recording(*args):
        recorded.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return kernel_call(*args)

    def recording_cg(sysm, rtol, maxiter):
        recorded_cg.append((type(sysm)(*[f.clone() for f in sysm]), rtol, maxiter))
        return cg_call(sysm, rtol, maxiter)

    wmedian_op.wmedian, cg_solvers.cg_solve = recording, recording_cg
    try:
        estimate_flow(rgb1, rgb2, "classic+nl-fast", PARAMS, device=dev)
    finally:
        wmedian_op.wmedian, cg_solvers.cg_solve = kernel_call, cg_call
    torch.cuda.synchronize()

    wmedian_kernel.launches = 0
    rof_kernel.launches = rof_kernel.launches_resident = rof_kernel.launches_streaming = 0
    cg_kernel.reset_stats()
    uv = estimate_flow(rgb1, rgb2, "classic+nl-fast", PARAMS, device=dev)
    torch.cuda.synchronize()
    launches = {"wmedian": wmedian_kernel.launches, "cg": cg_kernel.launches, "rof": rof_kernel.launches}
    by_path = {"cg resident": cg_kernel.launches_resident, "cg streaming": cg_kernel.launches_streaming,
               "rof resident": rof_kernel.launches_resident, "rof streaming": rof_kernel.launches_streaming}
    cg_iters = cg_kernel.iteration_counts(uv.device)[1]

    uv_np = uv.cpu().numpy()
    check(uv_np.shape == (388, 584, 2) and uv_np.dtype == np.float32, f"unexpected flow {uv_np.shape} {uv_np.dtype}")
    check(np.isfinite(uv_np).all(), "flow is not finite")
    aae, _, aepe = flow_angular_error(tu, tv, uv_np[..., 0], uv_np[..., 1])
    print(f"main path RubberWhale 584x388 classic+nl-fast: AAE {aae:.4f} deg, AEPE {aepe:.5f} px "
          f"(JAX float32: {TARGET_AAE} / {TARGET_AEPE})")
    print(f"launches in one frame: {launches}, by path {by_path}, CG iterations {cg_iters}")
    check(abs(aae - TARGET_AAE) <= GATE_AAE and abs(aepe - TARGET_AEPE) <= GATE_AEPE, "accuracy outside the classic+nl-fast gate")
    check(launches["wmedian"] == 21 and launches["cg"] == 21 and launches["rof"] == 1, f"unexpected launch counts {launches}")
    check(by_path["cg resident"] == 21 and by_path["rof resident"] == 1, f"a main-path solve left the resident path: {by_path}")

    ev_ms, host_ms = [], []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        estimate_flow(rgb1, rgb2, "classic+nl-fast", PARAMS, device=dev)
        end.record()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        ev_ms.append(start.elapsed_time(end))
    frame_ms = statistics.median(ev_ms)
    print(f"per-frame latency, median of 5 warm runs: {frame_ms:.2f} ms (CUDA events), "
          f"{statistics.median(host_ms):.2f} ms (host clock)  [{card}]")
    return launches, recorded, recorded_cg, frame_ms


def phase_wmedian_levels(torch, card, recorded):
    """The weighted median on the main path's own inputs: kernel against twin at
    the finest level, one call's time at each level shape, and the frame's sum."""
    from optical_flow_tpu_torch.ops.cuda.wmedian_kernel import wmedian, wmedian_plain

    check(len(recorded) == 21, f"recorded {len(recorded)} weighted-median calls in a frame, expected 21")
    finest = max(recorded, key=lambda a: a[4][0] * a[4][1])
    H, W = finest[4]
    out = wmedian(*finest)
    ref = wmedian_plain(*finest)
    torch.cuda.synchronize()
    n_diff, frac, adjacent = wmedian_agreement(torch, finest, out, ref)
    print(f"wmedian main-path input {H}x{W} hsz {finest[5]}: {n_diff} of {out.numel()} values differ "
          f"({100 * frac:.4f}% identical), all adjacent samples: {adjacent}")
    check(frac >= 0.9999 and adjacent, "weighted median outside the adjacent-sample criterion on the main path's input")
    again = wmedian(*finest)
    torch.cuda.synchronize()
    check(torch.equal(again, out), "weighted median differs between two runs on the main path's input")
    ms = cuda_ms(torch, lambda: wmedian(*finest), 20)
    plain_ms = cuda_ms(torch, lambda: wmedian_plain(*finest), 3)
    b = wmedian_bound(finest)
    rounds = wmedian_rounds(torch, finest, out) / (2 * H * W)
    print(f"wmedian main-path input {H}x{W}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"{rounds:.2f} rounds per pixel and field, bound {b['bound_ms']:.4f} ms ({b['bound_by']})  [{card}]")
    print(f"SM clock while the weighted median runs: {sm_clock_during(torch, lambda: wmedian(*finest))}")

    levels, frame_ms, frame_bound = {}, 0.0, 0.0
    for args in recorded:
        frame_ms += cuda_ms(torch, lambda: wmedian(*args), 5)
        frame_bound += wmedian_bound(args)["bound_ms"]
        if args[4] not in levels:
            h, w = args[4]
            levels[args[4]] = (cuda_ms(torch, lambda: wmedian(*args), 20), wmedian_bound(args)["bound_ms"],
                               wmedian_rounds(torch, args, wmedian(*args)) / (2 * h * w))
    for (h, w), (t, cb, r) in levels.items():
        print(f"wmedian level {h}x{w}: {t:.4f} ms, {r:.2f} rounds per pixel and field, bound {cb:.4f} ms  [{card}]")
    print(f"wmedian, the frame's 21 calls one by one: {frame_ms:.3f} ms, bound {frame_bound:.4f} ms  [{card}]")
    return {"main_path_ms": ms, "main_path_plain_ms": plain_ms, "main_path_bound_ms": b["bound_ms"],
            "main_path_max_abs_err": float((out - ref).abs().max()),
            "frame_sum_ms": frame_ms, "frame_sum_bound_ms": frame_bound}


def phase_cg_levels(torch, dev, card, recorded):
    """The PCG kernel on the 21 systems of a main-path frame: each against the
    twin, one solve's time at each level shape, the 21 solves' sum."""
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits

    check(len(recorded) == 21, f"recorded {len(recorded)} PCG solves in a frame, expected 21")
    limits = device_limits(dev)
    levels, frame_ms, frame_bound, finest = {}, 0.0, 0.0, None
    for k, (sysm, rtol, maxiter) in enumerate(recorded):
        H, W = sysm.a11.shape
        plan = cg_kernel.cg_plan(H, W, *limits)
        x_k = cg_kernel.cg_solve(sysm, rtol, maxiter)
        it_k = cg_kernel.iteration_counts(dev)[0]
        again = cg_kernel.cg_solve(sysm, rtol, maxiter)
        err, limit, res, it_t = cg_compare(torch, sysm, rtol, maxiter, x_k, it_k)
        # the previous (streaming) kernel on the same system, for comparison
        x_s = cg_kernel.launch([f.contiguous() for f in sysm], rtol, maxiter, cg_kernel.CgPlan("streaming"))
        it_s = cg_kernel.iteration_counts(dev)[0]
        err_s = cg_compare(torch, sysm, rtol, maxiter, x_s, it_s)[0]
        # the twin sums in float32, the kernels in double: the twin with
        # double sums is the kernels' own recurrence; the float64 twin shows
        # how far each lands from exact arithmetic
        x_t = cg_twin(torch, sysm, rtol, maxiter)[0]
        x_d, it_d = cg_twin(torch, sysm, rtol, maxiter, sums=torch.float64)
        x64 = cg_twin(torch, type(sysm)(*[f.double() for f in sysm]), rtol, maxiter)[0]
        err_d = float((x_k - x_d).abs().max())
        err64, err64_t = (float((x.double() - x64).abs().max()) for x in (x_k, x_t))
        torch.cuda.synchronize()
        print(f"cg main-path system {k + 1} {H}x{W}: iterations kernel {it_k} / plain {it_t} / plain, double sums "
              f"{it_d} / streaming {it_s}; max|dx| / limit against the plain twin {err / limit:.3f} (streaming "
              f"{err_s / limit:.3f}), against it with double sums {err_d / limit:.3f}; from the float64 twin: kernel "
              f"{err64 / limit:.3f}, plain twin {err64_t / limit:.3f}; residual / rtol {res / rtol:.3f}")
        check(min(err, err_d) <= limit and res <= 10 * rtol and torch.equal(again, x_k),
              f"cg main-path system {H}x{W}: max|dx| {err:.3e}, {err_d:.3e} with double sums (limit {limit:.3e}); "
              f"residual {res:.3e}")
        ms = cuda_ms(torch, lambda: cg_kernel.cg_solve(sysm, rtol, maxiter), 5)
        b = cg_bound(H, W, it_k)["bound_ms"]
        frame_ms += ms
        frame_bound += b
        lv = levels.setdefault((H, W), {"plan": plan, "solves": 0, "iters": 0, "ms": 0.0, "bound": 0.0,
                                        "err": 0.0, "res": 0.0, "it_t": 0})
        lv["solves"] += 1
        lv["iters"] += it_k
        lv["it_t"] += it_t
        lv["ms"] += ms
        lv["bound"] += b
        lv["err"] = max(lv["err"], err / limit)
        lv["res"] = max(lv["res"], res / rtol)
        if finest is None or H * W > finest[0].a11.numel() or (H * W == finest[0].a11.numel() and it_k > finest[3]):
            finest = (sysm, rtol, maxiter, it_k, err)
    for (H, W), lv in levels.items():
        print(f"cg level {H}x{W} ({lv['plan'].path}, {lv['plan'].blocks} blocks, {lv['plan'].ppt} px a thread): "
              f"{lv['solves']} solves, iterations kernel {lv['iters']} / plain {lv['it_t']}, {lv['ms']:.4f} ms "
              f"({lv['ms'] / lv['solves']:.4f} ms a solve, {1e3 * lv['ms'] / max(lv['iters'], 1):.2f} us an iteration), "
              f"bound {lv['bound']:.4f} ms; worst max|dx| / limit {lv['err']:.3f}, residual / rtol {lv['res']:.3f}  [{card}]")
    print(f"cg, the frame's 21 solves one by one: {frame_ms:.3f} ms, bound {frame_bound:.4f} ms  [{card}]")
    sysm, rtol, maxiter, it_k, err = finest
    H, W = sysm.a11.shape
    ms = cuda_ms(torch, lambda: cg_kernel.cg_solve(sysm, rtol, maxiter), 10)
    plain_ms = cuda_ms(torch, lambda: cg_kernel.cg_solve_plain(sysm, rtol, maxiter), 3)
    b = cg_bound(H, W, it_k)
    print(f"cg main-path system {H}x{W} ({it_k} iterations): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {b['bound_ms']:.4f} ms  [{card}]")
    return {"main_path_ms": ms, "main_path_plain_ms": plain_ms, "main_path_bound_ms": b["bound_ms"],
            "main_path_max_abs_err": err, "frame_sum_ms": frame_ms, "frame_sum_bound_ms": frame_bound}


def phase_profile(torch, dev, card, rgb1, rgb2, frame_ms):
    """One warm frame under torch.profiler: device busy time (the union of the
    device intervals), idle share, and device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from optical_flow_tpu_torch import estimate_flow

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        estimate_flow(rgb1, rgb2, "classic+nl-fast", PARAMS, device=dev)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print("profiled frame: the trace holds no device events; device split not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    split = {"wmedian": 0.0, "cg": 0.0, "rof": 0.0, "other": 0.0}
    for e in events:
        key = next((k for k, tag in (("wmedian", "wmedian_kernel"), ("cg", "cg_"), ("rof", "rof_"))
                    if tag in e.name), "other")
        split[key] += e.time_range.end - e.time_range.start
    busy_ms = busy_us / 1e3
    print(f"profiled frame: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, {len(events)} device events, "
          f"idle share {1 - busy_ms / wall_ms:.3f} of the profiled frame and {1 - busy_ms / frame_ms:.3f} "
          f"of the unprofiled {frame_ms:.2f} ms frame  [{card}]")
    print("profiled frame, device ms by kernel: " + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in split.items()))
    rof_launches = sum("rof_" in e.name for e in events)
    print(f"profiled frame: {rof_launches} ROF device launch(es), "
          f"{sum('cg_' in e.name for e in events)} PCG device launches")
    check(rof_launches == 1, f"ROF made {rof_launches} device launches in the frame, expected 1")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke test needs one NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "optical_flow_tpu_torch")):
        print("chip_smoke: optical_flow_tpu_torch is not beside this script", file=sys.stderr)
        return 3
    sys.path.insert(0, REPO)
    from optical_flow_tpu_torch.io.flo import read_flow_file

    try:
        card = phase_setup(torch)
        dev = torch.device("cuda", 0)
        rng = np.random.default_rng(SEED)
        rgb1, rgb2, tu, tv = read_flow_file("RubberWhale", 10)
        results = {
            "wmedian": check_wmedian(torch, dev, card, rng),
            "cg": check_cg(torch, dev, card, rng, rgb1, rgb2, tu, tv),
            "rof": check_rof(torch, dev, card, rgb1, rgb2),
        }
        launches, recorded, recorded_cg, frame_ms = phase_main_path(torch, dev, card, rgb1, rgb2, tu, tv)
        results["wmedian"].update(phase_wmedian_levels(torch, card, recorded))
        del recorded
        results["cg"].update(phase_cg_levels(torch, dev, card, recorded_cg))
        del recorded_cg
        phase_profile(torch, dev, card, rgb1, rgb2, frame_ms)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    meta = {
        "wmedian": ("optical_flow_tpu_torch/csrc/wmedian.cu", "optical_flow_tpu/ops/pallas/wmedian_kernel.py:202"),
        "cg": ("optical_flow_tpu_torch/csrc/cg.cu", "optical_flow_tpu/ops/pallas/cg_kernel.py:160"),
        "rof": ("optical_flow_tpu_torch/csrc/rof.cu", "optical_flow_tpu/ops/pallas/rof_kernel.py:75"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         # no one PyTorch call computes any of the three functions
         **results[name], "library_ms": None}
        for name, (src, rep) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
