#!/usr/bin/env python
"""Smoke test of the PyTorch / CUDA port (``optical_flow_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results; any failed check exits non-zero:

1. the card (name and power limit from nvidia-smi), torch and CUDA versions,
   the float32 matmul settings, and the build of the three CUDA kernels
   from ``optical_flow_tpu_torch/csrc`` (ptxas registers and spills);
2. each kernel against its plain PyTorch twin on the card at main-path
   shapes, with both times (CUDA events); for the weighted median also
   window half-sizes 0, 1 and 12, the wide kernel at 13 and 20, the
   coarsest main-path level and a repeat run (determinism); for PCG and
   ROF both paths (resident at the main path's shapes; above the resident
   limit the two-sweep streaming PCG and the tiled ROF, bit for bit at
   2x1080x1920, 2x2160x3840 and the B = 4 batch's 8x388x584), repeat
   runs, and the large-image kernels timed in turns with the resident ones
   on the same input;
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
   device time of each kernel and the ROF kernel's device launches;
7. the BA and Horn–Schunck paths, each ``estimate_flow(rgb1, rgb2, name,
   {"display": False}, device="cuda")`` on RubberWhale 584x388 at the
   preset's full schedule: ``classic++`` (90 PCG solves at rtol 1e-7,
   1 ROF call), ``ba`` (the cubic B-spline warp) and ``hs`` (the HS
   system, early stop).  For each: AAE / AEPE within the reference
   oracle's gate (``benchmarks/middlebury.py``), the kernels' launches by
   path (none of the plain twins may run), CG iterations per level (for
   hs, the warp iterations the early stop left), the per-frame latency
   (median of 3 warm runs); for classic++ also the 10 finest-level solves
   of the last GNC stage against the plain twin and one profiled frame
   with the median filter as its own row;
8. the plain-PyTorch median filter and B-spline prefilter on the card at
   388x584: equal to their CPU results, and one call's time;
9. the alt-BA and SOR paths on RubberWhale 584x388, as phase 7 drives the
   others: ``classic-c-a`` at the preset's defaults (the guard on at 1e9:
   finite and within 1e9, no accuracy gate since the trajectory diverges by
   design; the levels the guard rolled back, from a device tally read once
   after the frame; 90 PCG solves, 1 ROF call; one profiled frame with the
   median filter as its own row), its stable configuration
   ``{"lambda2": 0.01, "max_iters": 5, "gnc_iters": 2}`` (35 solves; AAE /
   AEPE against the JAX package's float32 CPU values) and ``hs`` with
   ``{"solver": "sor"}`` (SOR sweeps per solve by level and host reads a
   frame; AAE / AEPE against the JAX package's);
10. ``classic-c-a`` with ``{"guard_flow": None}``: the flow must blow up, as
    the JAX package's does, and the frame's first PCG system with a
    non-finite plane is held kernel against twin (iterations, the NaN and
    inf entries of x, the finite entries);
11. ``hs`` with ``{"guard_flow": 1e9}`` equal to ``hs`` without it, bit for
    bit;
12. the batched serving path: ``estimate_flow_batched_rgb`` on the real pairs
    of RubberWhale, Hydrangea, Dimetrodon and RubberWhale again as one batch
    (classic+nl-fast, pcg): launches by path (21 weighted-median launches of
    4 items, 21 PCG calls of which the two finest levels' launch once an
    item, 1 ROF call; no plain twin), each item inside the classic+nl-fast
    gate against the reference oracle of its sequence and within the
    float32 slice bounds of its single-pair run, the two RubberWhale items
    bit-identical; the batch's 21 PCG calls item by item against the twin
    with their time and bound by level, its finest weighted-median call
    against one launch per item, a second run and the twin
    (``check_batched_wmedian``), and its ROF call on 8 images
    against the twin (phase 2 also runs the batched kernels on random
    inputs at every plan path);
13. batched latency at B = 1, 3 and 4 beside B single frames, the B = 3
    batch's ROF call on 6 images against the twin, and one profiled B = 4
    call (its PCG device launches equal to the launch count);
14. ``estimate_flow_video`` on 5 gray frames of RubberWhale rolled 1 px a
    frame (inner mean u ~ 1) and ``estimate_flow_stream`` over three real
    pairs (each equal to its single-pair flow, in order);
15. the batched BA, Horn–Schunck and alt-BA families through
    ``estimate_flow_batched_rgb`` on the real pairs and a static pair
    (RubberWhale's frame 10 twice), ``FAMILY_BATCHES``: ``hs-brightness``
    (JAX's default; the static item stops on its own, at its single run's
    warp iterations, and costs 0 PCG iterations once stopped), ``hs`` (the
    batch's ROF input against the twin), ``classic++`` (the finest level's
    batched PCG against the twin at rtol 1e-7), ``classic-c-a`` stable and at
    its defaults (the guard's rollbacks item by item) and ``hs`` + SOR
    (sweeps by item).  Each batch is counted (no plain twin); each item is
    held to its own single-pair run (bit for bit but for SOR) and, where the
    oracle has its sequence, to its gate; then the latency of
    ``hs-brightness`` and ``classic++`` at B = 1 and 3 beside a single frame;
16. the row-sharded path, ``estimate_flow(..., mesh=flow_mesh(space=n,
    devices=...))`` on RubberWhale 584x388 (n distinct cards where there are
    that many, else n shards on card 0; the device list is printed):
    classic+nl-fast with pcg over 2 shards (388 rows divide) and 3 (the
    bottom pad), each in the classic+nl-fast gate and within 1e-3 px mean
    |d| of the unsharded card flow, and ``ba`` over 3 in its oracle gate.
    For each: the levels sharded and unsharded, the halo and the distributed
    PCG's iterations by level beside the unsharded frame's kernel
    iterations, the kernels' launches in one counted frame (the weighted
    median once a device and warp iteration on the shards, PCG kernel
    launches only on the unsharded levels, one ROF call, no plain twin); for
    classic+nl-fast the finest sharded weighted-median call against its twin
    on the same padded shards (``wmedian_valid``, as phase 4) and against one
    launch a shard (bit for bit), and the latency (median of 3) beside the
    unsharded frame's; ``ba`` runs one frame;
17. one process over a list of devices (n distinct cards where there are
    that many, else card 0; the device lists are printed): ``hs`` and the
    stable ``classic-c-a`` through ``estimate_flow(mesh=flow_mesh(space=2))``
    (each in its gate and within 1e-3 px mean |d| of the unsharded card
    flow; levels sharded and unsharded, warp iterations and distributed PCG
    iterations by level beside the unsharded frame's, PCG kernel launches
    only on the unsharded levels, one ROF call, no plain twin, one frame's
    host-clock time); ``estimate_flow_batched_rgb`` for classic+nl-fast and
    ``hs-brightness`` on phase 12's pairs over ``flow_mesh(batch=2,
    space=1)`` (each item bit-identical to the unmeshed batch's, launches by
    batch row and device); ``estimate_flow_pipelined`` over those pairs,
    classic+nl-fast with pcg at ``n_stages=3`` (the stage partition, each
    flow bit-identical to its ``estimate_flow`` and in order, four frames'
    launches, the time a pair over the stream beside a single frame);
18. several processes: two ranks spawned on card 0 over gloo (tcp
    localhost), each building nothing, classic+nl-fast over ``flow_mesh()``
    (one shard a rank) under the ``classic``, ``gear`` and ``cheby`` PCG
    recurrences (``classic`` bit-identical in every rank to phase 16's
    one-process 2-shard frame; each in the gate; iterations, psum rounds an
    iteration, halo exchanges and each rank's launches and host time), then
    phase 12's pairs over ``flow_mesh(batch=2, space=1)``, one batch row a
    rank (every item bit-identical to the unmeshed batch).  Any rank's
    failure fails the phase;
19. the JAX package's method-object API: RubberWhale through ``ope.images
    = ...; ope.compute_flow()`` (bit-identical to phase 3's frame, 21 / 21 /
    1 launches), the warm start ``compute_flow(init=<that flow>)`` in the
    gate, ``compute_flow_base`` from zero flow at the finest level (3 PCG and
    3 weighted-median launches) against the same call on the CPU (mean |d|
    <= 1e-3 px), ``solvers.pcg_solve`` on the card against the PCG kernel on
    phase 5's finest system (both converged, within phase 5's limit); then
    the JAX package's 4K harness call (``benchmarks/throughput.py``): a
    seeded uniform 2160x3840 frame and the same frame rolled 2 px, gray (the
    plain median) and RGB (the Lab guide and the weighted median at
    2160x3840), each finite with AEPE <= 0.1 px against (2, 0) on the
    interior (gate 1e-4 px), PCG on its streaming path and ROF on its tiled
    one, with levels, CG iterations, solves and summed ms by level and path,
    launches, peak memory and one warm frame's latency beside PR 11's;
    the 4K weighted-median call against its twin (``wmedian_valid``), the
    frame's last 2160x3840 and 1080x1920 PCG systems and its ROF call
    against theirs, each timed with its bound and, where a copy of the
    previous design's sources sits in the build directory
    (``previous_library``), in turns with that design's kernels; ``utils.profiling.trace`` around one frame (the trace names
    the three kernels and the annotation) and ``StageTimer``;
20. the cold start: fresh processes (the library already built by phase
    1, whose build-and-load time is printed beside) each time ``import``
    of the port and their first frame (host clock, and CUDA events around
    the call): A, RubberWhale through ``estimate_flow`` cold; B, the same
    after ``utils.warmup.warmup_classic_nl(ope, (388, 584))`` (its time and
    launches: every kernel, no plain twin); C, the 4K RGB harness frame
    after the warm-up at 2160x3840 (its PCG solves on the streaming path,
    its ROF call tiled).  A's and B's first frames must be ``torch.equal``
    to phase 3's frame, C's inside phase 19's 4K gate;
21. the level step's CUDA graphs (``utils/graphs.py``): in a fresh process
    for each tree, the RubberWhale classic+nl-fast frame (phase 3's call),
    the 4K RGB frame of phase 19 through ``estimate_flow`` and ``classic++``
    on 8 pairs in one batched call (phase 12's four and their mirror
    images), each called twice, with the graph counters after each call:
    captures only in the first call, every chain a replay in the second.
    Where a copy of the parent commit's tree sits in ``_checkout/parent``
    (``git archive <commit> | tar -x -C _checkout/parent``; git ignores
    ``_checkout/``), its flows are computed on the same inputs and every
    flow must be bit-identical to them; without it the phase says so.
    Then ``flowbench/spans_report.py`` on both benchmark cells, for this
    tree and the parent's: the per-level table and the span numbers.

22. Classic+NL at the preset's own settings, ``"classic+nl"`` with its
    backslash solve (PCG at rtol 1e-7): RubberWhale 584x388 through
    ``estimate_flow`` and the eight 640x480 Middlebury pairs of
    ``NL_VGA_SEQS`` in one ``estimate_flow_batched_rgb`` call.  A warm-up
    call (each PCG solve's iterations, a sync a solve), then a counted call:
    90 weighted-median launches (one a warp iteration: 5 + 2 + 2 levels of
    10 warps), of 1 and of 8 items, 90 PCG calls (PCG's items 90 and 720),
    1 ROF call, no plain twin, every graphed chain a replay; each flow with
    ground truth inside the reference oracle's Classic+NL gate; the warm
    frame's and the warm batch's latency (CUDA events), and one batch item
    against its single-pair call.  The batch's last weighted-median inputs at
    640x480 and 512x384 (recorded in the warm-up call, eight items a launch):
    the launch against one launch per item and, item by item, against the
    twin (``wmedian_valid``), twice bit for bit, and its time beside its bound.

``python3 chip_smoke.py --phase 21`` runs phase 1 and phase 21 alone;
``--phase 22`` runs phase 1 and phase 22 alone.

The last line is one JSON object ``{"ok": true, "device": {...}}``; the
line before it is nvidia-smi's name and power limit; before that, one
JSON object lists each kernel with its time, its plain twin's time and
its bound (the larger of bytes over 3.35 TB/s and operations over the
67 TFLOP/s float32 peak of an H100 SXM), all from phase 2.  The weighted
median's and PCG's entries add phases 4 and 5 under ``main_path_*`` and
``frame_sum_*`` (the 21 calls summed); PCG's adds the streaming kernel's
time on phase 2's input as ``streaming_ms``, ROF's the tiled kernel's as
``tiled_ms``; two more entries, ``rof_tiled`` and ``cg_stream``, hold the
large-image kernels at the 4K harness's inputs (``previous_ms``: the
previous design's time, where built).  Each
entry's ``launches`` sums ``launches_by_path``, the launches in one frame
of each path driven (counts set to 0 just before it), the paths of phases
9-19 included (phase 18's summed over the ranks); the 4K calls of phase 19
add ``frame4k_*``; phase 20's sub-runs count under ``cold start *``.  A line
before those holds phases 13, 15, 16 and 17's latencies, phase 13's profile,
phase 19's 4K frames, phase 20's cold starts, phase 21's calls and phase 22's
latencies as JSON.  Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.  It imports neither JAX nor the JAX package.
"""
import contextlib
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
# the BA and HS paths at their presets' own settings: the reference oracle's
# RubberWhale AAE / AEPE (benchmarks/results_ref_oracle_methods.json) and
# benchmarks/middlebury.py's gates for each
PATH_PARAMS = {"display": False}
PATH_GATES = {
    "classic++": ((2.6737, 0.08241), (0.2, 0.02)),
    "ba": ((2.8129, 0.08564), (0.2, 0.02)),
    "hs": ((3.361, 0.10439), (0.2, 0.01)),
}
# alt-BA and SOR, against the JAX package's estimate_flow on full RubberWhale
# in float32 on the CPU: classic-c-a at the preset's defaults diverges by design
# and only the guard keeps it finite (no accuracy gate); its stable
# configuration, and hs with SOR, have the gate widths of ba and hs
ALT_JAX = (90.23, 3.40e5)
ALT_UNGUARDED = {"display": False, "guard_flow": None}
ALT_STABLE = {"display": False, "lambda2": 0.01, "max_iters": 5, "gnc_iters": 2}
ALT_STABLE_GATE = ((7.820, 0.2717), (0.2, 0.02))
NEW_PATHS = [  # (label, method, params, gate, PCG solves a frame)
    ("classic-c-a", "classic-c-a", PATH_PARAMS, None, 90),
    ("classic-c-a stable", "classic-c-a", ALT_STABLE, ALT_STABLE_GATE, 35),
    ("hs sor", "hs", {"display": False, "solver": "sor"}, ((3.3592, 0.10434), (0.2, 0.01)), 0),
]
# the batched phase: the real pairs of these sequences (one twice) as one batch
BATCH_SEQS = ("RubberWhale", "Hydrangea", "Dimetrodon", "RubberWhale")
# the batched families: (label, method, params, pairs) of each batch; "static"
# is RubberWhale's frame 10 as both frames
FAMILY_BATCHES = [
    ("hs-brightness", "hs-brightness", PATH_PARAMS, ("RubberWhale", "Hydrangea", "static")),
    ("hs", "hs", PATH_PARAMS, ("RubberWhale", "Hydrangea", "Dimetrodon")),
    ("classic++", "classic++", PATH_PARAMS, ("RubberWhale", "Hydrangea", "Dimetrodon")),
    ("classic-c-a stable", "classic-c-a", ALT_STABLE, ("RubberWhale", "Hydrangea")),
    ("classic-c-a", "classic-c-a", PATH_PARAMS, ("RubberWhale", "Hydrangea")),
    ("hs sor", "hs", {"display": False, "solver": "sor"}, ("RubberWhale", "static")),
]
LATENCY_RUNS = 3
# Classic+NL at the preset's own settings: the reference oracle's AAE / AEPE
# (benchmarks/results_ref_oracle_methods.json) and benchmarks/middlebury.py's
# gate; the benchmark's eight 640x480 pairs; weighted-median launches and PCG
# solves a frame at 388x584 and at 640x480, (5 + 2 + 2) levels x 10 warps
NL_ORACLE = {"RubberWhale": (2.4235, 0.07653), "Grove2": (1.4444, 0.10079), "Grove3": (4.9609, 0.47053),
             "Urban2": (1.9419, 0.1981), "Urban3": (2.723, 0.38634)}
NL_GATE = (0.2, 0.02)
NL_VGA_SEQS = ("Beanbags", "DogDance", "Grove2", "Grove3", "MiniCooper", "Urban2", "Urban3", "Walking")
NL_WARPS = 90
NL_WMEDIAN_CHECKED = ((480, 640), (384, 512))
# the row-sharded phase: classic+nl-fast over 2 shards (divides 388 rows) and
# 3 (the bottom pad), ba over 3; mean |d| of the sharded flow from the
# unsharded card flow (float32: the order of the distributed PCG's sums)
SHARDS = (2, 3)
SHARDS_BA = 3
SHARDED_MEAN_DIFF = 1e-3
# the multi-device phase: hs and the stable alt-BA row-sharded over 2 shards
# (label, method, params, gate); meshed batches over 2 batch rows (method,
# params, launches of a row of 2 items); a pipeline of 3 stage groups
SHARDS_HS_ALT = 2
SHARDED_FAMILIES = [
    ("hs", "hs", PATH_PARAMS, PATH_GATES["hs"]),
    ("classic-c-a stable", "classic-c-a", ALT_STABLE, ALT_STABLE_GATE),
]
MESH_BATCH_ROWS = 2
MESH_BATCHES = [
    ("classic+nl-fast", PARAMS, {"wmedian": 21, "rof": 1}),
    ("hs-brightness", PATH_PARAMS, {"wmedian": 0, "rof": 0}),
]
PIPELINE_STAGES = 3
# the multi-process phase: PROCESSES ranks on card 0 over gloo, one shard a
# rank, classic+nl-fast under the three PCG recurrences, then the batch over
# flow_mesh(batch=PROCESSES, space=1); a launch may take RANKS_TIMEOUT seconds
PROCESSES = 2
PROCESS_SHARDS = 2  # phase 16's shard count whose frame the ranks repeat
CG_ALGOS = ("classic", "gear", "cheby")
RANKS_TIMEOUT = 300.0
SEED = 0
# an H100 SXM's published peaks (float32 outside the tensor cores; HBM3)
PEAK_F32_OPS, PEAK_BYTES = 67e12, 3.35e12
INT32_MIN = -(2**31)
# the weighted median against its twin on large real or random inputs: the
# share of values that must be identical (the rest each a median within rounding)
WMEDIAN_SHARE = 0.9999


# phase 1's kernel build-and-load seconds, printed again beside phase 20
SETUP = {}


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


def float32_settings(torch):
    """TF32 off and float32 matmuls at 'highest' precision, checked."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(torch.get_float32_matmul_precision() == "highest", "float32 matmul precision is not 'highest'")
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32, "TF32 is on")


def phase_setup(torch):
    from optical_flow_tpu_torch.ops.cuda import build

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device 0: {torch.cuda.get_device_name(0)}")
    float32_settings(torch)
    t0 = time.time()
    build.load_library()
    SETUP["build_load_s"] = time.time() - t0
    print(f"kernel build + load: {SETUP['build_load_s']:.1f} s (key {build.build_key()})")
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


PREVIOUS_DIR = os.path.join(REPO, "optical_flow_tpu_torch", "_build", "previous")


def previous_library():
    """The previous design of the two large-image kernels, where a copy of its
    sources sits in the build directory (``_build/previous/{cg,rof}.cu``,
    which git ignores; the tree holds only the new design): the streaming
    PCG ``cg_solve_f32`` (three grid barriers and 34 plane-passes an
    iteration) and the ROF ``rof_structure_f32`` (one launch an iteration),
    built with the package's flags into a library of their own.  None where
    the copy is absent."""
    import ctypes

    from optical_flow_tpu_torch.ops.cuda import build

    srcs = [os.path.join(PREVIOUS_DIR, f) for f in ("cg.cu", "rof.cu")]
    if not all(os.path.exists(f) for f in srcs):
        return None
    so = os.path.join(PREVIOUS_DIR, "libprevious.so")
    if not os.path.exists(so):
        nvcc = build._nvcc()
        objs = [f[:-3] + ".o" for f in srcs]
        procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-c", "-o", o, f], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for f, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        check(all(p.returncode == 0 for p in procs), "previous design: nvcc failed:\n" + "".join(logs))
        link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", so, *objs],
                              capture_output=True, text=True)
        check(link.returncode == 0, f"previous design: link failed: {link.stderr}")
    lib = ctypes.CDLL(so)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cg_solve_f32.argtypes = [P] * 13 + [I, I, I, F, I, P]
    lib.rof_structure_f32.argtypes = [P, P, P, I, I, I, F, I, P]
    lib.cg_solve_f32.restype = lib.rof_structure_f32.restype = ctypes.c_int
    return lib


def previous_cg(torch, lib, planes, rtol, maxiter):
    """The previous streaming PCG on nine (H, W) float32 CUDA planes: (H, W, 2)."""
    H, W = planes[0].shape
    dev = planes[0].device
    x = torch.empty((H, W, 2), dtype=torch.float32, device=dev)
    work = torch.empty((11, H, W), dtype=torch.float32, device=dev)
    partials = torch.empty(4 * 2048, dtype=torch.float64, device=dev)
    iters = torch.zeros(2, dtype=torch.int32, device=dev)
    err = lib.cg_solve_f32(*[p.data_ptr() for p in planes], x.data_ptr(), work.data_ptr(), partials.data_ptr(),
                           iters.data_ptr(), 1, H, W, float(rtol) ** 2, int(maxiter),
                           torch.cuda.current_stream(dev).cuda_stream)
    check(err == 0, f"previous cg_solve_f32: cudaError_t {err}")
    return x, iters


def previous_rof(torch, lib, x, theta, n_iters):
    """The previous ROF (one launch an iteration) on a (B, H, W) float32 CUDA tensor."""
    B, H, W = x.shape
    p = torch.zeros((4, B, H, W), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    err = lib.rof_structure_f32(x.data_ptr(), p.data_ptr(), out.data_ptr(), B, H, W, float(theta), int(n_iters),
                                torch.cuda.current_stream(x.device).cuda_stream)
    check(err == 0, f"previous rof_structure_f32: cudaError_t {err}")
    return out


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


def wmedian_valid(torch, args, out, ref):
    """(values that differ, share identical, every difference is valid): a
    value where ``out`` and ``ref`` differ is valid if, for both, it is a
    weighted median of its window within the sums' rounding: with the
    weights recomputed in float64 and T their total, the weight below the
    value is at most T/2 and the weight up to it at least T/2, each within
    K2 x 2^-22 x T (K2 float32 weights summed in some order).  A sum order
    can only move the crossing of T/2 across samples whose weights that
    tolerance covers.  The check passes with every difference valid and a
    share of at least WMEDIAN_SHARE identical."""
    u_pad, v_pad, occ_pad, guide_pad, _, hsz, sigma_i = args
    k = 2 * hsz + 1
    tol = k * k * 2.0**-22
    inv = 1.0 / (2.0 * float(sigma_i) ** 2)
    ok = True
    diff = out != ref
    for y, x, c in diff.nonzero().tolist():
        vals = (u_pad if c == 0 else v_pad)[y : y + k, x : x + k].double().reshape(-1)
        g = guide_pad[:, y : y + k, x : x + k].double().reshape(guide_pad.shape[0], -1)
        center = guide_pad[:, y + hsz, x + hsz].double()[:, None]
        w = torch.clamp(torch.exp(-((g - center) ** 2).sum(0) * inv)
                        * occ_pad[y : y + k, x : x + k].double().reshape(-1), min=1e-10)
        half = float(w.sum()) / 2
        for v in (float(out[y, x, c]), float(ref[y, x, c])):
            below, upto = float(w[vals < v].sum()), float(w[vals <= v].sum())
            ok = ok and below <= half + tol * 2 * half and upto >= half - tol * 2 * half
    n_diff = int(diff.sum())
    return n_diff, 1.0 - n_diff / out.numel(), ok


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
    n_diff, frac, valid = wmedian_valid(torch, args, out, ref)
    print(f"wmedian {H}x{W} hsz {hsz} C 3: {n_diff} of {out.numel()} values differ "
          f"({100 * frac:.4f}% identical), each a median within the sums' rounding: {valid}")
    check(frac >= WMEDIAN_SHARE and valid, "weighted median outside the sums' rounding at 388x584")
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

    # a batch of 4 in one launch, bit for bit against the twin item by item and
    # against one launch per item
    from optical_flow_tpu_torch.ops.cuda import wmedian_kernel

    items = [_wmedian_case(torch, dev, rng_new, 37, 53, 7, 3) for _ in range(4)]
    args = tuple(torch.stack([it[k] for it in items]) for k in range(4)) + items[0][4:]
    before = wmedian_kernel.launches
    out = wmedian(*args)
    one_launch = wmedian_kernel.launches - before
    ref = wmedian_plain(*args)
    each = torch.stack([wmedian(*it) for it in items])
    torch.cuda.synchronize()
    n_diff = int((out != ref).sum())
    print(f"wmedian B 4 x 37x53 hsz 7 C 3 in {one_launch} launch: {n_diff} values differ from the twin "
          f"(bit-exact required), equal to one launch per item: {torch.equal(out, each)}")
    check(one_launch == 1 and n_diff == 0 and torch.equal(out, each), "the batched weighted median is not bit-exact")

    # windows wider than the register kernel's (hsz 13 and 20): the wide
    # kernel, one launch a call, bit for bit on small shapes with a narrow
    # colour range, and at 388x584 hsz 13 within the sums' rounding
    for (H, W), hsz, C in [((29, 43), 13, 1), ((29, 43), 13, 3), ((45, 47), 20, 3)]:
        args = _wmedian_case(torch, dev, rng_new, H, W, hsz, C, color_hi=24.0)
        before = wmedian_kernel.launches
        out = wmedian(*args)
        one_launch = wmedian_kernel.launches - before
        ref = wmedian_plain(*args)
        torch.cuda.synchronize()
        n_diff = int((out != ref).sum())
        print(f"wmedian {H}x{W} hsz {hsz} C {C} (wide kernel, colours 0-24) in {one_launch} launch: {n_diff} "
              f"differing values (bit-exact required)")
        check(one_launch == 1 and n_diff == 0, f"wide weighted median is not bit-exact with its twin at {H}x{W} hsz {hsz}")
    args = _wmedian_case(torch, dev, rng_new, 388, 584, 13, 3)
    out = wmedian(*args)
    ref = wmedian_plain(*args)
    again = wmedian(*args)
    torch.cuda.synchronize()
    n_diff, frac, valid = wmedian_valid(torch, args, out, ref)
    wide_ms = cuda_ms(torch, lambda: wmedian(*args), 5)
    wide_plain_ms = cuda_ms(torch, lambda: wmedian_plain(*args), 3)
    wb = wmedian_bound(args)
    print(f"wmedian 388x584 hsz 13 C 3 (wide kernel): {n_diff} of {out.numel()} values differ ({100 * frac:.4f}% "
          f"identical), each a median within the sums' rounding: {valid}, run twice: torch.equal "
          f"{torch.equal(again, out)}; kernel {wide_ms:.3f} ms, plain {wide_plain_ms:.3f} ms, bound "
          f"{wb['bound_ms']:.4f} ms ({wb['bound_by']})  [{card}]")
    check(frac >= WMEDIAN_SHARE and valid and torch.equal(again, out),
          "wide weighted median outside the sums' rounding at 388x584 hsz 13")
    result.update({"wide_hsz13_ms": wide_ms, "wide_hsz13_plain_ms": wide_plain_ms,
                   "wide_hsz13_bound_ms": wb["bound_ms"]})
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
    # above the resident limit: the streaming kernel (two sweeps an iteration)
    big_sys = _random_flow_system(torch, dev, rng, 1200, 1600)
    result = None
    for name, sysm, rtol, maxiter, path in (("random", random_sys, 1e-6, 1000, "resident"),
                                           ("irls", irls_sys, 1e-3, 200, "resident"),
                                           ("random", big_sys, 1e-6, 100, "streaming")):
        H, W = sysm.a11.shape
        plan = cg_kernel.cg_plan(1, H, W, *limits)
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
            streaming = cg_kernel.streaming_plan(H, W, limits[0])
            # the streaming kernel and the resident one in turns: s, r, r, s
            t = [cuda_ms(torch, lambda p=p: cg_kernel.launch(planes, rtol, maxiter, p), 10)
                 for p in (streaming, plan, plan, streaming)]
            ms, streaming_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            plain_ms = cuda_ms(torch, lambda: cg_kernel.cg_solve_plain(sysm, rtol, maxiter), 3)
            b = cg_bound(H, W, it_k)
            print(f"cg irls {H}x{W} rtol 1e-3 ({it_k} iterations): resident {t[1]:.3f} / {t[2]:.3f} ms "
                  f"({1e3 * ms / it_k:.2f} us an iteration), streaming {t[0]:.3f} / {t[3]:.3f} ms "
                  f"({1e3 * streaming_ms / it_k:.2f} us), plain {plain_ms:.3f} ms, "
                  f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})  [{card}]")
            check(ms < streaming_ms, "cg: the resident kernel is not faster than the streaming one at 388x584")
            result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b, "streaming_ms": streaming_ms}
    return result


def _random_batch_systems(torch, dev, rng, B, H, W):
    """B seeded random flow systems of one shape, the items' edge weights
    scaled 1, 30, 0.01, 3, ... so that they stop after different iteration counts."""
    from optical_flow_tpu_torch.ops.stencil import FlowSystem

    scales = np.resize([1.0, 30.0, 0.01, 3.0], B)
    items = [_random_flow_system(torch, dev, rng, H, W) for _ in range(B)]
    items = [sysm._replace(**{f: getattr(sysm, f) * float(c) for f in ("wu_h", "wu_v", "wv_h", "wv_v")})
             for sysm, c in zip(items, scales)]
    return FlowSystem(*[torch.stack(planes) for planes in zip(*items)])


def check_cg_batched(torch, dev, card, rng):
    """The batched whole-PCG kernel on every plan path, item by item against
    the plain twin (max |dx|, iterations) and against one solve per item; and
    with item 1's right-hand side zero (a Horn–Schunck item that stopped):
    that item stops at iteration 0 with x = 0, the others are unchanged."""
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits
    from optical_flow_tpu_torch.ops.stencil import FlowSystem

    limits = device_limits(dev)
    for B, (H, W), maxiter in ((4, (25, 37), 300), (4, (49, 73), 300), (4, (97, 146), 300), (3, (194, 292), 300),
                               (4, (388, 584), 100), (2, (1200, 1600), 60)):
        sysm = _random_batch_systems(torch, dev, rng, B, H, W)
        plan = cg_kernel.cg_plan(B, H, W, *limits)
        x = cg_kernel.cg_solve(sysm, 1e-6, maxiter)
        its = cg_kernel.item_iterations(dev)
        again = cg_kernel.cg_solve(sysm, 1e-6, maxiter)
        worst, it_twin, it_single, same_single = 0.0, [], [], True
        for k in range(B):
            item = FlowSystem(*[f[k] for f in sysm])
            x_t, it_t = cg_twin(torch, item, 1e-6, maxiter)
            single = cg_kernel.cg_solve(item, 1e-6, maxiter)
            it_single.append(cg_kernel.iteration_counts(dev)[0])
            it_twin.append(it_t)
            worst = max(worst, float((x[k] - x_t).abs().max()) / (1e-5 * max(float(x_t.abs().max()), 1.0)))
            if (plan.items == 1 or plan.path == "single" or plan.path == "streaming") and not torch.equal(x[k], single):
                same_single = False
        zeroed = sysm._replace(b_u=sysm.b_u.clone(), b_v=sysm.b_v.clone())
        zeroed.b_u[1] = 0.0
        zeroed.b_v[1] = 0.0
        x_z = cg_kernel.cg_solve(zeroed, 1e-6, maxiter)
        its_z = cg_kernel.item_iterations(dev)
        rest = [k for k in range(B) if k != 1]
        zero_ok = (its_z[1] == 0 and not bool(x_z[1].any()) and [its_z[k] for k in rest] == [its[k] for k in rest]
                   and torch.equal(x_z[rest], x[rest]))
        torch.cuda.synchronize()
        print(f"cg batched B {B} x {H}x{W} ({plan.path}, {plan.blocks} bands an item, {plan.items} items a launch): "
              f"iterations by item kernel {its} / single solves {it_single} / plain {it_twin}; worst max|dx| / limit "
              f"{worst:.3f}; run twice: torch.equal {torch.equal(x, again)}; equal to one solve per item where the "
              f"band layout is a single solve's: {same_single}; item 1's right-hand side zeroed: iterations {its_z}, "
              f"x = 0 there and the other items unchanged: {zero_ok}")
        check(worst <= 1.0 and torch.equal(x, again) and same_single, f"batched cg {B}x{H}x{W} differs")
        check(zero_ok, f"batched cg {B}x{H}x{W}: a zero right-hand side did not stop its item at iteration 0 alone")
        check(all(abs(a - b) <= 2 for a, b in zip(its, it_twin)), f"batched cg {B}x{H}x{W}: iterations {its} vs {it_twin}")
        if plan.items > 1:  # one launch for all: the easy item must stop first
            check(len(set(its)) > 1, f"batched cg {B}x{H}x{W}: the items did not stop apart ({its})")


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
              "tiled", 0.0),
             ("the 4K harness's size", torch.as_tensor(rng.uniform(-1, 1, (2, 2160, 3840)), dtype=f32, device=dev),
              "tiled", 0.0),
             ("the B = 4 batch's images", torch.as_tensor(rng.uniform(-1, 1, (8, 388, 584)), dtype=f32, device=dev),
              "tiled", 0.0)]
    for name, x, path, limit in cases:
        plan = rof_kernel.rof_plan(*x.shape, *limits)
        check(plan.path == path, f"rof {tuple(x.shape)}: path {plan.path}, expected {path}")
        out = rof_structure(x, 1.0 / 8, 100)
        ref = rof_structure_2d(x, 1.0 / 8, 100)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        print(f"rof {'x'.join(map(str, x.shape))} {name}, 100 iterations ({plan.path}, {rof_kernel.device_launches(plan)} "
              f"device launches): max|d| {err:.3e} (limit {limit:g}), torch.equal {torch.equal(out, ref)}")
        check(err <= limit and (limit > 0 or torch.equal(out, ref)), f"ROF kernel differs from its twin at {tuple(x.shape)}")
        if x is im:
            result_err = err
        del out, ref
    del cases
    plan = rof_kernel.rof_plan(*im.shape, *limits)
    tiled = rof_kernel.tiled_plan(100)
    # the tiled kernel and the resident one in turns: t, r, r, t
    t = [cuda_ms(torch, lambda p=p: rof_kernel.launch(im, 1.0 / 8, 100, p), 10) for p in (tiled, plan, plan, tiled)]
    ms, tiled_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    plain_ms = cuda_ms(torch, lambda: rof_structure_2d(im, 1.0 / 8, 100), 3)
    # per pixel and iteration ~28 operations (the primal at three points 15,
    # the gradient 2, the dual step 4, the norm 5, the division 2), then 5 for
    # the final primal; bytes: the image in, the structure out
    n = im.numel()
    b = bound(n * (28 * 100 + 5), 8 * n)
    print(f"rof 2x388x584: resident {t[1]:.3f} / {t[2]:.3f} ms, tiled {t[0]:.3f} / {t[3]:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})  [{card}]")
    return {"max_abs_err": result_err, "ms": ms, "plain_ms": plain_ms, **b, "tiled_ms": tiled_ms}


def phase_main_path(torch, dev, card, rgb1, rgb2, tu, tv):
    from optical_flow_tpu_torch import estimate_flow, flow_angular_error
    from optical_flow_tpu_torch.ops.cuda import cg_kernel, rof_kernel, wmedian_kernel

    # warm-up (allocator, cuBLAS), keeping a copy of each weighted median's
    # and each PCG solve's inputs
    recorded, recorded_cg = [], []
    with _recording(torch, recorded, recorded_cg):
        estimate_flow(rgb1, rgb2, "classic+nl-fast", PARAMS, device=dev)
    torch.cuda.synchronize()

    reset_counts()
    uv = estimate_flow(rgb1, rgb2, "classic+nl-fast", PARAMS, device=dev)
    torch.cuda.synchronize()
    launches = {"wmedian": wmedian_kernel.launches, "cg": cg_kernel.launches, "rof": rof_kernel.launches}
    by_path = {"cg resident": cg_kernel.launches_resident, "cg streaming": cg_kernel.launches_streaming,
               "rof resident": rof_kernel.launches_resident, "rof tiled": rof_kernel.launches_tiled}
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
    return launches, recorded, recorded_cg, frame_ms, uv


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
    n_diff, frac, valid = wmedian_valid(torch, finest, out, ref)
    print(f"wmedian main-path input {H}x{W} hsz {finest[5]}: {n_diff} of {out.numel()} values differ "
          f"({100 * frac:.4f}% identical), each a median within the sums' rounding: {valid}")
    check(frac >= WMEDIAN_SHARE and valid, "weighted median outside the sums' rounding on the main path's input")
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
    twin, one solve's time at each level shape, the 21 solves' sum.  Returns
    the results and the finest system (sysm, rtol, maxiter): of the finest
    shape, the one of most iterations."""
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits

    check(len(recorded) == 21, f"recorded {len(recorded)} PCG solves in a frame, expected 21")
    limits = device_limits(dev)
    levels, frame_ms, frame_bound, finest = {}, 0.0, 0.0, None
    for k, (sysm, rtol, maxiter) in enumerate(recorded):
        H, W = sysm.a11.shape
        plan = cg_kernel.cg_plan(1, H, W, *limits)
        x_k = cg_kernel.cg_solve(sysm, rtol, maxiter)
        it_k = cg_kernel.iteration_counts(dev)[0]
        again = cg_kernel.cg_solve(sysm, rtol, maxiter)
        err, limit, res, it_t = cg_compare(torch, sysm, rtol, maxiter, x_k, it_k)
        # the streaming kernel on the same system, for comparison
        x_s = cg_kernel.launch([f.contiguous() for f in sysm], rtol, maxiter, cg_kernel.streaming_plan(H, W, limits[0]))
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
    return ({"main_path_ms": ms, "main_path_plain_ms": plain_ms, "main_path_bound_ms": b["bound_ms"],
             "main_path_max_abs_err": err, "frame_sum_ms": frame_ms, "frame_sum_bound_ms": frame_bound},
            (sysm, rtol, maxiter))


def phase_profile(torch, dev, card, rgb1, rgb2, frame_ms, method="classic+nl-fast", params=PARAMS, run=None,
                  rof_device_launches=1, cg_device_launches=None):
    """One warm frame under torch.profiler: device busy time (the union of the
    device intervals), idle share, and device time by kernel; the plain
    median filter's device time (every kernel launched inside a
    ``median_pair`` call, or a median pass of Li–Osher denoising) is its own
    row.  ``run`` (a callable, labelled ``method``) replaces the frame of
    ``method``; ``rof_device_launches`` is the ROF device launches it must
    make, ``cg_device_launches`` (if given) the PCG device launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from optical_flow_tpu_torch import estimate_flow
    from optical_flow_tpu_torch.methods import ba as ba_mod, hs as hs_mod
    from optical_flow_tpu_torch.ops import denoise as denoise_mod

    def labelled(fn):
        def median(*args):
            with record_function("median_filter2d"):
                return fn(*args)
        return median

    saved = [(m, n, getattr(m, n)) for m, n in
             ((ba_mod, "median_pair"), (hs_mod, "median_pair"), (denoise_mod, "median_filter2d"))]
    torch.cuda.synchronize()
    for m, n, fn in saved:
        setattr(m, n, labelled(fn))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if run is None:
                estimate_flow(rgb1, rgb2, method, params, device=dev)
            else:
                run()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    # the ranges around median_pair appear once on the host and once as a
    # device annotation; only kernels count as device events
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.name != "median_filter2d"]
    if not events:
        print(f"profiled {method} frame: the trace holds no device events; device split not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    split = {"wmedian": 0.0, "cg": 0.0, "rof": 0.0, "median": 0.0, "other": 0.0}
    for e in events:
        key = next((k for k, tag in (("wmedian", "wmedian_kernel"), ("cg", "cg_"), ("rof", "rof_"))
                    if tag in e.name), "other")
        split[key] += e.time_range.end - e.time_range.start
    # the median row: the device time of every kernel launched inside a median_pair call
    ranges = [e for e in prof.events() if e.name == "median_filter2d" and e.device_type == DeviceType.CPU]
    split["median"] = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0) for e in ranges)
    split["other"] -= split["median"]
    busy_ms = busy_us / 1e3
    print(f"profiled {method} frame: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, {len(events)} device events, "
          f"idle share {1 - busy_ms / wall_ms:.3f} of the profiled frame and {1 - busy_ms / frame_ms:.3f} "
          f"of the unprofiled {frame_ms:.2f} ms frame  [{card}]")
    median_row = f"{split['median'] / 1e3:.3f}" if split["median"] or not ranges else "not measured"
    print(f"profiled {method} frame, device ms by kernel: " + ", ".join(
        f"{k} {v / 1e3:.3f}" if k != "median" else f"median filter ({len(ranges)} calls) {median_row}"
        for k, v in split.items()))
    rof_launches = sum("rof_" in e.name for e in events)
    cg_launches = sum("cg_" in e.name for e in events)
    print(f"profiled {method} frame: {rof_launches} ROF device launch(es), {cg_launches} PCG device launches")
    check(rof_launches == rof_device_launches,
          f"ROF made {rof_launches} device launches in the {method} frame, expected {rof_device_launches}")
    check(cg_device_launches is None or cg_launches == cg_device_launches,
          f"PCG made {cg_launches} device launches in the {method} frame, its counter {cg_device_launches}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / frame_ms,
            **{f"{k}_ms": v / 1e3 for k, v in split.items()}}


@contextlib.contextmanager
def no_plain_twins():
    """Within the block, a call of the PCG, ROF or weighted-median plain twin
    fails the run: nothing on a path may run them on the card."""
    from optical_flow_tpu_torch.ops.cuda import cg_kernel, rof_kernel, wmedian_kernel

    saved = [(m, n, getattr(m, n)) for m, n in ((cg_kernel, "cg_solve_plain"), (rof_kernel, "rof_structure_2d"),
                                                (wmedian_kernel, "wmedian_plain"))]
    for m, n, _ in saved:
        setattr(m, n, lambda *a, _n=n, **k: check(False, f"the plain twin {_n} ran on the path"))
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


@contextlib.contextmanager
def solve_log(torch, dev, keep=0, keep_shapes=()):
    """Within the block, each PCG call appends (level shape, each item's
    iterations, each item's right-hand side non-zero) to ``log["cg"]`` (a
    sync a call) and its device time (CUDA events) to ``log["cg_ms"]``,
    with clones of the last ``keep`` systems in ``log["kept"]`` and of the
    last system of each shape of ``keep_shapes`` in ``log["by_shape"]``, and
    each SOR call (level shape, each item's sweeps) to ``log["sor"]``."""
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.solvers import cg as cg_solvers

    log = {"cg": [], "cg_ms": [], "sor": [], "kept": [], "by_shape": {}}
    call, sor_call = cg_solvers.cg_solve, cg_solvers.sor_solve

    def recording(sysm, rtol, maxiter):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        x = call(sysm, rtol, maxiter)
        end.record()
        end.synchronize()
        log["cg_ms"].append(start.elapsed_time(end))
        if tuple(sysm.a11.shape[-2:]) in keep_shapes:
            log["by_shape"][tuple(sysm.a11.shape[-2:])] = (type(sysm)(*[f.clone() for f in sysm]), rtol, maxiter)
        live = ((sysm.b_u != 0) | (sysm.b_v != 0)).flatten(-2).any(-1).reshape(-1).tolist()
        log["cg"].append((tuple(sysm.a11.shape[-2:]), cg_kernel.item_iterations(dev), live))
        if keep:
            log["kept"].append((type(sysm)(*[f.clone() for f in sysm]), rtol, maxiter))
            del log["kept"][:-keep]
        return x

    def recording_sor(sysm, omega, max_iters, tol):
        x, k = sor_call(sysm, omega, max_iters, tol, return_iters=True)
        log["sor"].append((tuple(sysm.a11.shape[-2:]), k if isinstance(k, list) else [k]))
        return x

    cg_solvers.cg_solve, cg_solvers.sor_solve = recording, recording_sor
    try:
        yield log
    finally:
        cg_solvers.cg_solve, cg_solvers.sor_solve = call, sor_call


def level_runs(solves):
    """[(shape, solves, iterations)] for each run of equal shapes, in order:
    one pyramid level each."""
    runs = []
    for shape, iters in solves:
        if runs and runs[-1][0] == shape:
            runs[-1] = (shape, runs[-1][1] + 1, runs[-1][2] + iters)
        else:
            runs.append((shape, 1, iters))
    return runs


def reset_counts():
    """Set every kernel's launch count (PCG's iteration and item totals, the
    weighted median's items, the distributed PCG's solves, iterations and
    collective rounds) to 0."""
    from optical_flow_tpu_torch.ops.cuda import cg_kernel, rof_kernel, wmedian_kernel
    from optical_flow_tpu_torch.parallel import dist

    wmedian_kernel.reset_stats()
    rof_kernel.launches = rof_kernel.launches_resident = rof_kernel.launches_tiled = 0
    cg_kernel.reset_stats()
    dist.reset_counts()


def read_counts():
    """(launches by kernel, launches by path and PCG's items) since :func:`reset_counts`."""
    from optical_flow_tpu_torch.ops.cuda import cg_kernel, rof_kernel, wmedian_kernel

    return ({"wmedian": wmedian_kernel.launches, "cg": cg_kernel.launches, "rof": rof_kernel.launches},
            {"cg resident": cg_kernel.launches_resident, "rof resident": rof_kernel.launches_resident,
             "cg resident one item at a time": cg_kernel.launches_resident_per_item,
             "cg streaming": cg_kernel.launches_streaming, "rof tiled": rof_kernel.launches_tiled,
             "cg items": cg_kernel.items})


@contextlib.contextmanager
def guard_tally(torch):
    """Within the block, each level guard of alt-BA and HS appends a device
    bool (True: the level rolled back), 0-d or one an item of a batch, to the
    list it yields; nothing is read on the host.  The BA and Classic+NL
    guards are replayed from CUDA graphs (``utils/graphs.py``), which no
    wrapper sees; none of their presets turns the guard on."""
    from optical_flow_tpu_torch.methods import alt_ba, hs
    from optical_flow_tpu_torch.utils.guard import flow_is_healthy

    rolled = []
    saved = [(m, n, getattr(m, n)) for m, n in ((alt_ba, "guard_level_pair"), (hs, "guard_level"))]

    def tallied(fn, n_new):
        def guarded(*args):
            new, max_flow = args[:n_new], args[-1]
            rolled.append(~torch.stack([flow_is_healthy(f, max_flow) for f in new]).all(0))  # one an item
            return fn(*args)
        return guarded

    for m, n, fn in saved:
        setattr(m, n, tallied(fn, 2 if n == "guard_level_pair" else 1))
    try:
        yield rolled
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def frame_latency(torch, dev, name, params, rgb1, rgb2, mesh=None):
    """Median of LATENCY_RUNS warm frames by CUDA events, the runs, and the host
    clock's median; with ``mesh``, frames sharded on it."""
    from optical_flow_tpu_torch import estimate_flow

    where = {"device": dev} if mesh is None else {"mesh": mesh}
    ev_ms, host_ms = [], []
    for _ in range(LATENCY_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        estimate_flow(rgb1, rgb2, name, params, **where)
        end.record()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        ev_ms.append(start.elapsed_time(end))
    return statistics.median(ev_ms), ev_ms, statistics.median(host_ms)


def phase_path(torch, dev, card, label, name, params, gate, rgb1, rgb2, tu, tv, keep=0, solves_expected=None):
    """One path at full size: a warm-up frame that reads each PCG solve's
    iterations and each SOR solve's sweeps (a sync a solve), a counted frame
    (no plain twin may run; the level guards tallied on the device and read
    once after it), the accuracy gate ``((AAE, AEPE), (gate AAE, gate AEPE))``,
    or with ``gate`` None the guard's bound (finite, |uv| <= 1e9), and the
    latency.  Returns each kernel's launches in the counted frame and, with
    ``keep``, the frame's last ``keep`` PCG systems."""
    from optical_flow_tpu_torch import estimate_flow, flow_angular_error
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.solvers.sor import CHUNK

    with solve_log(torch, dev, keep) as log:
        t0 = time.perf_counter()
        estimate_flow(rgb1, rgb2, name, params, device=dev)
        torch.cuda.synchronize()
    solves = [(shape, its[0]) for shape, its, _ in log["cg"]]
    sweeps = [(shape, ks[0]) for shape, ks in log["sor"]]
    kept = log["kept"]
    print(f"{label}: warm-up frame {time.perf_counter() - t0:.2f} s (host clock, one sync a solve)")

    reset_counts()
    with no_plain_twins(), guard_tally(torch) as rolled:
        uv = estimate_flow(rgb1, rgb2, name, params, device=dev)
        torch.cuda.synchronize()
    launches, by_path = read_counts()
    cg_iters = cg_kernel.iteration_counts(uv.device)[1]
    rolled = [int(r) for r in torch.stack(rolled).tolist()] if rolled else []

    uv_np = uv.cpu().numpy()
    check(uv_np.shape == (388, 584, 2) and uv_np.dtype == np.float32, f"{label}: unexpected flow {uv_np.shape} {uv_np.dtype}")
    check(np.isfinite(uv_np).all(), f"{label}: flow is not finite")
    aae, _, aepe = flow_angular_error(tu, tv, uv_np[..., 0], uv_np[..., 1])
    if gate is None:
        print(f"{label} RubberWhale 584x388: AAE {aae:.4f} deg, AEPE {aepe:.6g} px (JAX package, CPU float32: "
              f"{ALT_JAX[0]} / {ALT_JAX[1]:g}; no gate, the trajectory diverges by design), max|uv| "
              f"{float(np.abs(uv_np).max()):.6g} (bound 1e9)")
    else:
        (t_aae, t_aepe), (g_aae, g_aepe) = gate
        print(f"{label} RubberWhale 584x388: AAE {aae:.4f} deg, AEPE {aepe:.5f} px (target {t_aae} / {t_aepe}, "
              f"gate {g_aae} / {g_aepe})")
    if rolled:
        print(f"{label}: the guard rolled back {sum(rolled)} of {len(rolled)} levels (coarse to fine, 1 = rolled "
              f"back): {rolled}")
    if solves:
        runs = level_runs(solves)
        cg_frame_bound = sum(cg_bound(h, w, i)["bound_ms"] for (h, w), i in solves)
        print(f"{label}: launches in one frame {launches}, {by_path}, CG iterations {cg_iters} "
              f"(warm-up {sum(i for _, i in solves)}), bound of the frame's solves {cg_frame_bound:.4f} ms; "
              "per level, coarse to fine (shape: solves, iterations): "
              + "; ".join(f"{h}x{w}: {k}, {i}" for (h, w), k, i in runs))
    if sweeps:
        runs = level_runs(sweeps)
        reads = sum(-(-k // CHUNK) for _, k in sweeps)
        print(f"{label}: launches in one frame {launches}, {by_path}; {len(sweeps)} SOR solves, {sum(k for _, k in sweeps)} "
              f"sweeps (per solve {min(k for _, k in sweeps)}-{max(k for _, k in sweeps)}); host reads a frame: "
              f"{reads} convergence flags + {len(sweeps)} update norms; per level, coarse to fine (shape: solves, "
              "sweeps, sweeps a solve): " + "; ".join(f"{h}x{w}: {k}, {i}, {i / k:.1f}" for (h, w), k, i in runs))
    if gate is None:
        check(float(np.abs(uv_np).max()) <= 1e9, f"{label}: flow beyond the guard's bound 1e9")
    else:
        check(abs(aae - t_aae) <= g_aae and abs(aepe - t_aepe) <= g_aepe, f"{label}: accuracy outside the gate")
    check(launches["cg"] == len(solves) and launches["rof"] == 1 and launches["wmedian"] == 0,
          f"{label}: unexpected launch counts {launches} ({len(solves)} PCG solves in the warm-up frame)")
    check(len(solves) + len(sweeps) > 0, f"{label}: no solve ran")
    check(by_path["cg resident"] == launches["cg"] and by_path["rof resident"] == 1, f"{label}: a solve left the resident path")
    check(cg_iters == sum(i for _, i in solves), f"{label}: CG iterations differ between two frames")
    if solves_expected is not None:
        check(len(solves) == solves_expected, f"{label}: {len(solves)} PCG solves in a frame, expected {solves_expected}")

    frame_ms, ev_ms, host_ms = frame_latency(torch, dev, name, params, rgb1, rgb2)
    print(f"{label}: per-frame latency, median of {LATENCY_RUNS} warm runs: {frame_ms:.2f} ms (CUDA events; "
          f"runs {', '.join(f'{x:.2f}' for x in ev_ms)}), {host_ms:.2f} ms (host clock)  [{card}]")
    return launches, kept, frame_ms


def _nonfinite_pattern(torch, x):
    return torch.isnan(x), torch.isinf(x)


def phase_alt_unguarded(torch, dev, card, rgb1, rgb2):
    """classic-c-a with ``guard_flow: None``: the trajectory must blow up (non-finite
    or beyond 1e20 somewhere), as the JAX package's does.  The first PCG system of
    the frame with a non-finite plane is held kernel against twin: the same
    iterations, the same NaN and inf entries of x, the finite entries within
    1e-5 x scale (the float32 twin or the twin with double sums, as phase 5)."""
    from optical_flow_tpu_torch import estimate_flow
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.solvers import cg as cg_solvers
    from optical_flow_tpu_torch.utils.guard import flow_health

    captured, count, call = [], [0], cg_solvers.cg_solve

    def capturing(sysm, rtol, maxiter):
        count[0] += 1
        if not captured and not all(bool(torch.isfinite(f).all()) for f in sysm):
            captured.append((count[0], type(sysm)(*[f.clone() for f in sysm]), rtol, maxiter))
        return call(sysm, rtol, maxiter)

    reset_counts()
    cg_solvers.cg_solve = capturing
    try:
        with no_plain_twins():
            uv = estimate_flow(rgb1, rgb2, "classic-c-a", ALT_UNGUARDED, device=dev)
            torch.cuda.synchronize()
    finally:
        cg_solvers.cg_solve = call
    launches, by_path = read_counts()
    health = flow_health(uv)
    uv_np = uv.cpu().numpy()
    blown = bool((~np.isfinite(uv_np)).any() or np.abs(uv_np[np.isfinite(uv_np)]).max() > 1e20)
    print(f"classic-c-a guard_flow None RubberWhale 584x388: {health}, blown up (non-finite or > 1e20): {blown}; "
          f"launches {launches}, {by_path}, {count[0]} PCG solves")
    check(blown, "classic-c-a without the guard did not blow up, unlike the JAX package")
    if not captured:
        print("classic-c-a guard_flow None: no PCG solve of the frame saw a non-finite plane")
        return launches
    k, sysm, rtol, maxiter = captured[0]
    H, W = sysm.a11.shape
    bad = {name: int((~torch.isfinite(f)).sum()) for name, f in zip(sysm._fields, sysm) if not bool(torch.isfinite(f).all())}
    x_k = cg_kernel.cg_solve(sysm, rtol, maxiter)
    it_k = cg_kernel.iteration_counts(dev)[0]
    pattern_k = _nonfinite_pattern(torch, x_k)
    verdicts = []
    for twin, sums in (("float32 twin", None), ("twin with double sums", torch.float64)):
        x_t, it_t = cg_twin(torch, sysm, rtol, maxiter, sums=sums)
        pattern_t = _nonfinite_pattern(torch, x_t)
        same_pattern = all(torch.equal(a, b) for a, b in zip(pattern_k, pattern_t))
        both = torch.isfinite(x_k) & torch.isfinite(x_t)
        err = float((x_k - x_t)[both].abs().max()) if bool(both.any()) else 0.0
        limit = 1e-5 * max(float(x_t[both].abs().max()) if bool(both.any()) else 0.0, 1.0)
        ok = it_t == it_k and same_pattern and err <= limit
        verdicts.append(ok)
        print(f"classic-c-a guard_flow None, PCG system {k} ({H}x{W}, rtol {rtol:g}; non-finite entries by plane {bad}): "
              f"iterations kernel {it_k} / {twin} {it_t}; x non-finite kernel {int((~torch.isfinite(x_k)).sum())} "
              f"(NaN {int(pattern_k[0].sum())}) / twin {int((~torch.isfinite(x_t)).sum())}, same NaN and inf entries "
              f"{same_pattern}; finite entries max|dx| {err:.3e} (limit {limit:.3e})")
    check(any(verdicts), f"cg: the kernel differs from both twins on the non-finite system {k}")
    return launches


def phase_guard_noop(torch, dev, rgb1, rgb2):
    """hs with ``guard_flow: 1e9`` equals hs without it, bit for bit, on the card."""
    from optical_flow_tpu_torch import estimate_flow

    plain = estimate_flow(rgb1, rgb2, "hs", PATH_PARAMS, device=dev)
    reset_counts()
    with no_plain_twins():
        guarded = estimate_flow(rgb1, rgb2, "hs", {**PATH_PARAMS, "guard_flow": 1e9}, device=dev)
        torch.cuda.synchronize()
    launches, _ = read_counts()
    again = estimate_flow(rgb1, rgb2, "hs", PATH_PARAMS, device=dev)
    same, repeat = bool(torch.equal(plain, guarded)), bool(torch.equal(plain, again))
    print(f"hs guard_flow 1e9 against no guard, RubberWhale 584x388: torch.equal {same} (no guard run twice: "
          f"torch.equal {repeat}); launches {launches}")
    check(same, "the guard changed a healthy hs frame")
    return launches


def relative_residual(torch, sysm, x):
    """||A x - b|| / ||b|| in float64."""
    from optical_flow_tpu_torch.ops.stencil import FlowSystem, system_apply

    b = torch.stack([sysm.b_u, sysm.b_v], -1).double()
    return float(torch.linalg.norm(system_apply(FlowSystem(*[f.double() for f in sysm]), x.double()) - b)
                 / torch.linalg.norm(b))


def phase_cg_finest(torch, dev, card, recorded):
    """classic++'s last 10 solves (the finest level of the last GNC stage, rtol
    1e-7, maxiter 1000) against the plain twin, as phase 5 holds them: within
    1e-5 x scale of the float32 twin or of the twin with double sums.  Equal
    iterations are not required (the sums' types differ); the residual must
    be within 10 x rtol or twice the float32 twin's."""
    from optical_flow_tpu_torch.ops.cuda import cg_kernel

    check(len(recorded) == 10, f"recorded {len(recorded)} classic++ solves, expected 10")
    total_ms = 0.0
    for k, (sysm, rtol, maxiter) in enumerate(recorded):
        H, W = sysm.a11.shape
        x_k = cg_kernel.cg_solve(sysm, rtol, maxiter)
        it_k = cg_kernel.iteration_counts(dev)[0]
        x_t, it_t = cg_twin(torch, sysm, rtol, maxiter)
        x_d, it_d = cg_twin(torch, sysm, rtol, maxiter, sums=torch.float64)
        limit = 1e-5 * max(float(x_t.abs().max()), 1.0)
        err, err_d = (float((x_k - x).abs().max()) for x in (x_t, x_d))
        res, res_t = relative_residual(torch, sysm, x_k), relative_residual(torch, sysm, x_t)
        ms = cuda_ms(torch, lambda: cg_kernel.cg_solve(sysm, rtol, maxiter), 3)
        total_ms += ms
        print(f"cg classic++ finest system {k + 1} {H}x{W} rtol {rtol:g}: iterations kernel {it_k} / plain {it_t} / "
              f"plain, double sums {it_d}; max|dx| / limit against the plain twin {err / limit:.3f}, against it with "
              f"double sums {err_d / limit:.3f}; relative residual kernel {res:.3e}, plain twin {res_t:.3e}; "
              f"{ms:.3f} ms ({1e3 * ms / max(it_k, 1):.2f} us an iteration)  [{card}]")
        check(min(err, err_d) <= limit and res <= max(10 * rtol, 2 * res_t),
              f"cg classic++ system {k + 1}: max|dx| {err:.3e}, {err_d:.3e} with double sums (limit {limit:.3e}); "
              f"residual {res:.3e} (twin {res_t:.3e})")
    print(f"cg classic++, the 10 finest solves one by one: {total_ms:.3f} ms  [{card}]")


def phase_plain_ops(torch, dev, card):
    """The median filter and the B-spline prefilter (plain PyTorch on every
    path) at 388x584 on the card: equal to the CPU (the median bit for bit,
    the prefilter's float32 products within 1e-5 of float64), one call's time."""
    from optical_flow_tpu_torch.methods.base import median_pair
    from optical_flow_tpu_torch.ops.filters import median_filter2d
    from optical_flow_tpu_torch.ops.interp import spline_coeffs_2d

    rng = np.random.default_rng(SEED + 3)
    uv_np = rng.standard_normal((388, 584, 2)).astype(np.float32)
    uv_np[rng.uniform(size=uv_np.shape) < 1e-3] = np.nan
    uv = torch.as_tensor(uv_np, device=dev)
    out = median_pair(uv, (5, 5)).cpu()
    ref = median_pair(torch.as_tensor(uv_np), (5, 5))
    same = bool(torch.equal(out.isnan(), ref.isnan()) and torch.equal(out.nan_to_num(), ref.nan_to_num()))
    pair_ms = cuda_ms(torch, lambda: median_pair(uv, (5, 5)), 20)
    plane_ms = cuda_ms(torch, lambda: median_filter2d(uv[..., 0], 5), 20)
    # bound of the pair: each field read once and written once; a sort's
    # K2 log2 K2 compares a pixel and field, whatever the method
    n = uv.numel()
    b = bound(n * 25 * math.log2(25), 8 * n)
    print(f"median_filter2d 5x5 at 388x584 on the card: equal to the CPU bit for bit (NaNs included): {same}; "
          f"one call on the flow pair {pair_ms:.3f} ms (bound {b['bound_ms']:.4f} ms, {b['bound_by']}), "
          f"on one plane {plane_ms:.3f} ms  [{card}]")
    check(same, "median filter differs between the card and the CPU")

    tables_np = rng.uniform(0, 255, (3, 388, 584)).astype(np.float32)
    tables = torch.as_tensor(tables_np, device=dev)
    coeffs = spline_coeffs_2d(tables).cpu().double()
    ref = spline_coeffs_2d(torch.as_tensor(tables_np, dtype=torch.float64))
    err = float(((coeffs - ref).abs() / ref.abs().max()).max())
    spline_ms = cuda_ms(torch, lambda: spline_coeffs_2d(tables), 20)
    K, H, W = tables.shape
    b = bound(2 * K * (H * H * W + H * W * W), 4 * (2 * K * H * W + H * H + W * W))
    print(f"spline_coeffs_2d at 3x388x584 (one level's im2, I2x, I2y) on the card: max |d| / max |c| {err:.2e} "
          f"against float64 (limit 1e-5), one call {spline_ms:.3f} ms (bound {b['bound_ms']:.4f} ms, "
          f"{b['bound_by']})  [{card}]")
    check(err <= 1e-5, "B-spline prefilter outside 1e-5 of float64 on the card")
    # a batch of 3 such stacks: one product over the batch chooses its kernel
    # from the batch's shape; item by item, each item gets an unbatched call's bits
    batch = torch.stack([tables, tables.flip(-1), 0.5 * tables])
    joint = spline_coeffs_2d(batch.reshape(-1, H, W)).reshape(batch.shape)
    each = spline_coeffs_2d(batch, 1)
    torch.cuda.synchronize()
    same = [torch.equal(each[k], spline_coeffs_2d(batch[k])) for k in range(3)]
    print(f"spline_coeffs_2d on a batch of 3 x 3x388x584: one product over the batch equal to the unbatched calls "
          f"{[torch.equal(joint[k], spline_coeffs_2d(batch[k])) for k in range(3)]}; item by item (the batched "
          f"'cubic' warp's route) {same}")
    check(all(same), "the item-by-item B-spline prefilter differs from its unbatched calls")


def _recording(torch, record_wmedian, record_cg, record_rof=None):
    """Context: the weighted-median, PCG and ROF calls of the block append
    clones of their inputs to the lists; a list that is None records nothing."""
    from optical_flow_tpu_torch.ops import rof as rof_op, wmedian as wmedian_op
    from optical_flow_tpu_torch.solvers import cg as cg_solvers

    kernel_call, cg_call, rof_call = wmedian_op.wmedian, cg_solvers.cg_solve, rof_op.rof_structure

    def recording(*args):
        record_wmedian.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return kernel_call(*args)

    def recording_cg(sysm, rtol, maxiter):
        record_cg.append((type(sysm)(*[f.clone() for f in sysm]), rtol, maxiter))
        return cg_call(sysm, rtol, maxiter)

    def recording_rof(im, theta, n_iters):
        record_rof.append((im.clone(), theta, n_iters))
        return rof_call(im, theta, n_iters)

    @contextlib.contextmanager
    def ctx():
        if record_wmedian is not None:
            wmedian_op.wmedian = recording
        if record_cg is not None:
            cg_solvers.cg_solve = recording_cg
        if record_rof is not None:
            rof_op.rof_structure = recording_rof
        try:
            yield
        finally:
            wmedian_op.wmedian, cg_solvers.cg_solve, rof_op.rof_structure = kernel_call, cg_call, rof_call

    return ctx()


def _batch_of(pairs):
    return np.stack([p[1] for p in pairs]), np.stack([p[2] for p in pairs])


def check_recorded_rof(torch, dev, card, recorded, label):
    """The one ROF call a batch recorded, kernel against twin on its own input
    (bit for bit on either path, as phase 2 requires)."""
    from optical_flow_tpu_torch.ops.cuda import rof_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits
    from optical_flow_tpu_torch.ops.cuda.rof_kernel import rof_structure, rof_structure_2d

    check(len(recorded) == 1, f"{label}: recorded {len(recorded)} ROF calls, expected 1")
    im, theta, n_iters = recorded[0]
    plan = rof_kernel.rof_plan(*im.shape, *device_limits(dev))
    out = rof_structure(im, theta, n_iters)
    ref = rof_structure_2d(im, theta, n_iters)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    ms = cuda_ms(torch, lambda: rof_structure(im, theta, n_iters), 5)
    print(f"rof {label}: {'x'.join(map(str, im.shape))} ({plan.path}, {rof_kernel.device_launches(plan)} device "
          f"launches), {n_iters} iterations: max|d| against the twin {err:.3e} (bit for bit required), {ms:.3f} ms  "
          f"[{card}]")
    check(torch.equal(out, ref), f"{label}: the ROF kernel differs from its twin on the batch's input")
    return {"rof_path": plan.path, "rof_max_abs_err": err, "rof_ms": ms}


def phase_batch(torch, dev, card, pairs):
    """``estimate_flow_batched_rgb`` on the real pairs of ``pairs`` (sequence,
    rgb1, rgb2, tu, tv) as one batch: launches by path (no plain twin), each
    item inside the classic+nl-fast gate against the reference oracle of its
    sequence and within the float32 slice bounds of its own single-pair run
    (mean |d| <= 1e-3 px, 99th percentile <= 1e-2 px, max <= 0.5 px; it is
    bit-identical where every op gives an item an unbatched call's bits),
    identical pairs bit-identical; then
    the batch's recorded PCG systems
    (kernel against twin item by item, time and bound by level) and its
    finest weighted-median call (against one launch per item and the twin)."""
    from optical_flow_tpu_torch import estimate_flow, flow_angular_error
    from optical_flow_tpu_torch.evaluation.gates import GATES, REF_ORACLE
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits
    from optical_flow_tpu_torch.ops.stencil import FlowSystem
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched_rgb

    B = len(pairs)
    im1, im2 = _batch_of(pairs)
    recorded_wm, recorded_cg, recorded_rof = [], [], []
    with _recording(torch, recorded_wm, recorded_cg, recorded_rof):
        estimate_flow_batched_rgb(im1, im2, "classic+nl-fast", params=PARAMS, device=dev)
    torch.cuda.synchronize()
    limits = device_limits(dev)
    check(len(recorded_cg) == 21, f"recorded {len(recorded_cg)} batched PCG calls, expected 21")
    # one launch a call, or one an item where the plan says so
    plans = [cg_kernel.cg_plan(B, *sysm.a11.shape[-2:], *limits) for sysm, _, _ in recorded_cg]
    cg_expected = sum(cg_kernel.device_launches(B, p) for p in plans)
    per_item = sum(cg_kernel.device_launches(B, p) for p in plans if p.items < B)

    reset_counts()
    with no_plain_twins():
        uv = estimate_flow_batched_rgb(im1, im2, "classic+nl-fast", params=PARAMS, device=dev)
        torch.cuda.synchronize()
    launches, by_path = read_counts()
    iters = cg_kernel.iteration_counts(dev)[1]
    print(f"batch B {B} ({', '.join(p[0] for p in pairs)}) 584x388 classic+nl-fast: launches {launches}, {by_path}, "
          f"CG iterations over all items {iters}; PCG device launches expected from the plans {cg_expected}, "
          f"{per_item} of them one item a launch")
    check(launches == {"wmedian": 21, "cg": cg_expected, "rof": 1} and by_path["cg items"] == 21 * B
          and by_path["cg resident"] == cg_expected and by_path["cg resident one item at a time"] == per_item,
          f"batch: unexpected launches {launches}, {by_path}")
    LARGE_IMAGE_LAUNCHES["batch"] = (by_path["rof tiled"], by_path["cg streaming"])

    uv_np = uv.cpu().numpy()
    check(uv_np.shape == (B, 388, 584, 2) and np.isfinite(uv_np).all(), f"batch: flow {uv_np.shape} not finite")
    g_aae, g_aepe = GATES["classic+nl-fast"]
    failed = []
    for k, (seq, a, b, tu, tv) in enumerate(pairs):
        aae, _, aepe = flow_angular_error(tu, tv, uv_np[k, ..., 0], uv_np[k, ..., 1])
        o_aae, o_aepe = REF_ORACLE[seq]
        single = estimate_flow(a, b, "classic+nl-fast", PARAMS, device=dev).cpu().numpy()
        d = np.abs(uv_np[k] - single)
        print(f"batch item {k} {seq}: AAE {aae:.4f} deg, AEPE {aepe:.5f} px (reference oracle {o_aae} / {o_aepe}, "
              f"gate {g_aae} / {g_aepe}); against its single-pair run: bit-identical {np.array_equal(uv_np[k], single)}, "
              f"|d| mean {d.mean():.3e}, 99th percentile {np.percentile(d, 99):.3e}, max {d.max():.3e} px")
        if not (abs(aae - o_aae) <= g_aae and abs(aepe - o_aepe) <= g_aepe):
            failed.append(f"batch item {k} {seq}: outside the gate")
        if not (d.mean() <= 1e-3 and np.percentile(d, 99) <= 1e-2 and d.max() <= 0.5):
            failed.append(f"batch item {k} {seq}: outside the float32 slice bounds of its single-pair run")
    check(not failed, "; ".join(failed))
    same = [(i, j) for i in range(B) for j in range(i + 1, B) if pairs[i][0] == pairs[j][0]]
    for i, j in same:
        print(f"batch items {i} and {j} ({pairs[i][0]} twice): torch.equal {torch.equal(uv[i], uv[j])}")
        check(torch.equal(uv[i], uv[j]), f"batch items {i} and {j} differ on the same pair")

    # the batch's PCG calls, item by item against the twin, time and bound by level
    levels, frame_ms, frame_bound = {}, 0.0, 0.0
    for sysm, rtol, maxiter in recorded_cg:
        H, W = sysm.a11.shape[-2:]
        plan = cg_kernel.cg_plan(B, H, W, *limits)
        x = cg_kernel.cg_solve(sysm, rtol, maxiter)
        its = cg_kernel.item_iterations(dev)
        worst, it_t = 0.0, []
        for k in range(B):
            item = FlowSystem(*[f[k] for f in sysm])
            err, limit, res, it = cg_compare(torch, item, rtol, maxiter, x[k], its[k])
            if err > limit:  # the kernels sum in double: the twin with double sums is their recurrence
                x_d = cg_twin(torch, item, rtol, maxiter, sums=torch.float64)[0]
                err = min(err, float((x[k] - x_d).abs().max()))
            check(err <= limit and res <= 10 * rtol, f"batched cg {H}x{W} item {k}: max|dx| {err:.3e} (limit {limit:.3e})")
            worst = max(worst, err / limit)
            it_t.append(it)
        ms = cuda_ms(torch, lambda: cg_kernel.cg_solve(sysm, rtol, maxiter), 3)
        b = sum(cg_bound(H, W, i)["bound_ms"] for i in its)
        frame_ms += ms
        frame_bound += b
        lv = levels.setdefault((H, W), {"plan": plan, "calls": 0, "its": [0] * B, "it_t": [0] * B, "ms": 0.0,
                                        "bound": 0.0, "err": 0.0})
        lv["calls"] += 1
        lv["its"] = [a + c for a, c in zip(lv["its"], its)]
        lv["it_t"] = [a + c for a, c in zip(lv["it_t"], it_t)]
        lv["ms"] += ms
        lv["bound"] += b
        lv["err"] = max(lv["err"], worst)
    torch.cuda.synchronize()
    for (H, W), lv in levels.items():
        p = lv["plan"]
        print(f"cg batch B {B} level {H}x{W} ({p.path}, {p.blocks} bands an item, {p.items} items a launch): "
              f"{lv['calls']} calls, iterations by item kernel {lv['its']} / plain {lv['it_t']}, {lv['ms']:.4f} ms "
              f"({lv['ms'] / lv['calls']:.4f} ms a call), bound {lv['bound']:.4f} ms; worst max|dx| / limit "
              f"{lv['err']:.3f}  [{card}]")
    print(f"cg batch B {B}, the 21 calls one by one: {frame_ms:.3f} ms, bound {frame_bound:.4f} ms  [{card}]")

    # the finest weighted-median call of the batch: one launch for B items
    wm = check_batched_wmedian(torch, card, f"wmedian batch B {B}", max(recorded_wm, key=lambda a: a[4][0] * a[4][1]))
    rof = check_recorded_rof(torch, dev, card, recorded_rof, f"batch B {B}")
    return launches, by_path, {"batch_frame_sum_ms": frame_ms, "batch_frame_sum_bound_ms": frame_bound}, \
        {"batch_main_path_ms": wm["ms"], "batch_per_item_ms": wm["per_item_ms"],
         "batch_main_path_bound_ms": wm["bound_ms"]}, \
        {"batch_" + k: v for k, v in rof.items()}


def check_batched_wmedian(torch, card, label, args):
    """A batch's recorded weighted-median input ``args`` (B items, one
    launch): the launch against one launch per item and, item by item,
    against the twin (``wmedian_valid``), a second run bit for bit, and the
    launch's time beside its bound (the items' bounds summed)."""
    from optical_flow_tpu_torch.ops.cuda.wmedian_kernel import wmedian, wmedian_plain

    B, (H, W) = args[0].shape[0], args[4]
    item_args = [(*[x[k] for x in args[:4]], *args[4:]) for k in range(B)]
    out = wmedian(*args)
    again = wmedian(*args)
    each = torch.stack([wmedian(*a) for a in item_args])
    ref = wmedian_plain(*args)
    torch.cuda.synchronize()
    valid = [wmedian_valid(torch, item_args[k], out[k], ref[k]) for k in range(B)]
    ms = cuda_ms(torch, lambda: wmedian(*args), 10)
    ms_each = cuda_ms(torch, lambda: [wmedian(*a) for a in item_args], 10)
    wb = sum(wmedian_bound(a)["bound_ms"] for a in item_args)
    print(f"{label} x {H}x{W} hsz {args[5]}: one launch equal to one launch per item {torch.equal(out, each)}, "
          f"to a second run {torch.equal(out, again)}; against the twin, values differing by item "
          f"{[a[0] for a in valid]}, each a median within the sums' rounding by item {[a[2] for a in valid]}; "
          f"one launch {ms:.3f} ms, one launch per item {ms_each:.3f} ms, bound {wb:.4f} ms  [{card}]")
    check(torch.equal(out, again), f"{label} {H}x{W}: weighted median differs between two runs on the same input")
    check(torch.equal(out, each) and all(a[1] >= WMEDIAN_SHARE and a[2] for a in valid),
          f"{label} {H}x{W}: batched weighted median differs from one launch per item, or from the twin beyond "
          "the sums' rounding")
    return {"ms": ms, "per_item_ms": ms_each, "bound_ms": wb, "differing": [a[0] for a in valid],
            "max_abs_err": float((out - ref).abs().max())}


def phase_scaling(torch, dev, card, pairs):
    """Batched latency at B = 1, 3 and 4 beside B single frames (median of
    LATENCY_RUNS warm runs each, CUDA events), the ROF path each batch took
    (the B = 3 call, on the resident path, against the twin on its own
    input), and one profiled B = 4 call whose PCG device launches must equal
    the launch count of an unprofiled one."""
    from optical_flow_tpu_torch.ops.cuda import rof_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched_rgb

    single_ms, single_runs, _ = frame_latency(torch, dev, "classic+nl-fast", PARAMS, pairs[0][1], pairs[0][2])
    print(f"scaling: single frame (RubberWhale) {single_ms:.2f} ms, runs {', '.join(f'{x:.2f}' for x in single_runs)}"
          f"  [{card}]")
    out = {"single_ms": single_ms}
    for B in (1, 3, 4):
        im1, im2 = _batch_of(pairs[:B])

        def run():
            return estimate_flow_batched_rgb(im1, im2, "classic+nl-fast", params=PARAMS, device=dev)

        recorded_rof = []
        with _recording(torch, None, None, recorded_rof):
            run()
        if B == 3:
            rof = check_recorded_rof(torch, dev, card, recorded_rof, "batch B 3")
            out.update({"batch3_" + k: v for k, v in rof.items()})
        reset_counts()
        run()
        torch.cuda.synchronize()
        cg_launches = read_counts()[0]["cg"]
        ev_ms = []
        for _ in range(LATENCY_RUNS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            ev_ms.append(start.elapsed_time(end))
        ms = statistics.median(ev_ms)
        rof_plan = rof_kernel.rof_plan(2 * B, 388, 584, *device_limits(dev))
        rof_path = rof_plan.path
        print(f"scaling: batch B {B}: {ms:.2f} ms (runs {', '.join(f'{x:.2f}' for x in ev_ms)}), {ms / B:.2f} ms a pair; "
              f"{B} single frames {B * single_ms:.2f} ms; ratio {B * single_ms / ms:.3f}; ROF on {2 * B} images "
              f"{rof_path}; PCG device launches {cg_launches}  [{card}]")
        out[f"batch{B}_ms"] = ms
    prof = phase_profile(torch, dev, card, None, None, out["batch4_ms"], "batch B 4", run=run,
                         rof_device_launches=rof_kernel.device_launches(rof_plan), cg_device_launches=cg_launches)
    return out, prof


def phase_video_stream(torch, dev, card, pairs, cg_batch4):
    """``estimate_flow_video`` on 5 gray frames of RubberWhale rolled 1 px a
    frame (inner mean u ~ 1), and ``estimate_flow_stream`` over the real
    pairs, each flow equal to its single-pair run, in order."""
    from optical_flow_tpu_torch import estimate_flow
    from optical_flow_tpu_torch.parallel.video import estimate_flow_stream, estimate_flow_video
    from optical_flow_tpu_torch.utils.compat import rgb2gray

    gray = rgb2gray(torch.as_tensor(pairs[0][1])).numpy()
    frames = np.stack([np.roll(gray, k, axis=1) for k in range(5)])
    estimate_flow_video(frames, "classic+nl-fast", params=PARAMS, device=dev)
    reset_counts()
    with no_plain_twins():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        uv = estimate_flow_video(frames, "classic+nl-fast", params=PARAMS, device=dev)
        end.record()
        torch.cuda.synchronize()
    video, by_path = read_counts()
    uv_np = uv.cpu().numpy()
    inner = uv_np[:, 20:-20, 20:-20]
    means = [(float(m[..., 0].mean()), float(m[..., 1].mean())) for m in inner]
    print(f"video: 5 gray frames of RubberWhale rolled 1 px a frame: flows {uv_np.shape}, inner mean (u, v) by pair "
          f"{[(round(u, 4), round(v, 4)) for u, v in means]}; launches {video}, {by_path}; "
          f"{start.elapsed_time(end):.2f} ms for the 4 pairs  [{card}]")
    check(uv_np.shape == (4, 388, 584, 2) and np.isfinite(uv_np).all(), "video: flow not finite")
    check(all(abs(u - 1.0) <= 0.05 and abs(v) <= 0.05 for u, v in means), "video: the 1 px shift is not recovered")
    # the 4 pairs run as one batch of 4 with the batch phase's PCG plans
    check(video == {"wmedian": 0, "cg": cg_batch4, "rof": 1} and by_path["cg items"] == 84, f"video: launches {video}")

    seqs = pairs[:3]
    reset_counts()
    with no_plain_twins():
        t0 = time.perf_counter()
        outs = list(estimate_flow_stream(iter([(p[1], p[2]) for p in seqs]), "classic+nl-fast", PARAMS,
                                         max_in_flight=2, device=dev))
        stream_ms = 1e3 * (time.perf_counter() - t0)
    stream, _ = read_counts()
    same = [bool(np.array_equal(o, estimate_flow(p[1], p[2], "classic+nl-fast", PARAMS, device=dev).cpu().numpy()))
            for o, p in zip(outs, seqs)]
    print(f"stream: {len(outs)} pairs ({', '.join(p[0] for p in seqs)}), max_in_flight 2: {stream_ms:.2f} ms "
          f"(host clock), {stream_ms / len(outs):.2f} ms a pair; equal to one estimate_flow a pair, in order: {same}; "
          f"launches {stream}  [{card}]")
    check(len(outs) == 3 and all(same), "stream: a flow differs from its single-pair run")
    check(stream == {"wmedian": 63, "cg": 63, "rof": 3}, f"stream: launches {stream}")
    return video, stream


def item_level_warps(entries, k):
    """[(level shape, warp iterations)] of item ``k`` for each run of equal
    level shapes in a PCG log: the calls in which its right-hand side was not zero."""
    return [(shape, n) for shape, _, n in level_runs([(shape, int(live[k])) for shape, _, live in entries])]


def stopped_items_cost_nothing(entries):
    """True if, within each level, an item whose right-hand side has become
    zero keeps it zero and runs 0 PCG iterations in every later call."""
    stopped, shape0 = set(), None
    for shape, its, live in entries:
        if shape != shape0:
            stopped, shape0 = set(), shape
        for k, (n, on) in enumerate(zip(its, live)):
            if k in stopped and (on or n):
                return False
            if not on:
                if n:
                    return False
                stopped.add(k)
    return True


def batch_latency(torch, dev, method, items):
    """Median of LATENCY_RUNS warm ``estimate_flow_batched_rgb`` calls on ``items``, by CUDA events, and the runs."""
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched_rgb

    im1, im2 = _batch_of(items)
    estimate_flow_batched_rgb(im1, im2, method, params=PATH_PARAMS, device=dev)
    ev_ms = []
    for _ in range(LATENCY_RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        estimate_flow_batched_rgb(im1, im2, method, params=PATH_PARAMS, device=dev)
        end.record()
        torch.cuda.synchronize()
        ev_ms.append(start.elapsed_time(end))
    return statistics.median(ev_ms), ev_ms


def family_gate(label, seq):
    """((AAE, AEPE), (gate AAE, gate AEPE)) of an item of a family batch, or None:
    the reference oracle's hs and classic++ gates on every sequence, the hs
    gate for hs + SOR and JAX's stable alt-BA values on RubberWhale."""
    from optical_flow_tpu_torch.evaluation.gates import GATES, METHOD_ORACLE, SEQ_GATES

    method = {"hs": "hs", "classic++": "classic++", "hs sor": "hs"}.get(label)
    if method is not None and (label != "hs sor" or seq == "RubberWhale"):
        return METHOD_ORACLE[method][seq], SEQ_GATES.get((method, seq), GATES[method])
    if label == "classic-c-a stable" and seq == "RubberWhale":
        return ALT_STABLE_GATE
    return None


def phase_batch_families(torch, dev, card, pairs):
    """The BA, Horn–Schunck and alt-BA families through ``estimate_flow_batched_rgb``
    on real 584x388 frame-10 pairs (and a static pair, RubberWhale's frame 10
    twice), each batch counted (no plain twin; the counts set to 0 just before
    it), each item against its own single-pair run on the card: see
    ``FAMILY_BATCHES``.  Returns each batch's launches."""
    from optical_flow_tpu_torch import estimate_flow, flow_angular_error
    from optical_flow_tpu_torch.config import load_of_method
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits
    from optical_flow_tpu_torch.ops.stencil import FlowSystem
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched_rgb

    t_phase = time.perf_counter()
    seqs = {p[0]: p for p in pairs}
    seqs["static"] = ("static", seqs["RubberWhale"][1], seqs["RubberWhale"][1], None, None)
    launches = {}
    for label, method, params, names in FAMILY_BATCHES:
        items = [seqs[n] for n in names]
        B = len(items)
        im1, im2 = _batch_of(items)
        recorded_rof = []
        reset_counts()
        with no_plain_twins(), guard_tally(torch) as rolled, _recording(torch, None, None, recorded_rof), \
                solve_log(torch, dev, keep=10 if label == "classic++" else 0) as log:
            uv = estimate_flow_batched_rgb(im1, im2, method, params=params, device=dev)
            torch.cuda.synchronize()
        counts, by_path = read_counts()
        launches[f"batch {label}"] = counts
        uv_np = uv.cpu().numpy()
        rolled = torch.stack(rolled).tolist() if rolled else []
        print(f"batch {label} B {B} ({', '.join(names)}) 584x388: launches {counts}, {by_path}, CG iterations over all "
              f"items {cg_kernel.iteration_counts(dev)[1]}, {len(log['sor'])} SOR calls")
        check(uv_np.shape == (B, 388, 584, 2) and np.isfinite(uv_np).all(), f"batch {label}: flow not finite")
        ope = load_of_method(method)
        ope.parse_input_parameter(params)
        cg_expected = sum(cg_kernel.device_launches(B, cg_kernel.cg_plan(B, *shape, *device_limits(dev)))
                          for shape, _, _ in log["cg"])
        check(counts == {"wmedian": 0, "cg": cg_expected, "rof": int(bool(ope.texture))}
              and by_path["cg items"] == B * len(log["cg"]), f"batch {label}: unexpected launches {counts}, {by_path}")

        failed = []
        for k, (name, a, b, tu, tv) in enumerate(items):
            with solve_log(torch, dev) as slog, guard_tally(torch) as srolled:
                single = estimate_flow(a, b, method, params, device=dev).cpu().numpy()
            same = np.array_equal(uv_np[k], single)
            d = float(np.abs(uv_np[k] - single).max())
            line = f"batch {label} item {k} {name}: against its single-pair run bit-identical {same}, max |d| {d:.3e} px"
            if tu is not None:
                aae, _, aepe = flow_angular_error(tu, tv, uv_np[k, ..., 0], uv_np[k, ..., 1])
                line += f"; AAE {aae:.4f} deg, AEPE {aepe:.5f} px"
                gate = family_gate(label, name)
                if gate is not None:
                    (t_aae, t_aepe), (g_aae, g_aepe) = gate
                    line += f" (target {t_aae} / {t_aepe}, gate {g_aae} / {g_aepe})"
                    if not (abs(aae - t_aae) <= g_aae and abs(aepe - t_aepe) <= g_aepe):
                        failed.append(f"batch {label} item {k} {name}: outside the gate")
            if label.startswith("hs") and log["cg"]:
                warps = item_level_warps(log["cg"], k)
                single_warps = item_level_warps(slog["cg"], 0)
                line += f"; warp iterations by level, coarse to fine: {[n for _, n in warps]} (single run " \
                        f"{[n for _, n in single_warps]})"
                if warps != single_warps:
                    failed.append(f"batch {label} item {k} {name}: warp iterations differ from its single run")
            if log["sor"]:
                sweeps = [n for _, _, n in level_runs([(s, ks[k]) for s, ks in log["sor"]])]
                single_sweeps = [n for _, _, n in level_runs([(s, ks[0]) for s, ks in slog["sor"]])]
                line += f"; SOR sweeps by level {sweeps} (single run {single_sweeps})"
                limit = 1e-2 * max(float(np.abs(single).max()), 1.0)  # SOR's own tolerance
                if name == "static" and d > limit:
                    failed.append(f"batch {label} item {k}: beyond SOR's tolerance of its single run")
            elif not same:
                failed.append(f"batch {label} item {k} {name}: not bit-identical to its single-pair run")
            if rolled:
                mine = [int(r[k]) for r in rolled]
                theirs = [int(r) for r in torch.stack(srolled).tolist()]
                line += f"; levels rolled back {mine} (single run {theirs})"
                if mine != theirs:
                    failed.append(f"batch {label} item {k}: other levels rolled back than in its single run")
            if label == "classic-c-a" and not float(np.abs(uv_np[k]).max()) <= 1e9:
                failed.append(f"batch {label} item {k}: flow beyond the guard's bound 1e9")
            print(line + f"  [{card}]")
        check(not failed, "; ".join(failed))

        if label == "hs-brightness":
            k = names.index("static")
            others_on = any(not live[k] and any(live) for _, _, live in log["cg"])
            print(f"batch {label}: the static item stopped on its own while the others went on {others_on}; every "
                  f"stopped item ran 0 PCG iterations in every later call of its level "
                  f"{stopped_items_cost_nothing(log['cg'])}")
            check(others_on and stopped_items_cost_nothing(log["cg"]), f"batch {label}: the per-item stop failed")
        if label == "hs":
            check_recorded_rof(torch, dev, card, recorded_rof, f"batch {label} B {B}")
        if label == "classic++":
            worst, its_k, its_t = 0.0, [], []
            for sysm, rtol, maxiter in log["kept"]:
                x = cg_kernel.cg_solve(sysm, rtol, maxiter)
                its = cg_kernel.item_iterations(dev)
                for k in range(B):
                    item = FlowSystem(*[f[k] for f in sysm])
                    x_t, it_t = cg_twin(torch, item, rtol, maxiter)
                    x_d, it_d = cg_twin(torch, item, rtol, maxiter, sums=torch.float64)
                    limit = 1e-5 * max(float(x_t.abs().max()), 1.0)
                    err = min(float((x[k] - x_t).abs().max()), float((x[k] - x_d).abs().max()))
                    worst = max(worst, err / limit)
                    its_k.append(its[k])
                    its_t.append(it_t if its[k] == it_t else it_d)
            print(f"cg batch {label}: the finest level's {len(log['kept'])} calls of {B} items (rtol "
                  f"{log['kept'][0][1]:g}) against the plain twin: worst max|dx| / limit {worst:.3e}; iterations "
                  f"kernel {its_k} / twin {its_t} (the float32 twin's, or with double sums where those differ)  [{card}]")
            check(len(log["kept"]) == 10 and worst <= 1.0 and its_k == its_t,
                  f"batch {label}: the finest level's batched PCG differs from its twin")

    lat = {}
    for method in ("hs-brightness", "classic++"):
        rw = seqs["RubberWhale"]
        single_ms, single_runs, _ = frame_latency(torch, dev, method, PATH_PARAMS, rw[1], rw[2])
        lat[method] = {"single_ms": single_ms}
        line = f"batch latency {method}: single frame {single_ms:.2f} ms (runs {', '.join(f'{x:.2f}' for x in single_runs)})"
        for B in (1, 3):
            ms, runs = batch_latency(torch, dev, method, [seqs[n] for n in BATCH_SEQS[:B]])
            lat[method][f"batch{B}_ms"] = ms
            line += f"; B {B} {ms:.2f} ms (runs {', '.join(f'{x:.2f}' for x in runs)}), {ms / B:.2f} ms a pair"
        print(line + f"  [{card}]")
    print(f"batch families: phase wall time {time.perf_counter() - t_phase:.1f} s (host clock)")
    return launches, lat


def shard_devices(torch, n):
    """n distinct cards where there are that many, else n shards on card 0."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i if count >= n else 0) for i in range(n)]


@contextlib.contextmanager
def level_log(torch):
    """Within the block, each row-sharded level step of the four families'
    flow programs appends (level shape, halo, distributed PCG solves, their
    iterations, PCG kernel launches) to the list it yields: 0 solves is a
    level that ran unsharded (too short for its halo), on the kernel."""
    from optical_flow_tpu_torch.methods import alt_ba, ba, classic_nl, hs
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.parallel import dist

    log = []
    saved = [(m, n, getattr(m, n)) for m, n in
             ((classic_nl, "classic_nl_level_step_spatial"), (ba, "ba_level_step_spatial"),
              (hs, "hs_level_step_spatial"), (alt_ba, "alt_ba_level_step_spatial"))]

    def logged(fn):
        def step(cfg, images, *args):
            s0, i0, k0 = dist.solves, dist.iterations, cg_kernel.launches
            out = fn(cfg, images, *args)
            log.append((tuple(images.shape[:2]), args[-1], dist.solves - s0, dist.iterations - i0,
                        cg_kernel.launches - k0))
            return out
        return step

    for m, n, fn in saved:
        setattr(m, n, logged(fn))
    try:
        yield log
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


@contextlib.contextmanager
def sharded_wmedian_inputs(torch):
    """Within the block, the row-sharded levels' weighted-median calls keep a
    copy of the inputs of the largest one (the finest level's shards) in the
    dict they yield."""
    from optical_flow_tpu_torch.ops.cuda import wmedian_kernel

    kept, call = {}, wmedian_kernel.wmedian

    def recording(*args):
        H, W = args[4]
        if H * W >= kept.get("size", 0):
            kept["size"], kept["args"] = H * W, tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        return call(*args)

    wmedian_kernel.wmedian = recording
    try:
        yield kept
    finally:
        wmedian_kernel.wmedian = call


def _levels_line(log, unsharded_runs):
    """Per level, coarse to fine: shape, halo, sharded or not, the distributed
    PCG's iterations beside the unsharded frame's kernel iterations."""
    return "; ".join(
        f"{h}x{w} halo {halo}: " + (f"sharded, {its} it. (unsharded {ref})" if solves else f"unsharded ({ref} it.)")
        for ((h, w), halo, solves, its, _), (_, _, ref) in zip(log, unsharded_runs))


def phase_sharded(torch, dev, card, rgb1, rgb2, tu, tv):
    """Phase 16: ``estimate_flow(..., mesh=flow_mesh(space=n, devices=...))`` on
    RubberWhale 584x388.  classic+nl-fast (pcg) over ``SHARDS`` shards and ba
    over ``SHARDS_BA``: each in its gate, classic+nl-fast within
    ``SHARDED_MEAN_DIFF`` mean |d| of the unsharded card flow; the levels
    sharded and unsharded, the halo and the distributed PCG's iterations by
    level beside the unsharded frame's; each kernel's launches in one counted
    frame (no plain twin; the weighted median on the shards, PCG kernel
    launches only on unsharded levels, one ROF call); the finest sharded
    weighted-median call against its twin (within the sums' rounding, as
    phase 4 holds the main path's input) and bit for bit against one launch
    a shard; classic+nl-fast's latency beside the unsharded frame's.
    Returns each path's launches and latencies, and the n = 2 classic+nl-fast
    flow (phase 18's reference)."""
    from optical_flow_tpu_torch import estimate_flow, flow_angular_error
    from optical_flow_tpu_torch.ops.cuda import wmedian_kernel
    from optical_flow_tpu_torch.ops.cuda.wmedian_kernel import wmedian, wmedian_plain
    from optical_flow_tpu_torch.parallel import dist
    from optical_flow_tpu_torch.parallel.mesh import flow_mesh

    t_phase = time.perf_counter()
    launches, latency = {}, {}
    unsharded, flows = {}, {}
    for name, params in (("classic+nl-fast", PARAMS), ("ba", PATH_PARAMS)):
        with solve_log(torch, dev) as log:
            uv = estimate_flow(rgb1, rgb2, name, params, device=dev)
            torch.cuda.synchronize()
        unsharded[name] = (uv.cpu().numpy(), level_runs([(shape, its[0]) for shape, its, _ in log["cg"]]))
    frame_ms, _, _ = frame_latency(torch, dev, "classic+nl-fast", PARAMS, rgb1, rgb2)
    latency["unsharded"] = frame_ms

    runs = [("classic+nl-fast", PARAMS, n, (TARGET_AAE, TARGET_AEPE), (GATE_AAE, GATE_AEPE)) for n in SHARDS]
    runs.append(("ba", PATH_PARAMS, SHARDS_BA, *PATH_GATES["ba"]))
    for name, params, n, (t_aae, t_aepe), (g_aae, g_aepe) in runs:
        label = f"sharded {name} n={n}"
        devices = shard_devices(torch, n)
        mesh = flow_mesh(space=n, devices=devices)
        groups = len(set(devices))
        print(f"{label}: mesh devices {[str(d) for d in devices]}")
        if name == "classic+nl-fast":  # a warm-up frame; ba's one frame is its counted frame
            estimate_flow(rgb1, rgb2, name, params, mesh=mesh)
            torch.cuda.synchronize()
        reset_counts()
        with no_plain_twins(), level_log(torch) as levels, solve_log(torch, dev) as slog, \
                sharded_wmedian_inputs(torch) as kept:
            t0 = time.perf_counter()
            uv = estimate_flow(rgb1, rgb2, name, params, mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts, by_path = read_counts()
        items, solves, iters = wmedian_kernel.items, dist.solves, dist.iterations
        launches[label] = counts
        uv_np = flows[label] = uv.cpu().numpy()
        check(uv_np.shape == (388, 584, 2) and uv.device == devices[0] and np.isfinite(uv_np).all(),
              f"{label}: unexpected flow {uv_np.shape} on {uv.device}")
        aae, _, aepe = flow_angular_error(tu, tv, uv_np[..., 0], uv_np[..., 1])
        ref, ref_runs = unsharded[name]
        d = np.abs(uv_np - ref)
        sharded_levels = [lv for lv in levels if lv[2]]
        print(f"{label} RubberWhale 584x388: AAE {aae:.4f} deg, AEPE {aepe:.5f} px (target {t_aae} / {t_aepe}, gate "
              f"{g_aae} / {g_aepe}); against the unsharded card flow mean |d| {float(d.mean()):.3e} px, max |d| "
              f"{float(d.max()):.3e} px, {int((d > 1e-2).sum())} of {d.size} values beyond 0.01 px; frame "
              f"{wall:.2f} s (host clock, one host read a PCG iteration)")
        print(f"{label}: {len(sharded_levels)} levels sharded, {len(levels) - len(sharded_levels)} unsharded; "
              f"{solves} distributed PCG solves, {iters} iterations (the unsharded frame's kernel: "
              f"{sum(i for _, _, i in ref_runs)}); per level, coarse to fine: {_levels_line(levels, ref_runs)}")
        print(f"{label}: launches in one frame {counts} ({items} weighted-median items), {by_path}")
        check(abs(aae - t_aae) <= g_aae and abs(aepe - t_aepe) <= g_aepe, f"{label}: accuracy outside the gate")
        check(sharded_levels and solves == sum(lv[2] for lv in levels), f"{label}: no level ran sharded")
        unsharded_solves = len(slog["cg"])
        check(counts["cg"] == unsharded_solves == by_path["cg resident"] and counts["rof"] == 1,
              f"{label}: PCG kernel launches {counts['cg']} for {unsharded_solves} unsharded solves, ROF {counts['rof']}")
        if name == "classic+nl-fast":
            check(float(d.mean()) < SHARDED_MEAN_DIFF, f"{label}: mean |d| from the unsharded flow too large")
            check(counts["wmedian"] == solves * groups + unsharded_solves
                  and items == solves * n + unsharded_solves,
                  f"{label}: {counts['wmedian']} weighted-median launches of {items} items for {solves} sharded "
                  f"and {unsharded_solves} unsharded warp iterations")
            args = kept["args"]
            out, twin = wmedian(*args), wmedian_plain(*args)
            per_shard = torch.stack([wmedian(*[a[k].contiguous() for a in args[:4]], *args[4:])
                                     for k in range(args[0].shape[0])])
            torch.cuda.synchronize()
            n_diff, frac, valid = 0, 1.0, True
            for k in range(out.shape[0]):  # each shard a weighted median within the sums' rounding, as phase 4
                nd, _, ok = wmedian_valid(torch, tuple(a[k] for a in args[:4]) + args[4:], out[k], twin[k])
                n_diff, valid = n_diff + nd, valid and ok
            frac = 1.0 - n_diff / out.numel()
            print(f"{label}: the finest sharded weighted-median call ({tuple(args[0].shape)} padded shards, "
                  f"{args[4][0]}x{args[4][1]} each, hsz {args[5]}) against its twin: bit-identical "
                  f"{torch.equal(out, twin)}, {n_diff} of {out.numel()} values differ (max |d| "
                  f"{float((out - twin).abs().max()):.3e}), each a median within the sums' rounding: {valid}; "
                  f"against one launch a shard: bit-identical {torch.equal(out, per_shard)}")
            check(frac >= WMEDIAN_SHARE and valid, f"{label}: the sharded weighted median is outside its twin's rounding")
            check(torch.equal(out, per_shard), f"{label}: the shards' one launch differs from one launch a shard")
            ms, runs_ms, host_ms = frame_latency(torch, dev, name, params, rgb1, rgb2, mesh=mesh)
            latency[label] = ms
            print(f"{label}: per-frame latency, median of {LATENCY_RUNS} warm runs: {ms:.2f} ms (CUDA events; runs "
                  f"{', '.join(f'{x:.2f}' for x in runs_ms)}), {host_ms:.2f} ms (host clock); unsharded frame "
                  f"{frame_ms:.2f} ms  [{card}]")
        else:
            check(counts["wmedian"] == 0, f"{label}: a weighted median ran")
    print(f"sharded: phase wall time {time.perf_counter() - t_phase:.1f} s (host clock)")
    return launches, latency, flows[f"sharded classic+nl-fast n={PROCESS_SHARDS}"]


def _warps_line(log, unsharded_runs):
    """Per level, coarse to fine: sharded or not, the warp iterations (one solve
    each) and the distributed PCG's iterations beside the unsharded frame's."""
    return "; ".join(
        f"{h}x{w} halo {halo}: " + (f"sharded, {solves} warp it., {its} PCG it." if solves else
                                    f"unsharded, {kernel} warp it.")
        + f" (unsharded {ref_solves} warp it., {ref_its} PCG it.)"
        for ((h, w), halo, solves, its, kernel), (_, ref_solves, ref_its) in zip(log, unsharded_runs))


def phase_sharded_families(torch, dev, card, rgb1, rgb2, tu, tv):
    """Phase 17a: ``hs`` and the stable ``classic-c-a`` through
    ``estimate_flow(..., mesh=flow_mesh(space=SHARDS_HS_ALT))``: each in its gate
    and within ``SHARDED_MEAN_DIFF`` mean |d| of the unsharded card flow; the
    levels sharded and unsharded, the warp iterations and the distributed PCG's
    iterations by level beside the unsharded frame's; the launches of one
    counted frame (no plain twin; PCG kernel launches only on the unsharded
    levels, one ROF call, no weighted median) and its host-clock time."""
    from optical_flow_tpu_torch import estimate_flow, flow_angular_error
    from optical_flow_tpu_torch.parallel import dist
    from optical_flow_tpu_torch.parallel.mesh import flow_mesh

    launches, latency = {}, {}
    devices = shard_devices(torch, SHARDS_HS_ALT)
    mesh = flow_mesh(space=SHARDS_HS_ALT, devices=devices)
    for label, name, params, ((t_aae, t_aepe), (g_aae, g_aepe)) in SHARDED_FAMILIES:
        with solve_log(torch, dev) as log:
            t0 = time.perf_counter()
            ref = estimate_flow(rgb1, rgb2, name, params, device=dev)
            torch.cuda.synchronize()
            ref_ms = 1e3 * (time.perf_counter() - t0)
        ref_runs = level_runs([(shape, its[0]) for shape, its, _ in log["cg"]])
        ref = ref.cpu().numpy()
        path = f"sharded {label} n={SHARDS_HS_ALT}"
        print(f"{path}: mesh devices {[str(d) for d in devices]}")
        reset_counts()
        with no_plain_twins(), level_log(torch) as levels, solve_log(torch, dev) as slog:
            t0 = time.perf_counter()
            uv = estimate_flow(rgb1, rgb2, name, params, mesh=mesh)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        counts, by_path = read_counts()
        solves, iters = dist.solves, dist.iterations
        launches[path], latency[path] = counts, wall_ms
        uv_np = uv.cpu().numpy()
        check(uv_np.shape == (388, 584, 2) and uv.device == devices[0] and np.isfinite(uv_np).all(),
              f"{path}: unexpected flow {uv_np.shape} on {uv.device}")
        aae, _, aepe = flow_angular_error(tu, tv, uv_np[..., 0], uv_np[..., 1])
        d = np.abs(uv_np - ref)
        sharded = [lv for lv in levels if lv[2]]
        print(f"{path} RubberWhale 584x388: AAE {aae:.4f} deg, AEPE {aepe:.5f} px (target {t_aae} / {t_aepe}, gate "
              f"{g_aae} / {g_aepe}); against the unsharded card flow mean |d| {float(d.mean()):.3e} px, max |d| "
              f"{float(d.max()):.3e} px; frame {wall_ms:.2f} ms against {ref_ms:.2f} ms unsharded (host clock, one "
              f"frame each; one host read a distributed PCG iteration)  [{card}]")
        print(f"{path}: {len(sharded)} levels sharded, {len(levels) - len(sharded)} unsharded; {solves} distributed "
              f"PCG solves, {iters} iterations (the unsharded frame's kernel: {sum(i for _, _, i in ref_runs)}); per "
              f"level, coarse to fine: {_warps_line(levels, ref_runs)}")
        print(f"{path}: launches in one frame {counts}, {by_path}")
        check(abs(aae - t_aae) <= g_aae and abs(aepe - t_aepe) <= g_aepe, f"{path}: accuracy outside the gate")
        check(float(d.mean()) < SHARDED_MEAN_DIFF, f"{path}: mean |d| from the unsharded flow too large")
        check(sharded and solves == sum(lv[2] for lv in levels), f"{path}: no level ran sharded")
        unsharded_solves = len(slog["cg"])
        check(counts["cg"] == unsharded_solves == by_path["cg resident"] == sum(lv[4] for lv in levels)
              and counts["rof"] == 1 and counts["wmedian"] == 0,
              f"{path}: PCG kernel launches {counts['cg']} for {unsharded_solves} unsharded solves, {counts}")
    return launches, latency


def _per_device_launches(torch):
    """Within the block, each unmeshed batched program (``parallel.batch.
    _flow_batched``, the body of ``estimate_flow_batched``; one a batch row
    of a meshed batch) appends (its device, its items, the kernels' launches
    during it) to the list it yields."""
    from optical_flow_tpu_torch.parallel import batch as bp

    log, call = [], bp._flow_batched

    def counted(images_batch, method, mesh, *args):
        if mesh is not None:
            return call(images_batch, method, mesh, *args)
        before = read_counts()[0]
        out = call(images_batch, method, mesh, *args)
        after = read_counts()[0]
        log.append((str(out.device), len(images_batch), {k: after[k] - before[k] for k in after}))
        return out

    bp._flow_batched = counted
    return log, lambda: setattr(bp, "_flow_batched", call)


def phase_mesh_batches(torch, dev, card, pairs):
    """Phase 17b: ``estimate_flow_batched_rgb`` over ``flow_mesh(batch=2,
    space=1)`` on the batch phase's four pairs, ``MESH_BATCHES``: each item
    bit-identical to the same item of the unmeshed batch, the launches by
    batch row and device (no plain twin).  Returns the launches and the
    unmeshed classic+nl-fast batch (phase 18's reference)."""
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched_rgb
    from optical_flow_tpu_torch.parallel.mesh import flow_mesh

    im1, im2 = _batch_of(pairs)
    devices = shard_devices(torch, MESH_BATCH_ROWS)
    mesh = flow_mesh(batch=MESH_BATCH_ROWS, space=1, devices=devices)
    launches, refs = {}, {}
    for name, params, expected in MESH_BATCHES:
        path = f"mesh batch {name}"
        ref = refs[name] = estimate_flow_batched_rgb(im1, im2, name, params=params, device=dev)
        estimate_flow_batched_rgb(im1, im2, name, mesh=mesh, params=params)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        rows, restore = _per_device_launches(torch)
        try:
            with no_plain_twins():
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                uv = estimate_flow_batched_rgb(im1, im2, name, mesh=mesh, params=params)
                end.record()
                torch.cuda.synchronize()
        finally:
            restore()
        counts, by_path = read_counts()
        launches[path] = counts
        same = [bool(torch.equal(uv[k], ref[k])) for k in range(len(pairs))]
        print(f"{path}: flow_mesh(batch={MESH_BATCH_ROWS}, space=1) over {[str(d) for d in devices]}: "
              f"{start.elapsed_time(end):.2f} ms for {len(pairs)} pairs (CUDA events); each item bit-identical to "
              f"the unmeshed batch's: {same}; launches {counts}, {by_path}; by batch row (device, items, launches): "
              f"{rows}  [{card}]")
        check(uv.shape == ref.shape and uv.device == devices[0] and all(same),
              f"{path}: a meshed item differs from the unmeshed batch's")
        check(len(rows) == MESH_BATCH_ROWS and [r[0] for r in rows] == [str(d) for d in devices]
              and all(r[1] == len(pairs) // MESH_BATCH_ROWS for r in rows), f"{path}: batch rows {rows}")
        check(all(r[2]["wmedian"] == expected["wmedian"] and r[2]["rof"] == expected["rof"] for r in rows)
              and counts["cg"] == sum(r[2]["cg"] for r in rows) > 0, f"{path}: launches by row {rows}")
    return launches, refs["classic+nl-fast"].cpu().numpy()


def phase_pipeline(torch, dev, card, pairs, frame_ms):
    """Phase 17c: ``estimate_flow_pipelined`` over the batch phase's four pairs,
    classic+nl-fast with pcg, ``n_stages=PIPELINE_STAGES`` on distinct cards
    where there are that many: the stage partition, each flow bit-identical to
    its ``estimate_flow`` and in order, four frames' launches (no plain twin),
    and the time a pair over the stream (CUDA events) beside a single frame."""
    from optical_flow_tpu_torch import estimate_flow, estimate_flow_pipelined
    from optical_flow_tpu_torch.config import load_of_method
    from optical_flow_tpu_torch.parallel.pipeline import _partition, build_pipeline_schedule

    devices = shard_devices(torch, PIPELINE_STAGES)
    ope = load_of_method("classic+nl-fast")
    ope.parse_input_parameter(PARAMS)
    steps = build_pipeline_schedule(ope, (388, 584), use_color=True).steps
    groups = _partition([st.cost for st in steps], PIPELINE_STAGES)
    print("pipeline classic+nl-fast: stages " + "; ".join(
        f"{devices[g % len(devices)]}: " + ", ".join(f"{steps[i].label} ({steps[i].cost})" for i in group)
        for g, group in enumerate(groups)))
    stream = [(p[1], p[2]) for p in pairs]
    refs = [estimate_flow(a, b, "classic+nl-fast", PARAMS, device=dev) for a, b in stream]
    list(estimate_flow_pipelined(stream, "classic+nl-fast", PARAMS, devices=devices,
                                 n_stages=PIPELINE_STAGES))  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    with no_plain_twins():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outs = list(estimate_flow_pipelined(iter(stream), "classic+nl-fast", PARAMS, devices=devices,
                                            n_stages=PIPELINE_STAGES))
        for d in set(devices):
            torch.cuda.synchronize(d)
        end.record()
        torch.cuda.synchronize()
    counts, by_path = read_counts()
    pair_ms = start.elapsed_time(end) / len(stream)
    same = [bool(torch.equal(o.to(r.device), r)) for o, r in zip(outs, refs)]
    print(f"pipeline classic+nl-fast: {len(outs)} pairs over {[str(d) for d in devices]}, n_stages "
          f"{PIPELINE_STAGES}, depth {len(groups) + 1}: {pair_ms:.2f} ms a pair over the stream (CUDA events) "
          f"against a {frame_ms:.2f} ms single frame; each flow bit-identical to its estimate_flow, in order: {same}; "
          f"launches {counts}, {by_path}  [{card}]")
    check(len(outs) == len(stream) and all(same), "pipeline: a flow differs from its estimate_flow")
    check(counts == {"wmedian": 21 * len(stream), "cg": 21 * len(stream), "rof": len(stream)},
          f"pipeline: launches {counts}")
    return counts, {"pipeline_pair_ms": pair_ms, "single_frame_ms": frame_ms}


def _rank_counts():
    """This rank's kernel launches, the weighted median's items and the
    distributed PCG's solves, iterations and collective rounds since
    :func:`reset_counts`."""
    from optical_flow_tpu_torch.ops.cuda import wmedian_kernel
    from optical_flow_tpu_torch.parallel import dist

    counts, by_path = read_counts()
    return {**counts, "cg resident": by_path["cg resident"], "wmedian items": wmedian_kernel.items,
            "solves": dist.solves, "iterations": dist.iterations, "psum rounds": dist.psum_rounds,
            "halo rounds": dist.halo_rounds}


def phase18_rank(rank, world_size, address):
    """One rank of phase 18, on card 0 over gloo: RubberWhale classic+nl-fast
    over ``flow_mesh()`` (one shard a rank) under each PCG recurrence (the
    classic frame after one warm-up frame), then phase 12's four pairs over
    ``flow_mesh(batch=world_size, space=1)``.  Each path counted from 0 with no
    plain twin; returns the flows, this rank's counts and host times."""
    import torch

    sys.path.insert(0, REPO)
    from optical_flow_tpu_torch import estimate_flow
    from optical_flow_tpu_torch.io.flo import read_flow_file
    from optical_flow_tpu_torch.ops.cuda import build
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched_rgb
    from optical_flow_tpu_torch.parallel.mesh import flow_mesh, initialize_distributed
    from optical_flow_tpu_torch.solvers import cg

    t0 = time.perf_counter()
    float32_settings(torch)
    build.load_library()
    out = {"built here": bool(build.build_log)}
    initialize_distributed(address, world_size, rank, "gloo", device=torch.device("cuda", 0), timeout=RANKS_TIMEOUT)
    mesh = flow_mesh()
    out["layout"] = mesh.space_layout().index
    out["setup s"] = time.perf_counter() - t0
    rgb1, rgb2, _, _ = read_flow_file("RubberWhale", 10)
    estimate_flow(rgb1, rgb2, "classic+nl-fast", PARAMS, mesh=mesh)  # warm-up
    for algo in CG_ALGOS:
        cg.CG_ALGO = algo
        reset_counts()
        with no_plain_twins():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            uv = estimate_flow(rgb1, rgb2, "classic+nl-fast", PARAMS, mesh=mesh)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
        out[algo] = {"uv": uv.cpu().numpy(), "device": str(uv.device), "counts": _rank_counts(), "host s": host_s}
    cg.CG_ALGO = "classic"
    im1, im2 = _batch_of([(seq, *read_flow_file(seq, 10)) for seq in BATCH_SEQS])
    bmesh = flow_mesh(batch=world_size, space=1)
    estimate_flow_batched_rgb(im1, im2, "classic+nl-fast", mesh=bmesh, params=PARAMS)  # warm-up
    reset_counts()
    with no_plain_twins():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        uv = estimate_flow_batched_rgb(im1, im2, "classic+nl-fast", mesh=bmesh, params=PARAMS)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    out["batch"] = {"uv": uv.cpu().numpy(), "counts": _rank_counts(), "host s": host_s}
    return out


def phase_multiprocess(torch, card, tu, tv, sharded_ref, batch_ref):
    """Phase 18: ``PROCESSES`` ranks (``phase18_rank``) spawned on card 0 over
    gloo with a localhost rendezvous, each building nothing.  classic+nl-fast
    over ``flow_mesh()`` (one shard a rank): with ``classic`` bit-identical in
    every rank to phase 16's one-process frame of ``PROCESS_SHARDS`` shards
    (``sharded_ref``) and in the gate; ``gear`` and ``cheby`` in the gate,
    their mean |d| from it, iterations and psum rounds an iteration; in every
    rank the weighted median once a warp iteration on its shard, one ROF
    call, PCG kernel launches only on unsharded levels.  Then phase 12's
    pairs over ``flow_mesh(batch=PROCESSES, space=1)``, one batch row a rank:
    every item bit-identical to the unmeshed batch (``batch_ref``), each rank
    running its row's kernels.  Any rank's failure fails the phase.  Returns
    the launches by path, summed over the ranks, and the host times."""
    from optical_flow_tpu_torch import flow_angular_error
    from optical_flow_tpu_torch.parallel.launch import RanksFailed, free_tcp_address, run_ranks

    t_phase = time.perf_counter()
    try:
        ranks = run_ranks(phase18_rank, PROCESSES, (free_tcp_address(),), timeout=RANKS_TIMEOUT)
    except RanksFailed as e:
        raise CheckFailed(f"multi-process: {e}") from None
    spawn_s = time.perf_counter() - t_phase
    launches, host = {}, {}
    check([r["layout"] for r in ranks] == [(k,) for k in range(PROCESSES)] and not any(r["built here"] for r in ranks),
          f"multi-process: layouts {[r['layout'] for r in ranks]}, built in a rank: {[r['built here'] for r in ranks]}")
    print(f"multi-process: {PROCESSES} ranks on card 0 over gloo (tcp localhost), one shard a rank, none built a "
          f"kernel; rank setup {', '.join(f'{r['setup s']:.1f}' for r in ranks)} s  [{card}]")
    classic = ranks[0]["classic"]["uv"]
    for algo in CG_ALGOS:
        path = f"multi-process classic+nl-fast {algo} {PROCESSES} ranks"
        uvs = [r[algo]["uv"] for r in ranks]
        counts = [r[algo]["counts"] for r in ranks]
        aae, _, aepe = flow_angular_error(tu, tv, uvs[0][..., 0], uvs[0][..., 1])
        same_ranks = all(np.array_equal(u, uvs[0]) for u in uvs)
        d = np.abs(uvs[0] - classic)
        c0 = counts[0]
        per_it = c0["psum rounds"] / max(c0["iterations"], 1)
        print(f"{path}: AAE {aae:.4f} deg, AEPE {aepe:.5f} px (gate {TARGET_AAE} / {TARGET_AEPE} within {GATE_AAE} / "
              f"{GATE_AEPE}); every rank's flow the same: {same_ranks}; bit-identical to phase 16's one-process "
              f"{PROCESS_SHARDS}-shard frame: {bool(np.array_equal(uvs[0], sharded_ref))}; against classic mean |d| "
              f"{float(d.mean()):.3e} px, max |d| {float(d.max()):.3e} px; {c0['solves']} distributed solves, "
              f"{c0['iterations']} iterations, {c0['psum rounds']} psum rounds ({per_it:.3f} an iteration), "
              f"{c0['halo rounds']} halo exchanges; host time a frame by rank "
              f"{', '.join(f'{r[algo]['host s']:.2f}' for r in ranks)} s  [{card}]")
        print(f"{path}: launches by rank {[{k: c[k] for k in ('wmedian', 'wmedian items', 'cg', 'rof')} for c in counts]}")
        check(all(r[algo]["device"] == "cuda:0" for r in ranks) and same_ranks and np.isfinite(uvs[0]).all(),
              f"{path}: the ranks' flows differ or are not finite")
        check(abs(aae - TARGET_AAE) <= GATE_AAE and abs(aepe - TARGET_AEPE) <= GATE_AEPE, f"{path}: outside the gate")
        check(all(c["solves"] == 21 and c["wmedian"] == 21 and c["wmedian items"] == 21 and c["rof"] == 1
                  and c["cg"] == 0 and all(c[k] == c0[k] for k in ("iterations", "psum rounds", "halo rounds"))
                  for c in counts), f"{path}: counts by rank {counts}")
        if algo == "classic":
            check(np.array_equal(uvs[0], sharded_ref), f"{path}: differs from the one-process sharded frame")
        launches[path] = {k: sum(c[k] for c in counts) for k in ("wmedian", "cg", "rof")}
        host[algo] = [r[algo]["host s"] for r in ranks]
    path = f"multi-process batch classic+nl-fast {PROCESSES} ranks"
    counts = [r["batch"]["counts"] for r in ranks]
    same = [[bool(np.array_equal(r["batch"]["uv"][k], batch_ref[k])) for k in range(len(batch_ref))] for r in ranks]
    print(f"{path}: flow_mesh(batch={PROCESSES}, space=1), one row of {len(batch_ref) // PROCESSES} pairs a rank: "
          f"each item bit-identical to the unmeshed batch, by rank {same}; host time by rank "
          f"{', '.join(f'{r['batch']['host s'] * 1e3:.2f}' for r in ranks)} ms; launches by rank "
          f"{[{k: c[k] for k in ('wmedian', 'cg', 'cg resident', 'rof')} for c in counts]}  [{card}]")
    check(all(all(row) for row in same), f"{path}: an item differs from the unmeshed batch")
    check(all(c["wmedian"] == 21 and c["rof"] == 1 and c["cg"] > 0 for c in counts), f"{path}: counts {counts}")
    launches[path] = {k: sum(c[k] for c in counts) for k in ("wmedian", "cg", "rof")}
    host["batch"] = [r["batch"]["host s"] for r in ranks]
    print(f"multi-process: phase wall time {time.perf_counter() - t_phase:.1f} s, spawn to results {spawn_s:.1f} s "
          f"(host clock)")
    return launches, host


# phase 19: the JAX package's 4K harness (benchmarks/throughput.py::bench_4k):
# a seeded uniform frame and the same frame rolled 2 px, gray and RGB; the
# known answer (2, 0) on the interior (16 px in from every border, and the
# columns the roll wraps); a Lab-guided 4K frame adds the weighted median
FRAME_4K = (2160, 3840)
SHIFT_4K = 2
INTERIOR_4K = np.s_[16:-16, 18:-16]
GATE_4K_AEPE = 1e-4
# (tiled ROF, streaming PCG) wrapper launches in the counted frames of the
# paths that run them: the B = 4 batch (phase 12) and the 4K frames (phase 19)
LARGE_IMAGE_LAUNCHES = {}
# the 4K frames' CUDA-event times before the large-image kernels' redesign
# (PERF.md, PR 11's calls; gray, RGB), printed beside this run's
PR11_FRAME_4K_MS = {False: "895.68-933.94", True: "674.98-796.57"}
BASE_MEAN_DIFF = 1e-3  # compute_flow_base on the card against the CPU twins: mean |d|


def _counted(torch, dev, fn):
    """(result, launches by kernel, launches by path and PCG items, PCG iterations)
    of ``fn()`` run with every count set to 0 just before it."""
    from optical_flow_tpu_torch.ops.cuda import cg_kernel

    reset_counts()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    launches, by_path = read_counts()
    return out, launches, by_path, cg_kernel.iteration_counts(dev)[1]


def _method_object(torch, dev, rgb1, rgb2, params=PARAMS):
    """classic+nl-fast as the JAX package's callers hold it: ``ope.images`` and
    ``ope.color_images`` from ``preprocess_color_pair`` on the card, as
    ``estimate_flow`` prepares them."""
    from optical_flow_tpu_torch.config import load_of_method
    from optical_flow_tpu_torch.utils.compat import preprocess_color_pair

    ope = load_of_method("classic+nl-fast")
    ope.parse_input_parameter(params)
    a1, a2 = (torch.as_tensor(np.ascontiguousarray(x)).to(device=dev, dtype=torch.float32) for x in (rgb1, rgb2))
    ope.images, ope.color_images = preprocess_color_pair(a1, a2)
    return ope


@contextlib.contextmanager
def _last_full_size_calls(torch, hw):
    """Within the block, the last weighted-median call and the last ROF call at
    the frame size ``hw`` keep clones of their inputs in the dict yielded."""
    from optical_flow_tpu_torch.ops import rof as rof_op, wmedian as wmedian_op

    kept, wm_call, rof_call = {}, wmedian_op.wmedian, rof_op.rof_structure

    def wm(*args):
        if tuple(args[4]) == tuple(hw):
            kept["wmedian"] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        return wm_call(*args)

    def rof(im, theta, n_iters):
        if tuple(im.shape[-2:]) == tuple(hw):
            kept["rof"] = (im.clone(), theta, n_iters)
        return rof_call(im, theta, n_iters)

    wmedian_op.wmedian, rof_op.rof_structure = wm, rof
    try:
        yield kept
    finally:
        wmedian_op.wmedian, rof_op.rof_structure = wm_call, rof_call


def _known_answer(uv):
    """(AEPE against (SHIFT_4K, 0), median u, share of |u - SHIFT_4K| < 0.25) on the interior."""
    inner = uv[INTERIOR_4K]
    aepe = float(np.sqrt((inner[..., 0] - SHIFT_4K) ** 2 + inner[..., 1] ** 2).mean())
    return aepe, float(np.median(inner[..., 0])), float((np.abs(inner[..., 0] - SHIFT_4K) < 0.25).mean())


def phase_frame_4k(torch, dev, card, label, rgb):
    """One 4K frame of the JAX harness's call, ``ope.images = stack(...);
    ope.compute_flow()`` (classic+nl-fast, display off, the preset's solver):
    a warm-up frame logging each PCG solve's iterations (a sync a solve) and
    keeping the last full-size weighted-median, PCG and ROF inputs, then a
    counted frame (no plain twin; peak memory) and its latency.  Gray
    frames give no colour guide (the plain 5x5 median); RGB ones go through
    ``preprocess_color_pair`` and the Lab guide (the weighted median)."""
    from optical_flow_tpu_torch.config import load_of_method
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits
    from optical_flow_tpu_torch.utils.compat import preprocess_color_pair

    rng = np.random.default_rng(SEED)
    base = rng.uniform(0, 255, (*FRAME_4K, 3) if rgb else FRAME_4K).astype(np.float32)
    im2 = np.roll(base, SHIFT_4K, axis=1)
    ope = load_of_method("classic+nl-fast")
    ope.display = False
    if rgb:
        ope.images, ope.color_images = preprocess_color_pair(torch.as_tensor(base, device=dev),
                                                             torch.as_tensor(im2, device=dev))
    else:
        ope.images = torch.stack([torch.as_tensor(base, device=dev), torch.as_tensor(im2, device=dev)], 2)
    with solve_log(torch, dev, keep=1, keep_shapes=((1080, 1920),)) as log, \
            _last_full_size_calls(torch, FRAME_4K) as kept:
        t0 = time.perf_counter()
        with torch.no_grad():
            ope.compute_flow()
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    solves = [(shape, its[0]) for shape, its, _ in log["cg"]]
    torch.cuda.reset_peak_memory_stats(dev)
    with no_plain_twins():
        uv, launches, by_path, cg_iters = _counted(torch, dev, ope.compute_flow)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    with torch.no_grad():
        ope.compute_flow()
    end.record()
    torch.cuda.synchronize()
    host_ms, ev_ms = 1e3 * (time.perf_counter() - t0), start.elapsed_time(end)

    uv_np = uv.cpu().numpy()
    check(uv_np.shape == (*FRAME_4K, 2) and uv_np.dtype == np.float32, f"{label}: unexpected flow {uv_np.shape}")
    check(np.isfinite(uv_np).all(), f"{label}: flow is not finite")
    aepe, med_u, share = _known_answer(uv_np)
    runs = level_runs(solves)
    n_wm = launches["wmedian"]
    print(f"{label} {FRAME_4K[1]}x{FRAME_4K[0]} (rolled {SHIFT_4K} px): AEPE against ({SHIFT_4K}, 0) on the interior "
          f"{aepe:.6f} px (gate {GATE_4K_AEPE}), median u {med_u:.6f}, share |u - {SHIFT_4K}| < 0.25: {share:.6f}")
    print(f"{label}: pyramid levels {ope.pyramid_levels} (auto_level) + {ope.gnc_pyramid_levels} GNC levels; "
          f"launches {launches}, by path {by_path}; CG iterations {cg_iters} (warm-up {sum(i for _, i in solves)}); "
          "per level, coarse to fine (shape: solves, iterations): "
          + "; ".join(f"{h}x{w}: {k}, {i}" for (h, w), k, i in runs))
    print(f"{label}: one warm frame {ev_ms:.2f} ms (CUDA events), {host_ms:.2f} ms (host clock); warm-up frame "
          f"{warm_s:.2f} s (one sync a solve); peak memory {peak_gb:.3f} GB (max_memory_allocated)  [{card}]")
    print(f"{label}: the same frame before the large-image kernels' redesign: {PR11_FRAME_4K_MS[rgb]} ms "
          "(PERF.md, PR 11's calls on an H100 80GB HBM3, 700 W; another call)")
    # each level's solves in the warm-up frame (a sync a solve), by the path cg_plan gives them
    limits = device_limits(dev)
    per_level = []
    for (shape, its, _), ms in zip(log["cg"], log["cg_ms"]):
        path = cg_kernel.cg_plan(1, *shape, *limits).path
        if per_level and per_level[-1]["shape"] == list(shape):
            row = per_level[-1]
            row["solves"] += 1
            row["iterations"] += its[0]
            row["ms"] += ms
        else:
            per_level.append({"shape": list(shape), "path": path, "solves": 1, "iterations": its[0], "ms": ms})
    stream = [r for r in per_level if r["path"] == "streaming"]
    print(f"{label}: PCG solves by level in the warm-up frame (shape: path, solves, iterations, summed ms, us an "
          "iteration): " + "; ".join(f"{r['shape'][0]}x{r['shape'][1]}: {r['path']}, {r['solves']}, {r['iterations']}, "
                                    f"{r['ms']:.3f}, {1e3 * r['ms'] / max(r['iterations'], 1):.2f}" for r in per_level))
    print(f"{label}: streaming solves {sum(r['solves'] for r in stream)}, iterations "
          f"{sum(r['iterations'] for r in stream)}, {sum(r['ms'] for r in stream):.3f} ms of the frame's "
          f"{sum(log['cg_ms']):.3f} ms of PCG  [{card}]")
    check(aepe <= GATE_4K_AEPE, f"{label}: AEPE {aepe:.4f} px against the known answer, gate {GATE_4K_AEPE}")
    check(launches["cg"] == len(solves) and launches["rof"] == 1 and n_wm == (len(solves) if rgb else 0),
          f"{label}: unexpected launches {launches} ({len(solves)} PCG solves in the warm-up frame)")
    check(by_path["cg streaming"] > 0 and by_path["rof tiled"] == 1,
          f"{label}: the 4K solves or the ROF call did not take the streaming / tiled path: {by_path}")
    check(cg_iters == sum(i for _, i in solves), f"{label}: CG iterations differ between two frames")
    LARGE_IMAGE_LAUNCHES[label] = (by_path["rof tiled"], by_path["cg streaming"])
    kept["cg"] = log["kept"][0]
    kept["cg 1080p"] = log["by_shape"].get((1080, 1920))
    return launches, {"frame_ms": ev_ms, "host_ms": host_ms, "peak_gb": peak_gb, "aepe": aepe,
                      "levels": ope.pyramid_levels, "pcg_by_level": per_level}, kept


def check_kernels_4k(torch, dev, card, kept):
    """The 4K frame's full-size weighted-median call against its twin
    (``wmedian_valid``) and its time; the frame's last 2160x3840 PCG system
    and its last 1080x1920 one on the streaming kernel, and its ROF call on
    the tiled kernel, against their twins (PCG within phase 2's limit, ROF
    bit for bit), with their times (CUDA events) and bounds, as phase 2
    computes them; where the previous design's sources are present
    (``previous_library``), its kernels on the same inputs in turns with the
    new ones (previous, new, new, previous)."""
    from optical_flow_tpu_torch.ops.cuda import cg_kernel, rof_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits
    from optical_flow_tpu_torch.ops.cuda.rof_kernel import rof_structure, rof_structure_2d
    from optical_flow_tpu_torch.ops.cuda.wmedian_kernel import wmedian, wmedian_plain

    out = {}
    args = kept["wmedian"]
    H, W = args[4]
    wm, ref = wmedian(*args), wmedian_plain(*args)
    torch.cuda.synchronize()
    n_diff, frac, valid = wmedian_valid(torch, args, wm, ref)
    ms = cuda_ms(torch, lambda: wmedian(*args), 5)
    plain_ms = cuda_ms(torch, lambda: wmedian_plain(*args), 1)
    b = wmedian_bound(args)
    print(f"wmedian 4K input {H}x{W} hsz {args[5]}: {n_diff} of {wm.numel()} values differ from the twin "
          f"({100 * frac:.4f}% identical), each a median within the sums' rounding: {valid}; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})  [{card}]")
    check(frac >= WMEDIAN_SHARE and valid, "weighted median outside the sums' rounding on the 4K frame's input")
    out["wmedian"] = {"frame4k_ms": ms, "frame4k_plain_ms": plain_ms, "frame4k_bound_ms": b["bound_ms"],
                      "frame4k_max_abs_err": float((wm - ref).abs().max())}
    del wm, ref

    prev = previous_library()
    print("previous design (PR 11's cg.cu / rof.cu): " + ("built from the copy in the build directory" if prev else
          "sources absent; compare with PERF.md's PR 11 numbers (another call)"))
    out["cg"] = {}
    for tag, system in (("frame4k", kept["cg"]), ("frame1080p", kept["cg 1080p"])):
        check(system is not None, f"cg: the 4K frame kept no {tag} system")
        sysm, rtol, maxiter = system
        H, W = sysm.a11.shape
        plan = cg_kernel.cg_plan(1, H, W, *device_limits(dev))
        x_k = cg_kernel.cg_solve(sysm, rtol, maxiter)
        it_k = cg_kernel.iteration_counts(dev)[0]
        x_t, it_t = cg_twin(torch, sysm, rtol, maxiter)
        x_d = cg_twin(torch, sysm, rtol, maxiter, sums=torch.float64)[0]
        limit = 1e-5 * max(float(x_t.abs().max()), 1.0)
        err, err_d = (float((x_k - x).abs().max()) for x in (x_t, x_d))
        res, res_t = relative_residual(torch, sysm, x_k), relative_residual(torch, sysm, x_t)
        planes = list(sysm)
        new = lambda: cg_kernel.launch(planes, rtol, maxiter, plan)  # noqa: E731
        if prev is not None:
            x_p, it_p = previous_cg(torch, prev, planes, rtol, maxiter)
            it_p = int(it_p[1])
            old = lambda: previous_cg(torch, prev, planes, rtol, maxiter)  # noqa: E731
            t = [cuda_ms(torch, f, 2) for f in (old, new, new, old)]
            ms, prev_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            turns = (f"; previous design {it_p} iterations, max|dx| / limit {float((x_p - x_t).abs().max()) / limit:.3f}, "
                     f"in turns previous / new / new / previous {' / '.join(f'{v:.3f}' for v in t)} ms: "
                     f"{1e3 * prev_ms / max(it_p, 1):.2f} against {1e3 * ms / max(it_k, 1):.2f} us an iteration")
        else:
            ms, prev_ms, turns = cuda_ms(torch, new, 2), None, ""
        plain_ms = cuda_ms(torch, lambda: cg_kernel.cg_solve_plain(sysm, rtol, maxiter), 1)
        b = cg_bound(H, W, it_k)
        floor_us = 1e6 * cg_kernel.STREAM_PLANE_PASSES * 4 * H * W / PEAK_BYTES  # an iteration
        print(f"cg {tag} system {H}x{W} rtol {rtol:g} ({plan.path}, {plan.blocks} blocks, tiles of {plan.rows} rows): "
              f"iterations kernel {it_k} / plain {it_t}; max|dx| / limit {err / limit:.3f} against the twin, "
              f"{err_d / limit:.3f} against it with double sums; relative residual kernel {res:.3e}, plain twin "
              f"{res_t:.3e}; kernel {ms:.3f} ms ({1e3 * ms / max(it_k, 1):.2f} us an iteration; the schedule's "
              f"{cg_kernel.STREAM_PLANE_PASSES} plane-passes an iteration at 3.35 TB/s: {floor_us:.2f} us){turns}; plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})  [{card}]")
        check(plan.path == "streaming", f"cg {tag}: path {plan.path}")
        # as phase 7 holds classic++'s rtol-1e-7 solves: float32 stops the true
        # residual short of 1e-7, so 10 x rtol or twice the float32 twin's
        check(min(err, err_d) <= limit and res <= max(10 * rtol, 2 * res_t),
              f"cg {tag} system: max|dx| {err:.3e} / {err_d:.3e} (limit {limit:.3e}), residual {res:.3e} "
              f"(twin {res_t:.3e})")
        out["cg"].update({f"{tag}_ms": ms, f"{tag}_plain_ms": plain_ms, f"{tag}_bound_ms": b["bound_ms"],
                          f"{tag}_bound_by": b["bound_by"],
                          f"{tag}_iterations": it_k, f"{tag}_max_abs_err": min(err, err_d),
                          f"{tag}_us_an_iteration": 1e3 * ms / max(it_k, 1), f"{tag}_previous_ms": prev_ms})
        del x_k, x_t, x_d, planes

    im, theta, n_iters = kept["rof"]
    plan = rof_kernel.rof_plan(*im.shape, *device_limits(dev), n_iters)
    r_k, r_t = rof_structure(im, theta, n_iters), rof_structure_2d(im, theta, n_iters)
    torch.cuda.synchronize()
    same = torch.equal(r_k, r_t)
    err = float((r_k - r_t).abs().max())
    new = lambda: rof_kernel.launch(im, theta, n_iters, plan)  # noqa: E731
    if prev is not None:
        old = lambda: previous_rof(torch, prev, im, theta, n_iters)  # noqa: E731
        t = [cuda_ms(torch, f, 3) for f in (old, new, new, old)]
        ms, prev_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        turns = f"; in turns previous / new / new / previous {' / '.join(f'{v:.3f}' for v in t)} ms"
    else:
        ms, prev_ms, turns = cuda_ms(torch, new, 3), None, ""
    plain_ms = cuda_ms(torch, lambda: rof_structure_2d(im, theta, n_iters), 1)
    n = im.numel()
    b = bound(n * (28 * n_iters + 5), 8 * n)  # as phase 2
    print(f"rof 4K input {'x'.join(map(str, im.shape))} ({plan.path}, halo {plan.halo}, tiles {plan.tile}, "
          f"{plan.passes} passes), {n_iters} iterations: torch.equal to the twin {same} (max|d| {err:.3e}); kernel "
          f"{ms:.3f} ms{turns}, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})  [{card}]")
    check(plan.path == "tiled" and same, f"rof 4K: path {plan.path}, max|d| {err:.3e}")
    out["rof"] = {"frame4k_ms": ms, "frame4k_plain_ms": plain_ms, "frame4k_bound_ms": b["bound_ms"],
                  "frame4k_bound_by": b["bound_by"], "frame4k_max_abs_err": err, "frame4k_previous_ms": prev_ms,
                  "frame4k_device_launches": rof_kernel.device_launches(plan)}
    return out


def traced_frame(logdir, device="cuda:0"):
    """Phase 19's profiled frame, run in a process of its own (the library
    already built): one warm RubberWhale ``compute_flow()``, then one under
    ``utils.profiling.trace(logdir)`` inside ``annotate``."""
    import torch

    from optical_flow_tpu_torch.io.flo import read_flow_file
    from optical_flow_tpu_torch.utils.profiling import annotate, trace

    dev = torch.device(device)
    if dev.type == "cuda":
        float32_settings(torch)
    rgb1, rgb2, _, _ = read_flow_file("RubberWhale", 10)
    ope = _method_object(torch, dev, rgb1, rgb2)
    with torch.no_grad():
        ope.compute_flow()
        with trace(logdir), annotate("phase19-method-object"):
            ope.compute_flow()


def phase_method_objects(torch, dev, card, rgb1, rgb2, tu, tv, main_uv, finest_cg):
    """The JAX package's method-object API on the card: RubberWhale through
    ``ope.images = ...; ope.compute_flow()`` (bit-identical to phase 3's
    ``estimate_flow`` frame, the same launches), the warm start
    ``compute_flow(init=<that flow>)`` in the gate, ``compute_flow_base``
    from zero flow at the finest level against the CPU run of its plain twins
    (mean |d| <= BASE_MEAN_DIFF), ``pcg_solve`` against the PCG kernel on
    phase 5's finest system, the two 4K frames and their kernels, and the
    profiling utilities.  Returns the launches by path and the 4K results."""
    import json as json_mod
    import tempfile

    from optical_flow_tpu_torch import flow_angular_error
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.ops.stencil import system_apply, system_diag, system_rhs
    from optical_flow_tpu_torch.solvers import pcg_solve
    from optical_flow_tpu_torch.utils.profiling import SPAN_PREFIX, StageTimer

    t_phase = time.perf_counter()
    by_path = {}
    ope = _method_object(torch, dev, rgb1, rgb2)
    with no_plain_twins():
        uv, by_path["method object"], paths, cold_iters = _counted(torch, dev, ope.compute_flow)
    same = torch.equal(uv, main_uv)
    print(f"method object RubberWhale 584x388: ope.compute_flow() torch.equal to phase 3's estimate_flow frame: {same}; "
          f"launches {by_path['method object']}, by path {paths}, CG iterations {cold_iters}")
    check(same, "the method-object frame differs from estimate_flow's")
    check(by_path["method object"] == {"wmedian": 21, "cg": 21, "rof": 1}, f"unexpected launches {by_path['method object']}")

    with no_plain_twins():
        warm, by_path["warm start"], _, warm_iters = _counted(torch, dev, lambda: ope.compute_flow(init=uv))
    errs = {}
    for key, f in (("cold", uv), ("warm", warm)):
        f_np = f.cpu().numpy()
        check(np.isfinite(f_np).all(), f"method object {key} flow is not finite")
        aae, _, aepe = flow_angular_error(tu, tv, f_np[..., 0], f_np[..., 1])
        errs[key] = (aae, aepe)
    print(f"warm start compute_flow(init=<the frame's flow>): AAE {errs['warm'][0]:.4f} deg, AEPE {errs['warm'][1]:.5f} "
          f"px, {warm_iters} CG iterations, against the cold frame's {errs['cold'][0]:.4f} / {errs['cold'][1]:.5f}, "
          f"{cold_iters} (gate {TARGET_AAE} +- {GATE_AAE} / {TARGET_AEPE} +- {GATE_AEPE}); launches {by_path['warm start']}")
    check(abs(errs["warm"][0] - TARGET_AAE) <= GATE_AAE and abs(errs["warm"][1] - TARGET_AEPE) <= GATE_AEPE,
          "the warm start is outside the classic+nl-fast gate")

    zero = torch.zeros_like(uv)
    with no_plain_twins():
        base, by_path["compute_flow_base"], _, base_iters = _counted(torch, dev, lambda: ope.compute_flow_base(zero))
    cpu = _method_object(torch, torch.device("cpu"), rgb1, rgb2)
    with torch.no_grad():
        base_cpu = cpu.compute_flow_base(zero.cpu())
    d = (base.cpu() - base_cpu).abs()
    print(f"compute_flow_base(0) at 388x584 with the Lab guide: launches {by_path['compute_flow_base']}, "
          f"{base_iters} CG iterations; against the same call on the CPU (float32, the plain twins): mean |d| "
          f"{float(d.mean()):.3e} px (limit {BASE_MEAN_DIFF:g}), max |d| {float(d.max()):.3e} px")
    check(by_path["compute_flow_base"] == {"wmedian": 3, "cg": 3, "rof": 0},
          f"compute_flow_base: unexpected launches {by_path['compute_flow_base']}")
    check(bool(torch.isfinite(base).all()) and float(d.mean()) <= BASE_MEAN_DIFF, "compute_flow_base differs from its CPU run")

    sysm, rtol, maxiter = finest_cg
    H, W = sysm.a11.shape
    x_k = cg_kernel.cg_solve(sysm, rtol, maxiter)
    it_k = cg_kernel.iteration_counts(dev)[0]
    applies = [0]

    def apply_A(v):
        applies[0] += 1
        return system_apply(sysm, v)

    def dot64(a, b):  # the kernel's own summation type
        return (a.double() * b.double()).sum().to(a.dtype)

    b = system_rhs(sysm)
    x_p = pcg_solve(apply_A, b, system_diag(sysm), rtol, maxiter, a12=sysm.a12)
    it_p = applies[0] - 1
    x_d = pcg_solve(lambda v: system_apply(sysm, v), b, system_diag(sysm), rtol, maxiter, dot=dot64, a12=sysm.a12)
    b64 = b.double()
    sys64 = type(sysm)(*[f.double() for f in sysm])
    res = {k: float(torch.linalg.norm(system_apply(sys64, x.double()) - b64) / torch.linalg.norm(b64))
           for k, x in (("kernel", x_k), ("pcg_solve", x_p))}
    limit = 1e-5 * max(float(x_k.abs().max()), 1.0)
    err, err_d = float((x_p - x_k).abs().max()), float((x_d - x_k).abs().max())
    print(f"pcg_solve on the card, phase 5's finest system {H}x{W} rtol {rtol:g}: iterations kernel {it_k} / pcg_solve "
          f"{it_p} (maxiter {maxiter}); max|dx| from the kernel {err:.3e}, with float64 sums {err_d:.3e} (limit "
          f"{limit:.3e}); relative residual kernel {res['kernel']:.3e}, pcg_solve {res['pcg_solve']:.3e}")
    check(it_k < maxiter and it_p < maxiter, "the kernel or pcg_solve did not converge")
    check(min(err, err_d) <= limit and max(res.values()) <= 10 * rtol, "pcg_solve and the PCG kernel disagree")

    frames, kernels_4k = {}, {}
    for label, rgb in (("4K gray", False), ("4K rgb", True)):
        by_path[label], frames[label], kept = phase_frame_4k(torch, dev, card, label, rgb)
        if rgb:
            kernels_4k = check_kernels_4k(torch, dev, card, kept)
        del kept

    # the traced frame runs in a fresh process: in this one, minutes old,
    # the CUDA profiler drops a few more kernels from its record with every
    # minute (the ROF call among them after ~4 minutes; PERF.md §6)
    with tempfile.TemporaryDirectory() as logdir:
        child = subprocess.run(
            [sys.executable, "-c", f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
                                   f"chip_smoke.traced_frame({logdir!r})"],
            cwd=REPO, capture_output=True, text=True, timeout=RANKS_TIMEOUT)
        check(child.returncode == 0, f"the traced frame's process failed: {child.stderr[-3000:]}")
        with open(os.path.join(logdir, "trace.json")) as f:
            events = json_mod.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernel_names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    found = {k: any(tag in nm for nm in kernel_names)
             for k, tag in (("wmedian", "wmedian_kernel"), ("cg", "cg_"), ("rof", "rof_"))}
    timer = StageTimer()
    with timer.stage("compute_flow", sync=uv):
        with torch.no_grad():
            ope.compute_flow()
    span = SPAN_PREFIX + "phase19-method-object"
    print(f"profiling: trace.json names the kernels {found}, the annotation: {span in names}; "
          f"StageTimer: {timer.report().strip()}")
    check(all(found.values()) and span in names,
          f"the trace misses a kernel or the annotation: {len(kernel_names)} kernel names, "
          f"{sorted(kernel_names)[:40]}")
    check(timer.records[0][1] > 0, "StageTimer recorded no time")
    print(f"method objects: phase wall time {time.perf_counter() - t_phase:.1f} s (host clock)")
    return by_path, frames, kernels_4k


# phase 20: a fresh process's first frame, cold (A), after warmup_classic_nl
# (B), and the 4K RGB harness frame after the warm-up at its size (C)
COLD_RUNS = ("A", "B", "C")


def cold_start_run(run, outdir):
    """One sub-run of phase 20, in a process of its own (the library already
    built): the port's import time, then for B and C the warm-up (no plain
    twin; its time and launches), then the first frame with its launches,
    timed on the host clock and by CUDA events around the call, and for A
    and B a second frame.  Writes ``<run>.json`` and the first flow as
    ``<run>.npy`` to ``outdir``."""
    t0 = time.perf_counter()
    import torch

    import optical_flow_tpu_torch  # noqa: F401

    import_s = time.perf_counter() - t0
    from optical_flow_tpu_torch import estimate_flow, load_of_method
    from optical_flow_tpu_torch.io.flo import read_flow_file
    from optical_flow_tpu_torch.utils.compat import preprocess_color_pair
    from optical_flow_tpu_torch.utils.warmup import warmup_classic_nl

    dev = torch.device("cuda", 0)
    float32_settings(torch)
    out = {"import_s": import_s}
    if run == "C":
        rng = np.random.default_rng(SEED)
        base = rng.uniform(0, 255, (*FRAME_4K, 3)).astype(np.float32)
        im2 = np.roll(base, SHIFT_4K, axis=1)
        sz = FRAME_4K
    else:
        rgb1, rgb2, _, _ = read_flow_file("RubberWhale", 10)
        sz = rgb1.shape[:2]
    with no_plain_twins():
        if run != "A":
            ope = load_of_method("classic+nl-fast")  # C: phase 19's harness call, the preset's solver
            ope.parse_input_parameter(PARAMS if run == "B" else {"display": False})
            reset_counts()
            t0 = time.perf_counter()
            warmup_classic_nl(ope, sz, color=True)
            out["warmup_s"] = time.perf_counter() - t0
            out["warmup_launches"], out["warmup_by_path"] = read_counts()
        if run == "C":
            ope.images, ope.color_images = preprocess_color_pair(torch.as_tensor(base, device=dev),
                                                                 torch.as_tensor(im2, device=dev))
            frame = ope.compute_flow
        else:
            frame = lambda: estimate_flow(rgb1, rgb2, "classic+nl-fast", PARAMS, device=dev)  # noqa: E731
        for key in ("first", "second") if run != "C" else ("first",):
            reset_counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            with torch.no_grad():
                uv = frame()
            end.record()
            torch.cuda.synchronize()
            out[f"{key}_host_ms"] = 1e3 * (time.perf_counter() - t0)
            out[f"{key}_ms"] = start.elapsed_time(end)
            out[f"{key}_launches"], out[f"{key}_by_path"] = read_counts()
            if key == "first":
                np.save(os.path.join(outdir, f"{run}.npy"), uv.cpu().numpy())
    with open(os.path.join(outdir, f"{run}.json"), "w") as f:
        json.dump(out, f)


def phase_cold_start(torch, card, main_uv, frame_ms, frame_4k_ms):
    """Phase 20: ``cold_start_run`` A, B and C, each in a fresh process, one
    after the other with this process's cached blocks released.  A's and B's
    first flows must be ``torch.equal`` to phase 3's frame; B's warm-up must
    launch every kernel; C's warm-up must take the streaming PCG and tiled
    ROF paths and its first frame lie within phase 19's 4K gate.  Returns
    the launches by sub-run and the numbers."""
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res, launches = {}, {}
    with tempfile.TemporaryDirectory() as outdir:
        for run in COLD_RUNS:
            t0 = time.perf_counter()
            child = subprocess.run(
                [sys.executable, "-c", f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
                                       f"chip_smoke.cold_start_run({run!r}, {outdir!r})"],
                cwd=REPO, capture_output=True, text=True, timeout=RANKS_TIMEOUT)
            check(child.returncode == 0, f"cold start {run}: the process failed: {child.stderr[-3000:]}")
            with open(os.path.join(outdir, f"{run}.json")) as f:
                r = json.load(f)
            r["process_s"] = time.perf_counter() - t0
            r["uv"] = np.load(os.path.join(outdir, f"{run}.npy"))
            res[run] = r
    print(f"cold start: phase 1's kernel build + load {SETUP.get('build_load_s', float('nan')):.1f} s; each sub-run a "
          f"fresh process with the library built  [{card}]")
    for run, label in (("A", "A, estimate_flow cold"), ("B", "B, after warmup_classic_nl(ope, (388, 584))"),
                       ("C", "C, 4K RGB harness frame after warmup_classic_nl(ope, (2160, 3840))")):
        r = res[run]
        warm = (f"warm-up {r['warmup_s']:.3f} s (host clock), launches {r['warmup_launches']}, by path "
                f"{r['warmup_by_path']}; " if "warmup_s" in r else "")
        second = (f"; second frame {r['second_ms']:.2f} ms (CUDA events), {r['second_host_ms']:.2f} ms (host clock)"
                  if "second_ms" in r else "")
        print(f"cold start {label}: import {r['import_s']:.3f} s; {warm}first frame {r['first_ms']:.2f} ms (CUDA "
              f"events), {r['first_host_ms']:.2f} ms (host clock), launches {r['first_launches']}{second}; process "
              f"{r['process_s']:.1f} s  [{card}]")
        launches[f"cold start {run} frame"] = r["first_launches"]
        if "second_launches" in r:
            launches[f"cold start {run} second frame"] = r["second_launches"]
        if "warmup_launches" in r:
            launches[f"cold start {run} warm-up"] = r["warmup_launches"]
    print(f"cold start: phase 3's warm frame {frame_ms:.2f} ms, phase 19's warm 4K RGB frame {frame_4k_ms:.2f} ms "
          f"(CUDA events, this process)  [{card}]")
    main_np = main_uv.cpu().numpy()
    same = {run: bool(torch.equal(torch.from_numpy(res[run]["uv"]), torch.from_numpy(main_np))) for run in ("A", "B")}
    aepe, _, _ = _known_answer(res["C"]["uv"])
    print(f"cold start: first frames torch.equal to phase 3's frame: {same}; C's AEPE against ({SHIFT_4K}, 0) on the "
          f"interior {aepe:.6f} px (gate {GATE_4K_AEPE})")
    check(all(same.values()), f"a cold-start first frame differs from phase 3's frame: {same}")
    check(all(res["B"]["warmup_launches"][k] >= 1 for k in ("wmedian", "cg", "rof")),
          f"the warm-up did not launch every kernel: {res['B']['warmup_launches']}")
    c_paths = res["C"]["warmup_by_path"]
    check(c_paths["cg streaming"] > 0 and c_paths["rof tiled"] >= 1,
          f"the 4K warm-up did not take the streaming PCG and tiled ROF paths: {c_paths}")
    check(bool(np.isfinite(res["C"]["uv"]).all()) and aepe <= GATE_4K_AEPE,
          f"cold start C: AEPE {aepe:.4f} px against the known answer, gate {GATE_4K_AEPE}")
    for label, key in (("warm-up", "warmup_by_path"), ("frame", "first_by_path")):
        LARGE_IMAGE_LAUNCHES[f"cold start C {label}"] = (res["C"][key]["rof tiled"], res["C"][key]["cg streaming"])
    print(f"cold start: phase wall time {time.perf_counter() - t_phase:.1f} s (host clock)")
    numbers = {run: {k: v for k, v in r.items() if k != "uv"} for run, r in res.items()}
    numbers["build_load_s"] = SETUP.get("build_load_s")
    return launches, numbers


# phase 21: the level step's CUDA graphs against a copy of the parent commit's tree
PARENT_TREE = os.path.join(REPO, "_checkout", "parent")
GRAPH_RUNS = ("rubberwhale classic+nl-fast", "4K rgb classic+nl-fast", "classic++ B=8")
SPANS_CELLS = ("nlfast_4k_single", "classicpp_mbo_b8")
SPANS_SEED = 3141592653


def graph_flows(tree, outdir):
    """Phase 21's flows with the port of ``tree``, in a process of its own:
    each of ``GRAPH_RUNS`` called twice.  Writes ``flows.npz`` and
    ``calls.json`` (each call's host-clock ms and, where the tree has
    ``utils/graphs.py``, the graph counters of that call) to ``outdir``."""
    sys.path.insert(0, tree)
    import torch

    from optical_flow_tpu_torch import estimate_flow
    from optical_flow_tpu_torch.io.flo import read_flow_file
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched_rgb

    try:
        from optical_flow_tpu_torch.utils import graphs
    except ImportError:  # a tree before the graphs
        graphs = None
    float32_settings(torch)
    rgb1, rgb2, _, _ = read_flow_file("RubberWhale", 10)
    base = np.random.default_rng(SEED).uniform(0, 255, (*FRAME_4K, 3)).astype(np.float32)
    pairs = [read_flow_file(seq, 10)[:2] for seq in BATCH_SEQS]
    b1 = np.stack([p[0] for p in pairs] + [p[0][:, ::-1] for p in pairs])
    b2 = np.stack([p[1] for p in pairs] + [p[1][:, ::-1] for p in pairs])
    runs = dict(zip(GRAPH_RUNS, (
        lambda: estimate_flow(rgb1, rgb2, "classic+nl-fast", PARAMS, device="cuda"),
        lambda: estimate_flow(base, np.roll(base, SHIFT_4K, axis=1), "classic+nl-fast", {"display": False},
                              device="cuda"),
        lambda: estimate_flow_batched_rgb(b1, b2, "classic++", params=PATH_PARAMS, device="cuda"))))
    flows, calls = {}, {}
    for name, run in runs.items():
        for k in range(2):
            if graphs is not None:
                graphs.reset_stats()
            t0 = time.perf_counter()
            flows[f"{name}|{k}"] = run().cpu().numpy()
            calls[f"{name}|{k}"] = {"ms": 1e3 * (time.perf_counter() - t0),
                                    "graphs": graphs.stats("cuda") if graphs is not None else None}
    np.savez(os.path.join(outdir, "flows.npz"), **flows)
    with open(os.path.join(outdir, "calls.json"), "w") as f:
        json.dump(calls, f)


def phase_graphs(torch, card):
    """Phase 21 (see the module docstring).  Returns the calls' numbers by tree."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    trees = {"change": REPO}
    if os.path.isdir(os.path.join(PARENT_TREE, "optical_flow_tpu_torch")):
        trees = {"parent": PARENT_TREE, **trees}
        built = os.path.join(REPO, "optical_flow_tpu_torch", "_build")
        if not os.path.isdir(os.path.join(PARENT_TREE, "optical_flow_tpu_torch", "_build")):
            shutil.copytree(built, os.path.join(PARENT_TREE, "optical_flow_tpu_torch", "_build"))  # same sources
    else:
        print(f"graphs: no parent tree in {PARENT_TREE}: the flows are compared with nothing")
    flows, calls = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, tree in trees.items():
            outdir = os.path.join(tmp, label)
            os.makedirs(outdir)
            child = subprocess.run(
                [sys.executable, "-c", f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
                                       f"chip_smoke.graph_flows({tree!r}, {outdir!r})"],
                cwd=tree, capture_output=True, text=True, timeout=RANKS_TIMEOUT)
            check(child.returncode == 0, f"graphs: the {label} process failed: {child.stderr[-3000:]}")
            with np.load(os.path.join(outdir, "flows.npz")) as z:
                flows[label] = {k: z[k] for k in z.files}
            with open(os.path.join(outdir, "calls.json")) as f:
                calls[label] = json.load(f)
    for name in GRAPH_RUNS:
        times = "; ".join(f"{label} {calls[label][name + '|0']['ms']:.2f} / {calls[label][name + '|1']['ms']:.2f} ms"
                          for label in trees)
        print(f"graphs: {name}, first / second call (host clock): {times}  [{card}]")
        first, second = calls["change"][name + "|0"]["graphs"], calls["change"][name + "|1"]["graphs"]
        print(f"graphs: {name}: first call {first}; second call {second}")
        check(first["captures"] > 0 and second["captures"] == 0 and second["eager"] == 0
              and second["hit_share"] == 1.0, f"graphs: {name}: a capture after the first call, or an eager chain")
        same = np.array_equal(flows["change"][name + "|0"], flows["change"][name + "|1"])
        if "parent" in trees:
            ref = flows["parent"][name + "|0"]
            same = same and all(np.array_equal(flows[label][name + f"|{k}"], ref)
                                for label in trees for k in (0, 1))
            print(f"graphs: {name}: both calls bit-identical to the parent's flow: {same}")
        check(same, f"graphs: {name}: the flows differ between calls or from the parent's")
    for cell in SPANS_CELLS:
        for label, tree in reversed(list(trees.items())):
            child = subprocess.run([sys.executable, "flowbench/spans_report.py", "--workload", cell, "--seed",
                                    str(SPANS_SEED)], cwd=tree, capture_output=True, text=True,
                                   timeout=RANKS_TIMEOUT)
            check(child.returncode == 0, f"graphs: spans_report {cell} ({label}) failed: {child.stderr[-3000:]}")
            print(f"graphs: spans_report {cell} seed {SPANS_SEED}, {label} tree  [{card}]")
            print(child.stderr.rstrip())
            print(child.stdout.strip().splitlines()[-1])
    print(f"graphs: phase wall time {time.perf_counter() - t_phase:.1f} s (host clock)")
    return calls


def phase_classic_nl(torch, card, rgb1, rgb2, tu, tv):
    """Phase 22 (see the module docstring).  Returns each call's launches and the latencies."""
    from optical_flow_tpu_torch import estimate_flow, flow_angular_error
    from optical_flow_tpu_torch.io.flo import read_flow_file
    from optical_flow_tpu_torch.ops.cuda import cg_kernel, wmedian_kernel
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched_rgb
    from optical_flow_tpu_torch.utils import graphs

    dev = torch.device("cuda", 0)
    name = "classic+nl"
    seqs = {seq: read_flow_file(seq, 10) for seq in NL_VGA_SEQS}
    im1, im2 = np.stack([v[0] for v in seqs.values()]), np.stack([v[1] for v in seqs.values()])
    B = len(NL_VGA_SEQS)
    calls = {
        "classic+nl": (lambda: estimate_flow(rgb1, rgb2, name, PATH_PARAMS, device=dev), 1,
                       {"RubberWhale": (tu, tv)}),
        "classic+nl batch VGA": (lambda: estimate_flow_batched_rgb(im1, im2, name, params=PATH_PARAMS, device=dev),
                                 B, {seq: v[2:] for seq, v in seqs.items() if v[2] is not None}),
    }
    launches_by_path, timing = {}, {}
    for label, (run, n, truth) in calls.items():
        recorded = []
        with solve_log(torch, dev) as log, _recording(torch, recorded if n > 1 else None, None):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        # the batch's last weighted-median input at 640x480 (stage 3's finest
        # level) and at 512x384 (its GNC level below)
        kept = {a[4]: a for a in recorded if a[4] in NL_WMEDIAN_CHECKED}
        del recorded
        solves = [(shape, sum(its)) for shape, its, _ in log["cg"]]
        reset_counts()
        graphs.reset_stats()
        with no_plain_twins():
            uv = run()
            torch.cuda.synchronize()
        launches, by_path = read_counts()
        wm, g = wmedian_kernel.stats(), graphs.stats(dev)
        cg_iters = cg_kernel.iteration_counts(dev)[1]
        uv_np = uv.cpu().numpy().reshape(n, *uv.shape[-3:])
        check(np.isfinite(uv_np).all(), f"{label}: flow is not finite")
        print(f"{label}: warm-up call {warm_s:.2f} s (host clock, one sync a solve); launches in one call "
              f"{launches}, {by_path}, weighted median {wm}, graphs {g}, CG iterations {cg_iters} (warm-up "
              f"{sum(i for _, i in solves)}); per level, coarse to fine (shape: solves, iterations over the items): "
              + "; ".join(f"{h}x{w}: {k}, {i}" for (h, w), k, i in level_runs(solves)))
        for i, seq in enumerate(NL_VGA_SEQS if n > 1 else ["RubberWhale"]):
            if seq in truth:
                aae, _, aepe = flow_angular_error(*truth[seq], uv_np[i, ..., 0], uv_np[i, ..., 1])
                (t_aae, t_aepe), (g_aae, g_aepe) = NL_ORACLE[seq], NL_GATE
                print(f"{label} {seq}: AAE {aae:.4f} deg, AEPE {aepe:.5f} px (oracle {t_aae} / {t_aepe}, gate "
                      f"{g_aae} / {g_aepe})")
                check(abs(aae - t_aae) <= g_aae and abs(aepe - t_aepe) <= g_aepe, f"{label} {seq}: accuracy "
                      "outside the gate")
        check(wm == {"launches": NL_WARPS, "items": n * NL_WARPS} and launches["rof"] == 1,
              f"{label}: weighted median {wm}, ROF {launches['rof']}: expected {NL_WARPS} launches of {n} items, 1 ROF")
        check(len(solves) == NL_WARPS and by_path["cg items"] == n * NL_WARPS,
              f"{label}: {len(solves)} PCG calls of {by_path['cg items']} items, expected {NL_WARPS} of {n}")
        check(cg_iters == sum(i for _, i in solves), f"{label}: CG iterations differ between two calls")
        check(g["captures"] == 0 and g["hit_share"] == 1.0, f"{label}: a second call captured graphs: {g}")
        ev_ms = []
        for _ in range(LATENCY_RUNS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            ev_ms.append(start.elapsed_time(end))
        timing[label] = {"call_ms": statistics.median(ev_ms), "pair_ms": statistics.median(ev_ms) / n,
                         "runs_ms": ev_ms, "cg_iters": cg_iters, "solves": len(solves)}
        print(f"{label}: latency, median of {LATENCY_RUNS} warm calls: {timing[label]['call_ms']:.2f} ms a call, "
              f"{timing[label]['pair_ms']:.2f} ms a pair (CUDA events; runs {', '.join(f'{x:.2f}' for x in ev_ms)})"
              f"  [{card}]")
        launches_by_path[label] = launches
        if n > 1:
            check(sorted(kept) == sorted(NL_WMEDIAN_CHECKED), f"{label}: recorded weighted-median inputs at "
                  f"{sorted(kept)}, expected {sorted(NL_WMEDIAN_CHECKED)}")
            timing[label]["wmedian"] = {f"{h}x{w}": check_batched_wmedian(torch, card, f"{label} weighted median",
                                                                          kept[(h, w)]) for h, w in NL_WMEDIAN_CHECKED}
            del kept
            seq = NL_VGA_SEQS[2]
            single = estimate_flow(seqs[seq][0], seqs[seq][1], name, PATH_PARAMS, device=dev).cpu().numpy()
            d = np.abs(single - uv_np[2])
            print(f"{label}: item 2 ({seq}) against its single-pair call: mean |d| {d.mean():.3g} px, max "
                  f"{d.max():.3g} px")
    return launches_by_path, timing


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

    if sys.argv[1:] in (["--phase", "21"], ["--phase", "22"]):
        try:
            card = phase_setup(torch)
            if sys.argv[2] == "21":
                print("graphs: " + json.dumps(phase_graphs(torch, card)))
            else:
                rgb1, rgb2, tu, tv = read_flow_file("RubberWhale", 10)
                print("classic+nl: " + json.dumps(phase_classic_nl(torch, card, rgb1, rgb2, tu, tv)))
        except CheckFailed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(card_line())
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
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
        check_cg_batched(torch, dev, card, rng)
        launches, recorded, recorded_cg, frame_ms, main_uv = phase_main_path(torch, dev, card, rgb1, rgb2, tu, tv)
        results["wmedian"].update(phase_wmedian_levels(torch, card, recorded))
        del recorded
        cg_levels, finest_cg = phase_cg_levels(torch, dev, card, recorded_cg)
        results["cg"].update(cg_levels)
        del recorded_cg
        phase_profile(torch, dev, card, rgb1, rgb2, frame_ms)
        launches_by_path = {"classic+nl-fast": launches}
        for name, gate in PATH_GATES.items():
            keep = 10 if name == "classic++" else 0
            launches_by_path[name], recorded_cg, path_ms = phase_path(
                torch, dev, card, name, name, PATH_PARAMS, gate, rgb1, rgb2, tu, tv, keep,
                solves_expected=None if name == "hs" else 90)
            if name == "classic++":
                phase_cg_finest(torch, dev, card, recorded_cg)
                del recorded_cg
                phase_profile(torch, dev, card, rgb1, rgb2, path_ms, "classic++", PATH_PARAMS)
        phase_plain_ops(torch, dev, card)
        for label, name, params, gate, n_solves in NEW_PATHS:
            launches_by_path[label], _, path_ms = phase_path(
                torch, dev, card, label, name, params, gate, rgb1, rgb2, tu, tv, solves_expected=n_solves)
            if label == "classic-c-a":
                phase_profile(torch, dev, card, rgb1, rgb2, path_ms, name, params)
                launches_by_path["classic-c-a unguarded"] = phase_alt_unguarded(torch, dev, card, rgb1, rgb2)
        launches_by_path["hs guard"] = phase_guard_noop(torch, dev, rgb1, rgb2)
        pairs = [(seq, *read_flow_file(seq, 10)) for seq in BATCH_SEQS]
        launches_by_path["batch"], _, cg_batch, wm_batch, rof_batch = phase_batch(torch, dev, card, pairs)
        results["cg"].update(cg_batch)
        results["wmedian"].update(wm_batch)
        results["rof"].update(rof_batch)
        scaling, prof = phase_scaling(torch, dev, card, pairs)
        launches_by_path["video"], launches_by_path["stream"] = phase_video_stream(
            torch, dev, card, pairs, launches_by_path["batch"]["cg"])
        family_launches, family_latency = phase_batch_families(torch, dev, card, pairs)
        launches_by_path.update(family_launches)
        sharded_launches, sharded_latency, sharded_ref = phase_sharded(torch, dev, card, rgb1, rgb2, tu, tv)
        launches_by_path.update(sharded_launches)
        t_phase = time.perf_counter()
        family_launches, family_ms = phase_sharded_families(torch, dev, card, rgb1, rgb2, tu, tv)
        launches_by_path.update(family_launches)
        mesh_launches, batch_ref = phase_mesh_batches(torch, dev, card, pairs)
        launches_by_path.update(mesh_launches)
        launches_by_path["pipeline classic+nl-fast"], pipeline_ms = phase_pipeline(
            torch, dev, card, pairs, sharded_latency["unsharded"])
        print(f"multi-device: phase wall time {time.perf_counter() - t_phase:.1f} s (host clock)")
        process_launches, process_host_s = phase_multiprocess(torch, card, tu, tv, sharded_ref, batch_ref)
        launches_by_path.update(process_launches)
        api_launches, frames_4k, kernels_4k = phase_method_objects(torch, dev, card, rgb1, rgb2, tu, tv, main_uv,
                                                                   finest_cg)
        launches_by_path.update(api_launches)
        for name, extra in kernels_4k.items():
            results[name].update(extra)
        cold_launches, cold_start = phase_cold_start(torch, card, main_uv, frame_ms, frames_4k["4K rgb"]["frame_ms"])
        launches_by_path.update(cold_launches)
        graph_calls = phase_graphs(torch, card)
        nl_launches, nl_latency = phase_classic_nl(torch, card, rgb1, rgb2, tu, tv)
        launches_by_path.update(nl_launches)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    meta = {
        "wmedian": ("optical_flow_tpu_torch/csrc/wmedian.cu", "optical_flow_tpu/ops/pallas/wmedian_kernel.py:202"),
        "cg": ("optical_flow_tpu_torch/csrc/cg.cu", "optical_flow_tpu/ops/pallas/cg_kernel.py:160"),
        "rof": ("optical_flow_tpu_torch/csrc/rof.cu", "optical_flow_tpu/ops/pallas/rof_kernel.py:75"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(counts[name] for counts in launches_by_path.values()),
         "launches_by_path": {path: counts[name] for path, counts in launches_by_path.items()},
         # no one PyTorch call computes any of the three functions
         **results[name], "library_ms": None}
        for name, (src, rep) in meta.items()
    ]
    # the large-image kernels on their own lines, with the 4K harness's inputs
    for name, key, (src, rep), idx in (
            ("rof_tiled", "rof", ("optical_flow_tpu_torch/csrc/rof.cu", "optical_flow_tpu/ops/pallas/rof_kernel.py:199"), 0),
            ("cg_stream", "cg", ("optical_flow_tpu_torch/csrc/cg.cu", "optical_flow_tpu/ops/pallas/cg_kernel.py:160"), 1)):
        r = results[key]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": sum(v[idx] for v in LARGE_IMAGE_LAUNCHES.values()),
                        "launches_by_path": {path: v[idx] for path, v in LARGE_IMAGE_LAUNCHES.items()},
                        "max_abs_err": r["frame4k_max_abs_err"], "ms": r["frame4k_ms"], "plain_ms": r["frame4k_plain_ms"],
                        "bound_ms": r["frame4k_bound_ms"], "bound_by": r["frame4k_bound_by"], "library_ms": None,
                        "previous_ms": r["frame4k_previous_ms"]})
    print("batch scaling: " + json.dumps({**scaling, "profiled_batch4": prof, "families": family_latency,
                                          "sharded": sharded_latency,
                                          "multi_device": {"sharded_host_ms": family_ms, **pipeline_ms},
                                          "multi_process_host_s": process_host_s, "frames_4k": frames_4k,
                                          "cold_start": cold_start, "graphs": graph_calls,
                                          "classic_nl": nl_latency}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
