"""Cold-start warm-up of a Classic+NL flow (port of ``optical_flow_tpu/utils/warmup.py``).

The JAX package compiles every level program of a flow before the first
request.  The port compiles nothing per shape, but a fresh process still
pays at its first frame: the nvcc build (or the load) of the kernel
library, the CUDA context and library handles, each kernel's plan and
``device_limits`` query, and the caching allocator's first blocks at every
level shape.  :func:`warmup_classic_nl` runs every program a Classic+NL
``compute_flow`` of one size runs, on seeded random inputs, so that the
first real frame finds all of that done.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def level_schedule(ope, sz):
    """([(cfg, image_hw, uv_hw)] for every level call of a Classic+NL flow of
    size ``sz``, coarse to fine within each GNC stage, ``uv_hw`` the shape of
    the flow the level resamples from; the flow's plan).

    The plan is the method's own (``_make_nl_plan``), with colour as
    ``ope.color_images`` says; ``ope.pyramid_levels`` is left as it was.
    """
    levels = ope.pyramid_levels
    try:
        plan = ope._make_nl_plan(tuple(int(s) for s in sz), use_color=ope.color_images is not None)
    finally:
        ope.pyramid_levels = levels
    calls = []
    uv_hw = (int(sz[0]), int(sz[1]))
    for stage, (cfg, _alpha) in enumerate(plan.stages):
        shapes = plan.shapes if stage == 0 else plan.gnc_shapes
        for level in range(len(shapes) - 1, -1, -1):
            calls.append((cfg, shapes[level], uv_hw))
            uv_hw = shapes[level]
    return calls, plan


def warmup_classic_nl(ope, sz: Tuple[int, int], color: bool = True, max_workers: int = 8, device=None):
    """Run every program a Classic+NL ``compute_flow`` of size ``sz`` will run.

    ``ope`` must be configured exactly as it will be used (solver, iters,
    penalties, colour or not); ``sz`` is the input image size.  As in the
    JAX package, ``color=True`` on an ope without a guide sets the (1, 1, 3)
    placeholder and ``color=False`` sets ``ope.color_images`` to None.

    ``device`` defaults to ``"cuda"`` and raises without a GPU; the CPU runs
    only when named.  On the card it builds or loads the kernel library,
    then runs the preprocessing of a ``sz`` pair (the ROF kernel on the path
    ``sz`` takes), the colour conversion and pyramids where ``color`` is set,
    and one level step at every (image, flow) shape pair of the schedule
    (:func:`level_schedule`) under its stage's alpha, which launches the PCG
    kernel on the path its plan gives and the weighted median (the plain
    median without colour) and captures the level's CUDA graphs
    (``utils/graphs.py``), so that the first frame only replays them.
    ``max_workers`` is accepted for the JAX signature and unused: on one
    card the programs run in order on one stream.  Nothing is left that a
    later flow reads: the inputs come from a local ``np.random.default_rng(0)``.
    """
    from optical_flow_tpu_torch.interface import _resolve_dtype, resolve_device
    from optical_flow_tpu_torch.methods.ba import irls_pyramids
    from optical_flow_tpu_torch.methods.classic_nl import classic_nl_level_step, color_pyramids
    from optical_flow_tpu_torch.ops.resample import resample_flow
    from optical_flow_tpu_torch.utils import graphs
    from optical_flow_tpu_torch.utils.compat import preprocess_color_pair

    dev = resolve_device("cuda" if device is None else device, "warmup_classic_nl")
    if color and ope.color_images is None:
        ope.color_images = np.ones((1, 1, 3))
    if not color:
        ope.color_images = None
    if dev.type == "cuda":
        from optical_flow_tpu_torch.ops.cuda.build import load_library

        load_library()

    calls, plan = level_schedule(ope, sz)
    dtype = _resolve_dtype(ope.dtype)
    rng = np.random.default_rng(0)

    def uniform(*shape):
        return torch.as_tensor(rng.uniform(0, 255, shape), dtype=dtype, device=dev)

    with torch.no_grad():
        if color:
            rgb = uniform(*sz, 3)
            images, guide = preprocess_color_pair(rgb, rgb)
            color_pyramids(plan, guide)
        else:
            images = uniform(*sz, 2)
        irls_pyramids(plan.preprocess, plan.alp, plan, images)
        # each level under its stage's alpha and the flow program's level context, so that the graphs it
        # captures are the ones the flow replays (utils/graphs.py)
        where = [(stage, level, alpha) for stage, (_, alpha) in enumerate(plan.stages)
                 for level in range(len(plan.shapes if stage == 0 else plan.gnc_shapes) - 1, -1, -1)]
        for (cfg, img_hw, uv_hw), (stage, level, alpha) in zip(calls, where):
            uv = resample_flow(torch.zeros((*uv_hw, 2), dtype=dtype, device=dev), img_hw)
            with graphs.level((1, int(sz[0]), int(sz[1])), stage, level):
                classic_nl_level_step(cfg, uniform(*img_hw, 2), uniform(*img_hw, 3) if color else None, uv, alpha)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
