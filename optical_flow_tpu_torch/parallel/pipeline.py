"""Pipeline parallelism across video frames (port of ``optical_flow_tpu/parallel/pipeline.py``).

Within one frame the coarse-to-fine recursion is sequential: every pyramid
level consumes the previous level's flow.  Across a stream of frames it
pipelines: the whole (GNC stage, pyramid level) schedule is flattened into
an ordered list of level steps, cut into contiguous stage groups balanced
by pixel count (:func:`_partition`), and each group is pinned to a device,
so frame t runs group s while frame t+1 runs group s-1.  The host issues
every (frame, group) step in dependency order; CUDA runs each device's
work asynchronously, and the flow state moves between groups with
``.to(device)``.  Frames overlap only where a step reads nothing on the
host: the Classic+NL and BA levels read nothing, while Horn–Schunck's early
stop reads one flag a warp iteration.

Each step calls the family's own level function after ``resample_flow``,
with the family's plan (``methods/*.py``), in the order of its whole-flow
program, so a pipelined flow is that of ``estimate_flow`` on the same
device: only the placement differs.  All four families run: the
Classic+NL colour-guide pyramids and alt-BA's (uv, uvhat) state ride
through the schedule, Horn–Schunck's final median is its ``finish``.
"""
from __future__ import annotations

import collections
from functools import partial
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from optical_flow_tpu_torch.config import load_of_method
from optical_flow_tpu_torch.interface import prepare_pair, resolve_device
from optical_flow_tpu_torch.methods.alt_ba import AltBAOpticalFlow, alt_ba_level_step, alt_ba_pyramids
from optical_flow_tpu_torch.methods.ba import BAOpticalFlow, ba_level_step, irls_pyramids
from optical_flow_tpu_torch.methods.base import median_pair
from optical_flow_tpu_torch.methods.classic_nl import ClassicNLOpticalFlow, classic_nl_level_step, color_pyramids
from optical_flow_tpu_torch.methods.hs import HSOpticalFlow, hs_level_step, hs_pyramid
from optical_flow_tpu_torch.ops.resample import resample_flow

__all__ = ["build_pipeline_schedule", "estimate_flow_pipelined"]


class _Step:
    """One (GNC stage, pyramid level) tick: ``fn(state, *inputs) -> state``."""

    __slots__ = ("fn", "cost", "label")

    def __init__(self, fn, cost, label):
        self.fn = fn
        self.cost = cost
        self.label = label


class _Schedule:
    __slots__ = ("prepare", "steps", "init_state", "extract", "finish")

    def __init__(self, prepare, steps, init_state, extract, finish=None):
        self.prepare = prepare  # (images, color) -> [input tuple of each step]
        self.steps = steps  # list[_Step]
        self.init_state = init_state  # (H, W, dtype, device) -> state tuple
        self.extract = extract  # state -> uv
        self.finish = finish  # uv -> uv, or None


def _zero_flows(k):
    """``(H, W, dtype, device) -> `` a state of ``k`` zero (H, W, 2) flows."""
    return lambda H, W, dtype, dev: tuple(torch.zeros((H, W, 2), dtype=dtype, device=dev) for _ in range(k))


def _stage_ticks(plan):
    """(stage index, its level configuration tuple, level, level shape) of
    every level step of a GNC plan, in the program's order: each stage over
    its pyramid, coarse to fine."""
    for stage_idx, stage in enumerate(plan.stages):
        levels, shapes = (plan.levels, plan.shapes) if stage_idx == 0 else (plan.gnc_levels, plan.gnc_shapes)
        for level in range(levels - 1, -1, -1):
            yield stage_idx, stage, level, shapes[level]


def _per_tick(plan, pyramids, *more):
    """Each tick's inputs: its level of the stage's pyramid (stage 0 the
    first of ``pyramids``, later stages the second), and of each pair in ``more``."""
    return [tuple(p[0 if stage_idx == 0 else 1][level] for p in (pyramids, *more))
            for stage_idx, _, level, _ in _stage_ticks(plan)]


def _hs_step(cfg, shape, state, im):
    return (hs_level_step(cfg, im, resample_flow(state[0], shape)),)


def _ba_step(cfg, alpha, shape, state, im):
    return (ba_level_step(cfg, im, resample_flow(state[0], shape), alpha),)


def _nl_step(cfg, alpha, shape, state, im, col):
    return (classic_nl_level_step(cfg, im, col, resample_flow(state[0], shape), alpha),)


def _alt_ba_step(cfg, alpha, replacement, shape, state, im):
    uv, uvhat = (resample_flow(f, shape) for f in state)
    return alt_ba_level_step(cfg, im, uv, uvhat, alpha, replacement)


def build_pipeline_schedule(ope, sz, use_color: bool) -> _Schedule:
    """Flatten ``ope``'s coarse-to-fine (and GNC) schedule for frames of shape ``sz``."""
    sz = tuple(int(s) for s in sz)
    cost = lambda shape: int(np.prod(shape))  # noqa: E731

    if isinstance(ope, HSOpticalFlow):
        plan = ope._make_plan(sz)
        levels = range(plan.levels - 1, -1, -1)
        steps = [_Step(partial(_hs_step, plan.cfg, plan.shapes[lvl]), cost(plan.shapes[lvl]), f"hs L{lvl}")
                 for lvl in levels]
        finish = None if plan.final_median is None else partial(median_pair, size=plan.final_median)
        return _Schedule(lambda images, color: [(p,) for p in hs_pyramid(plan, images)[::-1]], steps,
                         _zero_flows(1), lambda state: state[0], finish)

    if isinstance(ope, AltBAOpticalFlow):
        plan = ope._make_alt_plan(sz)
        steps = [_Step(partial(_alt_ba_step, cfg, alpha, repl, shape), cost(shape), f"altba G{g}L{lvl}")
                 for g, (cfg, alpha, repl), lvl, shape in _stage_ticks(plan)]
        # alt-BA returns the auxiliary field
        return _Schedule(lambda images, color: _per_tick(plan, alt_ba_pyramids(plan, images)), steps,
                         _zero_flows(2), lambda state: state[1])

    if isinstance(ope, ClassicNLOpticalFlow):
        plan = ope._make_nl_plan(sz, use_color=use_color)
        steps = [_Step(partial(_nl_step, cfg, alpha, shape), cost(shape), f"nl G{g}L{lvl}")
                 for g, (cfg, alpha), lvl, shape in _stage_ticks(plan)]

        def prepare(images, color):
            return _per_tick(plan, irls_pyramids(plan.preprocess, plan.alp, plan, images), color_pyramids(plan, color))

        return _Schedule(prepare, steps, _zero_flows(1), lambda state: state[0])

    if isinstance(ope, BAOpticalFlow):
        plan = ope._make_plan(sz)
        steps = [_Step(partial(_ba_step, cfg, alpha, shape), cost(shape), f"ba G{g}L{lvl}")
                 for g, (cfg, alpha), lvl, shape in _stage_ticks(plan)]
        return _Schedule(lambda images, color: _per_tick(plan, irls_pyramids(plan.preprocess, plan.alp, plan, images)),
                         steps, _zero_flows(1), lambda state: state[0])

    raise ValueError(f"no pipeline schedule for method type {type(ope).__name__}")


def _partition(costs: Sequence[int], n_groups: int) -> List[List[int]]:
    """The contiguous partition of the step indices into at most ``n_groups``
    groups whose largest group cost is least (the linear-partition DP, exact;
    ties keep the earliest cut).  Coarse levels are cheap and the finest
    dominate, so the coarse tail lumps onto the first group."""
    n = len(costs)
    k = max(1, min(n_groups, n))
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + float(c))
    inf = float("inf")
    best = [[inf] * (k + 1) for _ in range(n + 1)]
    cut = [[0] * (k + 1) for _ in range(n + 1)]
    best[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(j, n + 1):
            for m in range(j - 1, i):
                v = max(best[m][j - 1], prefix[i] - prefix[m])
                if v < best[i][j]:
                    best[i][j] = v
                    cut[i][j] = m
    bounds, i = [], n
    for j in range(k, 0, -1):
        m = cut[i][j]
        bounds.append((m, i))
        i = m
    return [list(range(a, b)) for a, b in reversed(bounds)]


def _prep_pair(ope, im1, im2, dev):
    """(images, colour guide or None) of a frame pair on ``dev``, as the JAX
    package's pipeline prepares it: ``estimate_flow``'s preparation, except
    that (H, W, C < 3) frames take no colour guide."""
    return prepare_pair(ope, np.asarray(im1), np.asarray(im2), dev, small_channel_guide=False)


def estimate_flow_pipelined(pairs: Iterable, method: str = "classic+nl-fast", params=None,
                            devices: Optional[Sequence] = None, n_stages: Optional[int] = None,
                            depth: Optional[int] = None):
    """Stream flows for ``pairs`` with the pyramid-level groups pipelined across devices.

    Args:
        pairs: iterable of (im1, im2) frame pairs, all of one shape.
        method: preset name.
        params: optional overrides (``estimate_flow`` semantics).
        devices: the devices to pipeline over (default: every visible CUDA
            device); a device may repeat, e.g. ``["cpu"] * 4``.
        n_stages: the number of stage groups (default ``len(devices)``; at
            most the number of level steps).  Group g runs on
            ``devices[g % len(devices)]``; group 0's device also prepares
            each frame and builds its pyramids.
        depth: the frames in flight before the oldest is yielded (default:
            the number of groups + 1).

    Yields the (H, W, 2) flows in input order, each on its last group's
    device: the flow of ``estimate_flow`` on the same device, bit for bit.
    A frame of another shape than the first raises ``ValueError``.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("estimate_flow_pipelined(): no CUDA device is visible; pass devices, e.g. ['cpu'] * n")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d, "estimate_flow_pipelined") for d in devices]

    ope = load_of_method(method)
    ope.display = False
    if params is not None:
        ope.parse_input_parameter(params)

    schedule = groups = group_devices = sched_hw = None
    pending = collections.deque()
    for im1, im2 in pairs:
        if schedule is not None and np.shape(im1)[:2] != sched_hw:
            # the schedule (level count, level shapes) is the first frame's
            raise ValueError(f"estimate_flow_pipelined requires a consistent frame shape: got "
                             f"{np.shape(im1)[:2]} after building the schedule for {sched_hw}")
        with torch.no_grad():
            images, color = _prep_pair(ope, im1, im2, devices[0])
            if schedule is None:
                sched_hw = tuple(images.shape[:2])
                schedule = build_pipeline_schedule(ope, sched_hw, use_color=color is not None)
                groups = _partition([s.cost for s in schedule.steps], n_stages or len(devices))
                group_devices = [devices[g % len(devices)] for g in range(len(groups))]
                if depth is None:
                    depth = len(groups) + 1
            pending.append(_run_frame(schedule, groups, group_devices, images, color))
        while len(pending) > depth:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def _run_frame(schedule: _Schedule, groups, group_devices, images, color):
    """Issue one frame's steps, group by group on the groups' devices, the
    state handed on with ``.to(device)``; returns its flow (not waited for)."""
    step_inputs = schedule.prepare(images, color)
    state = schedule.init_state(*images.shape[:2], images.dtype, images.device)
    for group, dev in zip(groups, group_devices):
        state = tuple(s.to(dev) for s in state)
        for si in group:
            state = schedule.steps[si].fn(state, *(x if x is None else x.to(dev) for x in step_inputs[si]))
    uv = schedule.extract(state)
    return uv if schedule.finish is None else schedule.finish(uv)
