"""Horn–Schunck optical flow: quadratic penalties, Laplacian spatial term (port of ``optical_flow_tpu/methods/hs.py``).

Each pyramid level runs up to ``max_warping_iters`` warp iterations: the HS
system is built and solved (whole-PCG kernel), and the loop stops as soon
as the update's norm falls below 1e-3, discarding that update.  Otherwise
the clipped update is added and the flow median-filtered ``mf_iter`` times.
One more median pass follows the finest level.

With a leading batch axis each item stops on its own, as ``jax.vmap`` of
the JAX package's ``while_loop``: an item whose update fell below the stop
keeps its flow, and its later systems get a zero right-hand side, so the
solver stops it at iteration 0.  The host reads one flag a warp iteration,
whether any item still runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.methods.base import BaseOpticalFlow, median_pair
from optical_flow_tpu_torch.ops.derivatives import precompute_warp, warp_deriv
from optical_flow_tpu_torch.ops.pyramid import auto_pyramid_levels, build_pyramid, pyramid_shapes
from optical_flow_tpu_torch.ops.resample import resample_flow
from optical_flow_tpu_torch.ops.rof import structure_texture_decomposition_rof
from optical_flow_tpu_torch.ops.stencil import build_hs_system
from optical_flow_tpu_torch.solvers.cg import solve_flow_system
from optical_flow_tpu_torch.utils.compat import scale_image
from optical_flow_tpu_torch.utils.guard import guard_level

STOP_NORM = 1e-3  # the warp loop stops once ||x|| < STOP_NORM


@dataclasses.dataclass(frozen=True)
class HSLevelConfig:
    """Static per-level configuration for Horn–Schunck."""

    lambda_: float
    sigmaD2: float
    sigmaS2: float
    max_warping_iters: int
    median_filter_size: Optional[Tuple[int, int]]
    mf_iter: int
    limit_update: bool
    interp: str
    deriv_filter: Tuple[float, ...]
    blend: float
    solver: Tuple
    guard: float = 0.0


def hs_level_step(cfg: HSLevelConfig, images, uv):
    """One pyramid level of Horn–Schunck, with the early stop, then the guard."""
    pre = precompute_warp(images, cfg.interp, np.array(cfg.deriv_filter), cfg.blend)
    uv0 = uv
    running = torch.ones(uv.shape[:-3], dtype=torch.bool, device=uv.device)  # one sticky flag an item
    for _ in range(cfg.max_warping_iters):
        It, Ix, Iy = warp_deriv(pre, uv)
        sys = build_hs_system(uv, It, Ix, Iy, cfg.lambda_, cfg.sigmaD2, cfg.sigmaS2)
        # a stopped item's update is discarded: a zero right-hand side costs it no iteration
        on = running[..., None, None]
        sys = sys._replace(b_u=torch.where(on, sys.b_u, 0.0), b_v=torch.where(on, sys.b_v, 0.0))
        x = solve_flow_system(sys, *cfg.solver)
        # a NaN norm stops the item too, as in the JAX package's `norm >= 1e-3`
        running = running & (torch.linalg.norm(x.flatten(-3), dim=-1) >= STOP_NORM)
        if not bool(running.any()):
            break
        if cfg.limit_update:
            x = torch.clamp(x, -1.0, 1.0)
        new_uv = uv + x
        if cfg.median_filter_size is not None:
            for _k in range(cfg.mf_iter):
                new_uv = median_pair(new_uv, cfg.median_filter_size)
        uv = torch.where(running[..., None, None, None], new_uv, uv)
    if cfg.guard:
        uv = guard_level(uv, uv0, cfg.guard)
    return uv


@dataclasses.dataclass(frozen=True)
class HSFlowPlan:
    """Static whole-flow schedule: preprocessing + pyramid ladder + levels."""

    texture: bool
    levels: int
    spacing: float
    shapes: Tuple[Tuple[int, int], ...]  # finest first
    cfg: HSLevelConfig
    final_median: Optional[Tuple[int, int]]


def hs_flow_program(plan: HSFlowPlan, images, uv, display: bool = False, checkpoint=None):
    """The whole coarse-to-fine HS flow, then the final median pass;
    ``checkpoint(0, level, uv)`` after every level, if given.

    ``images`` (..., H, W, 2C) and ``uv`` (..., H, W, 2) may carry a leading
    batch axis: one program for B pairs of one shape, each item normalised,
    stopped and guarded on its own.
    """
    nb = images.ndim - 3  # leading batch axes
    if plan.texture:
        images = structure_texture_decomposition_rof(images, batch_dims=nb)
    else:
        images = scale_image(images, 0, 255, batch_dims=nb)
    pyramid = build_pyramid(images, plan.levels, plan.spacing, nb)
    for level in range(plan.levels - 1, -1, -1):
        if display:
            print(f"Pyramid level: {level + 1}")
        uv = resample_flow(uv, plan.shapes[level])
        uv = hs_level_step(plan.cfg, pyramid[level], uv)
        if checkpoint is not None:
            checkpoint(0, level, uv)
    if plan.final_median is not None:
        uv = median_pair(uv, plan.final_median)
    return uv


class HSOpticalFlow(BaseOpticalFlow):
    """Horn–Schunck with quadratic penalty and Laplacian spatial term."""

    def __init__(self):
        super().__init__()
        self.lambda_ = 80
        self.lambda_q = 80
        self.gnc_iters = 1
        self.pyramid_levels = 4
        self.pyramid_spacing = 2.0
        self.max_warping_iters = 10
        self.solver = "backslash"
        self.interpolation_method = "cubic"
        self.texture = False
        self.limit_update = True
        self.display = False
        self.sigmaD2 = 1.0
        self.sigmaS2 = 1.0
        self.mf_iter = 1

    def _level_cfg(self) -> HSLevelConfig:
        return HSLevelConfig(
            lambda_=float(self.lambda_),
            sigmaD2=float(self.sigmaD2),
            sigmaS2=float(self.sigmaS2),
            max_warping_iters=int(self.max_warping_iters),
            median_filter_size=self._median_size(),
            mf_iter=int(self.mf_iter),
            limit_update=bool(self.limit_update),
            interp=str(self.interpolation_method),
            deriv_filter=tuple(float(v) for v in np.asarray(self.deriv_filter).ravel()),
            blend=float(self.blend),
            solver=self._solver_cfg(),
            guard=float(self.guard_flow) if self.guard_flow else 0.0,
        )

    def _make_plan(self, sz) -> HSFlowPlan:
        """HS recomputes the level count from the size every time, whatever ``auto_level`` says."""
        self.pyramid_levels = auto_pyramid_levels(sz, self.pyramid_spacing)
        return HSFlowPlan(
            texture=bool(self.texture),
            levels=int(self.pyramid_levels),
            spacing=float(self.pyramid_spacing),
            shapes=tuple(pyramid_shapes(sz, self.pyramid_levels, 1.0 / self.pyramid_spacing)),
            cfg=self._level_cfg(),
            final_median=self._median_size(),
        )

    def compute_flow(self, images, color=None):
        """Flow (H, W, 2) from the (H, W, 2) gray pair; HS has no colour guide."""
        sz = tuple(int(s) for s in images.shape[:2])
        uv = torch.zeros((*sz, 2), dtype=images.dtype, device=images.device)
        return hs_flow_program(self._make_plan(sz), images, uv, display=bool(self.display), checkpoint=self.checkpoint)
