"""Black–Anandan optical flow: robust IRLS with GNC (port of ``optical_flow_tpu/methods/ba.py``).

Each warp iteration of a pyramid level builds two IRLS systems (quadratic
and robust), blends them by the GNC alpha, solves the blend (whole-PCG
kernel), clips the update to ±1 and median-filters the flow through the
duv trick.  The schedule is ``gnc_iters`` GNC stages, the first over the
2.0-spaced pyramid, the others over the 1.25-spaced one, coarse to fine.
Classic+NL (``classic_nl.py``) inherits the settings, the blended solve,
the preprocessing and the GNC schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.methods.base import BaseOpticalFlow, median_pair
from optical_flow_tpu_torch.ops.derivatives import precompute_warp, warp_deriv
from optical_flow_tpu_torch.ops.filters import correlate2d_multi
from optical_flow_tpu_torch.ops.penalties import Robust
from optical_flow_tpu_torch.ops.pyramid import auto_pyramid_levels, build_pyramid, pyramid_shapes
from optical_flow_tpu_torch.ops.resample import resample_flow
from optical_flow_tpu_torch.ops.rof import structure_texture_decomposition_rof
from optical_flow_tpu_torch.ops.stencil import blend_systems, build_irls_system
from optical_flow_tpu_torch.solvers.cg import solve_flow_system
from optical_flow_tpu_torch.utils.compat import fspecial_gaussian, scale_image
from optical_flow_tpu_torch.utils.guard import guard_level


@dataclasses.dataclass(frozen=True)
class IRLSLevelConfig:
    """Static per-level configuration for the IRLS family."""

    lambda_: float
    lambda_q: float
    rho_spatial_u: Tuple[Robust, Robust]
    rho_spatial_v: Tuple[Robust, Robust]
    rho_data: Robust
    qua_rho_spatial_u: Tuple[Robust, Robust]
    qua_rho_spatial_v: Tuple[Robust, Robust]
    qua_rho_data: Robust
    max_iters: int
    max_linear: int
    median_filter_size: Optional[Tuple[int, int]]
    limit_update: bool
    interp: str
    deriv_filter: Tuple[float, ...]
    blend: float
    solver: Tuple
    guard: float = 0.0


def blended_system(cfg: IRLSLevelConfig, uv, duv, It, Ix, Iy, alpha):
    """The alpha-blended quadratic/robust IRLS system of the update."""
    sys_q = build_irls_system(
        uv, duv, It, Ix, Iy, cfg.qua_rho_spatial_u, cfg.qua_rho_spatial_v, cfg.qua_rho_data, cfg.lambda_q
    )
    sys_r = build_irls_system(
        uv, duv, It, Ix, Iy, cfg.rho_spatial_u, cfg.rho_spatial_v, cfg.rho_data, cfg.lambda_
    )
    return blend_systems(alpha, sys_q, sys_r)


def solve_update(cfg: IRLSLevelConfig, sys):
    """Solve ``sys`` for the update and clip it to ±1 if ``cfg.limit_update``."""
    x = solve_flow_system(sys, *cfg.solver)
    if cfg.limit_update:
        x = torch.clamp(x, -1.0, 1.0)
    return x


def _blended_solve(cfg: IRLSLevelConfig, uv, duv, It, Ix, Iy, alpha):
    """Solve the alpha-blended quadratic/robust IRLS system for the update."""
    return solve_update(cfg, blended_system(cfg, uv, duv, It, Ix, Iy, alpha))


def ba_level_step(cfg: IRLSLevelConfig, images, uv, alpha):
    """One pyramid level of BA IRLS: ``max_iters`` warp iterations, then the guard."""
    pre = precompute_warp(images, cfg.interp, np.array(cfg.deriv_filter), cfg.blend)
    uv0 = uv
    for _ in range(cfg.max_iters):
        It, Ix, Iy = warp_deriv(pre, uv)
        duv = torch.zeros_like(uv)
        for _j in range(cfg.max_linear):
            duv = _blended_solve(cfg, uv, duv, It, Ix, Iy, alpha)
            if cfg.median_filter_size is not None:
                # the duv trick; this order of operations is the JAX package's
                duv = median_pair(uv + duv, cfg.median_filter_size) - uv
        uv = uv + duv
    if cfg.guard:
        uv = guard_level(uv, uv0, cfg.guard)
    return uv


@dataclasses.dataclass(frozen=True)
class BAFlowPlan:
    """Static whole-flow schedule: GNC stages x pyramid levels."""

    preprocess: str  # 'texture' | 'fc' | 'scale'
    alp: float
    levels: int
    spacing: float
    gnc_levels: int
    gnc_spacing: float
    shapes: Tuple[Tuple[int, int], ...]
    gnc_shapes: Tuple[Tuple[int, int], ...]
    stages: Tuple[Tuple[IRLSLevelConfig, float], ...]  # (cfg, alpha) per stage


def _preprocess_traced(kind: str, images, alp: float, batch_dims: int = 0):
    """The level pyramids' input: the ROF texture, a Gaussian high-pass, or a
    rescale to [0, 255], each item of ``batch_dims`` leading batch axes
    normalised on its own."""
    if kind == "texture":
        return structure_texture_decomposition_rof(images, 1.0 / 8, 100, alp, batch_dims)
    if kind == "fc":
        hp = images - alp * correlate2d_multi(images, fspecial_gaussian(5, 1.5), "reflect", batch_dims)
        return scale_image(hp, 0, 255, batch_dims=batch_dims)
    return scale_image(images, 0, 255, batch_dims=batch_dims)


def ba_flow_program(plan: BAFlowPlan, images, uv, display: bool = False, checkpoint=None):
    """The whole GNC + coarse-to-fine BA flow; ``checkpoint(stage, level, uv)``
    after every level, if given.

    ``images`` (..., H, W, 2C) and ``uv`` (..., H, W, 2) may carry a leading
    batch axis: one program for B pairs of one shape, each item normalised,
    solved and guarded on its own.
    """
    nb = images.ndim - 3  # leading batch axes
    proc = _preprocess_traced(plan.preprocess, images, plan.alp, nb)
    pyramid = build_pyramid(proc, plan.levels, plan.spacing, nb)
    gnc_pyramid = build_pyramid(proc, plan.gnc_levels, plan.gnc_spacing, nb)
    for stage_idx, (cfg, alpha) in enumerate(plan.stages):
        if display:
            print(f"GNC stage: {stage_idx + 1}")
        if stage_idx == 0:
            levels, cur, shapes = plan.levels, pyramid, plan.shapes
        else:
            levels, cur, shapes = plan.gnc_levels, gnc_pyramid, plan.gnc_shapes
        for level in range(levels - 1, -1, -1):
            if display:
                print(f"  Pyramid level: {level + 1}")
            uv = resample_flow(uv, shapes[level])
            uv = ba_level_step(cfg, cur[level], uv, alpha)
            if checkpoint is not None:
                checkpoint(stage_idx, level, uv)
    return uv


class BAOpticalFlow(BaseOpticalFlow):
    """Black & Anandan optical flow with robust estimation and GNC.

    Classic+NL subclasses it with its own settings and relaxation.
    """

    def __init__(self):
        super().__init__()
        self.lambda_ = 1.0
        self.lambda_q = 1.0
        self.gnc_iters = 3
        self.alpha = 1.0
        self.max_iters = 10
        self.max_linear = 1
        self.pyramid_levels = 4
        self.pyramid_spacing = 2.0
        self.gnc_pyramid_levels = 2
        self.gnc_pyramid_spacing = 1.25
        self.texture = False
        self.fc = False
        self.solver = "backslash"
        self.interpolation_method = "cubic"
        self.limit_update = True
        self.display = False

        method = "lorentzian"
        self.rho_spatial_u = [Robust(method, (0.03,)), Robust(method, (0.03,))]
        self.rho_spatial_v = [Robust(method, (0.03,)), Robust(method, (0.03,))]
        self.rho_data = Robust(method, (1.5,))

    def _quadratic_relaxation(self):
        """BA's GNC stage-1 penalties: unit spatial sigmas, data sigma ``σ_data / σ_spatial``."""
        ta = self.rho_data.param[0] / self.rho_spatial_u[0].param[0]
        qsu = (Robust("quadratic", (1.0,)), Robust("quadratic", (1.0,)))
        qsv = (Robust("quadratic", (1.0,)), Robust("quadratic", (1.0,)))
        qd = Robust("quadratic", (ta,))
        return qsu, qsv, qd

    def _level_cfg(self, max_linear=None) -> IRLSLevelConfig:
        qsu, qsv, qd = self._quadratic_relaxation()
        return IRLSLevelConfig(
            lambda_=float(self.lambda_),
            lambda_q=float(self.lambda_q),
            rho_spatial_u=tuple(self.rho_spatial_u),
            rho_spatial_v=tuple(self.rho_spatial_v),
            rho_data=self.rho_data,
            qua_rho_spatial_u=qsu,
            qua_rho_spatial_v=qsv,
            qua_rho_data=qd,
            max_iters=int(self.max_iters),
            max_linear=int(self.max_linear if max_linear is None else max_linear),
            median_filter_size=self._median_size(),
            limit_update=bool(self.limit_update),
            interp=str(self.interpolation_method),
            deriv_filter=tuple(float(v) for v in np.asarray(self.deriv_filter).ravel()),
            blend=float(self.blend),
            solver=self._solver_cfg(),
            guard=float(self.guard_flow) if self.guard_flow else 0.0,
        )

    def _gnc_alphas(self):
        """GNC alpha schedule."""
        alphas = []
        alpha = float(self.alpha)
        for ignc in range(self.gnc_iters):
            alphas.append(alpha)
            if self.gnc_iters > 1:
                alpha = max(0.0, min(alpha, 1.0 - (ignc + 1) / (self.gnc_iters - 1)))
        return alphas

    def _preprocess_kind(self) -> str:
        return "texture" if self.texture else ("fc" if self.fc else "scale")

    def _make_plan(self, sz) -> BAFlowPlan:
        if self.auto_level:
            self.pyramid_levels = auto_pyramid_levels(sz, self.pyramid_spacing)
        stages = tuple(
            (self._level_cfg(max_linear=1 if i == 0 else None), alpha) for i, alpha in enumerate(self._gnc_alphas())
        )
        return BAFlowPlan(
            preprocess=self._preprocess_kind(),
            alp=float(self.alp),
            levels=int(self.pyramid_levels),
            spacing=float(self.pyramid_spacing),
            gnc_levels=int(self.gnc_pyramid_levels),
            gnc_spacing=float(self.gnc_pyramid_spacing),
            shapes=tuple(pyramid_shapes(sz, self.pyramid_levels, 1.0 / self.pyramid_spacing)),
            gnc_shapes=tuple(pyramid_shapes(sz, self.gnc_pyramid_levels, 1.0 / self.gnc_pyramid_spacing)),
            stages=stages,
        )

    def compute_flow(self, images, color=None):
        """Flow (H, W, 2) from the (H, W, 2) gray pair; BA has no colour guide."""
        sz = tuple(int(s) for s in images.shape[:2])
        uv = torch.zeros((*sz, 2), dtype=images.dtype, device=images.device)
        return ba_flow_program(self._make_plan(sz), images, uv, display=bool(self.display), checkpoint=self.checkpoint)
