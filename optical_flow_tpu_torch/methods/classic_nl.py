"""Classic+NL optical flow: robust IRLS + non-local weighted-median term (port of ``optical_flow_tpu/methods/classic_nl.py``).

Each warp iteration of a pyramid level builds two IRLS systems, blends them
by the GNC alpha, solves (whole-PCG kernel), clips the update to ±1,
detects occlusions and applies the colour-guided weighted median through
the duv trick.  The schedule is two GNC stages over their pyramids, coarse
to fine; classic+nl-fast runs 3 warp iterations per level.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.methods.ba import BAOpticalFlow, IRLSLevelConfig, _blended_solve, _preprocess_traced
from optical_flow_tpu_torch.ops.derivatives import precompute_warp, warp_deriv
from optical_flow_tpu_torch.ops.occlusion import detect_occlusion
from optical_flow_tpu_torch.ops.penalties import Robust
from optical_flow_tpu_torch.ops.pyramid import auto_pyramid_levels, build_pyramid, pyramid_shapes
from optical_flow_tpu_torch.ops.resample import resample_flow
from optical_flow_tpu_torch.ops.wmedian import denoise_color_weighted_medfilt2
from optical_flow_tpu_torch.utils.guard import guard_level


@dataclasses.dataclass(frozen=True)
class NLLevelConfig:
    """Static per-level configuration for Classic+NL."""

    irls: IRLSLevelConfig
    area_hsz: int
    sigma_i: float
    full_version: bool
    use_color: bool


@dataclasses.dataclass(frozen=True)
class NLFlowPlan:
    """Static whole-flow schedule for Classic+NL."""

    preprocess: str
    alp: float
    levels: int
    spacing: float
    gnc_levels: int
    gnc_spacing: float
    shapes: Tuple[Tuple[int, int], ...]
    gnc_shapes: Tuple[Tuple[int, int], ...]
    stages: Tuple[Tuple[NLLevelConfig, float], ...]
    use_color: bool


def classic_nl_level_step(cfg: NLLevelConfig, images, color_images, uv, alpha):
    """One pyramid level of Classic+NL: ``max_iters`` warp iterations, then the guard."""
    irls = cfg.irls
    pre = precompute_warp(images, irls.interp, np.array(irls.deriv_filter), irls.blend)
    uv0 = uv
    for _ in range(irls.max_iters):
        It, Ix, Iy = warp_deriv(pre, uv)
        duv = torch.zeros_like(uv)
        for _j in range(irls.max_linear):
            duv = _blended_solve(irls, uv, duv, It, Ix, Iy, alpha)
            if irls.median_filter_size is not None:
                new_uv = uv + duv
                occ = detect_occlusion(new_uv, images)
                filtered = denoise_color_weighted_medfilt2(
                    new_uv,
                    color_images if cfg.use_color else None,
                    occ,
                    cfg.area_hsz,
                    irls.median_filter_size,
                    cfg.sigma_i,
                    cfg.full_version,
                )
                duv = filtered - uv
        uv = uv + duv
    if irls.guard:
        uv = guard_level(uv, uv0, irls.guard)
    return uv


def classic_nl_flow_program(plan: NLFlowPlan, images, color, uv, display: bool = False, checkpoint=None):
    """The whole GNC + coarse-to-fine Classic+NL flow; ``checkpoint(stage,
    level, uv)`` after every level, if given.

    ``images`` (..., H, W, 2C), ``color`` (..., H, W[, C']) and ``uv``
    (..., H, W, 2) may carry a leading batch axis: one program for B pairs
    of one shape, every op on every item at once, each item normalised,
    solved, stopped and guarded on its own.  The reference's original-image
    pyramid feeds only an inert attribute, so it is not built; the texture
    pyramids and the colour-guide pyramids are.
    """
    nb = images.ndim - 3  # leading batch axes: images are (..., H, W, 2C)
    proc = _preprocess_traced(plan.preprocess, images, plan.alp, nb)
    pyramid = build_pyramid(proc, plan.levels, plan.spacing, nb)
    gnc_pyramid = build_pyramid(proc, plan.gnc_levels, plan.gnc_spacing, nb)
    if plan.use_color:
        color_pyr = build_pyramid(color, plan.levels, plan.spacing, nb)
        color_gnc_pyr = build_pyramid(color, plan.gnc_levels, plan.gnc_spacing, nb)
    else:
        color_pyr = [None] * plan.levels
        color_gnc_pyr = [None] * plan.gnc_levels

    for stage_idx, (cfg, alpha) in enumerate(plan.stages):
        if display:
            print(f"GNC stage: {stage_idx + 1}")
        if stage_idx == 0:
            levels, cur, ccur, shapes = plan.levels, pyramid, color_pyr, plan.shapes
        else:
            levels, cur, ccur, shapes = plan.gnc_levels, gnc_pyramid, color_gnc_pyr, plan.gnc_shapes
        for level in range(levels - 1, -1, -1):
            if display:
                print(f"  Pyramid level: {level + 1}")
            uv = resample_flow(uv, shapes[level])
            uv = classic_nl_level_step(cfg, cur[level], ccur[level], uv, alpha)
            if checkpoint is not None:
                checkpoint(stage_idx, level, uv)
    return uv


class ClassicNLOpticalFlow(BAOpticalFlow):
    """Classic+NL with generalized Charbonnier penalties and the non-local term."""

    def __init__(self):
        super().__init__()
        self.lambda_ = 1.0
        self.lambda_q = 1.0
        self.lambda2 = 0.1
        self.lambda3 = 1.0
        self.solver = "backslash"
        self.texture = False
        self.fc = False
        self.median_filter_size = None
        self.interpolation_method = "bi-cubic"

        self.gnc_iters = 3
        self.alpha = 1.0
        self.max_iters = 10
        self.max_linear = 1
        self.pyramid_levels = 4
        self.pyramid_spacing = 2.0
        self.gnc_pyramid_levels = 2
        self.gnc_pyramid_spacing = 1.25

        method = "generalized_charbonnier"
        a = 0.45
        sig = 1e-3
        self.rho_spatial_u = [Robust(method, (sig, a)), Robust(method, (sig, a))]
        self.rho_spatial_v = [Robust(method, (sig, a)), Robust(method, (sig, a))]
        self.rho_data = Robust(method, (sig, a))

        # non-local / segmentation settings of the reference
        self.seg = None
        self.mfT = 15
        self.imfsz = [7, 7]
        self.filter_weight = None
        self.alp = 0.95
        self.hybrid = False
        self.area_hsz = 10
        self.affine_hsz = 4
        self.sigma_i = 7
        self.color_images = None
        self.auto_level = True
        self.input_seg = None
        self.input_occ = None
        self.fullVersion = False

    def _quadratic_relaxation(self):
        """Classic+NL reuses each penalty's own sigma."""
        qsu = tuple(Robust("quadratic", (r.param[0],)) for r in self.rho_spatial_u)
        qsv = tuple(Robust("quadratic", (r.param[0],)) for r in self.rho_spatial_v)
        qd = Robust("quadratic", (self.rho_data.param[0],))
        return qsu, qsv, qd

    def _nl_cfg(self, use_color: bool, max_linear=None) -> NLLevelConfig:
        return NLLevelConfig(
            irls=self._level_cfg(max_linear=max_linear),
            area_hsz=int(self.area_hsz),
            sigma_i=float(self.sigma_i),
            full_version=bool(self.fullVersion),
            use_color=use_color,
        )

    def _make_nl_plan(self, sz, use_color: bool) -> NLFlowPlan:
        if self.auto_level:
            self.pyramid_levels = auto_pyramid_levels(sz, self.pyramid_spacing)
        stages = tuple(
            (self._nl_cfg(use_color=use_color, max_linear=1 if i == 0 else None), alpha)
            for i, alpha in enumerate(self._gnc_alphas())
        )
        return NLFlowPlan(
            preprocess=self._preprocess_kind(),
            alp=float(self.alp),
            levels=int(self.pyramid_levels),
            spacing=float(self.pyramid_spacing),
            gnc_levels=int(self.gnc_pyramid_levels),
            gnc_spacing=float(self.gnc_pyramid_spacing),
            shapes=tuple(pyramid_shapes(sz, self.pyramid_levels, 1.0 / self.pyramid_spacing)),
            gnc_shapes=tuple(pyramid_shapes(sz, self.gnc_pyramid_levels, 1.0 / self.gnc_pyramid_spacing)),
            stages=stages,
            use_color=use_color,
        )

    def compute_flow(self, images, color=None):
        """Flow (H, W, 2) from the (H, W, 2) gray pair and the optional guide."""
        sz = tuple(int(s) for s in images.shape[:2])
        if color is not None and int(np.prod(color.shape[:2])) < sz[0] * sz[1]:
            color = None  # the (1, 1, 3) placeholder of the preset table means "no colour"
        plan = self._make_nl_plan(sz, use_color=color is not None)
        uv = torch.zeros((*sz, 2), dtype=images.dtype, device=images.device)
        return classic_nl_flow_program(plan, images, color, uv, display=bool(self.display), checkpoint=self.checkpoint)
