"""Alternative BA: an auxiliary field coupled to the flow, Li–Osher median denoising
(port of ``optical_flow_tpu/methods/alt_ba.py``).

The auxiliary field ``uvhat`` couples to the flow through a Charbonnier
penalty whose weight ``lambda2`` anneals over a logspace schedule, one
value a warp iteration.  Each warp iteration solves the blended BA system
plus the coupling (whole-PCG kernel), clips the update to ±1, updates
``uvhat`` by Li–Osher median denoising of the flow, and replaces the flow
with ``uvhat`` in every GNC stage but the last.  The flow returned is
``uvhat``.

``qterm``: the reference sets it per level but never reads it, and applies
the coupling unconditionally.  At the coarsest level, where uv == uvhat ==
0, the coupling still adds a lambda2 / sigma Tikhonov diagonal, so the
port, like the JAX package, always couples and keeps the attribute only
for configuration parity.  So are ``seg``, ``mfT``, ``imfsz`` and
``weightRatio``.

With a mesh (``estimate_flow(mesh=)``) each level that tiles runs on the
row shards (``parallel/spatial.py::alt_ba_level_step_spatial``); both
fields are resampled every level and the warp halo is sized from ``uv``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.methods.ba import (
    BAOpticalFlow,
    IRLSLevelConfig,
    irls_pyramids,
    blended_system,
    solve_update,
)
from optical_flow_tpu_torch.ops.denoise import denoise_LO
from optical_flow_tpu_torch.ops.derivatives import precompute_warp, warp_deriv
from optical_flow_tpu_torch.ops.penalties import Robust
from optical_flow_tpu_torch.ops.pyramid import auto_pyramid_levels, pyramid_shapes
from optical_flow_tpu_torch.ops.resample import resample_flow
from optical_flow_tpu_torch.ops.stencil import add_coupling
from optical_flow_tpu_torch.parallel.spatial import alt_ba_level_step_spatial
from optical_flow_tpu_torch.utils.guard import guard_level_pair


@dataclasses.dataclass(frozen=True)
class AltBALevelConfig:
    """Static per-level configuration for Alt-BA."""

    irls: IRLSLevelConfig
    rho_couple: Robust
    lambda2: float
    lambda3: float
    iters_lo: int


def _annealing(cfg: AltBALevelConfig, dtype):
    """Per warp iteration, (lambda2, lambda2 / lambda3) as Python floats holding
    compute-dtype values: lambda2 runs logspace 1e-4 -> ``cfg.lambda2`` in
    float64, is cast to the compute dtype, and is divided there."""
    lambda2s = np.logspace(np.log10(1e-4), np.log10(cfg.lambda2), cfg.irls.max_iters)
    lambda2s = torch.as_tensor(lambda2s).to(dtype)
    return list(zip(lambda2s.tolist(), (lambda2s / cfg.lambda3).tolist()))


def alt_ba_level_step(cfg: AltBALevelConfig, images, uv, uvhat, alpha, replacement: bool):
    """One pyramid level of Alt-BA: ``max_iters`` warp iterations, then the
    guard on the (uv, uvhat) pair; returns (uv, uvhat)."""
    irls = cfg.irls
    pre = precompute_warp(images, irls.interp, np.array(irls.deriv_filter), irls.blend)
    uv0, uvhat0 = uv, uvhat
    for lambda2, lam_lo in _annealing(cfg, uv.dtype):
        It, Ix, Iy = warp_deriv(pre, uv)
        duv = torch.zeros_like(uv)
        for _j in range(irls.max_linear):
            sys = blended_system(irls, uv, duv, It, Ix, Iy, alpha)
            # the coupling lambda2 rho'(uv - uvhat) on the diagonal and its
            # right-hand side, applied unconditionally (see the module docstring)
            tmp = cfg.rho_couple.deriv_over_x(uv - uvhat)
            sys = add_coupling(sys, lambda2 * tmp)
            delta = lambda2 * tmp * (uvhat - uv)
            sys = sys._replace(b_u=sys.b_u + delta[..., 0], b_v=sys.b_v + delta[..., 1])
            duv = solve_update(irls, sys)
        uv = uv + duv
        # Li–Osher update of the auxiliary field, both fields in one call
        uvhat = denoise_LO(uv.movedim(-1, -3), irls.median_filter_size, lam_lo, cfg.iters_lo).movedim(-3, -1)
        if replacement:
            uv = uvhat
    if irls.guard:
        uv, uvhat = guard_level_pair(uv, uvhat, uv0, uvhat0, irls.guard)
    return uv, uvhat


@dataclasses.dataclass(frozen=True)
class AltBAFlowPlan:
    """Static whole-flow schedule: GNC stages x pyramid levels."""

    texture: bool
    levels: int
    spacing: float
    gnc_levels: int
    gnc_spacing: float
    shapes: Tuple[Tuple[int, int], ...]
    gnc_shapes: Tuple[Tuple[int, int], ...]
    stages: Tuple[Tuple[AltBALevelConfig, float, bool], ...]  # (cfg, alpha, replacement)


def alt_ba_pyramids(plan: AltBAFlowPlan, images, batch_dims: int = 0):
    """(the ``plan.spacing`` pyramid, the GNC pyramid) of the preprocessed
    images: the texture route runs ROF at its default ``alp`` 0.95, whatever
    the method's ``alp``, as the reference does."""
    return irls_pyramids("texture" if plan.texture else "scale", 0.95, plan, images, batch_dims)


def alt_ba_flow_program(plan: AltBAFlowPlan, images, uv, uvhat, display: bool = False, checkpoint=None, mesh=None,
                        halo_of=None, stage_end=None):
    """The whole GNC + coarse-to-fine Alt-BA flow; returns the auxiliary field.
    ``checkpoint(stage, level, uv)`` after every level, if given (``uv``,
    not the auxiliary field, as in the JAX package).  With a ``mesh`` each
    level runs row-sharded with the warp halo ``halo_of(uv)``.

    ``images`` (..., H, W, 2C) and
    the fields (..., H, W, 2) may carry a leading batch axis: one program for
    B pairs of one shape, each item normalised and guarded on its own.
    """
    nb = images.ndim - 3  # leading batch axes
    pyramid, gnc_pyramid = alt_ba_pyramids(plan, images, nb)
    for stage_idx, (cfg, alpha, replacement) in enumerate(plan.stages):
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
            uvhat = resample_flow(uvhat, shapes[level])
            if mesh is None:
                uv, uvhat = alt_ba_level_step(cfg, cur[level], uv, uvhat, alpha, replacement)
            else:
                # the warp reads only uv; uvhat, its median, stays within uv's range
                uv, uvhat = alt_ba_level_step_spatial(cfg, cur[level], uv, uvhat, alpha, replacement, mesh,
                                                      halo_of(uv))
            if checkpoint is not None:
                checkpoint(stage_idx, level, uv)
        if stage_end is not None:
            stage_end(stage_idx, uv)
    return uvhat


class AltBAOpticalFlow(BAOpticalFlow):
    """Alternative BA with the coupled auxiliary field."""

    def __init__(self):
        super().__init__()
        self.lambda_ = 5.0
        self.lambda_q = 5.0
        self.solver = "backslash"
        self.warping_mode = "backward"
        self.texture = False
        self.median_filter_size = None
        self.interpolation_method = "cubic"

        self.gnc_iters = 3
        self.alpha = 1.0
        self.max_iters = 10
        self.max_linear = 1
        self.pyramid_levels = 4
        self.pyramid_spacing = 2.0
        self.gnc_pyramid_levels = 2
        self.gnc_pyramid_spacing = 1.25

        method = "lorentzian"
        self.rho_spatial_u = [Robust(method, (0.03,)), Robust(method, (0.03,))]
        self.rho_spatial_v = [Robust(method, (0.03,)), Robust(method, (0.03,))]
        self.rho_data = Robust(method, (1.5,))

        # Alt-BA's own settings; seg, mfT, imfsz, qterm and weightRatio are inert
        self.seg = None
        self.mfT = 15
        self.imfsz = [7, 7]
        self.qterm = True
        self.lambda2 = 0.1
        self.lambda3 = 1.0
        self.weightRatio = 1.0
        self.itersLO = 1
        self.replacement = True
        self.rho_couple = Robust("charbonnier", (1e-3,))
        self.auto_level = True

    def _quadratic_relaxation(self):
        """Alt-BA's GNC stage-1 penalties: unit sigmas, data term included."""
        qsu = (Robust("quadratic", (1.0,)), Robust("quadratic", (1.0,)))
        qsv = (Robust("quadratic", (1.0,)), Robust("quadratic", (1.0,)))
        qd = Robust("quadratic", (1.0,))
        return qsu, qsv, qd

    def _alt_cfg(self) -> AltBALevelConfig:
        return AltBALevelConfig(
            irls=self._level_cfg(),
            rho_couple=self.rho_couple,
            lambda2=float(self.lambda2),
            lambda3=float(self.lambda3),
            iters_lo=int(self.itersLO),
        )

    def _make_alt_plan(self, sz) -> AltBAFlowPlan:
        """The pyramid depth always follows the size, whatever ``auto_level`` says;
        ``replacement`` holds in every GNC stage but the last."""
        self.pyramid_levels = auto_pyramid_levels(sz, self.pyramid_spacing)
        stages = tuple((self._alt_cfg(), alpha, i != self.gnc_iters - 1) for i, alpha in enumerate(self._gnc_alphas()))
        return AltBAFlowPlan(
            texture=bool(self.texture),
            levels=int(self.pyramid_levels),
            spacing=float(self.pyramid_spacing),
            gnc_levels=int(self.gnc_pyramid_levels),
            gnc_spacing=float(self.gnc_pyramid_spacing),
            shapes=tuple(pyramid_shapes(sz, self.pyramid_levels, 1.0 / self.pyramid_spacing)),
            gnc_shapes=tuple(pyramid_shapes(sz, self.gnc_pyramid_levels, 1.0 / self.gnc_pyramid_spacing)),
            stages=stages,
        )

    def compute_flow(self, init=None, gt=None):
        """The auxiliary field (H, W, 2) of ``self.images``, the (H, W, 2C) pair,
        with both fields starting from ``init`` (default zero); no colour guide."""
        images, _, uv = self._flow_inputs(init)
        sz = tuple(int(s) for s in images.shape[:2])
        return alt_ba_flow_program(self._make_alt_plan(sz), images, uv, uv, display=bool(self.display),
                                   checkpoint=self.checkpoint, mesh=self.spatial_mesh, halo_of=self._spatial_halo_of(),
                                   stage_end=self._stage_printer())

    def compute_flow_base(self, uv, uvhat=None):
        """One level on ``self.images`` at the method's own ``alpha`` and
        ``replacement``, from ``uv`` (and ``uvhat``, by default ``uv``);
        returns (uv, uvhat)."""
        images, _, uv = self._flow_inputs(uv)
        uvhat = uv if uvhat is None else self._as_tensor(uvhat, uv.device)
        return alt_ba_level_step(self._alt_cfg(), images, uv, uvhat, float(self.alpha), bool(self.replacement))
