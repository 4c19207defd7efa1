"""The pieces of Black–Anandan IRLS that Classic+NL uses (port of parts of ``optical_flow_tpu/methods/ba.py``).

BA's own level program and presets wait for ROADMAP queue 1, item 10; this
module carries the per-level configuration, the blended IRLS solve, the
preprocessing and the GNC schedule that Classic+NL inherits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.methods.base import BaseOpticalFlow
from optical_flow_tpu_torch.ops.penalties import Robust
from optical_flow_tpu_torch.ops.rof import structure_texture_decomposition_rof
from optical_flow_tpu_torch.ops.stencil import blend_systems, build_irls_system
from optical_flow_tpu_torch.solvers.cg import solve_flow_system


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


def _blended_solve(cfg: IRLSLevelConfig, uv, duv, It, Ix, Iy, alpha):
    """Solve the alpha-blended quadratic/robust IRLS system for the update."""
    sys_q = build_irls_system(
        uv, duv, It, Ix, Iy, cfg.qua_rho_spatial_u, cfg.qua_rho_spatial_v, cfg.qua_rho_data, cfg.lambda_q
    )
    sys_r = build_irls_system(
        uv, duv, It, Ix, Iy, cfg.rho_spatial_u, cfg.rho_spatial_v, cfg.rho_data, cfg.lambda_
    )
    x = solve_flow_system(blend_systems(alpha, sys_q, sys_r), *cfg.solver)
    if cfg.limit_update:
        x = torch.clamp(x, -1.0, 1.0)
    return x


def _preprocess_traced(kind: str, images, alp: float):
    """The level pyramids' input: the ROF texture of the gray pair."""
    if kind == "texture":
        return structure_texture_decomposition_rof(images, 1.0 / 8, 100, alp)
    raise NotImplementedError(f"preprocessing {kind!r} is not ported yet (ROADMAP queue 1, item 10)")


class BAOpticalFlow(BaseOpticalFlow):
    """IRLS settings and schedule shared by the BA family (Classic+NL included).

    Subclasses supply ``_quadratic_relaxation`` (the GNC stage-1 penalties).
    """

    def _level_cfg(self, max_linear=None) -> IRLSLevelConfig:
        mfs = self.median_filter_size
        if mfs is not None:
            mfs = (int(mfs[0]), int(mfs[1])) if hasattr(mfs, "__len__") else (int(mfs), int(mfs))
        if self.guard_flow is not None:
            raise NotImplementedError("guard_flow is not ported yet (ROADMAP queue 1, item 12)")
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
            median_filter_size=mfs,
            limit_update=bool(self.limit_update),
            interp=str(self.interpolation_method),
            deriv_filter=tuple(float(v) for v in np.asarray(self.deriv_filter).ravel()),
            blend=float(self.blend),
            solver=self._solver_cfg(),
            guard=0.0,
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
