"""Matrix-free flow linear systems as coupled 5-point stencils (port of ``optical_flow_tpu/ops/stencil.py``).

The system ``A x = b`` is held as nine (H, W) coefficient planes
(:class:`FlowSystem`): a per-pixel 2x2 data block plus the edge weights of
two 4-neighbour graph Laplacians, and the two right-hand-side planes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class FlowSystem(NamedTuple):
    """Coefficients of ``A @ x = b`` over a (H, W) grid.

    a11, a12, a22: per-pixel 2x2 data block.  wu_h, wu_v, wv_h, wv_v: edge
    weights (already scaled by lambda) of the u and v Laplacians; ``w*_h``
    weights the edge (i,j)-(i,j+1) and is 0 in the last column, ``w*_v``
    weights (i,j)-(i+1,j) and is 0 in the last row.  b_u, b_v: right-hand side.
    """

    a11: torch.Tensor
    a12: torch.Tensor
    a22: torch.Tensor
    wu_h: torch.Tensor
    wu_v: torch.Tensor
    wv_h: torch.Tensor
    wv_v: torch.Tensor
    b_u: torch.Tensor
    b_v: torch.Tensor


def _shift_left0(x):
    """x[i, j+1], zero in the last column."""
    return F.pad(x[..., :, 1:], (0, 1))


def _shift_right0(x):
    """x[i, j-1], zero in the first column."""
    return F.pad(x[..., :, :-1], (1, 0))


def _shift_up0(x):
    """x[i+1, j], zero in the last row."""
    return F.pad(x[..., 1:, :], (0, 0, 0, 1))


def _shift_down0(x):
    """x[i-1, j], zero in the first row."""
    return F.pad(x[..., :-1, :], (0, 0, 1, 0))


def forward_diff_h(x):
    """``x[i, j+1] - x[i, j]`` stored at (i, j); 0 in the last column."""
    return F.pad(x[:, 1:] - x[:, :-1], (0, 1))


def forward_diff_v(x):
    """``x[i+1, j] - x[i, j]`` stored at (i, j); 0 in the last row."""
    return F.pad(x[1:, :] - x[:-1, :], (0, 0, 0, 1))


def weighted_laplacian_apply(w_h, w_v, x):
    """Apply ``Fᵀ diag(w) F`` (4-neighbour edge-weighted Laplacian) to ``x``."""
    eh = w_h * (x - _shift_left0(x))
    ev = w_v * (x - _shift_up0(x))
    out = eh + ev
    out = out - _shift_right0(eh)
    return out - _shift_down0(ev)


def weighted_laplacian_diag(w_h, w_v):
    """Diagonal of ``Fᵀ diag(w) F``: the sum of incident edge weights."""
    return w_h + _shift_right0(w_h) + w_v + _shift_down0(w_v)


def system_apply_split(sys: FlowSystem, xu, xv):
    """``A @ x`` with channel-split state: two (H, W) planes in and out."""
    yu = sys.a11 * xu + sys.a12 * xv + weighted_laplacian_apply(sys.wu_h, sys.wu_v, xu)
    yv = sys.a12 * xu + sys.a22 * xv + weighted_laplacian_apply(sys.wv_h, sys.wv_v, xv)
    return yu, yv


def system_apply(sys: FlowSystem, x):
    """``A @ x`` for ``x`` of shape (H, W, 2)."""
    yu, yv = system_apply_split(sys, x[:, :, 0], x[:, :, 1])
    return torch.stack([yu, yv], dim=-1)


def blend_systems(alpha, sys_q: FlowSystem, sys_r: FlowSystem) -> FlowSystem:
    """GNC blend ``alpha * A_quadratic + (1 - alpha) * A_robust``, field by field."""
    return FlowSystem(*[alpha * q + (1.0 - alpha) * r for q, r in zip(sys_q, sys_r)])


def _channel_mean(x):
    return torch.mean(x, dim=2) if x.ndim == 3 else x


def build_irls_system(uv, duv, It, Ix, Iy, rho_spatial_u, rho_spatial_v, rho_data, lam) -> FlowSystem:
    """IRLS linear system of the BA / Classic+NL family.

    Spatial IRLS weights come from the forward differences of ``uv + duv``;
    the data term is linearized as ``It + Ix du + Iy dv`` with channel-mean
    reduction; ``lam`` is folded into the edge weights and the RHS.
    """
    u = uv[:, :, 0]
    v = uv[:, :, 1]
    up = u + duv[:, :, 0]
    vp = v + duv[:, :, 1]

    wu_h = rho_spatial_u[0].deriv_over_x(forward_diff_h(up))
    wu_v = rho_spatial_u[1].deriv_over_x(forward_diff_v(up))
    wv_h = rho_spatial_v[0].deriv_over_x(forward_diff_h(vp))
    wv_v = rho_spatial_v[1].deriv_over_x(forward_diff_v(vp))
    # zero the dangling edges (rows of F that are identically zero)
    mask_h = torch.ones_like(wu_h)
    mask_h[:, -1] = 0.0
    mask_v = torch.ones_like(wu_v)
    mask_v[-1, :] = 0.0
    wu_h = lam * wu_h * mask_h
    wv_h = lam * wv_h * mask_h
    wu_v = lam * wu_v * mask_v
    wv_v = lam * wv_v * mask_v

    if It.ndim == 3:
        It_lin = It + Ix * duv[:, :, 0:1] + Iy * duv[:, :, 1:2]
    else:
        It_lin = It + Ix * duv[:, :, 0] + Iy * duv[:, :, 1]
    pp_d = _channel_mean(rho_data.deriv_over_x(It_lin))
    Ix2 = _channel_mean(Ix**2)
    Iy2 = _channel_mean(Iy**2)
    Ixy = _channel_mean(Ix * Iy)
    Itx = _channel_mean(It_lin * Ix)
    Ity = _channel_mean(It_lin * Iy)

    a11 = pp_d * Ix2
    a12 = pp_d * Ixy
    a22 = pp_d * Iy2
    b_u = -weighted_laplacian_apply(wu_h, wu_v, u) - pp_d * Itx
    b_v = -weighted_laplacian_apply(wv_h, wv_v, v) - pp_d * Ity
    return FlowSystem(a11, a12, a22, wu_h, wu_v, wv_h, wv_v, b_u, b_v)


def build_hs_system(uv, It, Ix, Iy, lam, sigmaD2, sigmaS2) -> FlowSystem:
    """Horn–Schunck system: ``A = D / sigmaD2 + (lam / sigmaS2) blkdiag(L, L)``.

    L is the Neumann graph Laplacian (uniform edge weights, zero in the last
    column for ``wh`` and in the last row for ``wv``) and
    ``b = -(lam / sigmaS2) L uv - [Itx; Ity] / sigmaD2``.
    """
    Ix2 = _channel_mean(Ix**2) / sigmaD2
    Iy2 = _channel_mean(Iy**2) / sigmaD2
    Ixy = _channel_mean(Ix * Iy) / sigmaD2
    Itx = _channel_mean(It * Ix) / sigmaD2
    Ity = _channel_mean(It * Iy) / sigmaD2

    w_edge = lam / sigmaS2
    wh = torch.full_like(Ix2, w_edge)
    wh[:, -1] = 0.0
    wv = torch.full_like(Ix2, w_edge)
    wv[-1, :] = 0.0

    b_u = -weighted_laplacian_apply(wh, wv, uv[:, :, 0]) - Itx
    b_v = -weighted_laplacian_apply(wh, wv, uv[:, :, 1]) - Ity
    return FlowSystem(Ix2, Ixy, Iy2, wh, wv, wh, wv, b_u, b_v)


def add_coupling(sys: FlowSystem, weight) -> FlowSystem:
    """Add a per-pixel diagonal coupling term ``weight`` (H, W, 2) to a11 and a22.

    Alt-BA's coupling of the flow to its auxiliary field; the caller updates
    the right-hand side.
    """
    return sys._replace(a11=sys.a11 + weight[:, :, 0], a22=sys.a22 + weight[:, :, 1])
