"""Warped spatiotemporal derivatives (port of ``optical_flow_tpu/ops/derivatives.py``).

Three interpolations, as in the JAX package:

* ``'bi-cubic'`` (Classic+NL, classic++): the Hermite bicubic interpolator
  and its analytical spatial derivatives;
* ``'cubic'`` (BA, HS): cubic B-spline warping of frame 2 and of its two
  derivative images, with the prefilter as two matrix products;
* ``'bi-linear'``: 2×2 sampling of the same three images.

Everything that depends only on the images is built once per level
(:func:`precompute_warp`); each warp iteration (:func:`warp_deriv`) is a
gather plus the interpolation's arithmetic.  Images and flows may carry a
leading batch axis, (B, H, W, 2C) and (B, H, W, 2); every gather reads each
item's own planes.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from optical_flow_tpu_torch.ops.filters import correlate2d
from optical_flow_tpu_torch.ops.interp import (
    gather_points,
    per_item,
    sample_bilinear,
    sample_cubic_spline,
    spline_coeffs_2d,
    tap_index,
)

DEFAULT_DERIV_FILTER = np.array([1.0, -8.0, 0.0, 8.0, -1.0]) / 12.0

# Hermite bicubic coefficient matrix (Numerical Recipes "bcucof" table).
W_BICUBIC = np.array(
    [
        [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0],
        [-3, 0, 0, 3, 0, 0, 0, 0, -2, 0, 0, -1, 0, 0, 0, 0],
        [2, 0, 0, -2, 0, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0],
        [0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0],
        [0, 0, 0, 0, -3, 0, 0, 3, 0, 0, 0, 0, -2, 0, 0, -1],
        [0, 0, 0, 0, 2, 0, 0, -2, 0, 0, 0, 0, 1, 0, 0, 1],
        [-3, 3, 0, 0, -2, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, -3, 3, 0, 0, -2, -1, 0, 0],
        [9, -9, 9, -9, 6, 3, -3, -6, 6, -6, -3, 3, 4, 2, 1, 2],
        [-6, 6, -6, 6, -4, -2, 2, 4, -3, 3, 3, -3, -2, -1, -1, -2],
        [2, -2, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 2, -2, 0, 0, 1, 1, 0, 0],
        [-6, 6, -6, 6, -3, -3, 3, 3, -4, 4, 2, -2, -2, -2, -1, -1],
        [4, -4, 4, -4, 2, 2, -2, -2, 2, -2, -2, 2, 1, 1, 1, 1],
    ],
    dtype=np.float64,
)

# corner order per table: 00=(fx,fy), 10=(cx,fy), 11=(cx,cy), 01=(fx,cy)
HERMITE_CORNER_SHIFTS = ((0, 0), (0, 1), (1, 1), (1, 0))


class WarpPrecompute(NamedTuple):
    """Flow-independent per-level tables for :func:`warp_deriv` (per-channel tuples)."""

    method: str
    blend: float
    im1: tuple  # (..., H, W) per channel
    I1x: tuple
    I1y: tuple
    # 'cubic': spline coefficients of (im2, I2x, I2y); 'bi-linear': the images; (..., 3, H, W) per channel
    warp_tables: tuple
    hermite_tables: tuple  # 'bi-cubic': (Z, DX, DY, DXY) of frame 2, per channel


def precompute_warp(images, interp_method: str = "cubic", deriv_filter=None, blend: float = 0.5):
    """Build all flow-independent tables for one pyramid level of (..., H, W, 2C) ``images``."""
    if interp_method not in ("bi-cubic", "cubic", "bi-linear"):
        raise ValueError(f"Unknown interpolation method: {interp_method}")
    if deriv_filter is None:
        deriv_filter = DEFAULT_DERIV_FILTER
    f = np.asarray(deriv_filter, dtype=np.float64)
    fx, fy, fxy = f.reshape(1, -1), f.reshape(-1, 1), np.outer(f, f)

    nc = images.shape[-1] // 2
    im1s = tuple(images[..., c] for c in range(nc))
    im2s = tuple(images[..., nc + c] for c in range(nc))
    warp_tables, hermite_tables = (), ()
    if interp_method == "bi-cubic":
        hermite_tables = tuple(
            (c, correlate2d(c, fx, "reflect"), correlate2d(c, fy, "reflect"), correlate2d(c, fxy, "reflect"))
            for c in im2s
        )
    else:
        warp_tables = tuple(
            torch.stack([c, correlate2d(c, fx, "reflect"), correlate2d(c, fy, "reflect")], dim=-3) for c in im2s
        )
        if interp_method == "cubic":
            warp_tables = tuple(spline_coeffs_2d(t, images.ndim - 3) for t in warp_tables)
    return WarpPrecompute(
        method=interp_method,
        blend=float(blend),
        im1=im1s,
        I1x=tuple(correlate2d(c, fx, "reflect") for c in im1s),
        I1y=tuple(correlate2d(c, fy, "reflect") for c in im1s),
        warp_tables=warp_tables,
        hermite_tables=hermite_tables,
    )


@lru_cache(maxsize=None)
def _w_bicubic(dtype, device) -> torch.Tensor:
    return torch.as_tensor(W_BICUBIC, dtype=dtype, device=device)


def hermite_eval(taps, ax, ay, batch_dims: int = 0):
    """(val, d/dx, d/dy) from (16, ...) corner taps and in-cell offsets (ax, ay) of shape (...).

    With ``batch_dims`` leading batch axes after the 16 (taps (16, *batch,
    h, w)), the coefficient product runs item by item (``per_item``), so each
    item gets the bits of an unbatched call.
    """
    Wb = _w_bicubic(taps.dtype, taps.device)
    if batch_dims:
        C = per_item(lambda t: torch.tensordot(Wb, t, dims=1), taps.movedim(0, batch_dims), batch_dims)
        C = C.movedim(batch_dims, 0)
    else:
        C = torch.tensordot(Wb, taps, dims=1)

    ax_p = [torch.ones_like(ax), ax, ax * ax, ax * ax * ax]
    ay_p = [torch.ones_like(ay), ay, ay * ay, ay * ay * ay]

    val = torch.zeros_like(ax)
    vx = torch.zeros_like(ax)
    vy = torch.zeros_like(ax)
    idx = 0
    for i in range(4):
        for j in range(4):
            c = C[idx]
            val = val + c * ax_p[i] * ay_p[j]
            if i > 0:
                vx = vx + i * c * ax_p[i - 1] * ay_p[j]
            if j > 0:
                vy = vy + j * c * ax_p[i] * ay_p[j - 1]
            idx += 1
    return val, vx, vy


def _hermite_bicubic(tables, yq, xq):
    """Hermite bicubic sample + analytical d/dx, d/dy at 0-based (yq, xq).

    ``tables`` are four (*batch, H, W) planes and (yq, xq) (*batch, h, w):
    each item's tables are read at its own points.  Returns (val, vx, vy,
    oob); a point is out once its ceil neighbour leaves the grid, i.e.
    x >= W-1 counts as out.  The 16 corner taps read the edge-padded tables
    at the clamped base index, which is the same as clamping each corner's
    index.
    """
    nb = xq.ndim - 2
    H, W = tables[0].shape[-2:]
    fx = torch.floor(xq)
    fy = torch.floor(yq)
    oob = (fx < 0) | (fx + 1 > W - 1) | (fy < 0) | (fy + 1 > H - 1)

    iy0 = tap_index(fy, H)
    ix0 = tap_index(fx, W)
    flat = torch.stack(tables, dim=-3).reshape(*xq.shape[:nb], 4, H * W)  # (Z, DX, DY, DXY)
    corners = torch.stack(
        [torch.clamp(iy0 + a, max=H - 1) * W + torch.clamp(ix0 + b, max=W - 1) for a, b in HERMITE_CORNER_SHIFTS],
        dim=nb,
    )
    # (*batch, 4 tables, 4 corners, h, w) -> (16, *batch, h, w): table-major, then corner
    taps = gather_points(flat, corners, nb).flatten(nb, nb + 1).movedim(nb, 0)
    val, vx, vy = hermite_eval(taps, xq - fx, yq - fy, nb)
    return val, vx, vy, oob


def partial_deriv(images, uv, interp_method: str = "cubic", deriv_filter=None, blend: float = 0.5):
    """The reference's one-shot surface: (It, Ix, Iy) of ``images`` warped by ``uv``."""
    return warp_deriv(precompute_warp(images, interp_method, deriv_filter, blend), uv)


def interp2_bicubic(Z, XI, YI, deriv_filter=None):
    """Hermite bicubic interpolation of the (H, W) ``Z`` with analytical
    derivatives at the 1-based points (``XI``, ``YI``), of any one shape:
    returns (ZI, ZXI, ZYI), with ZI NaN where a point is out of bounds (its
    ceil neighbour off the grid).  The derivative tables correlate ``Z``
    with ``deriv_filter`` under scipy-'reflect' padding."""
    if deriv_filter is None:
        deriv_filter = DEFAULT_DERIV_FILTER
    f = np.asarray(deriv_filter, dtype=np.float64)
    Z = torch.as_tensor(Z)
    XI = torch.as_tensor(XI, dtype=Z.dtype, device=Z.device)
    YI = torch.as_tensor(YI, dtype=Z.dtype, device=Z.device)
    tables = (
        Z,
        correlate2d(Z, f.reshape(1, -1), "reflect"),
        correlate2d(Z, f.reshape(-1, 1), "reflect"),
        correlate2d(Z, np.outer(f, f), "reflect"),
    )
    # the interpolator reads (h, w) point grids: any other shape goes as one row
    shape = XI.shape
    val, vx, vy, oob = _hermite_bicubic(tables, YI.reshape(1, -1) - 1.0, XI.reshape(1, -1) - 1.0)
    val = torch.where(oob, torch.full_like(val, float("nan")), val)
    return val.reshape(shape), vx.reshape(shape), vy.reshape(shape)


def warp_deriv(pre: WarpPrecompute, uv):
    """Warp frame 2 by ``uv`` (..., H, W, 2) and return (It, Ix, Iy): (..., H, W)
    for one channel, else (..., H, W, C)."""
    H, W = uv.shape[-3:-1]
    ygrid, xgrid = torch.meshgrid(
        torch.arange(H, dtype=uv.dtype, device=uv.device),
        torch.arange(W, dtype=uv.dtype, device=uv.device),
        indexing="ij",
    )
    xq = xgrid + uv[..., 0]
    yq = ygrid + uv[..., 1]
    if pre.method != "bi-cubic":
        # the strictly-outside mask of the 'cubic' and 'bi-linear' routes; the
        # Hermite route masks with its own, which counts x >= W-1 as outside
        B = (xq > W - 1) | (xq < 0) | (yq > H - 1) | (yq < 0)

    blend = pre.blend
    Its, Ixs, Iys = [], [], []
    zero = torch.zeros((), dtype=uv.dtype, device=uv.device)
    for c in range(len(pre.im1)):
        if pre.method == "bi-cubic":
            warp, wx, wy, mask = _hermite_bicubic(pre.hermite_tables[c], yq, xq)
        elif pre.method == "cubic":
            warp, wx, wy = sample_cubic_spline(pre.warp_tables[c], yq, xq)[0].unbind(-3)
            mask = B
        else:
            warp, wx, wy = (sample_bilinear(t, yq, xq, mode="nearest") for t in pre.warp_tables[c].unbind(-3))
            mask = B
        It = warp - pre.im1[c]
        Ix = blend * wx + (1 - blend) * pre.I1x[c]
        Iy = blend * wy + (1 - blend) * pre.I1y[c]
        Its.append(torch.where(mask, zero, It))
        Ixs.append(torch.where(mask, zero, Ix))
        Iys.append(torch.where(mask, zero, Iy))

    if len(Its) == 1:
        return Its[0], Ixs[0], Iys[0]
    return torch.stack(Its, dim=-1), torch.stack(Ixs, dim=-1), torch.stack(Iys, dim=-1)
