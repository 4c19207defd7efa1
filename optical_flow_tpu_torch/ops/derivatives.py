"""Warped spatiotemporal derivatives, ``'bi-cubic'`` path (port of ``optical_flow_tpu/ops/derivatives.py``).

Classic+NL warps with the Hermite bicubic interpolator and its analytical
spatial derivatives.  Everything that depends only on the images is built
once per level (:func:`precompute_warp`); each warp iteration
(:func:`warp_deriv`) is a 16-tap gather plus the polynomial evaluation.
The ``'cubic'`` and ``'bi-linear'`` paths wait for the other method
families (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from optical_flow_tpu_torch.ops.filters import correlate2d

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

    blend: float
    im1: tuple  # (H, W) per channel
    I1x: tuple
    I1y: tuple
    hermite_tables: tuple  # (Z, DX, DY, DXY) of frame 2, per channel


def precompute_warp(images, interp_method: str = "bi-cubic", deriv_filter=None, blend: float = 0.5):
    """Build all flow-independent tables for one pyramid level of (H, W, 2C) ``images``."""
    if interp_method != "bi-cubic":
        raise NotImplementedError(
            f"interpolation {interp_method!r} is not ported yet (ROADMAP queue 1, item 10)"
        )
    if deriv_filter is None:
        deriv_filter = DEFAULT_DERIV_FILTER
    f = np.asarray(deriv_filter, dtype=np.float64)
    fx, fy, fxy = f.reshape(1, -1), f.reshape(-1, 1), np.outer(f, f)

    nc = images.shape[2] // 2
    im1s = tuple(images[:, :, c] for c in range(nc))
    im2s = tuple(images[:, :, nc + c] for c in range(nc))
    return WarpPrecompute(
        blend=float(blend),
        im1=im1s,
        I1x=tuple(correlate2d(c, fx, "reflect") for c in im1s),
        I1y=tuple(correlate2d(c, fy, "reflect") for c in im1s),
        hermite_tables=tuple(
            (c, correlate2d(c, fx, "reflect"), correlate2d(c, fy, "reflect"), correlate2d(c, fxy, "reflect"))
            for c in im2s
        ),
    )


@lru_cache(maxsize=None)
def _w_bicubic(dtype, device) -> torch.Tensor:
    return torch.as_tensor(W_BICUBIC, dtype=dtype, device=device)


def hermite_eval(taps, ax, ay):
    """(val, d/dx, d/dy) from (16, ...) corner taps and in-cell offsets (ax, ay)."""
    C = torch.tensordot(_w_bicubic(taps.dtype, taps.device), taps, dims=1)

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

    Returns (val, vx, vy, oob); a point is out once its ceil neighbour
    leaves the grid, i.e. x >= W-1 counts as out.  The 16 corner taps read
    the edge-padded tables at the clamped base index, which is the same as
    clamping each corner's index.
    """
    H, W = tables[0].shape
    fx = torch.floor(xq)
    fy = torch.floor(yq)
    oob = (fx < 0) | (fx + 1 > W - 1) | (fy < 0) | (fy + 1 > H - 1)

    iy0 = torch.clamp(fy, 0, H - 1).long()
    ix0 = torch.clamp(fx, 0, W - 1).long()
    flat = torch.stack(tables).reshape(4, H * W)  # (Z, DX, DY, DXY)
    corners = torch.stack(
        [torch.clamp(iy0 + a, max=H - 1) * W + torch.clamp(ix0 + b, max=W - 1) for a, b in HERMITE_CORNER_SHIFTS]
    ).reshape(4, -1)
    taps = flat[:, corners].reshape(16, *xq.shape)  # table-major, then corner
    val, vx, vy = hermite_eval(taps, xq - fx, yq - fy)
    return val, vx, vy, oob


def warp_deriv(pre: WarpPrecompute, uv):
    """Warp frame 2 by ``uv`` and return (It, Ix, Iy): (H, W) for one channel, else (H, W, C)."""
    H, W = uv.shape[:2]
    ygrid, xgrid = torch.meshgrid(
        torch.arange(H, dtype=uv.dtype, device=uv.device),
        torch.arange(W, dtype=uv.dtype, device=uv.device),
        indexing="ij",
    )
    xq = xgrid + uv[:, :, 0]
    yq = ygrid + uv[:, :, 1]

    blend = pre.blend
    Its, Ixs, Iys = [], [], []
    zero = torch.zeros((), dtype=uv.dtype, device=uv.device)
    for c in range(len(pre.im1)):
        warp, wx, wy, oob = _hermite_bicubic(pre.hermite_tables[c], yq, xq)
        It = warp - pre.im1[c]
        Ix = blend * wx + (1 - blend) * pre.I1x[c]
        Iy = blend * wy + (1 - blend) * pre.I1y[c]
        Its.append(torch.where(oob, zero, It))
        Ixs.append(torch.where(oob, zero, Ix))
        Iys.append(torch.where(oob, zero, Iy))

    if len(Its) == 1:
        return Its[0], Ixs[0], Iys[0]
    return torch.stack(Its, dim=2), torch.stack(Ixs, dim=2), torch.stack(Iys, dim=2)
