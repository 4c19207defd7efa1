"""Bilinear sampling and MATLAB-convention resizes (port of ``optical_flow_tpu/ops/interp.py``).

Resizes stay dense per-axis operators applied as two matrix products.  They
are plain products outside any kernel; on the card they run in full float32
(``torch.get_float32_matmul_precision() == "highest"``).  Gathers index the
tensor directly at clamped indices.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def sample_bilinear(im, ys, xs, mode: str = "nearest"):
    """Bilinear sampling of (H, W) ``im`` at 0-based (ys, xs).

    ``mode='nearest'`` clamps coordinates to the image; ``mode='constant'``
    also returns the mask of strictly-outside points.
    """
    H, W = im.shape
    ysc = torch.clamp(ys, 0.0, H - 1.0)
    xsc = torch.clamp(xs, 0.0, W - 1.0)
    y0f = torch.floor(ysc)
    x0f = torch.floor(xsc)
    y0 = y0f.long()
    x0 = x0f.long()
    y1 = torch.clamp(y0 + 1, max=H - 1)  # == the edge-padded row below
    x1 = torch.clamp(x0 + 1, max=W - 1)
    ay = ysc - y0f
    ax = xsc - x0f
    v00, v01, v10, v11 = im[y0, x0], im[y0, x1], im[y1, x0], im[y1, x1]
    top = v00 * (1.0 - ax) + v01 * ax
    bot = v10 * (1.0 - ax) + v11 * ax
    val = top * (1.0 - ay) + bot * ay
    if mode == "nearest":
        return val
    oob = (ys < 0) | (ys > H - 1) | (xs < 0) | (xs > W - 1)
    return val, oob


@lru_cache(maxsize=None)
def matlab_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """1-D MATLAB ``imresize(..., 'bilinear', Antialiasing=false)`` operator.

    Dense (n_out, n_in); u = (out + 0.5) / scale - 0.5, clipped.
    """
    scale = n_out / n_in
    u = (np.arange(n_out) + 0.5) / scale - 0.5
    u = np.clip(u, 0, n_in - 1)
    lo = np.floor(u).astype(int)
    hi = np.minimum(lo + 1, n_in - 1)
    a = u - lo
    M = np.zeros((n_out, n_in))
    M[np.arange(n_out), lo] += 1.0 - a
    M[np.arange(n_out), hi] += a
    return M


@lru_cache(maxsize=None)
def _resize_operator(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """:func:`matlab_resize_matrix` as a tensor, kept per (dtype, device)."""
    return torch.as_tensor(matlab_resize_matrix(n_in, n_out), dtype=dtype, device=device)


def resize_planes(x, out_hw):
    """MATLAB bilinear resize of the last two axes of ``x`` (..., H, W)."""
    H, W = x.shape[-2:]
    Rh = _resize_operator(H, int(out_hw[0]), x.dtype, x.device)
    Rw = _resize_operator(W, int(out_hw[1]), x.dtype, x.device)
    return Rh @ x @ Rw.T


def matlab_imresize_bilinear(im, out_hw):
    """2-D MATLAB-convention bilinear resize for (H, W) or (H, W, C)."""
    if im.ndim == 2:
        return resize_planes(im, out_hw)
    return resize_planes(im.permute(2, 0, 1), out_hw).permute(1, 2, 0)
