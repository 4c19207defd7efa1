"""Bilinear and cubic B-spline sampling and MATLAB-convention resizes (port of ``optical_flow_tpu/ops/interp.py``).

Resizes and the B-spline prefilter stay dense per-axis operators applied as
two matrix products.  They are plain products outside any kernel; on the
card they run in full float32 (``torch.get_float32_matmul_precision() ==
"highest"``).  Gathers index the tensor directly at clamped indices.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from optical_flow_tpu_torch.ops.filters import pad2d


@lru_cache(maxsize=None)
def bspline_prefilter_matrix(n: int) -> np.ndarray:
    """Inverse of the cubic B-spline interpolation system with mirror boundary.

    Row i: (c[i-1] + 4 c[i] + c[i+1]) / 6 = f[i], folded c[-1] = c[1],
    c[n] = c[n-2]; the dense inverse reproduces
    ``scipy.ndimage.spline_filter1d(order=3)``.
    """
    if n == 1:
        return np.ones((1, 1))
    B = np.zeros((n, n))
    for i in range(n):
        B[i, i] += 4.0 / 6.0
        for d in (-1, 1):
            j = i + d
            if j < 0:
                j = -j
            if j >= n:
                j = 2 * (n - 1) - j
            B[i, j] += 1.0 / 6.0
    return np.linalg.inv(B)


@lru_cache(maxsize=None)
def _prefilter_operator(n: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(bspline_prefilter_matrix(n), dtype=dtype, device=device)


def spline_coeffs_2d(im, batch_dims: int = 0):
    """Cubic B-spline coefficients of the last two axes of ``im`` (..., H, W): two
    matrix products; with ``batch_dims`` leading batch axes, item by item (see
    :func:`per_item`)."""
    if batch_dims:
        return per_item(spline_coeffs_2d, im, batch_dims)
    H, W = im.shape[-2:]
    Ph = _prefilter_operator(H, im.dtype, im.device)
    Pw = _prefilter_operator(W, im.dtype, im.device)
    return Ph @ im @ Pw.T


def _bspline3(t):
    """Cubic B-spline kernel beta^3(t), support |t| < 2."""
    at = torch.abs(t)
    inner = 2.0 / 3.0 - at**2 + at**3 / 2.0
    outer = (2.0 - at) ** 3 / 6.0
    return torch.where(at < 1.0, inner, torch.where(at < 2.0, outer, 0.0))


_SPLINE_OFFSETS = (-1, 0, 1, 2)


def tap_index(f, n: int):
    """Integer index of the floored coordinates ``f``, clamped to [0, n - 1].

    A NaN coordinate (a flow that diverged) reads index 0, as XLA converts
    NaN to 0; its weights are NaN whatever it reads.  Converted unclamped,
    NaN would become an out-of-range index.
    """
    return torch.clamp(torch.nan_to_num(f, nan=0.0), 0, n - 1).long()


def gather_points(planes, idx, batch_dims: int):
    """``planes`` (*batch, [K,] P) read at ``idx`` (*batch, ...): each item at its
    own indices, every one of its K planes at the same ones; -> (*batch, [K,] ...)."""
    batch = idx.shape[:batch_dims]
    flat_idx = idx.reshape(*batch, -1)
    if planes.ndim - batch_dims == 2:  # K planes share each item's indices
        flat_idx = flat_idx.unsqueeze(-2).expand(*batch, planes.shape[-2], flat_idx.shape[-1])
        return torch.gather(planes, -1, flat_idx).reshape(*planes.shape[:-1], *idx.shape[batch_dims:])
    return torch.gather(planes, -1, flat_idx).reshape(idx.shape)


def sample_cubic_spline(coeffs, ys, xs):
    """Evaluate cubic B-spline surfaces at 0-based (ys, xs).

    ``ys``, ``xs`` are (*batch, h, w); ``coeffs`` is (*batch, H, W) or a stack
    (*batch, K, H, W) of coefficient planes (see :func:`spline_coeffs_2d`),
    each item's planes sampled at that item's points.  Returns
    ``(values, oob)``: values (*batch, [K,] h, w) and the mask of strictly
    outside points, for the caller to fill.  The planes are padded by 2
    with numpy-'reflect' (``"mirror"`` here: the edge is not repeated), the
    4×4 taps are read at the clamped base index, and their weights come from
    the unclamped offsets.
    """
    nb = ys.ndim - 2
    H, W = coeffs.shape[-2:]
    padded = pad2d(coeffs, 2, 2, 2, 2, "mirror")
    flat = padded.reshape(*coeffs.shape[:-2], -1)
    fy = torch.floor(ys)
    fx = torch.floor(xs)
    base = tap_index(fy, H) * (W + 4) + tap_index(fx, W)
    idx = torch.stack(
        [base + (dy + 2) * (W + 4) + (dx + 2) for dy in _SPLINE_OFFSETS for dx in _SPLINE_OFFSETS], dim=nb
    )
    taps = gather_points(flat, idx, nb).unbind(-3)

    wy = [_bspline3(ys - (fy + dy)) for dy in _SPLINE_OFFSETS]
    wx = [_bspline3(xs - (fx + dx)) for dx in _SPLINE_OFFSETS]
    if coeffs.ndim - nb == 3:  # the weights broadcast over the K planes
        wy = [w.unsqueeze(-3) for w in wy]
        wx = [w.unsqueeze(-3) for w in wx]
    out = torch.zeros_like(taps[0])
    for a in range(4):
        for b in range(4):
            out = out + wy[a] * wx[b] * taps[a * 4 + b]
    oob = (ys < 0) | (ys > H - 1) | (xs < 0) | (xs > W - 1)
    return out, oob


def sample_bilinear(im, ys, xs, mode: str = "nearest"):
    """Bilinear sampling of (..., H, W) ``im`` at 0-based (ys, xs) of
    (..., h, w): each item of a leading batch axis at its own points.

    ``mode='nearest'`` clamps coordinates to the image; ``mode='constant'``
    also returns the mask of strictly-outside points.
    """
    nb = im.ndim - 2
    H, W = im.shape[-2:]
    flat = im.reshape(*im.shape[:-2], H * W)
    ysc = torch.clamp(ys, 0.0, H - 1.0)
    xsc = torch.clamp(xs, 0.0, W - 1.0)
    y0f = torch.floor(ysc)
    x0f = torch.floor(xsc)
    y0 = tap_index(y0f, H)
    x0 = tap_index(x0f, W)
    y1 = torch.clamp(y0 + 1, max=H - 1)  # == the edge-padded row below
    x1 = torch.clamp(x0 + 1, max=W - 1)
    ay = ysc - y0f
    ax = xsc - x0f
    v00, v01, v10, v11 = (gather_points(flat, r * W + c, nb) for r, c in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)))
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


def per_item(fn, x, batch_dims: int):
    """``fn`` of each item of ``x`` (its leading ``batch_dims`` axes), stacked.

    Each item is first copied to a fresh tensor with the item's own strides:
    cuBLAS chooses a product's kernel, and so its rounding, from the shapes,
    the strides and the pointers' alignment, so an item then gets the bits
    of an unbatched call, and a batched flow its items' single-pair flows.
    """
    lead = x.shape[:batch_dims]
    items = x.reshape(-1, *x.shape[batch_dims:])
    out = torch.stack([fn(torch.empty_like(item).copy_(item)) for item in items.unbind(0)])
    return out.reshape(*lead, *out.shape[1:])


def resize_planes(x, out_hw, batch_dims: int = 0):
    """MATLAB bilinear resize of the last two axes of ``x`` (..., H, W); with
    ``batch_dims`` leading batch axes, item by item (see :func:`per_item`)."""
    if batch_dims:
        return per_item(lambda item: resize_planes(item, out_hw), x, batch_dims)
    H, W = x.shape[-2:]
    Rh = _resize_operator(H, int(out_hw[0]), x.dtype, x.device)
    Rw = _resize_operator(W, int(out_hw[1]), x.dtype, x.device)
    return Rh @ x @ Rw.T


def matlab_imresize_bilinear(im, out_hw, batch_dims: int = 0):
    """2-D MATLAB-convention bilinear resize for (H, W) or (H, W, C) after
    ``batch_dims`` leading batch axes."""
    if im.ndim - batch_dims == 2:
        return resize_planes(im, out_hw, batch_dims)
    return resize_planes(im.movedim(-1, -3), out_hw, batch_dims).movedim(-3, -1)
