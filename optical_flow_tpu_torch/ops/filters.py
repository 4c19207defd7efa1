"""Small-stencil correlation filters and the median filter (port of ``optical_flow_tpu/ops/filters.py``).

A k×k correlation with a constant kernel is a sum of shifted multiplies over
a padded array, as in the JAX package.  It deliberately does not become
``conv2d``: cuDNN runs float32 convolutions in TF32 by default.  The median
filter stacks the k² window views and sorts them once.

Boundary names follow scipy.ndimage: ``reflect`` repeats the edge value
(numpy ``symmetric``), ``nearest`` clamps (numpy ``edge``) and ``mirror``
does not repeat the edge (numpy ``reflect``).  torch's own
``F.pad(mode="reflect")`` is numpy ``reflect`` and torch has no
``symmetric`` mode, so padding is done by index.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def pad_index(n: int, before: int, after: int, boundary: str) -> np.ndarray:
    """Source index of every padded position along an axis of length ``n``."""
    i = np.arange(-before, n + after)
    if boundary == "reflect":  # numpy 'symmetric': period 2n, edge repeated
        i = np.mod(i, 2 * n)
        return np.where(i >= n, 2 * n - 1 - i, i)
    if boundary == "mirror":  # numpy 'reflect': period 2n - 2, edge not repeated
        if n == 1:
            return np.zeros_like(i)
        i = np.mod(i, 2 * n - 2)
        return np.where(i >= n, 2 * n - 2 - i, i)
    if boundary == "nearest":
        return np.clip(i, 0, n - 1)
    raise ValueError(f"Unknown boundary {boundary!r}")


@lru_cache(maxsize=None)
def _pad_index_tensor(n: int, before: int, after: int, boundary: str, device) -> torch.Tensor:
    """:func:`pad_index` on ``device``, built once: a fresh host-to-device copy
    per call would synchronise the stream on every pad."""
    return torch.as_tensor(pad_index(n, before, after, boundary), device=device)


def pad_axis(x, dim: int, before: int, after: int, boundary: str):
    """Pad axis ``dim`` of ``x`` with scipy.ndimage boundary semantics."""
    return x.index_select(dim, _pad_index_tensor(x.shape[dim], before, after, boundary, x.device))


def pad2d(im, pad_t: int, pad_b: int, pad_l: int, pad_r: int, boundary: str):
    """Pad the last two axes of ``im`` with scipy.ndimage boundary semantics."""
    return pad_axis(pad_axis(im, -2, pad_t, pad_b, boundary), -1, pad_l, pad_r, boundary)


def correlate2d(im, kernel, boundary: str = "reflect"):
    """2-D correlation with a constant kernel, scipy.ndimage semantics.

    ``im`` is (..., H, W); the kernel origin is centered with ties toward
    the upper-left, as ``scipy.ndimage.correlate``.
    """
    kernel = np.atleast_2d(np.asarray(kernel))
    kh, kw = kernel.shape
    cy, cx = kh // 2, kw // 2
    padded = pad2d(im, cy, kh - 1 - cy, cx, kw - 1 - cx, boundary)
    return correlate_padded(padded, kernel, *im.shape[-2:])


def correlate_padded(padded, kernel, H: int, W: int, row0: int = 0):
    """The (..., H, W) correlation of ``padded`` (already extended by the
    kernel's radius on every side) with the constant 2-D ``kernel``; its
    window rows start ``row0`` rows into ``padded``."""
    kh, kw = kernel.shape
    out = torch.zeros(padded.shape[:-2] + (H, W), dtype=padded.dtype, device=padded.device)
    for dy in range(kh):
        for dx in range(kw):
            w = float(kernel[dy, dx])
            if w == 0.0:
                continue
            out = out + w * padded[..., row0 + dy : row0 + dy + H, dx : dx + W]
    return out


def correlate2d_multi(im, kernel, boundary: str = "reflect", batch_dims: int = 0):
    """Channel-wise :func:`correlate2d` for (H, W) or (H, W, C) inputs after
    ``batch_dims`` leading batch axes."""
    if im.ndim - batch_dims == 2:
        return correlate2d(im, kernel, boundary)
    return correlate2d(im.movedim(-1, -3), kernel, boundary).movedim(-3, -1)


def median_filter2d(im, size, boundary: str = "reflect"):
    """Median filter of the last two axes of ``im`` (..., H, W), window ``size`` (int or (h, w)).

    The value of rank ``k²//2`` of each window, as
    ``scipy.ndimage.median_filter(mode='reflect')`` and both routes of the
    JAX package.  NaNs sort last.  For windows of at most 49 values the JAX
    package selects through a pruned Batcher network after mapping NaN to
    +inf, and maps a +inf result back to NaN; here the same scrub and
    mapping surround one sort, whose selected value is the network's bit
    for bit.  Larger windows sort the raw values, as there.
    """
    if isinstance(size, (tuple, list, np.ndarray)):
        kh, kw = int(size[0]), int(size[1])
    else:
        kh = kw = int(size)
    cy, cx = kh // 2, kw // 2
    padded = pad2d(im, cy, kh - 1 - cy, cx, kw - 1 - cx, boundary)
    return median_of_windows(padded, *im.shape[-2:], kh, kw)


def median_of_windows(padded, H: int, W: int, kh: int, kw: int):
    """The value of rank ``kh*kw // 2`` of each (kh, kw) window of ``padded``
    (..., H + kh - 1, W + kw - 1), as :func:`median_filter2d` selects it."""
    n = kh * kw
    scrub = n <= 49 and padded.is_floating_point()
    if scrub:
        padded = torch.where(torch.isnan(padded), torch.inf, padded)
    stack = torch.stack([padded[..., dy : dy + H, dx : dx + W] for dy in range(kh) for dx in range(kw)], dim=-1)
    out = torch.sort(stack, dim=-1).values[..., n // 2]
    if scrub:
        out = torch.where(out == torch.inf, torch.nan, out)
    return out
