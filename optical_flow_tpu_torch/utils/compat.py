"""MATLAB-compat numeric helpers (port of ``optical_flow_tpu/utils/compat.py``).

Tensor functions keep the JAX package's (H, W) / (H, W, C) layouts and its
operation order, so float64 results agree to machine precision.  A leading
batch axis is optional; the functions that reduce over an item (its min and
max, its Lab range) take the number of leading batch axes explicitly
(``batch_dims``), since an (H, W, C) image and a (B, H, W) batch of planes
both have three axes.
"""
from __future__ import annotations

import numpy as np
import torch


def matlab_round(x: float) -> int:
    """Round half away from zero for positive sizes (MATLAB ``round``)."""
    return int(np.floor(x + 0.5))


def _item_dims(im, batch_dims: int):
    """The axes of one item of ``im`` after ``batch_dims`` leading batch axes."""
    return tuple(range(batch_dims, im.ndim))


def scale_image(im, vlow, vhigh, ilow=None, ihigh=None, batch_dims: int = 0):
    """Linearly rescale ``im`` from [ilow, ihigh] to [vlow, vhigh].

    Omitted source bounds are the min/max of each item across *all* its
    channels: of the whole tensor without a batch axis.
    """
    if ilow is None:
        ilow = im.amin(_item_dims(im, batch_dims), keepdim=True)
    if ihigh is None:
        ihigh = im.amax(_item_dims(im, batch_dims), keepdim=True)
    span = torch.as_tensor(ihigh - ilow, dtype=im.dtype, device=im.device)
    safe = torch.where(span == 0, torch.ones_like(span), span)
    scaled = (im - ilow) / safe * (vhigh - vlow) + vlow
    return torch.where(span == 0, torch.full_like(im, (vlow + vhigh) / 2.0), scaled)


def fspecial_gaussian(size, sigma) -> np.ndarray:
    """MATLAB ``fspecial('gaussian', size, sigma)`` kernel (numpy)."""
    if isinstance(size, (int, np.integer)):
        size = (int(size), int(size))
    m, n = [(s - 1) / 2.0 for s in size]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x**2 + y**2) / (2.0 * sigma**2))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    s = h.sum()
    if s != 0:
        h /= s
    return h


def rgb2gray(im):
    """MATLAB ``double(rgb2gray(uint8(im)))`` of (..., H, W, 3) RGB.

    Both roundings are ``floor(x + 0.5)`` (half away from zero for these
    non-negative values), not ``torch.round``, which rounds half to even.
    """
    if im.ndim == 2:
        return im
    q = torch.clamp(torch.floor(im + 0.5), 0, 255)
    gray = 0.2989 * q[..., 0] + 0.5870 * q[..., 1] + 0.1140 * q[..., 2]
    return torch.floor(gray + 0.5)


def _cbrt(t):
    """Real cube root; torch has no ``cbrt``.

    ``sign(t) * |t|^(1/3)`` differs from a correctly rounded cube root by at
    most a few ulp (pow's error plus the rounding of 1/3), i.e. within
    ~1e-15 relative in float64 and ~3e-7 in float32.
    """
    return torch.sign(t) * torch.abs(t) ** (1.0 / 3.0)


def rgb2lab(im):
    """(..., H, W, 3) RGB -> CIE Lab with BT.709 primaries and a D65 white point.

    Each (H, W, 3) image is divided by 255 if any of its values exceeds 1.
    """
    R, G, B = im[..., 0], im[..., 1], im[..., 2]

    def peak(c):
        return c.amax((-2, -1), keepdim=True)

    needs_norm = torch.maximum(torch.maximum(peak(R), peak(G)), peak(B)) > 1.0
    inv255 = torch.full((), 1.0 / 255.0, dtype=im.dtype, device=im.device)
    scale = torch.where(needs_norm, inv255, torch.ones_like(inv255))
    R, G, B = R * scale, G * scale, B * scale

    T = 0.008856
    X = (0.412453 * R + 0.357580 * G + 0.180423 * B) / 0.950456
    Y = 0.212671 * R + 0.715160 * G + 0.072169 * B
    Z = (0.019334 * R + 0.119193 * G + 0.950227 * B) / 1.088754

    XT, YT, ZT = X > T, Y > T, Z > T
    Y3 = _cbrt(Y)
    fX = torch.where(XT, _cbrt(X), 7.787 * X + 16.0 / 116.0)
    fY = torch.where(YT, Y3, 7.787 * Y + 16.0 / 116.0)
    fZ = torch.where(ZT, _cbrt(Z), 7.787 * Z + 16.0 / 116.0)

    L = torch.where(YT, 116.0 * Y3 - 16.0, 903.3 * Y)
    a = 500.0 * (fX - fY)
    b = 200.0 * (fY - fZ)
    return torch.stack([L, a, b], dim=-1)


def preprocess_color_pair(im1, im2, batch_dims: int = 0):
    """Grayscale pair (..., H, W, 2) + the [0, 255]-scaled Lab guide (..., H, W, 3)
    of (..., H, W, 3) RGB frames; each Lab channel of each item is rescaled on its own."""
    gray = torch.stack([rgb2gray(im1), rgb2gray(im2)], dim=-1)
    lab = rgb2lab(im1)
    lab = torch.stack([scale_image(lab[..., j], 0, 255, batch_dims=batch_dims) for j in range(lab.shape[-1])], dim=-1)
    return gray, lab


def preprocess_color_batch(im1_batch, im2_batch):
    """(B, H, W, 3) RGB pairs -> the (B, H, W, 2) gray pairs and (B, H, W, 3)
    [0, 255]-Lab guides: :func:`preprocess_color_pair` of every pair."""
    return preprocess_color_pair(im1_batch, im2_batch, batch_dims=1)
