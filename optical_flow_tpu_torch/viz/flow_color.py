"""Middlebury flow color coding (copy of ``optical_flow_tpu/viz/flow_color.py``).

Implements the canonical Baker et al. "colorTest"/"computeColor" scheme
(the published Middlebury flow-code spec, mirrored by the reference's
``viz/flow_color.py``): a 55-bin piecewise-linear hue wheel
(RY15 YG6 GC4 CB11 BM13 MR6), hue interpolated around the wheel from flow
direction, saturation ramping with normalized radius, out-of-range radii
dimmed by 0.75, sentinel (unknown) pixels black.

Host-side numpy — visualization is not a device path.  The code below the
docstring is the JAX package's, character for character
(``tests/test_torch_viz_profiling.py`` pins it).
"""
from __future__ import annotations

import numpy as np

UNKNOWN_FLOW_THRESH = 1e9

# The wheel walks the RGB hexagon R -> Y -> G -> C -> B -> M -> R; each
# leg changes exactly one channel, quantized as floor(255 * i / bins).
_HUE_VERTICES = np.array(
    [
        [255, 0, 0],  # R
        [255, 255, 0],  # Y
        [0, 255, 0],  # G
        [0, 255, 255],  # C
        [0, 0, 255],  # B
        [255, 0, 255],  # M
    ],
    dtype=float,
)
_BINS_PER_LEG = (15, 6, 4, 11, 13, 6)  # RY YG GC CB BM MR


def make_colorwheel() -> np.ndarray:
    """(55, 3) RGB colorwheel in [0, 255]."""
    legs = []
    for i, bins in enumerate(_BINS_PER_LEG):
        start = _HUE_VERTICES[i]
        stop = _HUE_VERTICES[(i + 1) % len(_HUE_VERTICES)]
        ramp = np.floor(255.0 * np.arange(bins) / bins)
        # (stop - start) / 255 is -1, 0, or +1 per channel
        legs.append(start + np.outer(ramp, (stop - start) / 255.0))
    return np.concatenate(legs, axis=0)


def compute_color(u, v) -> np.ndarray:
    """uint8 color image from flow components pre-normalized to radius<=1."""
    u = np.asarray(u, dtype=float)
    v = np.asarray(v, dtype=float)
    wheel = make_colorwheel() / 255.0  # (N, 3) in [0, 1]
    nbins = wheel.shape[0]

    radius = np.sqrt(u**2 + v**2)[..., None]
    # continuous wheel position in [0, nbins-1], wrapping at the seam
    position = (np.arctan2(-v, -u) / np.pi + 1.0) / 2.0 * (nbins - 1)
    lo = np.floor(position).astype(int)
    hi = np.where(lo + 1 == nbins, 0, lo + 1)
    frac = (position - lo)[..., None]

    hue = wheel[lo] * (1 - frac) + wheel[hi] * frac  # (H, W, 3)
    shade = 1.0 - radius * (1.0 - hue)  # desaturate toward white at r=0
    shade = np.where(radius > 1.0, shade * 0.75, shade)  # out-of-range dimmed
    return np.floor(255.0 * np.clip(shade, 0.0, 1.0)).astype(np.uint8)


def flow_to_color(flow, max_flow=None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 Middlebury color image."""
    flow = np.asarray(flow)
    u = flow[:, :, 0].astype(float)
    v = flow[:, :, 1].astype(float)
    unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)

    if max_flow is not None:
        max_radius = max_flow
    else:
        known_r = np.sqrt(u[~unknown] ** 2 + v[~unknown] ** 2)
        max_radius = known_r.max() if known_r.size else 0.0
    max_radius = max(max_radius, 1e-8)

    img = compute_color(u / max_radius, v / max_radius)
    img[unknown] = 0
    return img
