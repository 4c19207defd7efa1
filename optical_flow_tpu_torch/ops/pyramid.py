"""Gaussian image pyramids with MATLAB-exact resampling (port of ``optical_flow_tpu/ops/pyramid.py``)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from optical_flow_tpu_torch.ops.filters import correlate2d_multi
from optical_flow_tpu_torch.ops.interp import matlab_imresize_bilinear
from optical_flow_tpu_torch.utils.compat import fspecial_gaussian, matlab_round


def pyramid_shapes(hw: Tuple[int, int], n_levels: int, ratio: float) -> List[Tuple[int, int]]:
    """Static shape ladder, index 0 = finest (input size)."""
    shapes = [(int(hw[0]), int(hw[1]))]
    for _ in range(1, n_levels):
        H, W = shapes[-1]
        shapes.append((max(1, matlab_round(H * ratio)), max(1, matlab_round(W * ratio))))
    return shapes


def auto_pyramid_levels(hw: Tuple[int, int], spacing: float) -> int:
    """1 + floor(log(min_dim / 16) / log(spacing))."""
    min_dim = min(hw[0], hw[1])
    return 1 + int(np.floor(np.log(min_dim / 16.0) / np.log(spacing)))


def pyramid_filter(spacing: float) -> np.ndarray:
    """Gaussian smoothing kernel for one pyramid step.

    ``round`` is Python's (half to even), as in the JAX package.
    """
    smooth_sigma = np.sqrt(spacing) / np.sqrt(2.0)
    ksize = 2 * int(round(1.5 * smooth_sigma)) + 1
    return fspecial_gaussian(int(ksize), smooth_sigma)


def compute_image_pyramid(img, f: np.ndarray, n_levels: int, ratio: float):
    """The Gaussian pyramid of an (H, W) or (H, W, C) image, finest first:
    smooth with the kernel ``f`` (scipy-'reflect'), then resize by ``ratio``."""
    shapes = pyramid_shapes(img.shape[:2], n_levels, ratio)
    pyramid = [img]
    current = img
    for lvl in range(1, n_levels):
        current = matlab_imresize_bilinear(correlate2d_multi(current, f, "reflect"), shapes[lvl])
        pyramid.append(current)
    return pyramid


def pyramid_pair(images, levels: int, spacing: float, gnc_levels: int, gnc_spacing: float):
    """Both pyramid ladders of an image, (the ``spacing`` one, the GNC one), each a tuple finest first."""
    return (tuple(build_pyramid(images, levels, spacing)), tuple(build_pyramid(images, gnc_levels, gnc_spacing)))


def build_pyramid(images, levels: int, spacing: float, batch_dims: int = 0):
    """List of (H, W[, C]) levels after ``batch_dims`` leading batch axes,
    finest first: smooth (reflect), then resize."""
    shapes = pyramid_shapes(images.shape[batch_dims : batch_dims + 2], levels, 1.0 / spacing)
    f = pyramid_filter(spacing)
    pyramid = [images]
    current = images
    for lvl in range(1, levels):
        smooth = correlate2d_multi(current, f, "reflect", batch_dims)
        current = matlab_imresize_bilinear(smooth, shapes[lvl], batch_dims)
        pyramid.append(current)
    return pyramid
