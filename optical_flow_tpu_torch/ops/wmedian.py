"""Colour-guided weighted median filtering, the non-local term (port of ``optical_flow_tpu/ops/wmedian.py``).

The filter runs through
:func:`~optical_flow_tpu_torch.ops.cuda.wmedian_kernel.wmedian`: the CUDA
bisection kernel on the card, the sort-path plain twin on the CPU.
"""
from __future__ import annotations

import numpy as np

from optical_flow_tpu_torch.ops.cuda.wmedian_kernel import (
    _weighted_median_lastaxis,
    wmedfilt_prepadded,
    wmedian,
)
from optical_flow_tpu_torch.ops.filters import median_filter2d, pad2d
from optical_flow_tpu_torch.ops.interp import matlab_imresize_bilinear

__all__ = ["_weighted_median_lastaxis", "denoise_color_weighted_medfilt2", "wmedfilt_prepadded"]


def denoise_color_weighted_medfilt2(uv, color_images, occ, area_hsz: int, mfsz, sigma_i: float, full_version: bool = False):
    """Weighted median filter of the (H, W, 2) flow guided by colour affinity.

    ``full_version`` is accepted for API parity and, as in the reference,
    does not change the computation.  Without a guide (``None``, or one
    smaller than the flow, such as the presets' (1, 1, 3) placeholder) the
    result is a plain median filter of size ``mfsz[0]`` on each field, with
    scipy-'reflect' padding, as in the JAX package.
    """
    H, W = uv.shape[:2]
    if color_images is None or int(np.prod(color_images.shape[:2])) < H * W:
        sz = int(mfsz[0]) if hasattr(mfsz, "__len__") else int(mfsz)
        return median_filter2d(uv.permute(2, 0, 1), sz, "reflect").permute(1, 2, 0)
    if color_images.shape[0] != H or color_images.shape[1] != W:
        color_images = matlab_imresize_bilinear(color_images, (H, W))
    if color_images.ndim == 2:
        color_images = color_images[:, :, None]

    hsz = int(area_hsz)
    # numpy-'reflect' (mirror, no edge duplication) as the reference pads
    # here -- NOT the scipy 'reflect' of the correlation filters
    def pad(x):
        return pad2d(x, hsz, hsz, hsz, hsz, "mirror").contiguous()

    return wmedian(
        pad(uv[:, :, 0]),
        pad(uv[:, :, 1]),
        pad(occ),
        pad(color_images.permute(2, 0, 1)),
        (H, W),
        hsz,
        float(sigma_i),
    )
