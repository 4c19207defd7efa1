"""Occlusion detection from flow divergence + brightness constancy (port of ``optical_flow_tpu/ops/occlusion.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from optical_flow_tpu_torch.ops.interp import sample_bilinear


def detect_occlusion(uv, images, sigma_d: float = 0.3, sigma_i: float = 20.0):
    """Occlusion confidence in [0, 1] of (..., H, W, 2) flow and (..., H, W, 2C)
    images; higher = less occluded (0-based coordinates)."""
    H, W = uv.shape[-3:-1]
    u = uv[..., 0]
    v = uv[..., 1]

    # backward-difference divergence, zero at the leading edge
    dudx = F.pad(u[..., :, 1:] - u[..., :, :-1], (1, 0))
    dvdy = F.pad(v[..., 1:, :] - v[..., :-1, :], (0, 0, 1, 0))
    div = dudx + dvdy
    occ_div = torch.exp(-(div**2) / (2.0 * sigma_d**2))

    nc = images.shape[-1] // 2
    ygrid, xgrid = torch.meshgrid(
        torch.arange(H, dtype=uv.dtype, device=uv.device),
        torch.arange(W, dtype=uv.dtype, device=uv.device),
        indexing="ij",
    )
    xq = xgrid + u
    yq = ygrid + v

    It = torch.zeros_like(u)
    for c in range(nc):
        warp = sample_bilinear(images[..., nc + c], yq, xq, mode="nearest")
        It = It + torch.abs(warp - images[..., c])
    It = It / nc

    occ_bc = torch.exp(-(It**2) / (2.0 * sigma_i**2))
    return occ_div * occ_bc
