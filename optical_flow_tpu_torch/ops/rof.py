"""ROF structure–texture decomposition (port of ``optical_flow_tpu/ops/rof.py``).

The input is normalized to [-1, 1] *globally across channels*, and the
texture ``norm - alp * structure`` is rescaled to [0, 255].  The structure
of every channel comes from :func:`~optical_flow_tpu_torch.ops.cuda.rof_kernel.rof_structure`
in one call: the CUDA kernel on the card, its plain twin
:func:`rof_structure_2d` on the CPU.
"""
from __future__ import annotations

from optical_flow_tpu_torch.ops.cuda.rof_kernel import rof_structure, rof_structure_2d
from optical_flow_tpu_torch.utils.compat import scale_image

__all__ = ["rof_structure_2d", "structure_texture_decomposition_rof"]


def structure_texture_decomposition_rof(im, theta=1.0 / 8, n_iters=100, alp=0.95):
    """Texture component of ``im`` ((H, W) or (H, W, C)), scaled to [0, 255]."""
    im_norm = scale_image(im, -1, 1)
    if im_norm.ndim == 3:
        structure = rof_structure(im_norm.permute(2, 0, 1).contiguous(), theta, n_iters)
        structure = structure.permute(1, 2, 0)
    else:
        structure = rof_structure(im_norm.contiguous(), theta, n_iters)
    return scale_image(im_norm - alp * structure, 0, 255)
