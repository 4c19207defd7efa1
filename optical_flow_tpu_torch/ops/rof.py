"""ROF structure–texture decomposition (port of ``optical_flow_tpu/ops/rof.py``).

Each item is normalized to [-1, 1] *globally across its channels*, and the
texture ``norm - alp * structure`` is rescaled to [0, 255].  The structure
of every channel of every item comes from
:func:`~optical_flow_tpu_torch.ops.cuda.rof_kernel.rof_structure` in one
call (a batch of B pairs is one call on 2B images): the CUDA kernel on the
card, its plain twin :func:`rof_structure_2d` on the CPU.
"""
from __future__ import annotations

from optical_flow_tpu_torch.ops.cuda.rof_kernel import rof_structure, rof_structure_2d
from optical_flow_tpu_torch.utils.compat import scale_image

__all__ = ["rof_structure_2d", "structure_texture_decomposition_rof"]


def structure_texture_decomposition_rof(im, theta=1.0 / 8, n_iters=100, alp=0.95, batch_dims: int = 0):
    """Texture component of ``im``, scaled to [0, 255].

    ``im`` is (..., H, W) or (..., H, W, C) after ``batch_dims`` leading
    batch axes; the normalisations are per item.
    """
    im_norm = scale_image(im, -1, 1, batch_dims=batch_dims)
    planes = im_norm.movedim(-1, -3) if im_norm.ndim - batch_dims == 3 else im_norm
    H, W = planes.shape[-2:]
    structure = rof_structure(planes.reshape(-1, H, W).contiguous(), theta, n_iters).reshape(planes.shape)
    if im_norm.ndim - batch_dims == 3:
        structure = structure.movedim(-3, -1)
    return scale_image(im_norm - alp * structure, 0, 255, batch_dims=batch_dims)
