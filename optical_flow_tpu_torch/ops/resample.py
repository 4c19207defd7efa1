"""Flow resampling between pyramid levels (port of ``optical_flow_tpu/ops/resample.py``)."""
from __future__ import annotations

from optical_flow_tpu_torch.ops.interp import resize_planes


def resample_flow(uv, target_hw):
    """Resize (..., H, W, 2) flow to ``target_hw`` and scale its magnitude.

    A MATLAB quirk the reference keeps: *both* components are scaled by the
    height ratio ``new_H / H``.
    """
    H, W = uv.shape[-3:-1]
    new_H, new_W = int(target_hw[0]), int(target_hw[1])
    if (H, W) == (new_H, new_W):
        return uv
    out = resize_planes(uv.movedim(-1, -3), (new_H, new_W), uv.ndim - 3).movedim(-3, -1)
    return out * (new_H / H)
