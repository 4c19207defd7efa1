"""High-level interface: ``estimate_flow(im1, im2, method, params, device)`` (port of ``optical_flow_tpu/interface.py``).

Grayscale conversion (MATLAB uint8-quantized), the Lab guide for the
non-local term (channels rescaled to [0, 255]), parameter overrides and
dispatch.  The device is explicit: ``"cuda"`` without a GPU raises, and the
CPU runs only when asked for by name.
"""
from __future__ import annotations

import numpy as np
import torch

from optical_flow_tpu_torch.config import load_of_method
from optical_flow_tpu_torch.utils.compat import preprocess_color_pair


def _resolve_dtype(dt):
    return getattr(torch, dt) if isinstance(dt, str) else dt


def resolve_device(device, caller: str = "estimate_flow") -> torch.device:
    """``device`` as a torch device; the card without a GPU raises (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}(device='cuda'): no CUDA device is available")
    return dev


def estimate_flow(im1, im2, method: str = "classic+nl-fast", params=None, device="cuda"):
    """Estimate optical flow between two images.

    Args:
        im1, im2: (H, W) grayscale or (H, W, 3) RGB images (float or uint8);
            (H, W, C) frames with C < 3 are taken channel by channel, the pair
            as (H, W, 2C), with the raw first frame as the colour guide.
        method: preset name (see :func:`~optical_flow_tpu_torch.config.load_of_method`).
        params: optional dict (or MATLAB-style k/v list) of overrides, e.g.
            ``{"solver": "pcg"}``, ``{"dtype": torch.float64}`` or
            ``{"out_dtype": "float16"}``.
        device: ``"cuda"`` (default; raises without a GPU) or ``"cpu"``.

    Returns:
        uv: (H, W, 2) tensor on ``device``; uv[..., 0] horizontal, uv[..., 1] vertical.
    """
    dev = resolve_device(device)
    im1 = np.asarray(im1)
    im2 = np.asarray(im2)
    if im1.shape != im2.shape:
        raise ValueError(f"frame shapes differ: {im1.shape} vs {im2.shape}")

    ope = load_of_method(method)
    if params is not None:
        ope.parse_input_parameter(params)
    dtype = _resolve_dtype(ope.dtype)

    with torch.no_grad():
        a1 = torch.as_tensor(np.ascontiguousarray(im1)).to(device=dev, dtype=dtype)
        a2 = torch.as_tensor(np.ascontiguousarray(im2)).to(device=dev, dtype=dtype)
        if a1.ndim == 3 and a1.shape[2] >= 3:
            images, lab = preprocess_color_pair(a1, a2)
            color = lab if ope.color_images is not None else None
        elif a1.ndim in (2, 3):
            images = torch.stack([a1, a2], dim=2) if a1.ndim == 2 else torch.cat([a1, a2], dim=2)
            # such a pair's guide is the raw first frame (no Lab, no rescale)
            color = a1 if ope.color_images is not None else None
        else:
            raise ValueError(f"expected (H, W) or (H, W, C) frames, got {im1.shape}")
        uv = ope.compute_flow(images, color)
        if ope.out_dtype is not None:
            uv = uv.to(_resolve_dtype(ope.out_dtype))
    return uv
