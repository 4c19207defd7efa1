"""Colour-guided weighted median: the CUDA kernel ``csrc/wmedian.cu`` and its plain twin.

Replaces the Pallas kernel ``_wmedian_kernel`` / ``wmedian_pallas``
(``optical_flow_tpu/ops/pallas/wmedian_kernel.py``).  For u and v, the
occlusion- and colour-weighted median over a (2h+1)^2 window, with weights
``max(exp(-sum_c dc^2 / (2 sigma^2)) * occ, 1e-10)``.

On the H100 the function is bound by operations, not bytes: at 388x584,
hsz 7, C 3 a pixel costs ~14 operations per weight and, for each field, a
sort's K2 log2 K2 compares and K2 adds, ~0.024 ms at the float32 peak,
against 2.3 us for its 7.6 MB.  The first design (one thread per
pixel, its 225 weights in shared memory) fit 4 warps per SM and ran at ~40
cycles per (round, sample) step.  The kernel now gives each pixel a group
of lanes (8 at hsz 7) that hold their samples' keys and weights in
registers, sums them per lane and then by a xor butterfly (bit-identical
in every lane, so the group branches as one and results repeat), and stops
each field's bisection exactly where 32 rounds would have ended.  A block
stages only the window planes in shared memory.  The plain twin sorts
(H, W, 225) patch stacks instead, ~1 GB of temporaries at 388x584.

A leading batch axis is one launch (grid z is the item).  Windows wider
than the register kernel's (hsz > 12), which the JAX package sends to its
sort route, run a second kernel of the same source: one warp a pixel, the
window's weights and keys in shared memory, the same sums and bisection.
"""
from __future__ import annotations

import math

import torch

from optical_flow_tpu_torch.ops.cuda.build import check, current_stream, load_library, require_cuda_f32

MAX_HSZ = 12  # the register kernel's widest window; wider ones run the wide kernel
launches = 0  # kernel launches (one per call, whatever the batch)
items = 0  # flows filtered by the kernel (B per call)


def wide_fits(hsz: int) -> bool:
    """Whether one warp's weights and keys of a (2 hsz + 1)^2 window fit the
    H100's 232,448 B of shared memory a block (``wide_warps`` in csrc/wmedian.cu)."""
    return 8 * (2 * hsz + 1) ** 2 <= 232448


def _patch_stack(padded, H, W, k):
    """(H+2h, W+2h) padded -> (H, W, k*k) shifted views, offset order dy-major."""
    return padded.unfold(0, k, 1).unfold(1, k, 1).reshape(H, W, k * k)


def _weighted_median_lastaxis(values, weights):
    """Weighted median along the last axis: the first sorted sample whose
    cumulative weight reaches half the total.  The sort is stable, as
    ``lax.sort`` is, so tied values keep their weights' order."""
    v_sorted, order = torch.sort(values, dim=-1, stable=True)
    w_sorted = torch.gather(weights, -1, order)
    cumw = torch.cumsum(w_sorted, dim=-1)
    total = cumw[..., -1:]
    idx = torch.argmax((cumw >= total / 2.0).to(torch.uint8), dim=-1, keepdim=True)
    return torch.gather(v_sorted, -1, idx)[..., 0]


def wmedfilt_prepadded(u_pad, v_pad, occ_pad, color_pad, color_center, H, W, hsz, sigma_i):
    """Plain twin on pre-padded fields: (H+2h, W+2h) u, v, occ, (H+2h, W+2h, C)
    guide and the (H, W, C) guide at the output pixels -> (H, W, 2).

    Rows run in chunks of at most 64 Mi patch-stack elements each.
    """
    k = 2 * hsz + 1
    C = color_pad.shape[2]
    inv_2sigma2 = 1.0 / (2.0 * sigma_i**2)
    row_chunk = max(1, min(H, (64 * 1024 * 1024) // (W * k * k)))
    outs = []
    for r0 in range(0, H, row_chunk):
        rows = min(row_chunk, H - r0)
        sl = slice(r0, r0 + rows + 2 * hsz)
        up = _patch_stack(u_pad[sl], rows, W, k)
        vp = _patch_stack(v_pad[sl], rows, W, k)
        op = _patch_stack(occ_pad[sl], rows, W, k)
        cdiff = torch.zeros_like(op)
        for c in range(C):
            cp = _patch_stack(color_pad[sl, :, c], rows, W, k)
            center = color_center[r0 : r0 + rows, :, c][:, :, None]
            cdiff = cdiff + (cp - center) ** 2
        w = torch.clamp(torch.exp(-cdiff * inv_2sigma2) * op, min=1e-10)
        outs.append(torch.stack([_weighted_median_lastaxis(up, w), _weighted_median_lastaxis(vp, w)], dim=-1))
    return torch.cat(outs, dim=0)


def wmedian_plain(u_pad, v_pad, occ_pad, guide_pad, out_hw, hsz, sigma_i):
    """The plain twin with the kernel's signature (guide channel-major), item
    by item over a leading batch axis."""
    if u_pad.ndim == 3:
        return torch.stack([wmedian_plain(*item, out_hw, hsz, sigma_i)
                            for item in zip(u_pad, v_pad, occ_pad, guide_pad)])
    H, W = out_hw
    color_pad = guide_pad.permute(1, 2, 0)
    color_center = color_pad[hsz : hsz + H, hsz : hsz + W]
    return wmedfilt_prepadded(u_pad, v_pad, occ_pad, color_pad, color_center, H, W, hsz, float(sigma_i))


def wmedian(u_pad, v_pad, occ_pad, guide_pad, out_hw, hsz: int, sigma_i: float):
    """Weighted median of both flow fields -> (..., H, W, 2).

    ``u_pad``, ``v_pad``, ``occ_pad``: (..., H+2h, W+2h) mirror-padded
    fields; ``guide_pad``: (..., C, H+2h, W+2h) padded guide, with the same
    leading batch axes.  CPU tensors run the plain twin; contiguous float32
    CUDA tensors run the kernel (the wide kernel above hsz 12); anything else
    raises.
    """
    global launches, items
    if u_pad.device.type == "cpu":
        return wmedian_plain(u_pad, v_pad, occ_pad, guide_pad, out_hw, hsz, sigma_i)
    require_cuda_f32("wmedian", u_pad, v_pad, occ_pad, guide_pad)
    hsz = int(hsz)
    if hsz < 0 or not wide_fits(hsz):
        raise ValueError(f"wmedian: hsz must be >= 0 and its window fit one warp's shared memory, got {hsz}")
    H, W = int(out_hw[0]), int(out_hw[1])
    batch = tuple(u_pad.shape[:-2])
    C = guide_pad.shape[-3]
    for t in (u_pad, v_pad, occ_pad, guide_pad[..., 0, :, :]):
        if tuple(t.shape) != (*batch, H + 2 * hsz, W + 2 * hsz):
            raise ValueError(f"wmedian: padded planes must be {(*batch, H + 2 * hsz, W + 2 * hsz)}, "
                             f"got {tuple(t.shape)}")
    B = math.prod(batch)
    lib = load_library()
    out = torch.empty((*batch, H, W, 2), dtype=torch.float32, device=u_pad.device)
    with torch.cuda.device(u_pad.device):  # the library launches on the current device
        err = lib.wmedian_f32(
            u_pad.data_ptr(), v_pad.data_ptr(), occ_pad.data_ptr(), guide_pad.data_ptr(), out.data_ptr(),
            B, C, H, W, hsz, float(1.0 / (2.0 * sigma_i**2)), current_stream(u_pad.device),
        )
    check(err, "wmedian_f32")
    launches += 1
    items += B
    return out
