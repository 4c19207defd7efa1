"""ROF structure component: the CUDA kernel ``csrc/rof.cu`` and its plain twin.

Replaces the Pallas kernels ``rof_structure_2d_pallas`` and
``rof_structure_2d_tiled`` (``optical_flow_tpu/ops/pallas/rof_kernel.py``),
which compute the same function at any size.

On the H100 an iteration (~28 flops per pixel) costs less than a launch,
so the iterations are bound by latency.  Two paths, which :func:`rof_plan`
chooses from the shape and the card alone:

* ``resident``: one cooperative launch for all iterations; each block keeps
  a band of rows of one image (image, dual field, primal) in shared memory
  and swaps one halo row each side with its neighbours at one grid barrier
  per iteration.
* ``streaming``: one fused launch per iteration over planes in global
  memory (L2 at the main path's size), for images too large for the first.

Both equal the plain twin bit for bit.  Every image of a leading batch axis
runs in the same launch.  A resident launch that the card refuses raises;
it never falls back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from optical_flow_tpu_torch.ops.cuda.build import check, current_stream, device_limits, load_library, require_cuda_f32

launches = 0  # kernel launches (one per wrapper call that runs the kernel)
launches_resident = 0  # of which on the resident path (one device launch)
launches_streaming = 0  # of which on the streaming path (n_iters + 1 device launches)


class RofPlan(NamedTuple):
    """``path`` "resident" (``per_image`` bands of rows for each image,
    ``smem`` bytes of dynamic shared memory a block) or "streaming"."""

    path: str
    per_image: int = 0
    smem: int = 0


def rof_smem(rows: int, W: int) -> int:
    """Dynamic shared memory of a resident block of ``rows`` rows: image, px
    and the primal on the band and the row below, py with a row each side."""
    return 4 * W * (3 * (rows + 1) + rows + 2)


def rof_plan(B: int, H: int, W: int, sms: int, smem_optin: int) -> RofPlan:
    """The path of a (B, H, W) call on a card with ``sms`` SMs and
    ``smem_optin`` bytes of shared memory a block: resident if each image's
    share of the SMs, one band each, holds every band in shared memory."""
    per_image = min(sms // B, H)
    if per_image >= 1:
        smem = rof_smem(-(-H // per_image), W)
        if smem <= smem_optin:
            return RofPlan("resident", per_image, smem)
    return RofPlan("streaming")


def _divergence(px, py):
    """Backward-difference divergence with zero boundary, over (..., H, W)."""
    return (px - F.pad(px[..., :, :-1], (1, 0))) + (py - F.pad(py[..., :-1, :], (0, 0, 1, 0)))


def _gradient(u):
    """Forward-difference gradient, zero at the far boundary."""
    gx = F.pad(u[..., :, 1:] - u[..., :, :-1], (0, 1))
    gy = F.pad(u[..., 1:, :] - u[..., :-1, :], (0, 0, 0, 1))
    return gx, gy


def rof_structure_2d(im, theta: float = 1.0 / 8, n_iters: int = 100):
    """Plain twin: structure component of every (H, W) image in ``im`` (..., H, W)."""
    delta = 1.0 / (4.0 * theta)
    px = torch.zeros_like(im)
    py = torch.zeros_like(im)
    for _ in range(n_iters):
        u = im + theta * _divergence(px, py)
        gx, gy = _gradient(u)
        px = px + delta * gx
        py = py + delta * gy
        norm = torch.clamp(torch.sqrt(px**2 + py**2), min=1.0)
        px = px / norm
        py = py / norm
    return im + theta * _divergence(px, py)


def rof_structure(im, theta: float = 1.0 / 8, n_iters: int = 100):
    """Structure component of (H, W) or (B, H, W) ``im``.

    A CPU tensor runs the plain twin; a contiguous float32 CUDA tensor runs
    the kernel; anything else raises.
    """
    global launches, launches_resident, launches_streaming
    if im.device.type == "cpu":
        return rof_structure_2d(im, theta, n_iters)
    require_cuda_f32("rof_structure", im)
    x = im if im.ndim == 3 else im.unsqueeze(0)
    plan = rof_plan(*x.shape, *device_limits(x.device))
    out = launch(x, theta, n_iters, plan)
    launches += 1
    if plan.path == "streaming":
        launches_streaming += 1
    else:
        launches_resident += 1
    return out.reshape(im.shape)


def launch(x, theta: float, n_iters: int, plan: RofPlan):
    """Launch the kernel(s) of ``plan`` on a contiguous float32 (B, H, W) CUDA
    tensor.  :func:`rof_structure` is the entry point; ``chip_smoke.py`` calls
    this to time one path against another.  The launch runs with ``x``'s
    card current: the library launches on the current device."""
    B, H, W = x.shape
    lib = load_library()
    out = torch.empty_like(x)
    stream = current_stream(x.device)
    with torch.cuda.device(x.device):
        if plan.path == "streaming":
            p = torch.zeros((4, B, H, W), dtype=torch.float32, device=x.device)
            err = lib.rof_structure_f32(x.data_ptr(), p.data_ptr(), out.data_ptr(), B, H, W,
                                        float(theta), int(n_iters), stream)
            check(err, "rof_structure_f32")
            return out
        halo = torch.empty((2, B * plan.per_image, 3, W), dtype=torch.float32, device=x.device)
        err = lib.rof_resident_f32(x.data_ptr(), halo.data_ptr(), out.data_ptr(), B, H, W,
                                   float(theta), int(n_iters), plan.per_image, plan.smem, stream)
    check(err, "rof_resident_f32")
    return out
