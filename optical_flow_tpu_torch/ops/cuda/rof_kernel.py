"""ROF structure component: the CUDA kernel ``csrc/rof.cu`` and its plain twin.

Replaces the Pallas kernels ``rof_structure_2d_pallas`` and
``rof_structure_2d_tiled`` (``optical_flow_tpu/ops/pallas/rof_kernel.py``),
which compute the same function at any size.

On the H100 an iteration (~28 flops per pixel) costs less than a launch
and less than a round trip of its planes through device memory, so the
iterations stay on chip.  Two paths, which :func:`rof_plan` chooses from
the shape and the card alone:

* ``resident``: one cooperative launch for all iterations; each block keeps
  a band of rows of one image (image, dual field, primal) in shared memory
  and swaps one halo row each side with its neighbours at one grid barrier
  per iteration.
* ``tiled``: the counterpart of ``_rof_tiled_call``, for images too large
  for the first: overlap-and-discard windows of ``WINDOW`` pixels, each a
  tile and a halo of ``halo`` pixels a side, run ``k <= halo`` iterations
  on chip a launch (``passes`` launches a call; the last writes the
  structure component).

Both equal the plain twin bit for bit.  Every image of a leading batch axis
runs in the same launch.  A launch that the card refuses raises; it never
falls back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from optical_flow_tpu_torch.ops.cuda.build import check, current_stream, device_limits, load_library, require_cuda_f32

launches = 0  # kernel launches (one per wrapper call that runs the kernel)
launches_resident = 0  # of which on the resident path (one device launch)
launches_tiled = 0  # of which on the tiled path (``passes`` device launches)

WINDOW = (96, 128)  # kWinRows, kWinCols in csrc/rof.cu: the rows and columns of a tiled block's window
TILED_THREADS = 1024  # kTiledThreads
MAX_HALO = 8  # the most iterations a tiled pass runs


class RofPlan(NamedTuple):
    """``path`` "resident" (``per_image`` bands of rows for each image,
    ``smem`` bytes of dynamic shared memory a block) or "tiled" (``smem``,
    a ``halo`` of pixels each side of a tile of ``tile`` rows and columns,
    ``passes`` launches)."""

    path: str
    per_image: int = 0
    smem: int = 0
    halo: int = 0
    passes: int = 0
    tile: tuple = (0, 0)


def rof_smem(rows: int, W: int) -> int:
    """Dynamic shared memory of a resident block of ``rows`` rows: image, px
    and the primal on the band and the row below, py with a row each side."""
    return 4 * W * (3 * (rows + 1) + rows + 2)


def tiled_smem() -> int:
    """Dynamic shared memory of a tiled block: the image, px and the primal of
    its window, py of each strip's last row."""
    rows, cols = WINDOW
    return 4 * cols * (3 * rows + TILED_THREADS // cols)


def tiled_schedule(n_iters: int, max_halo: int = MAX_HALO) -> tuple:
    """(halo, iterations of each pass) of ``n_iters`` iterations in passes of at
    most ``halo``, the last at most ``halo - 1`` (its primal reads p one
    pixel further): the fewest passes, then the smallest halo."""
    passes = -(-(n_iters + 1) // max_halo)
    halo = -(-(n_iters + 1) // passes)
    per, extra = divmod(n_iters, passes)
    return halo, [per + (q < extra) for q in range(passes)]


def tiled_plan(n_iters: int = 100) -> RofPlan:
    """The tiled path's plan for ``n_iters`` iterations (any shape)."""
    halo, iters = tiled_schedule(n_iters)
    return RofPlan("tiled", 0, tiled_smem(), halo, len(iters), (WINDOW[0] - 2 * halo, WINDOW[1] - 2 * halo))


def rof_plan(B: int, H: int, W: int, sms: int, smem_optin: int, n_iters: int = 100) -> RofPlan:
    """The path of a (B, H, W) call of ``n_iters`` iterations on a card with
    ``sms`` SMs and ``smem_optin`` bytes of shared memory a block: resident
    if each image's share of the SMs, one band each, holds every band in
    shared memory; else tiled."""
    per_image = min(sms // B, H)
    if per_image >= 1:
        smem = rof_smem(-(-H // per_image), W)
        if smem <= smem_optin:
            return RofPlan("resident", per_image, smem)
    return tiled_plan(n_iters)


def device_launches(plan: RofPlan) -> int:
    """The device launches of one call on ``plan``."""
    return plan.passes if plan.path == "tiled" else 1


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
    global launches, launches_resident, launches_tiled
    if im.device.type == "cpu":
        return rof_structure_2d(im, theta, n_iters)
    require_cuda_f32("rof_structure", im)
    x = im if im.ndim == 3 else im.unsqueeze(0)
    plan = rof_plan(*x.shape, *device_limits(x.device), n_iters)
    out = launch(x, theta, n_iters, plan)
    launches += 1
    if plan.path == "tiled":
        launches_tiled += 1
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
        if plan.path == "tiled":
            p = torch.empty((min(plan.passes - 1, 2) * 2, B, H, W), dtype=torch.float32, device=x.device)
            err = lib.rof_tiled_f32(x.data_ptr(), p.data_ptr(), out.data_ptr(), B, H, W, float(theta),
                                    int(n_iters), plan.halo, plan.passes, plan.smem, stream)
            check(err, "rof_tiled_f32")
            return out
        halo = torch.empty((2, B * plan.per_image, 3, W), dtype=torch.float32, device=x.device)
        err = lib.rof_resident_f32(x.data_ptr(), halo.data_ptr(), out.data_ptr(), B, H, W,
                                   float(theta), int(n_iters), plan.per_image, plan.smem, stream)
    check(err, "rof_resident_f32")
    return out
