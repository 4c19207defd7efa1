"""Whole-PCG flow solve: the CUDA kernel ``csrc/cg.cu`` and its plain twin.

Replaces the Pallas kernel ``_cg_kernel`` / ``cg_solve_pallas``
(``optical_flow_tpu/ops/pallas/cg_kernel.py``): block-Jacobi (per-pixel 2x2)
PCG on the coupled 2-field 5-point system, from x0 = 0, stopping when
``||r||^2 <= rtol^2 ||b||^2`` (tested before every iteration) or at
``maxiter``.

On the H100 an iteration is bound by latency and grid-wide
synchronisation, not arithmetic: it needs two grid-wide sums.  A solve is
one launch with the whole loop on the device, by one of two paths that
:func:`cg_plan` chooses from the shape and the card alone:

* ``resident``: one block per SM owns a band of rows and keeps the band's
  state in registers and shared memory for the whole solve; two grid
  barriers per iteration.  A system that one block holds runs as one block
  (``single``), with no grid barrier.
* ``streaming``: planes in global memory (L2), a grid-stride loop, three
  grid barriers per iteration; for systems too large to stay on chip.

A leading batch axis of B systems is one call, with each item's own
stopping test and trip count, as the Pallas kernel's batch grid axis
(``custom_vmap``) has.  :func:`cg_plan` chooses, from (B, H, W) and the
card alone: ``single`` (B blocks, one an item, one launch); ``resident``
with ``sms // B`` bands an item, all items in one launch, where every band
fits; else ``resident`` one item at a time (``items`` 1 in the plan: the
same kernel, launched once per item on the same stream); else
``streaming``, once per item.  An item's sums run over its own blocks
only, in one fixed order, so its bits depend only on its own band layout;
a batched launch loops while any item still iterates, a stopped item's
state frozen, so that every block reaches every grid barrier.

A resident launch that the card refuses raises; it never falls back.  The
plain twin below costs ~10 launches and a host sync per iteration; it
solves item by item.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from optical_flow_tpu_torch.ops.cuda.build import check, current_stream, device_limits, load_library, require_cuda_f32
from optical_flow_tpu_torch.ops.stencil import FlowSystem, system_apply_split, weighted_laplacian_diag

_MAX_BLOCKS = 2048  # kMaxBlocks in csrc/cg.cu (streaming kernel)
RES_THREADS = 256  # kResThreads in csrc/cg.cu
RES_MAX_BLOCKS = 256  # kResMaxBlocks in csrc/cg.cu
RES_STATIC_SMEM = 10240  # bytes kept for the kernel's static shared memory (9,600 used)
PPTS = (1, 2, 4, 8)  # pixels a thread (csrc/cg.cu instantiates these)

launches = 0  # device launches of the kernel (one a call, or one an item where the plan says so)
launches_resident = 0  # of which on the resident path (one block an item, or bands)
launches_resident_per_item = 0  # of those, launches of plans that take one item a launch
launches_streaming = 0  # of which on the streaming path (one an item)
items = 0  # systems solved by the kernel (B per call)
_last_items = {}  # device -> items of the last call
_iters = {}  # device -> int32 (1 + B,): [running total, iterations of each item of the last call]


def reset_stats() -> None:
    """Zero the launch and item counts and the on-device iteration counts."""
    global launches, launches_resident, launches_resident_per_item, launches_streaming, items
    launches = launches_resident = launches_resident_per_item = launches_streaming = items = 0
    for buf in _iters.values():
        buf.zero_()


class CgPlan(NamedTuple):
    """How a batch of solves runs: ``path`` is "single", "resident" or
    "streaming"; ``blocks`` bands an item, ``ppt`` pixels a thread, ``smem``
    bytes of dynamic shared memory a block (0 on the streaming path) and
    ``items`` systems a launch (1: one launch per item)."""

    path: str
    blocks: int = 0
    ppt: int = 0
    smem: int = 0
    items: int = 1


def band_bounds(H: int, nb: int):
    """[(row0, rows)] of the ``nb`` bands of ``H`` rows, as ``band_of`` in
    csrc/cg.cu and csrc/rof.cu: the first ``H % nb`` bands take one row more."""
    base, extra = divmod(H, nb)
    return [(b * base + min(b, extra), base + (b < extra)) for b in range(nb)]


def resident_smem(rows: int, W: int) -> int:
    """Dynamic shared memory of a resident block of ``rows`` rows: p_u, p_v
    with two halo rows, the vertical weights with the row above, and eight
    planes of the band (horizontal weights, data block, preconditioner)."""
    return 4 * W * (2 * (rows + 2) + 2 * (rows + 1) + 8 * rows)


def _resident_bands(nb: int, H: int, W: int, limit: int):
    """(ppt, smem) of ``nb`` bands of an (H, W) system, or None if a band does not fit."""
    rows = -(-H // nb)
    for ppt in PPTS:
        if rows * W <= ppt * RES_THREADS and resident_smem(rows, W) <= limit:
            return ppt, resident_smem(rows, W)
    return None


def cg_plan(B: int, H: int, W: int, sms: int, smem_optin: int) -> CgPlan:
    """The path of B (H, W) solves on a card with ``sms`` SMs and
    ``smem_optin`` bytes of shared memory a block: one block an item if it
    holds the system; else ``sms // B`` bands an item, all in one launch, if
    every band fits; else one band per SM and one launch per item; else
    streaming.  B = 1 gives the plans of a single solve."""
    limit = smem_optin - RES_STATIC_SMEM
    if W < 65536:  # the kernel packs a pixel's row and column into 16 bits each
        for ppt in PPTS:
            if H * W <= ppt * RES_THREADS and resident_smem(H, W) <= limit:
                return CgPlan("single", 1, ppt, resident_smem(H, W), B)
        for nb, per_launch in ((min(sms // B, H, RES_MAX_BLOCKS // B), B), (min(sms, H, RES_MAX_BLOCKS), 1)):
            fit = _resident_bands(nb, H, W, limit) if nb >= 2 else None
            if fit is not None:
                return CgPlan("resident", nb, *fit, per_launch)
    return CgPlan("streaming")


def _device_key(device) -> torch.device:
    """``device`` with its index ("cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def iteration_counts(device) -> tuple:
    """(iterations of the last kernel call, summed over its items; iterations
    summed over every item since :func:`reset_stats`) on ``device``; reading
    them synchronises."""
    buf = _iters.get(_device_key(device))
    return sum(item_iterations(device)), 0 if buf is None else int(buf[0])


def item_iterations(device) -> list:
    """Each item's iterations in the last kernel call on ``device``; reading them synchronises."""
    device = _device_key(device)
    buf = _iters.get(device)
    return [] if buf is None else buf[1 : 1 + _last_items[device]].tolist()


def _block_jacobi_split(du, dv, a12):
    """Exact inverse of the per-pixel 2x2 block [[du, a12], [a12, dv]], acting on
    (ru, rv) plane pairs; the zeroed-inverse diagonal where the block is singular."""
    zero = torch.zeros((), dtype=du.dtype, device=du.device)
    one = torch.ones((), dtype=du.dtype, device=du.device)
    dinv_u = torch.where(torch.abs(du) > 1e-12, 1.0 / du, zero)
    dinv_v = torch.where(torch.abs(dv) > 1e-12, 1.0 / dv, zero)
    det = du * dv - a12 * a12
    ok = torch.abs(det) > 1e-12
    safe = torch.where(ok, det, one)
    i00 = torch.where(ok, dv / safe, dinv_u)
    i01 = torch.where(ok, -a12 / safe, zero)
    i11 = torch.where(ok, du / safe, dinv_v)
    return lambda ru, rv: (i00 * ru + i01 * rv, i01 * ru + i11 * rv)


def _dot2(au, av, bu, bv):
    return torch.sum(au * bu) + torch.sum(av * bv)


def pcg_solve_split(apply_A, bu, bv, du, dv, rtol, maxiter, *, a12, return_iters=False):
    """Plain twin: block-Jacobi PCG with channel-split (H, W) plane state, from x0 = 0.

    The classic recurrence of the JAX package's ``pcg_solve_split``; the
    stopping test reads ``||r||^2`` on the host every iteration.
    """
    xu, xv = torch.zeros_like(bu), torch.zeros_like(bv)
    precond = _block_jacobi_split(du, dv, a12)
    ru, rv = bu, bv
    zu, zv = precond(ru, rv)
    pu, pv = zu, zv
    rz = _dot2(ru, rv, zu, zv)
    tol2 = (rtol**2) * _dot2(bu, bv, bu, bv)
    zero = torch.zeros((), dtype=bu.dtype, device=bu.device)
    k = 0
    while k < maxiter and bool(_dot2(ru, rv, ru, rv) > tol2):
        Apu, Apv = apply_A(pu, pv)
        pAp = _dot2(pu, pv, Apu, Apv)
        alpha = torch.where(pAp != 0.0, rz / pAp, zero)
        xu = xu + alpha * pu
        xv = xv + alpha * pv
        ru = ru - alpha * Apu
        rv = rv - alpha * Apv
        zu, zv = precond(ru, rv)
        rz_new = _dot2(ru, rv, zu, zv)
        beta = torch.where(rz != 0.0, rz_new / rz, zero)
        pu = zu + beta * pu
        pv = zv + beta * pv
        rz = rz_new
        k += 1
    if return_iters:
        return xu, xv, k
    return xu, xv


def cg_solve_plain(sys: FlowSystem, rtol: float, maxiter: int):
    """The plain twin on a :class:`FlowSystem` of (..., H, W) planes, from
    x0 = 0, item by item; returns (..., H, W, 2)."""
    if sys.a11.ndim > 2:
        H, W = sys.a11.shape[-2:]
        flat = FlowSystem(*[f.reshape(-1, H, W) for f in sys])
        x = torch.stack([cg_solve_plain(FlowSystem(*item), rtol, maxiter) for item in zip(*flat)])
        return x.reshape(*sys.a11.shape, 2)
    du = sys.a11 + weighted_laplacian_diag(sys.wu_h, sys.wu_v)
    dv = sys.a22 + weighted_laplacian_diag(sys.wv_h, sys.wv_v)
    xu, xv = pcg_solve_split(
        lambda xu, xv: system_apply_split(sys, xu, xv),
        sys.b_u, sys.b_v, du, dv, rtol, maxiter, a12=sys.a12,
    )
    return torch.stack([xu, xv], dim=-1)


def cg_solve(sys: FlowSystem, rtol: float, maxiter: int):
    """Solve ``sys`` (planes (..., H, W): one system an item) from x0 = 0 and
    return the (..., H, W, 2) update.

    CPU tensors run the plain twin; contiguous float32 CUDA planes run the
    kernel; anything else raises.
    """
    global launches, launches_resident, launches_resident_per_item, launches_streaming, items
    if sys.a11.device.type == "cpu":
        return cg_solve_plain(sys, rtol, maxiter)
    planes = [f.contiguous() for f in sys]
    require_cuda_f32("cg_solve", *planes)
    H, W = planes[0].shape[-2:]
    B = planes[0].numel() // max(H * W, 1)
    plan = cg_plan(B, H, W, *device_limits(planes[0].device))
    x = launch(planes, rtol, maxiter, plan)
    n = device_launches(B, plan)
    launches += n
    items += B
    if plan.path == "streaming":
        launches_streaming += n
    else:
        launches_resident += n
        launches_resident_per_item += n if plan.items < B else 0
    return x


def device_launches(B: int, plan: CgPlan) -> int:
    """The device launches that :func:`launch` makes for B items on ``plan``:
    one for all, or one an item (streaming, and resident plans of one item
    a launch)."""
    return B if plan.path == "streaming" else -(-B // min(plan.items, B))


def _iteration_buffer(dev, B: int):
    """The device's iteration counts, room for B items; the running total kept."""
    buf = _iters.get(dev)
    if buf is None or buf.numel() < 1 + B:
        grown = torch.zeros(1 + max(B, 64), dtype=torch.int32, device=dev)
        if buf is not None:
            grown[0] = buf[0]
        _iters[dev] = buf = grown
    _last_items[dev] = B
    return buf


def launch(planes, rtol: float, maxiter: int, plan: CgPlan):
    """Launch the kernel of ``plan`` on nine contiguous float32 (..., H, W) CUDA
    planes; returns the (..., H, W, 2) solution.  :func:`cg_solve` is the
    entry point; ``chip_smoke.py`` calls this to time one path against another.
    The launch runs with the planes' card current: the library launches on
    the current device."""
    H, W = planes[0].shape[-2:]
    B = planes[0].numel() // max(H * W, 1)
    dev = planes[0].device
    lib = load_library()
    x = torch.empty((*planes[0].shape, 2), dtype=torch.float32, device=dev)
    iters = _iteration_buffer(dev, B)
    with torch.cuda.device(dev):
        if plan.path == "streaming":
            work = torch.empty((11, H, W), dtype=torch.float32, device=dev)
            partials = torch.empty(4 * _MAX_BLOCKS, dtype=torch.float64, device=dev)
            err = lib.cg_solve_f32(
                *[p.data_ptr() for p in planes], x.data_ptr(), work.data_ptr(), partials.data_ptr(),
                iters.data_ptr(), B, H, W, float(rtol) ** 2, int(maxiter), current_stream(dev),
            )
            check(err, "cg_solve_f32")
            return x
        zhalo = torch.empty((min(plan.items, B) * plan.blocks, 4, W), dtype=torch.float32, device=dev)
        partials = torch.empty(4 * RES_MAX_BLOCKS, dtype=torch.float64, device=dev)
        err = lib.cg_resident_f32(
            *[p.data_ptr() for p in planes], x.data_ptr(), zhalo.data_ptr(), partials.data_ptr(),
            iters.data_ptr(), B, H, W, float(rtol) ** 2, int(maxiter), plan.blocks, min(plan.items, B), plan.ppt,
            plan.smem, current_stream(dev),
        )
    check(err, "cg_resident_f32")
    return x
