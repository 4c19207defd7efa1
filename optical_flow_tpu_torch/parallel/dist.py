"""Distributed matrix-free PCG over a row-sharded image grid (port of ``optical_flow_tpu/parallel/dist.py``).

The flow system's stencil makes the distributed solve cheap: one radius-1
halo exchange per operator apply and inner products summed over the
shards (:func:`~optical_flow_tpu_torch.parallel.mesh.psum`).  The
recurrence is the classic block-Jacobi PCG of the plain twin
(``ops/cuda/cg_kernel.py::pcg_solve_split``) from x0 = 0, with the global
``||r||^2`` read on the host once an iteration, as the twin reads it; its
inner products sum in float64, as the kernel's do.  The
JAX package's sharded PCG is XLA code too, so this is plain PyTorch: each
shard's work is a few launches on its own device.

Functions suffixed ``_local`` take sharded fields (lists of row blocks,
one a shard, in shard order); :func:`solve_flow_system_sharded` is the
host-callable wrapper.  The Chronopoulos–Gear and Chebyshev recurrences
(``algo="gear"`` / ``"cheby"``) are ROADMAP item 14c.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from optical_flow_tpu_torch.ops.cuda.cg_kernel import _block_jacobi_split
from optical_flow_tpu_torch.ops.stencil import FlowSystem, weighted_laplacian_apply, weighted_laplacian_diag
from optical_flow_tpu_torch.parallel.halo import halo_exchange_rows, halo_exchange_rows_multi
from optical_flow_tpu_torch.parallel.mesh import broadcast, gather_rows, psum, shard_rows

solves = 0  # distributed solves since the counts were last set to 0
iterations = 0  # their PCG iterations, summed


def _check_algo(algo) -> None:
    if algo in (None, "classic"):
        return
    if algo in ("gear", "cheby"):
        raise NotImplementedError(f"distributed PCG algo={algo!r}: the gear and cheby recurrences are ROADMAP item 14c")
    raise ValueError(f"unknown CG algo {algo!r}; expected 'classic', 'gear' or 'cheby'")


def _zero_row_pad(x):
    return F.pad(x, (0, 0, 1, 1))


def sharded_laplacian_apply_local(w_h, w_v, x) -> list:
    """Edge-weighted Laplacian of the sharded field ``x`` (radius-1 halo)."""
    x_e = halo_exchange_rows(x, 1)
    wv_e = halo_exchange_rows(w_v, 1)
    # the halo rows of w_h never reach the cropped interior rows
    return [weighted_laplacian_apply(_zero_row_pad(h), v, xe)[1:-1] for h, v, xe in zip(w_h, wv_e, x_e)]


def sharded_laplacian_diag_local(w_h, w_v) -> list:
    wv_e = halo_exchange_rows(w_v, 1)
    return [weighted_laplacian_diag(_zero_row_pad(h), v)[1:-1] for h, v in zip(w_h, wv_e)]


def _dot2(au, av, bu, bv):
    """sum(au bu) + sum(av bv) over every shard, on the first shard's device.

    As the PCG kernel sums: the products and sums in float64 (a product of
    two float32 values is exact there), the total rounded to the fields'
    dtype, so that a float32 solve's scalars are the kernel's up to the
    order of double sums.
    """
    parts = [torch.sum(a.double() * b.double()) + torch.sum(c.double() * d.double())
             for a, b, c, d in zip(au, bu, av, bv)]
    return psum(parts).to(au[0].dtype)


def solve_flow_system_local(systems, rtol: float = 1e-3, maxiter: int = 200, algo=None) -> list:
    """PCG on a row-sharded :class:`FlowSystem`: ``systems`` holds each
    shard's (Hs, W) planes, in shard order.  Returns each shard's
    (Hs, W, 2) update.

    Channel-split as the twin: the state is (u, v) plane pairs.  The
    loop-invariant vertical edge weights are halo-extended once, before the
    loop; an operator apply moves the u and v strips in one exchange.  The
    scalars of the recurrence are computed on the first shard's device and
    copied to the others.
    """
    global solves, iterations
    _check_algo(algo)
    wu_v_e, wv_v_e = halo_exchange_rows_multi([[s.wu_v for s in systems], [s.wv_v for s in systems]], 1)
    wu_h_p = [_zero_row_pad(s.wu_h) for s in systems]
    wv_h_p = [_zero_row_pad(s.wv_h) for s in systems]
    du = [s.a11 + weighted_laplacian_diag(h, v)[1:-1] for s, h, v in zip(systems, wu_h_p, wu_v_e)]
    dv = [s.a22 + weighted_laplacian_diag(h, v)[1:-1] for s, h, v in zip(systems, wv_h_p, wv_v_e)]

    def apply_A(xu, xv):
        xu_e, xv_e = halo_exchange_rows_multi([xu, xv], 1)
        yu, yv = [], []
        for k, s in enumerate(systems):
            yu.append(s.a11 * xu[k] + s.a12 * xv[k] + weighted_laplacian_apply(wu_h_p[k], wu_v_e[k], xu_e[k])[1:-1])
            yv.append(s.a12 * xu[k] + s.a22 * xv[k] + weighted_laplacian_apply(wv_h_p[k], wv_v_e[k], xv_e[k])[1:-1])
        return yu, yv

    # a12 is per pixel: the block-Jacobi preconditioner shards freely
    precond = [_block_jacobi_split(a, b, s.a12) for a, b, s in zip(du, dv, systems)]

    def apply_M(ru, rv):
        zs = [p(a, b) for p, a, b in zip(precond, ru, rv)]
        return [z[0] for z in zs], [z[1] for z in zs]

    bu = [s.b_u for s in systems]
    bv = [s.b_v for s in systems]
    xu = [torch.zeros_like(b) for b in bu]
    xv = [torch.zeros_like(b) for b in bv]
    ru, rv = bu, bv
    zu, zv = apply_M(ru, rv)
    pu, pv = zu, zv
    rz = _dot2(ru, rv, zu, zv)
    tol2 = (rtol**2) * _dot2(bu, bv, bu, bv)
    zero = torch.zeros((), dtype=rz.dtype, device=rz.device)
    k = 0
    while k < maxiter and bool(_dot2(ru, rv, ru, rv) > tol2):
        Apu, Apv = apply_A(pu, pv)
        pAp = _dot2(pu, pv, Apu, Apv)
        alpha = broadcast(torch.where(pAp != 0.0, rz / pAp, zero), bu)
        xu = [x + a * p for x, a, p in zip(xu, alpha, pu)]
        xv = [x + a * p for x, a, p in zip(xv, alpha, pv)]
        ru = [r - a * q for r, a, q in zip(ru, alpha, Apu)]
        rv = [r - a * q for r, a, q in zip(rv, alpha, Apv)]
        zu, zv = apply_M(ru, rv)
        rz_new = _dot2(ru, rv, zu, zv)
        beta = broadcast(torch.where(rz != 0.0, rz_new / rz, zero), bu)
        pu = [z + b * p for z, b, p in zip(zu, beta, pu)]
        pv = [z + b * p for z, b, p in zip(zv, beta, pv)]
        rz = rz_new
        k += 1
    solves += 1
    iterations += k
    return [torch.stack([a, b], dim=-1) for a, b in zip(xu, xv)]


def solve_flow_system_sharded(sys: FlowSystem, mesh, rtol: float = 1e-3, maxiter: int = 200, algo=None):
    """Host-callable distributed solve of an (H, W) system whose rows divide
    over the mesh: each plane sharded by rows, the (H, W, 2) update gathered
    on the mesh's first device."""
    planes = [shard_rows(f, mesh) for f in sys]
    systems = [FlowSystem(*fields) for fields in zip(*planes)]
    return gather_rows(solve_flow_system_local(systems, rtol, maxiter, algo), mesh.devices[0])
