"""Flow-system solves (port of ``optical_flow_tpu/solvers/cg.py``).

``'pcg'`` is block-Jacobi PCG at rtol 1e-3 / maxiter 200; ``'backslash'``
(the reference's direct solve) maps, as in the JAX package, to the same
PCG at rtol 1e-7 / maxiter 1000.  Both go through
:func:`~optical_flow_tpu_torch.ops.cuda.cg_kernel.cg_solve`: the whole-PCG
kernel on the card, the plain twin :func:`pcg_solve_split` on the CPU.
``'sor'`` is red-black SOR (:func:`~optical_flow_tpu_torch.solvers.sor.sor_solve`,
plain PyTorch on either device).  Both take planes with leading batch
axes, one system an item, each stopped or converged on its own.

``CG_ALGO`` (``OFTPU_CG_ALGO``, default ``"classic"``) is the JAX
package's choice of PCG recurrence: ``"gear"`` (Chronopoulos–Gear, its
three scalars independent, so a mesh reduces them in one collective round)
or ``"cheby"`` (Chebyshev semi-iteration, ``solvers/chebyshev.py``, no
reduction in the body).  Both pay only where a reduction crosses devices
(``parallel/dist.py``).  As in the JAX package the value is checked on
every solve, the card runs the PCG kernel whatever it is (as JAX's Pallas
route does), and the plain route on CPU tensors follows it.
"""
from __future__ import annotations

import os

import torch

from optical_flow_tpu_torch.ops.cuda.cg_kernel import _block_jacobi_split, _dot2, cg_solve, pcg_solve_split
from optical_flow_tpu_torch.ops.stencil import FlowSystem, system_apply_split, weighted_laplacian_diag
from optical_flow_tpu_torch.solvers.chebyshev import cheby_solve_split, lanczos_bounds_split, zeros_like
from optical_flow_tpu_torch.solvers.sor import sor_solve

__all__ = ["CG_ALGO", "check_algo", "pcg_solve", "pcg_solve_split", "pcg_solve_split_gear", "solve_flow_system"]

# 'classic' | 'gear' | 'cheby'; read on every solve (tests and callers may set it)
CG_ALGO = os.environ.get("OFTPU_CG_ALGO", "classic")
CG_ALGOS = ("classic", "gear", "cheby")


def check_algo(algo: str) -> str:
    """``algo`` if it names a recurrence; a misspelt name raises, on every route."""
    if algo not in CG_ALGOS:
        raise ValueError(f"Unknown CG algo {algo!r} (OFTPU_CG_ALGO?): expected one of {CG_ALGOS}")
    return algo


def _block_jacobi_stacked(diag, a12):
    """Preconditioner of (..., 2)-stacked state: the exact inverse of the
    per-pixel 2x2 block [[diag_u, a12], [a12, diag_v]], or the zeroed-inverse
    diagonal where the block is singular or ``a12`` is None."""
    zero = torch.zeros((), dtype=diag.dtype, device=diag.device)
    if a12 is None:
        dinv = torch.where(torch.abs(diag) > 1e-12, 1.0 / diag, zero)
        return lambda r: dinv * r
    split = _block_jacobi_split(diag[..., 0], diag[..., 1], a12)
    return lambda r: torch.stack(split(r[..., 0], r[..., 1]), dim=-1)


def _dot(a, b):
    return torch.sum(a * b)


def pcg_solve(apply_A, b, diag, rtol, maxiter, x0=None, dot=None, sync_axes=(), a12=None):
    """PCG on ``A x = b`` with (..., 2)-stacked state, block-Jacobi (2x2 per
    pixel) preconditioned; the JAX package's generic solver.

    ``apply_A`` maps a like-shaped tensor to a like-shaped tensor, ``diag``
    is diag(A) as (..., 2) (``ops.stencil.system_diag``) and ``a12`` the
    optional per-pixel u-v coupling (without it the preconditioner is the
    zeroed-inverse diagonal).  Starts from ``x0`` (default zero) and stops
    when ``dot(r, r) <= rtol^2 dot(b, b)``, read on the host before every
    iteration, or at ``maxiter``.  ``dot`` defaults to the sum of the
    elementwise product.  Plain PyTorch on either device: the flow levels
    solve through ``solve_flow_system`` and the PCG kernel.

    ``sync_axes`` (the JAX package's mesh axes whose groups must iterate in
    step under ``shard_map``) must be empty: the port has no ``shard_map``,
    its row-sharded solves run in ``parallel/dist.py``, and no caller of the
    JAX package sets it.  A non-empty value raises ``NotImplementedError``.
    """
    if sync_axes:
        raise NotImplementedError("pcg_solve(sync_axes=...): the port has no shard_map; see parallel/dist.py")
    dot = _dot if dot is None else dot
    x = torch.zeros_like(b) if x0 is None else x0
    precond = _block_jacobi_stacked(diag, a12)
    r = b - apply_A(x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    tol2 = (rtol**2) * dot(b, b)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    k = 0
    while k < maxiter and bool(dot(r, r) > tol2):
        Ap = apply_A(p)
        pAp = dot(p, Ap)
        alpha = torch.where(pAp != 0.0, rz / pAp, zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = torch.where(rz != 0.0, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
        k += 1
    return x


def pcg_solve_split_gear(apply_A, bu, bv, du, dv, rtol, maxiter, a12=None, dots3=None, precond=None,
                         return_iters: bool = False):
    """Chronopoulos–Gear block-Jacobi PCG on channel-split state, from x0 = 0.

    alpha and beta come from gamma = (r, u) and delta = (w, u), with
    u = M⁻¹r and w = Au both known before any scalar is needed::

        beta_k  = gamma_k / gamma_{k-1}
        alpha_k = gamma_k / (delta_k - beta_k * gamma_k / alpha_{k-1})

    so gamma, delta and the stopping test's ||r||² are independent sums:
    ``dots3(ru, rv, uu, uv, wu, wv) -> (r·u, w·u, r·r)`` computes the three
    together (one collective round on a mesh).  The fixed point, the
    preconditioner and the stopping rule (||r|| <= rtol ||b||, read on the
    host before every iteration) are classic PCG's; the iterates agree up
    to rounding.  ``precond`` defaults to the block-Jacobi inverse of
    (du, a12, dv).
    """
    precond = _block_jacobi_split(du, dv, a12) if precond is None else precond
    if dots3 is None:
        def dots3(ru, rv, uu, uv, wu, wv):
            return _dot2(ru, rv, uu, uv), _dot2(wu, wv, uu, uv), _dot2(ru, rv, ru, rv)

    xu, xv = zeros_like(bu), zeros_like(bv)
    Axu, Axv = apply_A(xu, xv)
    ru, rv = bu - Axu, bv - Axv
    uu, uv = precond(ru, rv)
    wu, wv = apply_A(uu, uv)
    gamma, delta, rr = dots3(ru, rv, uu, uv, wu, wv)
    tol2 = (rtol**2) * dots3(bu, bv, bu, bv, bu, bv)[2]
    zero = torch.zeros_like(gamma)
    alpha = torch.where(delta != 0.0, gamma / delta, zero)
    beta = zero
    pu, pv = zeros_like(bu), zeros_like(bv)
    su, sv = zeros_like(bu), zeros_like(bv)
    k = 0
    while k < maxiter and bool(rr > tol2):
        pu = uu + beta * pu
        pv = uv + beta * pv
        su = wu + beta * su
        sv = wv + beta * sv
        xu = xu + alpha * pu
        xv = xv + alpha * pv
        ru = ru - alpha * su
        rv = rv - alpha * sv
        uu, uv = precond(ru, rv)
        wu, wv = apply_A(uu, uv)
        gamma_new, delta, rr = dots3(ru, rv, uu, uv, wu, wv)
        beta = torch.where(gamma != 0.0, gamma_new / gamma, zero)
        denom = delta - beta * torch.where(alpha != 0.0, gamma_new / alpha, zero)
        alpha = torch.where(denom != 0.0, gamma_new / denom, zero)
        gamma = gamma_new
        k += 1
    if return_iters:
        return xu, xv, k
    return xu, xv


def solve_split_algo(sys: FlowSystem, rtol: float, maxiter: int, algo: str, return_iters: bool = False):
    """The plain ``"gear"`` or ``"cheby"`` solve of an (H, W) system from
    x0 = 0 -> (H, W, 2), as the JAX package's XLA route: Chebyshev with
    Lanczos bounds and 4 x ``maxiter`` (its ~1.9x iterations plus the
    block rounding)."""
    du = sys.a11 + weighted_laplacian_diag(sys.wu_h, sys.wu_v)
    dv = sys.a22 + weighted_laplacian_diag(sys.wv_h, sys.wv_v)

    def apply_A(xu, xv):
        return system_apply_split(sys, xu, xv)

    if algo == "gear":
        xu, xv, k = pcg_solve_split_gear(apply_A, sys.b_u, sys.b_v, du, dv, rtol, maxiter, a12=sys.a12,
                                         return_iters=True)
    else:
        lo, hi = lanczos_bounds_split(apply_A, _block_jacobi_split(du, dv, sys.a12), sys.b_u, sys.b_v)
        xu, xv, k = cheby_solve_split(apply_A, sys.b_u, sys.b_v, du, dv, lo, hi, rtol, 4 * maxiter, a12=sys.a12,
                                      return_iters=True)
    x = torch.stack([xu, xv], dim=-1)
    return (x, k) if return_iters else x


def _pcg(sys: FlowSystem, rtol: float, maxiter: int):
    """PCG of ``CG_ALGO`` on (..., H, W) planes: the kernel on the card, the
    plain recurrence on the CPU, item by item."""
    if CG_ALGO == "classic" or sys.a11.device.type != "cpu":
        return cg_solve(sys, rtol, maxiter)
    if sys.a11.ndim > 2:
        H, W = sys.a11.shape[-2:]
        flat = FlowSystem(*[f.reshape(-1, H, W) for f in sys])
        x = torch.stack([solve_split_algo(FlowSystem(*item), rtol, maxiter, CG_ALGO) for item in zip(*flat)])
        return x.reshape(*sys.a11.shape, 2)
    return solve_split_algo(sys, rtol, maxiter, CG_ALGO)


def solve_flow_system(
    sys: FlowSystem,
    solver: str = "pcg",
    pcg_rtol: float = 1e-3,
    pcg_maxiter: int = 200,
    backslash_rtol: float = 1e-7,
    backslash_maxiter: int = 1000,
    sor_omega: float = 1.9,
    sor_max_iters: int = 10000,
    sor_tol: float = 1e-2,
):
    """Solve a :class:`FlowSystem` for the (..., H, W, 2) update field, from x0 = 0."""
    check_algo(CG_ALGO)  # before any route: a misspelt value raises on the card too
    if solver == "pcg":
        return _pcg(sys, pcg_rtol, pcg_maxiter)
    if solver == "backslash":
        return _pcg(sys, backslash_rtol, backslash_maxiter)
    if solver == "sor":
        return sor_solve(sys, sor_omega, sor_max_iters, sor_tol)
    raise ValueError(f"Unknown solver: {solver}")
