"""Chebyshev semi-iteration for the flow system (port of ``optical_flow_tpu/solvers/chebyshev.py``).

The recurrence replaces PCG's inner products with a fixed three-term
recurrence driven by eigenvalue bounds [λmin, λmax] of the preconditioned
operator M⁻¹A: the iteration body has no reduction, and the stopping test
‖r‖ ≤ rtol‖b‖ runs once per ``check_every``-iteration block.  Its price is
iteration count (the minimax polynomial on the whole interval, not CG's
adaptive one): the JAX package measured ~1.9x CG's iterations, and uses it
only where a reduction costs a collective round, on a mesh
(``parallel/dist.py``, ``algo="cheby"``).

The bounds come from :func:`lanczos_bounds_split`: k steps of the
preconditioned Lanczos (PCG coefficient) recurrence, the eigenvalues of the
k x k tridiagonal taken on the host in float64 (numpy ``eigvalsh``, one
host read a solve), so that every process and device gets the same bounds
bit for bit, then widened (Ritz values lie inside the spectrum).

Both functions take plane pairs: two (H, W) tensors, or two sharded fields
(``parallel/dist.py::Shards``) with ``dot2`` and ``precond`` injected.
"""
from __future__ import annotations

import numpy as np
import torch

from optical_flow_tpu_torch.ops.cuda.cg_kernel import _block_jacobi_split, _dot2


def zeros_like(x):
    """Zeros in the layout of ``x``: a plane or a sharded field."""
    return torch.zeros_like(x) if torch.is_tensor(x) else x.zeros()


def lanczos_bounds_split(apply_A, precond, bu, bv, k: int = 12, widen: float = 1.05, shrink: float = 0.8,
                         dot2=None):
    """(λmin, λmax) of M⁻¹A from k Lanczos steps seeded with the right-hand side.

    The PCG alpha / beta recurrence from x0 = 0; the tridiagonal of M⁻¹A in
    the M-inner product (Saad §6.7.3), ``T[j,j] = 1/α_j + β_{j-1}/α_{j-1}``,
    ``T[j,j+1] = sqrt(β_j)/α_j``, assembled and solved in float64 on the
    host; its extreme eigenvalues, times ``shrink`` and ``widen``, as 0-d
    tensors of the planes' dtype on their (first) device.
    """
    dot2 = _dot2 if dot2 is None else dot2
    ref = bu if torch.is_tensor(bu) else bu[0]  # the scalars' dtype and device
    one = torch.ones((), dtype=ref.dtype, device=ref.device)
    zero = torch.zeros((), dtype=ref.dtype, device=ref.device)
    ru, rv = bu, bv
    zu, zv = precond(ru, rv)
    rz = dot2(ru, rv, zu, zv)
    pu, pv = zu, zv
    alphas, betas = [], []
    for _ in range(k):
        Apu, Apv = apply_A(pu, pv)
        pAp = dot2(pu, pv, Apu, Apv)
        alpha = torch.where(pAp != 0.0, rz / pAp, one)
        ru = ru - alpha * Apu
        rv = rv - alpha * Apv
        zu, zv = precond(ru, rv)
        rz2 = dot2(ru, rv, zu, zv)
        beta = torch.where(rz != 0.0, rz2 / rz, zero)
        pu = zu + beta * pu
        pv = zv + beta * pv
        rz = rz2
        alphas.append(alpha)
        betas.append(beta)
    ab = torch.stack(alphas + betas).to(torch.float64).cpu().numpy()  # the one host read
    a, b = ab[:k], ab[k:]
    safe_a = np.where(a != 0.0, a, 1.0)
    diag = 1.0 / safe_a
    diag[1:] += b[:-1] / safe_a[:-1]
    off = np.sqrt(np.maximum(b, 0.0)) / safe_a
    T = np.diag(diag) + np.diag(off[:-1], 1) + np.diag(off[:-1], -1)
    eig = np.linalg.eigvalsh(T)
    return (torch.tensor(eig[0] * shrink, dtype=ref.dtype, device=ref.device),
            torch.tensor(eig[-1] * widen, dtype=ref.dtype, device=ref.device))


def cheby_solve_split(apply_A, bu, bv, du, dv, lmin, lmax, rtol, maxiter, a12=None, check_every: int = 16,
                      dot2=None, precond=None, return_iters: bool = False):
    """Preconditioned Chebyshev iteration on channel-split state, from x0 = 0.

    The fixed point and stopping rule (‖r‖ ≤ rtol‖b‖) of PCG; the test
    reads ‖r‖² on the host once per ``check_every`` iterations, so a solve
    runs a multiple of ``check_every`` iterations.  Recurrence (Templates
    §5.3, Saad Alg. 12.1) on z = M⁻¹r with d = (λmax+λmin)/2 and
    c = (λmax−λmin)/2: β = (cα/2)², α ← 1/(d − β/α) (β = 0, α = 1/d the
    first time), p ← z + βp, x ← x + αp, r ← r − αAp.  Eigenvalues outside
    [lmin, lmax] stall the iteration, which then ends at ``maxiter``.
    ``precond`` defaults to the block-Jacobi inverse of (du, a12, dv).
    """
    dot2 = _dot2 if dot2 is None else dot2
    precond = _block_jacobi_split(du, dv, a12) if precond is None else precond
    d = (lmax + lmin) / 2.0
    c = (lmax - lmin) / 2.0
    xu, xv = zeros_like(bu), zeros_like(bv)
    Axu, Axv = apply_A(xu, xv)
    ru, rv = bu - Axu, bv - Axv
    tol2 = (rtol**2) * dot2(bu, bv, bu, bv)
    pu, pv = zeros_like(bu), zeros_like(bv)
    alpha = torch.zeros_like(d)
    zero, one = torch.zeros_like(d), torch.ones_like(d)
    k = 0
    while k < maxiter and bool(dot2(ru, rv, ru, rv) > tol2):
        for _ in range(check_every):
            zu, zv = precond(ru, rv)
            first = alpha == 0.0
            beta = torch.where(first, zero, (c * alpha / 2.0) ** 2)
            alpha = 1.0 / (d - beta / torch.where(first, one, alpha))
            pu = zu + beta * pu
            pv = zv + beta * pv
            Apu, Apv = apply_A(pu, pv)
            xu = xu + alpha * pu
            xv = xv + alpha * pv
            ru = ru - alpha * Apu
            rv = rv - alpha * Apv
        k += check_every
    if return_iters:
        return xu, xv, k
    return xu, xv
