"""Distributed matrix-free PCG over a row-sharded image grid (port of ``optical_flow_tpu/parallel/dist.py``).

The flow system's stencil makes the distributed solve cheap: one radius-1
halo exchange per operator apply and inner products summed over the
shards (:func:`~optical_flow_tpu_torch.parallel.mesh.psum`), whether the
shards live in one process or in several.  The JAX package's sharded PCG
is XLA code too, so this is plain PyTorch: each shard's work is a few
launches on its own device.  Every inner product sums its products in
float64, as the PCG kernel's do, and is read on the host where the
recurrence needs it; the same gathered bits decide the stop in every
process.

Three recurrences, ``algo`` (default ``solvers/cg.py::CG_ALGO``, read on
each call), with their collective rounds an iteration:

* ``"classic"`` — block-Jacobi PCG: three psum rounds (p·Ap, r·z and the
  stopping test's ||r||²);
* ``"gear"`` — Chronopoulos–Gear (``solvers/cg.py::pcg_solve_split_gear``):
  its three scalars reduce in one stacked psum;
* ``"cheby"`` — Chebyshev semi-iteration (``solvers/chebyshev.py``):
  12 Lanczos steps with psum'd dots for the bounds, then one psum per
  16-iteration block, at 4 x maxiter.

Each iteration also makes one halo exchange (the operator apply).
``psum_rounds`` and ``halo_rounds`` count both kinds of round.

Functions suffixed ``_local`` take sharded fields (lists of this process's
row blocks, in shard order); :func:`solve_flow_system_sharded` is the
host-callable wrapper.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from optical_flow_tpu_torch.ops.cuda.cg_kernel import _block_jacobi_split
from optical_flow_tpu_torch.ops.stencil import FlowSystem, weighted_laplacian_apply, weighted_laplacian_diag
from optical_flow_tpu_torch.parallel.halo import halo_exchange_rows, halo_exchange_rows_multi
from optical_flow_tpu_torch.parallel.mesh import broadcast, gather_rows, psum, shard_rows, sharded_over
from optical_flow_tpu_torch.solvers import cg as _cg
from optical_flow_tpu_torch.solvers.chebyshev import cheby_solve_split, lanczos_bounds_split

solves = 0  # distributed solves since the counts were last set to 0
iterations = 0  # their PCG iterations, summed
psum_rounds = 0  # their psum rounds (one a reduction, whatever it carries)
halo_rounds = 0  # their halo exchanges (one an operator apply, the weights' one)


def reset_counts() -> None:
    """Set the solve, iteration and collective-round counts to 0."""
    global solves, iterations, psum_rounds, halo_rounds
    solves = iterations = psum_rounds = halo_rounds = 0


class Shards(tuple):
    """A sharded plane as one value of the solver recurrences: ``+`` and
    ``-`` act shard by shard, and a 0-d scalar multiplies every shard,
    copied to the shard's device."""

    def __add__(self, other):
        return Shards(a + b for a, b in zip(self, other))

    def __sub__(self, other):
        return Shards(a - b for a, b in zip(self, other))

    def __mul__(self, scalar):
        return Shards(scalar.to(a.device) * a for a in self)

    __rmul__ = __mul__

    def zeros(self):
        return Shards(torch.zeros_like(a) for a in self)


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


def _partial2(au, av, bu, bv):
    """One shard's sum(au bu) + sum(av bv), the products and sums in float64
    (a product of two float32 values is exact there)."""
    return torch.sum(au.double() * bu.double()) + torch.sum(av.double() * bv.double())


def _dot2(au, av, bu, bv):
    """sum(au bu) + sum(av bv) over every shard, on the first shard's device.

    As the PCG kernel sums: float64 partials, added in shard order, the
    total rounded to the fields' dtype, so that a float32 solve's scalars
    are the kernel's up to the order of double sums.  One psum round.
    """
    global psum_rounds
    psum_rounds += 1
    return psum([_partial2(*t) for t in zip(au, av, bu, bv)]).to(au[0].dtype)


def _dots3(ru, rv, uu, uv, wu, wv):
    """(r·u, w·u, r·r) over every shard in one stacked psum round (gear)."""
    global psum_rounds
    psum_rounds += 1
    parts = [torch.stack([_partial2(a, b, c, d), _partial2(e, f, c, d), _partial2(a, b, a, b)])
             for a, b, c, d, e, f in zip(ru, rv, uu, uv, wu, wv)]
    s = psum(parts).to(ru[0].dtype)
    return s[0], s[1], s[2]


def solve_flow_system_local(systems, rtol: float = 1e-3, maxiter: int = 200, algo=None) -> list:
    """PCG on a row-sharded :class:`FlowSystem`: ``systems`` holds each of
    this process's shards' (Hs, W) planes, in shard order.  Returns each
    shard's (Hs, W, 2) update.

    Channel-split as the twin: the state is (u, v) plane pairs.  The
    loop-invariant vertical edge weights are halo-extended once, before the
    loop; an operator apply moves the u and v strips in one exchange.  The
    scalars of the recurrence are computed on the first shard's device and
    copied to the others.  ``algo``: see the module docstring.
    """
    global solves, iterations, halo_rounds
    algo = _cg.check_algo(_cg.CG_ALGO if algo is None else algo)
    wu_v_e, wv_v_e = halo_exchange_rows_multi([[s.wu_v for s in systems], [s.wv_v for s in systems]], 1)
    halo_rounds += 1
    wu_h_p = [_zero_row_pad(s.wu_h) for s in systems]
    wv_h_p = [_zero_row_pad(s.wv_h) for s in systems]
    du = [s.a11 + weighted_laplacian_diag(h, v)[1:-1] for s, h, v in zip(systems, wu_h_p, wu_v_e)]
    dv = [s.a22 + weighted_laplacian_diag(h, v)[1:-1] for s, h, v in zip(systems, wv_h_p, wv_v_e)]

    def apply_A(xu, xv):
        global halo_rounds
        halo_rounds += 1
        xu_e, xv_e = halo_exchange_rows_multi([xu, xv], 1)
        yu, yv = [], []
        for k, s in enumerate(systems):
            yu.append(s.a11 * xu[k] + s.a12 * xv[k] + weighted_laplacian_apply(wu_h_p[k], wu_v_e[k], xu_e[k])[1:-1])
            yv.append(s.a12 * xu[k] + s.a22 * xv[k] + weighted_laplacian_apply(wv_h_p[k], wv_v_e[k], xv_e[k])[1:-1])
        return Shards(yu), Shards(yv)

    # a12 is per pixel: the block-Jacobi preconditioner shards freely
    precond = [_block_jacobi_split(a, b, s.a12) for a, b, s in zip(du, dv, systems)]

    def apply_M(ru, rv):
        zs = [p(a, b) for p, a, b in zip(precond, ru, rv)]
        return Shards(z[0] for z in zs), Shards(z[1] for z in zs)

    bu = Shards(s.b_u for s in systems)
    bv = Shards(s.b_v for s in systems)
    if algo == "gear":
        xu, xv, k = _cg.pcg_solve_split_gear(apply_A, bu, bv, None, None, rtol, maxiter, dots3=_dots3,
                                             precond=apply_M, return_iters=True)
    elif algo == "cheby":
        lo, hi = lanczos_bounds_split(apply_A, apply_M, bu, bv, k=12, dot2=_dot2)
        xu, xv, k = cheby_solve_split(apply_A, bu, bv, None, None, lo, hi, rtol, 4 * maxiter, dot2=_dot2,
                                      precond=apply_M, return_iters=True)
    else:
        xu, xv, k = _classic(apply_A, apply_M, bu, bv, rtol, maxiter)
    solves += 1
    iterations += k
    return [torch.stack([a, b], dim=-1) for a, b in zip(xu, xv)]


def _classic(apply_A, apply_M, bu, bv, rtol, maxiter):
    """Classic block-Jacobi PCG from x0 = 0 (the twin's recurrence) -> (xu, xv, iterations)."""
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
    return xu, xv, k


def solve_flow_system_sharded(sys: FlowSystem, mesh, rtol: float = 1e-3, maxiter: int = 200, algo=None):
    """Host-callable distributed solve of an (H, W) system whose rows divide
    over the mesh: each plane sharded by rows, the (H, W, 2) update gathered
    on the mesh's first device of this process (every process holds the
    whole system and gets the whole update)."""
    with sharded_over(mesh):
        planes = [shard_rows(f, mesh) for f in sys]
        systems = [FlowSystem(*fields) for fields in zip(*planes)]
        return gather_rows(solve_flow_system_local(systems, rtol, maxiter, algo), mesh.home)
