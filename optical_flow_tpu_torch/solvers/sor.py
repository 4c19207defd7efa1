"""Red-black SOR for the coupled flow system (port of ``optical_flow_tpu/solvers/sor.py``).

Checkerboard colouring makes each half sweep an independent set of pixels;
within a pixel, u is updated first and v then sees the new u.  A sweep
stops the solve once ``||x_k - x_{k-1}|| < tol ||x_k||`` or after
``max_iters`` sweeps.

The JAX package tests that condition on the device (``lax.while_loop``).
Reading it on the host after every sweep would cost a synchronisation a
sweep, so sweeps run in chunks of :data:`CHUNK`: a device flag records the
first converged sweep, every later sweep of the chunk is masked out
(``torch.where(done, old, new)``), and the host reads the flag once a
chunk.  Result and sweep count equal the JAX loop's, with
``ceil(sweeps / CHUNK)`` host reads a solve.  Plain PyTorch, as the JAX
solver is XLA code and not a Pallas kernel.

Planes with leading batch axes are one system an item, as ``jax.vmap`` of
the JAX solver: each item tests its own ``delta`` and ``norm`` over its own
(H, W) planes, keeps its own flag and sweep count and is frozen once it
converges, and the chunks run while any item sweeps.  An item whose
right-hand side is zero (Horn–Schunck's batch gives an item that stopped
one) is solved by x0 = 0 and runs no sweep; the JAX loop would sweep it to
``max_iters`` without changing it.
"""
from __future__ import annotations

import torch

from optical_flow_tpu_torch.ops.stencil import FlowSystem, weighted_laplacian_apply, weighted_laplacian_diag

CHUNK = 8  # sweeps between two host reads of the convergence flag


def sor_solve(sys: FlowSystem, omega: float = 1.9, max_iters: int = 200, tol: float = 1e-2, return_iters=False):
    """Red-black SOR from x0 = 0 on (..., H, W) planes, returning the
    (..., H, W, 2) solution (and, with ``return_iters``, the sweeps run, read
    on the host: an int, or a list of each item's with batch axes)."""
    H, W = sys.a11.shape[-2:]
    dev = sys.a11.device
    ii = torch.arange(H, device=dev)[:, None]
    jj = torch.arange(W, device=dev)[None, :]
    red = ((ii + jj) % 2) == 0

    lap_du = weighted_laplacian_diag(sys.wu_h, sys.wu_v)
    lap_dv = weighted_laplacian_diag(sys.wv_h, sys.wv_v)
    du = sys.a11 + lap_du
    dv = sys.a22 + lap_dv
    ok_u = torch.abs(du) > 1e-15
    ok_v = torch.abs(dv) > 1e-15
    du_inv = torch.where(ok_u, 1.0 / du, 0.0)
    dv_inv = torch.where(ok_v, 1.0 / dv, 0.0)
    # the pixels each half sweep updates: its colour, where the diagonal is not ~0
    upd = [(red & ok_u, red & ok_v), (~red & ok_u, ~red & ok_v)]

    def half_sweep(u, v, upd_u, upd_v):
        # x_i <- (1 - w) x_i + w (b_i - sum_{j != i} A_ij x_j) / A_ii: the
        # off-diagonal row sum is the Laplacian less its diagonal plus a12 * (other field)
        Lu = weighted_laplacian_apply(sys.wu_h, sys.wu_v, u)
        off_u = (Lu - lap_du * u) + sys.a12 * v
        u_new = (1 - omega) * u + omega * (sys.b_u - off_u) * du_inv
        u = torch.where(upd_u, u_new, u)
        Lv = weighted_laplacian_apply(sys.wv_h, sys.wv_v, v)
        off_v = (Lv - lap_dv * v) + sys.a12 * u
        v_new = (1 - omega) * v + omega * (sys.b_v - off_v) * dv_inv
        v = torch.where(upd_v, v_new, v)
        return u, v

    u = torch.zeros_like(sys.b_u)
    v = torch.zeros_like(sys.b_v)
    # one flag and one sweep count an item; x0 = 0 solves a zero right-hand side
    done = ((sys.b_u == 0) & (sys.b_v == 0)).flatten(-2).all(-1)
    sweeps = torch.zeros(sys.a11.shape[:-2], dtype=torch.int64, device=dev)
    for start in range(0, int(max_iters), CHUNK):
        for _ in range(min(CHUNK, int(max_iters) - start)):
            u1, v1 = half_sweep(u, v, *upd[0])
            u1, v1 = half_sweep(u1, v1, *upd[1])
            delta = torch.sqrt(torch.sum((u1 - u) ** 2 + (v1 - v) ** 2, dim=(-2, -1)))
            norm = torch.sqrt(torch.sum(u1**2 + v1**2, dim=(-2, -1)))
            sweeps = sweeps + (~done).long()
            frozen = done[..., None, None]
            u = torch.where(frozen, u, u1)
            v = torch.where(frozen, v, v1)
            done = done | (delta < tol * norm)
        if bool(done.all()):
            break
    x = torch.stack([u, v], dim=-1)
    return (x, sweeps.tolist()) if return_iters else x
