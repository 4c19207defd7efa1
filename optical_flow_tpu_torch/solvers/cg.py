"""Flow-system solves (port of ``optical_flow_tpu/solvers/cg.py``).

``'pcg'`` is block-Jacobi PCG at rtol 1e-3 / maxiter 200; ``'backslash'``
(the reference's direct solve) maps, as in the JAX package, to the same
PCG at rtol 1e-7 / maxiter 1000.  Both go through
:func:`~optical_flow_tpu_torch.ops.cuda.cg_kernel.cg_solve`: the whole-PCG
kernel on the card, the plain twin :func:`pcg_solve_split` on the CPU.
``'sor'`` is red-black SOR (:func:`~optical_flow_tpu_torch.solvers.sor.sor_solve`,
plain PyTorch on either device).
"""
from __future__ import annotations

from optical_flow_tpu_torch.ops.cuda.cg_kernel import cg_solve, pcg_solve_split
from optical_flow_tpu_torch.ops.stencil import FlowSystem
from optical_flow_tpu_torch.solvers.sor import sor_solve

__all__ = ["pcg_solve_split", "solve_flow_system"]


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
    """Solve a :class:`FlowSystem` for the (H, W, 2) update field, from x0 = 0."""
    if solver == "pcg":
        return cg_solve(sys, pcg_rtol, pcg_maxiter)
    if solver == "backslash":
        return cg_solve(sys, backslash_rtol, backslash_maxiter)
    if solver == "sor":
        return sor_solve(sys, sor_omega, sor_max_iters, sor_tol)
    raise ValueError(f"Unknown solver: {solver}")
