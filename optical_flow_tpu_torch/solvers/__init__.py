from optical_flow_tpu_torch.solvers.cg import pcg_solve, solve_flow_system
from optical_flow_tpu_torch.solvers.sor import sor_solve

__all__ = ["pcg_solve", "solve_flow_system", "sor_solve"]
