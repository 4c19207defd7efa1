"""RobustFunction: reference-compatible constructor surface (port of ``optical_flow_tpu/robust/robust_function.py``).

``RobustFunction('lorentzian', 0.03)`` /
``RobustFunction('generalized_charbonnier', 1e-3, 0.45)``: positional
parameters like the reference, returning the frozen
:class:`~optical_flow_tpu_torch.ops.penalties.Robust` descriptor used
throughout the port.
"""
from optical_flow_tpu_torch.ops.penalties import PENALTIES as PENALTY_MAP
from optical_flow_tpu_torch.ops.penalties import Robust, robust


def RobustFunction(method: str, *args) -> Robust:
    return robust(method, *args)


__all__ = ["RobustFunction", "PENALTY_MAP", "Robust"]
