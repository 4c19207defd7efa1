"""Reference-compatible import path for the robust penalty machinery (port of ``optical_flow_tpu/robust/``).

The reference exposes ``optical_flow.robust.robust_function.RobustFunction``
and ``optical_flow.robust.penalties``; this mirror keeps user code working
verbatim.  The implementation lives in :mod:`optical_flow_tpu_torch.ops.penalties`.
"""
from optical_flow_tpu_torch.robust.robust_function import PENALTY_MAP, RobustFunction

__all__ = ["RobustFunction", "PENALTY_MAP"]
