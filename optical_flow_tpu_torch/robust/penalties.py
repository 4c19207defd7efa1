"""Reference-compatible import path for the penalty functions (port of ``optical_flow_tpu/robust/penalties.py``).

Re-exports :mod:`optical_flow_tpu_torch.ops.penalties` under the reference's
``robust.penalties`` module path.
"""
from optical_flow_tpu_torch.ops.penalties import (  # noqa: F401
    PENALTIES,
    charbonnier,
    gaussian,
    geman_mcclure,
    generalized_charbonnier,
    huber,
    lorentzian,
    mixture,
    quadratic,
    spline_penalty,
    tdist,
    tdist_unnorm,
    tukey,
)
