"""optical_flow_tpu_torch — the PyTorch / CUDA port of ``optical_flow_tpu``.

The Classic+NL, BA and Horn–Schunck families (every preset of the JAX
package but ``classic-c-a``) from RGB or gray frames to flow on one NVIDIA
H100, through three CUDA kernels written by hand (weighted median, whole-PCG
solve, ROF).  Module names mirror the JAX package so every function has an
obvious counterpart; the JAX package is the reference this one is tested
against.  This package imports ``torch`` and ``numpy`` only — never JAX.
"""
from optical_flow_tpu_torch.config import available_methods, load_of_method, method_from_state
from optical_flow_tpu_torch.evaluation.metrics import flow_angular_error
from optical_flow_tpu_torch.interface import estimate_flow

__all__ = ["available_methods", "estimate_flow", "flow_angular_error", "load_of_method", "method_from_state"]
