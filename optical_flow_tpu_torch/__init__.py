"""optical_flow_tpu_torch — the PyTorch / CUDA port of ``optical_flow_tpu``.

The first slice: ``classic+nl-fast`` (and its ``classic+nl`` /
``classic+nl-full`` siblings) from RGB or gray frames to flow on one NVIDIA
H100, through three CUDA kernels written by hand (weighted median, whole-PCG
solve, ROF).  Module names mirror the JAX package so every function has an
obvious counterpart; the JAX package is the reference this one is tested
against.  This package imports ``torch`` and ``numpy`` only — never JAX.
"""
from optical_flow_tpu_torch.config import load_of_method, method_from_state
from optical_flow_tpu_torch.evaluation.metrics import flow_angular_error
from optical_flow_tpu_torch.interface import estimate_flow

__all__ = ["estimate_flow", "flow_angular_error", "load_of_method", "method_from_state"]
