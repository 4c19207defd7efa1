"""optical_flow_tpu_torch — the PyTorch / CUDA port of ``optical_flow_tpu``.

Every preset of the JAX package (the Classic+NL, BA, Horn–Schunck and
alt-BA families), every solver (``'pcg'``, ``'backslash'``, ``'sor'``) and
the level-rollback guard (``guard_flow``), from RGB or gray frames to flow
on NVIDIA H100s, through three CUDA kernels written by hand (weighted
median, whole-PCG solve, ROF): single pairs, batches, video, streams, and
in one process over several devices (a row-sharding ``mesh``, a batch x
space mesh, a pipeline of level groups).  Module names mirror the JAX package so
every function has an obvious counterpart; the JAX package is the
reference this one is tested against.  This package imports ``torch`` and
``numpy`` only — never JAX.
"""
from optical_flow_tpu_torch.config import available_methods, load_of_method, method_from_state
from optical_flow_tpu_torch.evaluation.metrics import flow_angular_error
from optical_flow_tpu_torch.interface import estimate_flow
from optical_flow_tpu_torch.parallel.pipeline import estimate_flow_pipelined
from optical_flow_tpu_torch.parallel.video import estimate_flow_stream, estimate_flow_video
from optical_flow_tpu_torch.solvers.direct import dense_solve
from optical_flow_tpu_torch.solvers.sor import sor_solve
from optical_flow_tpu_torch.utils.guard import flow_health

__all__ = [
    "available_methods",
    "dense_solve",
    "estimate_flow",
    "estimate_flow_pipelined",
    "estimate_flow_stream",
    "estimate_flow_video",
    "flow_angular_error",
    "flow_health",
    "load_of_method",
    "method_from_state",
    "sor_solve",
]
