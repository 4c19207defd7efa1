"""optical_flow_tpu_torch — the PyTorch / CUDA port of ``optical_flow_tpu``.

Every preset of the JAX package (the Classic+NL, BA, Horn–Schunck and
alt-BA families), every solver (``'pcg'``, ``'backslash'``, ``'sor'``) and
the level-rollback guard (``guard_flow``), from RGB or gray frames to flow
on NVIDIA H100s, through three CUDA kernels written by hand (weighted
median, whole-PCG solve, ROF): single pairs, batches, video, streams, and
over several devices (a row-sharding ``mesh``, a batch x space mesh, in one
process or across processes joined by ``torch.distributed``; a pipeline of
level groups in one process).  Module names mirror the JAX package so
every function has an obvious counterpart; the JAX package is the
reference this one is tested against.  This package imports ``torch`` and
``numpy`` only — never JAX.
"""
from optical_flow_tpu_torch.config import available_methods, load_of_method, method_from_state
from optical_flow_tpu_torch.evaluation.metrics import flow_angular_error
from optical_flow_tpu_torch.interface import estimate_flow
from optical_flow_tpu_torch.io.flo import read_flo, read_flow_file, write_flo
from optical_flow_tpu_torch.parallel.pipeline import estimate_flow_pipelined
from optical_flow_tpu_torch.parallel.video import estimate_flow_stream, estimate_flow_video
from optical_flow_tpu_torch.solvers.direct import dense_solve
from optical_flow_tpu_torch.solvers.sor import sor_solve
from optical_flow_tpu_torch.utils.guard import flow_health
from optical_flow_tpu_torch.viz.flow_color import compute_color, flow_to_color, make_colorwheel
from optical_flow_tpu_torch.viz.plot_flow import plot_flow

__version__ = "0.1.0"

__all__ = [
    "available_methods",
    "compute_color",
    "dense_solve",
    "estimate_flow",
    "estimate_flow_pipelined",
    "estimate_flow_stream",
    "estimate_flow_video",
    "flow_angular_error",
    "flow_health",
    "flow_to_color",
    "load_of_method",
    "make_colorwheel",
    "method_from_state",
    "plot_flow",
    "read_flo",
    "read_flow_file",
    "sor_solve",
    "write_flo",
]
