"""Base class of the optical flow methods (port of ``optical_flow_tpu/methods/base.py``).

Mutable attribute configuration plus ``parse_input_parameter``, as in the
JAX package.  The compute dtype is a torch dtype (float32 by default;
float64 for the CPU parity tests).
"""
from __future__ import annotations

import numpy as np
import torch

from optical_flow_tpu_torch.ops.derivatives import DEFAULT_DERIV_FILTER
from optical_flow_tpu_torch.ops.filters import median_filter2d
from optical_flow_tpu_torch.ops.penalties import Robust


def median_pair(uv, size):
    """Median-filter both fields of the (..., H, W, 2) flow (scipy-'reflect' boundary) in one call."""
    return median_filter2d(uv.movedim(-1, -3), size, "reflect").movedim(-3, -1)


class BaseOpticalFlow:
    """Shared mutable configuration."""

    # whether estimate_flow(mesh=) can run this family's levels on the row
    # shards (parallel/spatial.py); a mesh for a family that cannot raises
    spatial_mesh_supported = False

    def __init__(self):
        self.images = None
        self.lambda_ = 1.0
        self.lambda_q = 1.0
        self.solver = "backslash"
        self.pcg_rtol = 1e-3
        self.pcg_maxiter = 200
        self.backslash_rtol = 1e-7
        self.backslash_maxiter = 1000
        self.sor_max_iters = 10000
        self.sor_omega = 1.9
        self.sor_tol = 1e-2
        self.interpolation_method = "cubic"
        self.deriv_filter = np.array(DEFAULT_DERIV_FILTER)
        self.blend = 0.5
        self.texture = False
        self.fc = False
        self.median_filter_size = None
        self.limit_update = True
        self.display = False
        self.color_images = None
        self.auto_level = True
        self.alp = 0.95
        self.dtype = torch.float32
        # dtype of the returned flow (e.g. 'float16'); None = the compute dtype
        self.out_dtype = None
        # level-rollback threshold (utils/guard.py); None = off
        self.guard_flow = None
        # called as checkpoint(stage, level, uv) after every pyramid level
        # (utils/checkpoint.FlowCheckpointer); it reads the flow on the host
        self.checkpoint = None
        # row sharding: a parallel.mesh.flow_mesh runs every level that tiles
        # on the mesh's row shards (parallel/spatial.py); spatial_halo is the
        # largest warp displacement read exactly across a shard edge: "auto"
        # sizes it a level from the incoming flow (_resolve_spatial_halo)
        self.spatial_mesh = None
        self.spatial_halo = "auto"

        self.pyramid_levels = 4
        self.pyramid_spacing = 2.0
        self.gnc_iters = 1
        self.gnc_pyramid_levels = 2
        self.gnc_pyramid_spacing = 1.25
        self.alpha = 1.0
        self.max_iters = 10
        self.max_linear = 1

        method = "quadratic"
        self.rho_spatial_u = [Robust(method, (1.0,)), Robust(method, (1.0,))]
        self.rho_spatial_v = [Robust(method, (1.0,)), Robust(method, (1.0,))]
        self.rho_data = Robust(method, (1.0,))

    def parse_input_parameter(self, params):
        """Set parameters from a dict or MATLAB-style [k, v, k, v, ...] list."""
        if isinstance(params, dict):
            items = params.items()
        elif isinstance(params, (list, tuple)):
            items = zip(params[0::2], params[1::2])
        else:
            return
        for key, val in items:
            attr = "lambda_" if key == "lambda" else key
            if hasattr(self, attr):
                setattr(self, attr, val)

    def _median_size(self):
        """``median_filter_size`` as an (h, w) tuple, or None."""
        mfs = self.median_filter_size
        if mfs is None:
            return None
        return (int(mfs[0]), int(mfs[1])) if hasattr(mfs, "__len__") else (int(mfs), int(mfs))

    def _resolve_spatial_halo(self, uv, max_growth: int) -> int:
        """The warp halo of a sharded level.

        ``"auto"`` reads the level's incoming flow bound (one host read a
        level) and adds ``max_growth``, the warp iterations: the ±1 update
        clip bounds the growth an iteration, so |uv| within the level never
        exceeds ceil(max|uv_in|) + iterations.  Rounded up to a multiple of 8.
        """
        h = self.spatial_halo
        if h != "auto":
            return int(h)
        if not bool(self.limit_update):
            # without the update clip no halo computed from |uv_in| is exact
            raise ValueError(
                "spatial_halo='auto' requires limit_update=True (the ±1 per-iteration update clip is what "
                "bounds flow growth within a level); set an explicit integer spatial_halo or re-enable "
                "limit_update."
            )
        m = float(torch.max(torch.abs(uv)))
        if not np.isfinite(m):
            m = 0.0
        req = int(np.ceil(m)) + int(max_growth)
        return max(8, -(-req // 8) * 8)

    def _spatial_halo_of(self, max_growth=None):
        """``uv -> halo`` of each level of a sharded flow, or None without a mesh;
        ``max_growth`` is the level's warp iterations (default ``max_iters``)."""
        if self.spatial_mesh is None:
            return None
        growth = self.max_iters if max_growth is None else max_growth
        return lambda uv: self._resolve_spatial_halo(uv, growth)

    def _solver_cfg(self):
        return (
            str(self.solver),
            float(self.pcg_rtol),
            int(self.pcg_maxiter),
            float(self.backslash_rtol),
            int(self.backslash_maxiter),
            float(self.sor_omega),
            int(self.sor_max_iters),
            float(self.sor_tol),
        )

    def compute_flow(self, images, color=None):
        raise NotImplementedError
