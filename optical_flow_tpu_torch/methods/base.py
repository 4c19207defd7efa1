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
