"""Level-rollback guard (port of ``optical_flow_tpu/utils/guard.py``).

A pyramid level whose result is not finite, or exceeds ``max_flow`` in
magnitude anywhere, rolls back to the flow it started from; a start that
is itself unhealthy becomes zero flow, so a guarded result never exceeds
``max_flow``.  1e9 is the natural threshold: the metrics treat |f| >= 1e9
as unknown flow.  The test is one reduction to a 0-d device bool and the
rollback a ``torch.where`` on it: the guard reads nothing on the host and
adds no synchronisation to a frame.  Off (``guard_flow=None``) on every
method class; the ``classic-c-a`` preset turns it on at 1e9.
"""
from __future__ import annotations

import numpy as np
import torch


def flow_is_healthy(uv, max_flow: float):
    """0-d device bool: every component finite and ``|uv| <= max_flow``.

    NaN and ±inf both fail ``<=``, so one reduction does.
    """
    return torch.all(torch.abs(uv) <= max_flow)


def guard_level(uv_new, uv_init, max_flow: float):
    """``uv_new`` if healthy, else ``uv_init`` if healthy, else zero flow.

    The whole field reverts, not single pixels: a divergent solve poisons
    its neighbourhood through the spatial term.
    """
    safe_init = torch.where(flow_is_healthy(uv_init, max_flow), uv_init, 0.0)
    return torch.where(flow_is_healthy(uv_new, max_flow), uv_new, safe_init)


def guard_level_pair(uv_new, uvhat_new, uv_init, uvhat_init, max_flow: float):
    """Alt-BA's coupled (uv, uvhat) pair rolls back together: if either field
    is unhealthy, the other is already contaminated through the coupling."""
    ok = flow_is_healthy(uv_new, max_flow) & flow_is_healthy(uvhat_new, max_flow)
    init_ok = flow_is_healthy(uv_init, max_flow) & flow_is_healthy(uvhat_init, max_flow)
    safe_uv = torch.where(init_ok, uv_init, 0.0)
    safe_uvhat = torch.where(init_ok, uvhat_init, 0.0)
    return torch.where(ok, uv_new, safe_uv), torch.where(ok, uvhat_new, safe_uvhat)


def flow_health(uv) -> dict:
    """Host-side diagnostic summary (for logs): reads the field to the host."""
    arr = uv.detach().cpu().numpy() if torch.is_tensor(uv) else np.asarray(uv)
    finite = np.isfinite(arr)
    return {
        "finite_frac": float(finite.mean()),
        "max_abs": float(np.abs(arr[finite]).max()) if finite.any() else float("inf"),
        "healthy": bool(finite.all()),
    }
