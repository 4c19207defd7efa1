"""Flow evaluation metrics, Barron angular error + endpoint error (copy of ``optical_flow_tpu/evaluation/metrics.py``)."""
from __future__ import annotations

import numpy as np

UNKNOWN_FLOW_THRESH = 1e9


def flow_angular_error(tu, tv, u, v, border: int = 0):
    """Return (average angular error deg, std, average endpoint error)."""
    tu = np.asarray(tu, dtype=float)
    tv = np.asarray(tv, dtype=float)
    u = np.asarray(u, dtype=float)
    v = np.asarray(v, dtype=float)

    if border > 0:
        sl = np.s_[border:-border, border:-border]
        tu, tv, u, v = tu[sl], tv[sl], u[sl], v[sl]

    valid = (np.abs(tu) < UNKNOWN_FLOW_THRESH) & (np.abs(tv) < UNKNOWN_FLOW_THRESH)
    if not np.all(valid):
        tu, tv, u, v = tu[valid], tv[valid], u[valid], v[valid]

    # +1 homogeneous coordinate (Barron et al.)
    n_est = 1.0 / np.sqrt(u**2 + v**2 + 1.0)
    n_gt = 1.0 / np.sqrt(tu**2 + tv**2 + 1.0)
    cos_angle = np.clip((u * tu + v * tv + 1.0) * n_est * n_gt, -1.0, 1.0)
    ae = np.degrees(np.arccos(cos_angle))

    epe = np.sqrt((tu - u) ** 2 + (tv - v) ** 2)
    return float(np.mean(ae)), float(np.std(ae)), float(np.mean(epe))
