"""Li–Osher iterated median denoising, used by Alt-BA (port of ``optical_flow_tpu/ops/denoise.py``)."""
from __future__ import annotations

from optical_flow_tpu_torch.ops.filters import median_filter2d


def denoise_LO(un, mfsz, lambda_param, n_iters: int = 1):
    """``u <- medfilt(u + lambda (un - u))``, iterated ``n_iters`` times, from u = un.

    ``un`` is (..., H, W): every leading plane is filtered on its own (the
    scipy-``reflect`` boundary), so the two fields of a flow go in one call.
    ``mfsz`` is the window (int or (h, w)); None returns ``un``.
    """
    if mfsz is None:
        return un
    u = un
    for _ in range(int(n_iters)):
        u = median_filter2d(u + lambda_param * (un - u), mfsz, "reflect")
    return u
