"""The port's main path against the JAX package's ``estimate_flow`` in float32,
on a 48x64 RubberWhale crop (``torch_parity.SLICE_CROP32``; see
``test_torch_slice.py`` for why the crop is free of gray-rounding ties)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_parity import SLICE_CROP32, jax_flow, one_cpu_thread, port_flow, rubberwhale_crop  # noqa: E402,F401


def test_slice_matches_jax_float32():
    """XLA:CPU fuses the JAX program and contracts multiply-adds into FMAs
    while the port rounds every op, so the flows differ at float32 rounding:
    measured mean |d| 2.9e-6 px, 99th percentile 2.3e-5 px, max 8.8e-5 px.
    The bounds leave room for a weighted-median selection that flips to the
    neighbouring sample (seen on the 64x96 crop: max 0.18 px at a handful of
    pixels, mean 1.1e-4 px, AEPE equal to 1.3e-5)."""
    from optical_flow_tpu_torch.evaluation.metrics import flow_angular_error

    a, b, tu, tv = rubberwhale_crop(**SLICE_CROP32)
    uv_j = jax_flow(a, b, jnp.float32)
    uv_p = port_flow(a, b, torch.float32)
    assert uv_p.dtype == np.float32 and np.isfinite(uv_p).all()
    d = np.abs(uv_p - uv_j)
    assert d.mean() <= 1e-3 and np.quantile(d, 0.99) <= 1e-2 and d.max() <= 0.5
    aepe_j = flow_angular_error(tu, tv, uv_j[..., 0], uv_j[..., 1])[2]
    aepe_p = flow_angular_error(tu, tv, uv_p[..., 0], uv_p[..., 1])[2]
    assert abs(aepe_p - aepe_j) <= 1e-3
