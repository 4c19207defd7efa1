"""Whole Horn–Schunck flows, the gray-frame path, and classic++ at its full
schedule, against the JAX package's ``estimate_flow`` on the 48x64
RubberWhale crop (``torch_parity.SLICE_CROP32``)."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_parity import SLICE_CROP32, flows, one_cpu_thread, rubberwhale_crop  # noqa: E402,F401


def _aepe(uv, tu, tv):
    from optical_flow_tpu_torch.evaluation.metrics import flow_angular_error

    return flow_angular_error(tu, tv, uv[..., 0], uv[..., 1])[2]


@pytest.mark.parametrize("name", ["hs", "hs-brightness"])
def test_hs_flow_matches_jax_float64(name):
    """From RGB frames; max |d| <= 1e-6 px (measured 1.4e-14 and 1.5e-14)."""
    a, b, _, _ = rubberwhale_crop(**SLICE_CROP32)
    uv_j, uv_p = flows(a, b, name, {"display": False})
    assert uv_p.shape == (48, 64, 2) and uv_p.dtype == np.float64
    assert np.abs(uv_p - uv_j).max() <= 1e-6
    assert np.abs(uv_p).max() > 0.1


def test_gray_frames_reach_hs_as_in_jax():
    """Gray frames go in as they are (no quantisation, no guide): max |d| <= 1e-6 px."""
    a, b, _, _ = rubberwhale_crop(**SLICE_CROP32)
    ga, gb = a.mean(axis=2), b.mean(axis=2)  # float gray, not on the uint8 grid
    uv_j, uv_p = flows(ga, gb, "hs-brightness", {"display": False})
    assert np.abs(uv_p - uv_j).max() <= 1e-6


def test_classic_pp_full_schedule_float64():
    """classic++ at its full schedule (10 warp iterations a level, 'backslash'):
    its generalized-Charbonnier systems amplify rounding, so no two programs
    that round differently agree to 1e-6.  The JAX package moves 2.38 px
    from itself when lambda changes by one part in 1e14 (measured here).  The
    port is held to that scale: measured max |d| 2.31 px, mean 4.3e-3 px,
    99th percentile 0.065 px, AEPE 0.16452 against JAX's 0.16176 px."""
    a, b, tu, tv = rubberwhale_crop(**SLICE_CROP32)
    uv_j, uv_p = flows(a, b, "classic++", {"display": False})
    uv_j2, _ = flows(a, b, "classic++", {"display": False, "lambda_": 3 * (1 + 1e-14), "lambda_q": 3 * (1 + 1e-14)})
    assert np.abs(uv_j2 - uv_j).max() > 0.1  # the JAX package's own spread
    d = np.abs(uv_p - uv_j)
    assert d.mean() <= 0.02 and np.quantile(d, 0.99) <= 0.2
    assert abs(_aepe(uv_p, tu, tv) - _aepe(uv_j, tu, tv)) <= 1e-2


def test_classic_pp_float32():
    """float32, the card's type: XLA:CPU contracts multiply-adds into FMAs and
    the port rounds every op, and the full schedule amplifies that (see
    above).  Measured mean |d| 8.3e-3 px, 99th percentile 0.068 px, max
    2.36 px; AEPE 0.16354 against JAX's 0.16136 px."""
    a, b, tu, tv = rubberwhale_crop(**SLICE_CROP32)
    uv_j, uv_p = flows(a, b, "classic++", {"display": False, "dtype": "float32"})
    assert uv_p.dtype == np.float32 and np.isfinite(uv_p).all()
    d = np.abs(uv_p - uv_j)
    assert d.mean() <= 0.02 and np.quantile(d, 0.99) <= 0.2
    assert abs(_aepe(uv_p, tu, tv) - _aepe(uv_j, tu, tv)) <= 1e-2
