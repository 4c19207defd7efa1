"""Whole BA-family flows: ``estimate_flow(..., device="cpu")`` against the JAX
package's ``estimate_flow`` on the 48x64 RubberWhale crop
(``torch_parity.SLICE_CROP32``, free of gray-rounding ties), in float64,
max |d| <= 1e-6 px.

classic++ and classic-c-brightness run their full schedules in
``test_torch_flows_hs.py``: with ten warp iterations a level their
Charbonnier systems amplify rounding, in the JAX package as in the port.
Here they run the preset's every setting but the warp count, at which the
flows agree to rounding.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_parity import SLICE_CROP32, flows, rubberwhale_crop  # noqa: E402

# name -> the preset's overrides; the max |d| measured is in each comment
CASES = {
    "ba": {},  # the 'cubic' B-spline warp, Lorentzian penalties: 1.8e-12 px
    "ba-brightness": {},  # the 'scale' route: 1.9e-14 px
    "classic++": {"max_iters": 3},  # the 'bi-cubic' warp, generalized Charbonnier: 8.4e-8 px
    "classic-c-brightness": {"max_iters": 1},  # Charbonnier on the 'scale' route: 1.5e-9 px
}


@pytest.mark.parametrize("name", list(CASES))
def test_ba_family_flow_matches_jax_float64(name):
    a, b, _, _ = rubberwhale_crop(**SLICE_CROP32)
    uv_j, uv_p = flows(a, b, name, {"display": False, **CASES[name]})
    assert uv_p.shape == (48, 64, 2) and uv_p.dtype == np.float64
    assert np.abs(uv_p - uv_j).max() <= 1e-6
    assert np.abs(uv_p).max() > 0.1  # a real flow, not a trivial one
