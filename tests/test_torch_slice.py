"""The port's main path end to end: ``estimate_flow(..., "classic+nl-fast", device="cpu")``
against the JAX package's ``estimate_flow`` on a RubberWhale crop, in float64.
The float32 comparison is in ``test_torch_slice_float32.py``, so that the two
JAX compiles run on different workers.

The crops (``torch_parity.SLICE_CROP``, 64x96 at row 220, column 200) have no
pixel whose gray value sits on an exact .5 tie: XLA:CPU contracts the jitted
JAX gray conversion's weighted sum into FMAs and rounds such ties up, where
eager JAX, NumPy, MATLAB and the port round them down
(``test_gray_ties_are_absent_from_the_crop`` pins the crops' choice;
``test_torch_ops.py`` pins the rounding rule).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_parity import (  # noqa: E402,F401
    MAIN_PATH_PARAMS, SLICE_CROP, SLICE_CROP32, jax_flow, one_cpu_thread, port_flow, rubberwhale_crop,
)


def test_gray_ties_are_absent_from_the_crop():
    import jax

    from optical_flow_tpu.utils.compat import rgb2gray

    a, b, _, _ = rubberwhale_crop(**SLICE_CROP)
    a32, b32, _, _ = rubberwhale_crop(**SLICE_CROP32)  # inside SLICE_CROP
    assert np.array_equal(a32, a[:48, :64]) and np.array_equal(b32, b[:48, :64])
    for im in (a, b):
        x = jnp.asarray(im)
        np.testing.assert_array_equal(np.asarray(jax.jit(rgb2gray)(x)), np.asarray(rgb2gray(x)))


def test_slice_matches_jax_float64():
    a, b, _, _ = rubberwhale_crop(**SLICE_CROP)
    uv_j = jax_flow(a, b, jnp.float64)
    uv_p = port_flow(a, b, torch.float64)
    assert uv_p.shape == (64, 96, 2) and uv_p.dtype == np.float64
    assert np.abs(uv_p - uv_j).max() <= 1e-6  # measured 3.3e-12


def test_known_answer_gray_shift():
    """A gray pair shifted one pixel right: u ~ +1, v ~ 0 away from the border."""
    rng = np.random.default_rng(42)
    im1 = rng.uniform(0, 255, (48, 64))
    im2 = np.roll(im1, 1, axis=1)
    uv = port_flow(im1, im2, torch.float64)
    inner = uv[8:-8, 8:-8]
    assert abs(inner[..., 0].mean() - 1.0) < 0.05
    assert abs(inner[..., 1].mean()) < 0.05


def test_device_is_explicit_and_out_dtype():
    from optical_flow_tpu_torch import estimate_flow

    a, b, _, _ = rubberwhale_crop(h=24, w=32, y0=220, x0=200)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            estimate_flow(a, b)  # the default device is the card; no CPU fallback
    uv = estimate_flow(a, b, "classic+nl-fast", {**MAIN_PATH_PARAMS, "out_dtype": "float16"}, device="cpu")
    assert uv.dtype == torch.float16 and uv.device.type == "cpu" and uv.shape == (24, 32, 2)
    # classic-c-a, which raised here before alt-BA was ported, runs on the CPU when asked
    uv = estimate_flow(a, b, "classic-c-a", {"max_iters": 1}, device="cpu")
    assert uv.dtype == torch.float32 and uv.shape == (24, 32, 2) and torch.isfinite(uv).all()
