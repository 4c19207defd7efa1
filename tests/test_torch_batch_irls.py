"""The batched BA and alt-BA families (the IRLS methods) against the JAX
package in float64 on the CPU and against the port's own single-pair calls.

The batch (``torch_parity.family_batch``) is the 24x32 crop of RubberWhale
and Hydrangea and a static pair, gray as the JAX package's
``preprocess_color_batch`` makes it.  JAX's side is its fused batched route
(``params={"fuse": True}``): ``jax.vmap`` of the whole-flow program.  Each
JAX level program takes seconds to compile, so the cases run fewer GNC
stages and warp iterations than their presets: ``ba`` two stages of three
warp iterations a level (both pyramids and both GNC alphas), the chaotic
presets one stage of one warp iteration (classic++, classic-c) or two
(classic-c-a), and classic-c and classic-c-a with the tight solve of
``tests/test_torch_alt_ba.py`` (rtol 1e-12, maxiter 8000): at the presets'
own schedules their systems amplify rounding, in the JAX package as in the
port.  The JAX batches are computed once for the module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import STATIC, jax_family_flows, one_cpu_thread, port_batched, port_single, t  # noqa: E402,F401

PARAMS = {"display": False}
TIGHT = {"backslash_rtol": 1e-12, "backslash_maxiter": 8000}
# label -> (method, params)
CASES = {
    "ba": ("ba", {"max_iters": 3, "gnc_iters": 2}),  # the texture route, the 'cubic' warp
    "classic++": ("classic++", {"max_iters": 1, "gnc_iters": 1}),  # the 'bi-cubic' warp
    "classic-c": ("classic-c", {"max_iters": 1, "gnc_iters": 1, **TIGHT}),  # Charbonnier
    "classic-c-a": ("classic-c-a", {"lambda2": 0.01, "max_iters": 2, "gnc_iters": 1, **TIGHT}),  # alt-BA
    "ba fc": ("ba-brightness", {"fc": True, "gnc_iters": 1}),  # the high-pass route: no preset takes it
}


@pytest.fixture(scope="module")
def batch():
    return jax_family_flows(CASES)


@pytest.mark.parametrize("label", list(CASES))
def test_batched_flow_matches_jax_and_the_single_pair_flows(batch, label):
    """Each item within 1e-6 px of JAX's fused batch and within 1e-12 px of
    the port's single-pair flow of the same pair (alt-BA: the auxiliary field)."""
    method, params = CASES[label]
    got = port_batched(batch["images"], method, params)
    assert got.shape == (3, 24, 32, 2) and got.dtype == np.float64
    for k in range(3):
        assert np.abs(got[k] - batch[label][k]).max() <= 1e-6, k
        single = port_single(batch["images"][k], method, params)
        np.testing.assert_allclose(got[k], single, rtol=0, atol=1e-12)
    assert np.abs(got[0]).max() > 0.1 and np.abs(got[STATIC]).max() < 1e-12  # a real flow; the still pair's 0


def test_rgb_batch_matches_jax(batch):
    """``estimate_flow_batched_rgb`` with ``ba-brightness`` (the high-pass case):
    the gray pairs (no Lab guide), then the batch; within 1e-6 px of JAX's
    batch of the same gray pairs, which is JAX's RGB route on the CPU."""
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched_rgb

    method, params = CASES["ba fc"]
    p = {**PARAMS, **params, "dtype": torch.float64}
    got = estimate_flow_batched_rgb(batch["im1"], batch["im2"], method, params=p, device="cpu").numpy()
    assert got.shape == (3, 24, 32, 2) and np.abs(got - batch["ba fc"]).max() <= 1e-6


@pytest.mark.parametrize("method,params", [
    ("ba-brightness", {"max_iters": 1}),
    ("classic-l", {"max_iters": 1}),
    ("classic-c-brightness", {"max_iters": 1, "gnc_iters": 1}),
    ("classic-c-a", {"max_iters": 2}),  # three GNC stages, lambda2 -> 100 diverges, the guard at 1e9
])
def test_other_presets_run_batched_as_their_single_pairs(batch, method, params):
    """Every other BA-family name of ``available_methods()``, and ``classic-c-a``
    at its defaults' three stages, runs batched, each item within 1e-12 px of
    its single-pair flow (one or two warp iterations a level, to keep the
    test short)."""
    got = port_batched(batch["images"], method, params)
    assert got.shape == (3, 24, 32, 2)
    for k in range(3):
        np.testing.assert_allclose(got[k], port_single(batch["images"][k], method, params), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["fc", "scale", "texture"])
def test_items_are_normalised_on_their_own(batch, kind):
    """A batch of one pair and the same pair at a quarter of its range plus 10
    through each of BA's three preprocessings: each item is normalised on its
    own, so both items get the same flow, each its single-pair flow."""
    pair = batch["images"][0]
    images = np.stack([pair, 0.25 * pair + 10.0])
    params = {"max_iters": 1, "gnc_iters": 1, "texture": kind == "texture", "fc": kind == "fc"}
    got = port_batched(images, "ba-brightness", params)
    np.testing.assert_allclose(got[1], got[0], rtol=0, atol=1e-9)
    for k in range(2):
        np.testing.assert_allclose(got[k], port_single(images[k], "ba-brightness", params), rtol=0, atol=1e-12)
    assert np.abs(got[0]).max() > 0.1


@pytest.mark.parametrize("op", ["denoise_LO", "add_coupling"])
def test_alt_ba_ops_on_a_batch_match_jax_vmap(op):
    """alt-BA's Li–Osher denoising (both fields of every item in one call) and
    coupling on a (B, H, W, 2) batch, against ``jax.vmap`` of the JAX ops."""
    import jax
    import jax.numpy as jnp

    from optical_flow_tpu.ops import denoise as dj, stencil as sj
    from optical_flow_tpu_torch.ops import denoise as dp, stencil as sp

    rng = np.random.default_rng(2)
    uv = rng.normal(0, 1.5, (3, 13, 17, 2))
    if op == "denoise_LO":
        def one(u):
            return jnp.stack([dj.denoise_LO(u[..., c], (5, 5), 0.3, 5) for c in range(2)], axis=-1)

        ref = np.asarray(jax.vmap(one)(jnp.asarray(uv)))
        got = dp.denoise_LO(t(uv).movedim(-1, -3), (5, 5), 0.3, 5).movedim(-3, -1).numpy()
        np.testing.assert_array_equal(got, ref)
    else:
        fields = [rng.uniform(0.1, 1.0, (3, 13, 17)) for _ in range(9)]
        weight = rng.uniform(0, 1, (3, 13, 17, 2))
        ref = jax.vmap(lambda f, w: sj.add_coupling(sj.FlowSystem(*f), w))([jnp.asarray(f) for f in fields],
                                                                           jnp.asarray(weight))
        got = sp.add_coupling(sp.FlowSystem(*[t(f) for f in fields]), t(weight))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
