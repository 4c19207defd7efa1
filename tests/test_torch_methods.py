"""One pyramid level of BA and of Horn–Schunck against the JAX package's
level programs, in float64 on seeded inputs (the whole flows are in
``test_torch_flows_ba.py`` and ``test_torch_flows_hs.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_parity import j, n, one_cpu_thread, t  # noqa: E402,F401


def _level_inputs(rng, H=24, W=32):
    """A smooth textured pair shifted by about half a pixel, and a small flow."""
    y, x = np.mgrid[0:H, 0:W].astype(float)
    base = lambda dx: 128 + 60 * np.sin(0.45 * (x + dx)) * np.cos(0.3 * y) + 20 * np.cos(0.7 * (x + dx) + 0.2 * y)
    im1 = base(0.0) + rng.uniform(-2, 2, (H, W))
    im2 = base(-0.6) + rng.uniform(-2, 2, (H, W))
    uv = 0.2 * rng.standard_normal((H, W, 2))
    return np.stack([im1, im2], axis=2), uv


@pytest.mark.parametrize("name,stage", [("ba", 0), ("ba", 2), ("classic++", 1), ("classic-c-brightness", 0)])
def test_ba_level_step_matches_jax(rng, name, stage):
    """One level at the preset's settings and a GNC stage's alpha, three warp
    iterations (the full ten of a stiff preset amplify rounding, see
    ``test_torch_flows_hs.py``): max |d| <= 1e-9 px."""
    import dataclasses

    from optical_flow_tpu.config import load_of_method as lj
    from optical_flow_tpu.methods.ba import ba_level_step as sj
    from optical_flow_tpu_torch.config import load_of_method as lp
    from optical_flow_tpu_torch.methods.ba import ba_level_step as sp

    images, uv = _level_inputs(rng)
    plan_j, plan_p = lj(name)._make_plan((24, 32)), lp(name)._make_plan((24, 32))
    (cfg_j, alpha), (cfg_p, _) = plan_j.stages[stage], plan_p.stages[stage]
    cfg_j, cfg_p = dataclasses.replace(cfg_j, max_iters=3), dataclasses.replace(cfg_p, max_iters=3)
    out_j = sj(cfg_j, j(images), j(uv), jnp.asarray(alpha, jnp.float64))
    out_p = sp(cfg_p, t(images), t(uv), alpha)
    assert np.abs(n(out_p) - n(out_j)).max() <= 1e-9
    assert np.abs(n(out_p) - uv).max() > 1e-3  # the level moved the flow


@pytest.mark.parametrize("name", ["hs", "hs-brightness"])
def test_hs_level_step_matches_jax(rng, name):
    """A full level, median passes and early stop included: max |d| <= 1e-9 px."""
    from optical_flow_tpu.config import load_of_method as lj
    from optical_flow_tpu.methods.hs import hs_level_step as sj
    from optical_flow_tpu_torch.config import load_of_method as lp
    from optical_flow_tpu_torch.methods.hs import hs_level_step as sp

    images, uv = _level_inputs(rng)
    out_j = sj(lj(name)._level_cfg(), j(images), j(uv))
    out_p = sp(lp(name)._level_cfg(), t(images), t(uv))
    assert np.abs(n(out_p) - n(out_j)).max() <= 1e-9


def test_hs_early_stop_discards_the_small_update(rng):
    """A pair with no motion from a flow of zero: the first update's norm is
    below 1e-3, so the level returns its input untouched (no median pass)."""
    import optical_flow_tpu_torch.solvers.cg as cg_solvers
    from optical_flow_tpu.config import load_of_method as lj
    from optical_flow_tpu.methods.hs import hs_level_step as sj
    from optical_flow_tpu_torch.config import load_of_method as lp
    from optical_flow_tpu_torch.methods.hs import hs_level_step as sp

    images, _ = _level_inputs(rng)
    images[:, :, 1] = images[:, :, 0]
    uv = np.zeros((24, 32, 2))
    uv[3, 4] = [1e-5, -1e-5]  # a median pass would remove this spike
    solves = []
    call = cg_solvers.cg_solve

    def counting(sysm, rtol, maxiter):
        solves.append(sysm.a11.shape)
        return call(sysm, rtol, maxiter)

    cg_solvers.cg_solve = counting
    try:
        out_p = sp(lp("hs")._level_cfg(), t(images), t(uv))
    finally:
        cg_solvers.cg_solve = call
    out_j = sj(lj("hs")._level_cfg(), j(images), j(uv))
    assert len(solves) == 1
    np.testing.assert_array_equal(n(out_p), uv)
    np.testing.assert_array_equal(n(out_j), uv)
