"""Alt-BA (``classic-c-a``): one level and the whole flow against the JAX
package, in float64 on the 40x44 smooth pair of ``tests/test_full_parity.py``
with its tight solver settings (backslash at rtol 1e-12, maxiter 8000)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_parity import j, jax_method_state, n, one_cpu_thread, t  # noqa: E402,F401

# the stable configuration of tests/test_full_parity.py: the preset's own
# default (lambda2 -> 100 over ten warp iterations) diverges by design
STABLE = {"lambda2": 0.01, "max_iters": 5, "gnc_iters": 2}


def _plain(val):
    """Comparable form of a level setting of either package."""
    if hasattr(val, "name") and hasattr(val, "params"):
        return (val.name, tuple(val.params))
    if isinstance(val, (list, tuple)):
        return tuple(_plain(v) for v in val)
    return val


def smooth_pair(rng, h=40, w=44):
    """``tests/test_full_parity.py::_smooth_pair``: a smoothed random frame and
    its one-pixel roll blended with smoothed noise, as an (h, w, 2) stack."""
    from scipy.ndimage import gaussian_filter

    base = gaussian_filter(rng.uniform(0, 255, (h, w)), 1.0)
    im1 = 255 * (base - base.min()) / np.ptp(base)
    im2 = 0.9 * np.roll(im1, 1, axis=1) + 0.1 * gaussian_filter(rng.uniform(0, 255, (h, w)), 1.0)
    return np.stack([im1, im2], axis=2)


def tight(ope, dtype, **settings):
    ope.dtype = dtype
    ope.backslash_rtol = 1e-12
    ope.backslash_maxiter = 8000
    ope.display = False
    for key, val in settings.items():
        setattr(ope, key, val)
    return ope


@pytest.fixture(scope="module")
def stable_case():
    """The pair and the JAX package's stable classic-c-a flow of it (one compile for the module)."""
    from optical_flow_tpu.config import load_of_method

    images = smooth_pair(np.random.default_rng(0))
    ope = tight(load_of_method("classic-c-a"), jnp.float64, **STABLE)
    ope.images = jnp.asarray(images)
    return images, np.asarray(ope.compute_flow())


@pytest.mark.parametrize("alpha,replacement", [(0.5, True), (0.0, False)])
def test_alt_ba_level_step_matches_jax(alpha, replacement):
    """One level of the preset at the stable lambda2 (annealing 1e-4 -> 0.01;
    at the preset's 100 the level diverges), five Li–Osher passes, the
    coupling from a uvhat unlike uv, three warp iterations, guard off: uv and
    uvhat within 1e-9 px.  The second case goes through ``compute_flow_base``."""
    from optical_flow_tpu.config import load_of_method as lj
    from optical_flow_tpu.methods.alt_ba import alt_ba_level_step as sj
    from optical_flow_tpu_torch.config import load_of_method as lp
    from optical_flow_tpu_torch.methods.alt_ba import alt_ba_level_step as sp

    rng = np.random.default_rng(1)
    images = smooth_pair(rng)
    uv = 0.3 * rng.standard_normal((40, 44, 2))
    uvhat = uv + 0.05 * rng.standard_normal((40, 44, 2))
    settings = {"max_iters": 3, "lambda2": 0.01, "guard_flow": None, "alpha": alpha, "replacement": replacement}
    oj = tight(lj("classic-c-a"), jnp.float64, **settings)
    op = tight(lp("classic-c-a"), torch.float64, **settings)
    cfg_j, cfg_p = oj._alt_cfg(), op._alt_cfg()
    assert cfg_p.irls.solver == cfg_j.irls.solver and cfg_p.iters_lo == 5 and cfg_p.lambda2 == 0.01
    uv_j, uvhat_j = sj(cfg_j, j(images), j(uv), j(uvhat), jnp.asarray(alpha, jnp.float64), jnp.asarray(replacement))
    if replacement:
        uv_p, uvhat_p = sp(cfg_p, t(images), t(uv), t(uvhat), alpha, replacement)
    else:
        op.images = t(images)
        uv_p, uvhat_p = op.compute_flow_base(t(uv), t(uvhat))
    assert np.abs(n(uv_p) - n(uv_j)).max() <= 1e-9
    assert np.abs(n(uvhat_p) - n(uvhat_j)).max() <= 1e-9
    assert np.abs(n(uvhat_p) - uvhat).max() > 1e-3  # the level moved the fields
    if replacement:
        np.testing.assert_array_equal(n(uv_p), n(uvhat_p))
    else:
        assert np.abs(n(uv_p) - n(uvhat_p)).max() > 1e-6


def test_alt_ba_stable_flow_matches_jax(stable_case):
    """The whole classic-c-a flow (texture, 3 + 2 levels, two GNC stages,
    replacement in the first) at the stable configuration: within 1e-6 px
    (measured 7.8e-12)."""
    from optical_flow_tpu_torch.config import load_of_method

    images, uv_j = stable_case
    ope = tight(load_of_method("classic-c-a"), torch.float64, **STABLE)
    ope.images = t(images)
    uv_p = ope.compute_flow().numpy()
    assert np.abs(uv_p - uv_j).max() <= 1e-6
    assert np.abs(uv_p).max() > 0.5  # a real flow


def test_method_from_state_carries_alt_ba(stable_case):
    """The port's object built from the JAX object's attributes gives the JAX flow."""
    from optical_flow_tpu_torch.config import method_from_state

    images, uv_j = stable_case
    state = jax_method_state("classic-c-a")
    assert state["__class__"] == "AltBAOpticalFlow" and state["guard_flow"] == 1e9
    ope = method_from_state({**state, "dtype": "float64"})
    assert ope.rho_couple.name == "charbonnier" and (ope.itersLO, ope.lambda2) == (5, 100.0)
    ope = tight(ope, torch.float64, **STABLE)
    ope.images = t(images)
    uv_p = ope.compute_flow().numpy()
    assert np.abs(uv_p - uv_j).max() <= 1e-6


def test_alt_ba_schedule_matches_jax():
    """Plans at the main-path size and at 40x44: levels, shapes, alphas,
    replacement flags and every level setting equal; 90 solves a frame at
    584x388."""
    from optical_flow_tpu.config import load_of_method as lj
    from optical_flow_tpu_torch.config import load_of_method as lp

    for sz in ((388, 584), (40, 44)):
        pj, pp = lj("classic-c-a")._make_alt_plan(sz), lp("classic-c-a")._make_alt_plan(sz)
        assert (pp.texture, pp.levels, pp.shapes, pp.gnc_levels, pp.gnc_shapes) == (
            pj.texture, pj.levels, pj.shapes, pj.gnc_levels, pj.gnc_shapes)
        assert [(a, r) for _, a, r in pp.stages] == [(a, r) for _, a, r in pj.stages]
        for (cp, _, _), (cj, _, _) in zip(pp.stages, pj.stages):
            assert (cp.rho_couple.name, cp.rho_couple.params, cp.lambda2, cp.lambda3, cp.iters_lo) == (
                cj.rho_couple.name, tuple(cj.rho_couple.params), cj.lambda2, cj.lambda3, cj.iters_lo)
            assert {k: _plain(v) for k, v in vars(cp.irls).items()} == {k: _plain(v) for k, v in vars(cj.irls).items()}
    plan = lp("classic-c-a")._make_alt_plan((388, 584))
    assert [r for _, _, r in plan.stages] == [True, True, False]
    assert (plan.levels + 2 * plan.gnc_levels) * plan.stages[0][0].irls.max_iters == 90
