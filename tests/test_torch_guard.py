"""The level-rollback guard, Alt-BA's coupling term and Li–Osher denoising
against the JAX package: the guard's functions on their own, inside the
BA, Classic+NL and Horn–Schunck level steps, and on the ``classic-c-a``
preset whose default trajectory diverges."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_parity import j, n, t  # noqa: E402


def _fields(case):
    """(new, init) flow fields of one guard case, as float64 numpy."""
    rng = np.random.default_rng(7)
    new = rng.uniform(-3, 3, (5, 6, 2))
    init = rng.uniform(-1, 1, (5, 6, 2))
    if case == "nan":
        new[2, 3, 1] = np.nan
    elif case == "+inf":
        new[0, 5, 0] = np.inf
    elif case == "over":
        new[4, 0, 0] = -2e9
    elif case == "unhealthy init":
        new[1, 1, 0] = np.nan
        init[3, 2, 1] = 4e9
    return new, init


GUARD_CASES = ["healthy", "nan", "+inf", "over", "unhealthy init"]


@pytest.mark.parametrize("case", GUARD_CASES)
def test_guard_equals_jax(case):
    from optical_flow_tpu.utils import guard as gj
    from optical_flow_tpu_torch.utils import guard as gp

    new, init = _fields(case)
    assert bool(gp.flow_is_healthy(t(new), 1e9)) == bool(gj.flow_is_healthy(j(new), 1e9)) == (case == "healthy")
    out_p, out_j = gp.guard_level(t(new), t(init), 1e9), gj.guard_level(j(new), j(init), 1e9)
    np.testing.assert_array_equal(n(out_p), n(out_j))
    expect = new if case == "healthy" else (np.zeros_like(init) if case == "unhealthy init" else init)
    np.testing.assert_array_equal(n(out_p), expect)
    # the pair: a sick field in either slot rolls both back
    hat = np.flip(new, axis=0).copy()
    for args in ((new, hat, init, 0.5 * init), (hat, new, 0.5 * init, init)):
        pp = gp.guard_level_pair(*[t(a) for a in args], 1e9)
        pj = gj.guard_level_pair(*[j(a) for a in args], 1e9)
        for a, b in zip(pp, pj):
            np.testing.assert_array_equal(n(a), n(b))
    assert gp.flow_health(t(new)) == gj.flow_health(new)


def test_add_coupling_equals_jax():
    from optical_flow_tpu.ops.stencil import FlowSystem as FJ, add_coupling as cj
    from optical_flow_tpu_torch.ops.stencil import FlowSystem as FP, add_coupling as cp

    rng = np.random.default_rng(3)
    planes = [rng.standard_normal((9, 11)) for _ in range(9)]
    weight = rng.uniform(0, 2, (9, 11, 2))
    out_p = cp(FP(*[t(p) for p in planes]), t(weight))
    out_j = cj(FJ(*[j(p) for p in planes]), j(weight))
    for a, b in zip(out_p, out_j):
        np.testing.assert_array_equal(n(a), n(b))
    np.testing.assert_array_equal(n(out_p.a11), planes[0] + weight[:, :, 0])
    np.testing.assert_array_equal(n(out_p.b_u), planes[7])  # the caller updates the right-hand side


@pytest.mark.parametrize("iters,mfsz,dtype", [
    (1, [5, 5], "float64"), (5, [5, 5], "float64"), (5, [3, 3], "float64"), (1, None, "float64"), (5, [5, 5], "float32"),
])
def test_denoise_LO_pair_call_equals_jax_per_field(iters, mfsz, dtype):
    """The port filters both fields in one call; JAX one field at a time, as
    Alt-BA calls it.  Equal bit for bit, NaNs included."""
    from optical_flow_tpu.ops.denoise import denoise_LO as dj
    from optical_flow_tpu_torch.ops.denoise import denoise_LO as dp

    rng = np.random.default_rng(11)
    uv = rng.standard_normal((17, 23, 2)).astype(dtype)
    uv[rng.uniform(size=uv.shape) < 0.01] = np.nan
    lam = np.asarray(0.37, dtype)  # a compute-dtype value, as Alt-BA's lambda2 / lambda3
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out_p = dp(t(uv, tdt).permute(2, 0, 1), mfsz, float(lam), iters).permute(1, 2, 0)
    out_j = np.stack([np.asarray(dj(j(uv[:, :, c], jdt), mfsz, jnp.asarray(lam), iters)) for c in range(2)], -1)
    assert n(out_p).dtype == out_j.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(n(out_p), out_j)
    if mfsz is None:
        np.testing.assert_array_equal(n(out_p), uv)


def _level_case(family, guard):
    """(port step, JAX step) closures over one level of ``family`` at ``guard``,
    two warp iterations (three for hs's early-stopped loop), and the inputs."""
    from optical_flow_tpu.config import load_of_method as lj
    from optical_flow_tpu_torch.config import load_of_method as lp

    rng = np.random.default_rng(5)
    H, W = 24, 32
    y, x = np.mgrid[0:H, 0:W].astype(float)
    base = lambda dx: 128 + 60 * np.sin(0.45 * (x + dx)) * np.cos(0.3 * y) + 20 * np.cos(0.7 * (x + dx) + 0.2 * y)
    images = np.stack([base(0.0), base(-0.6)], axis=2) + rng.uniform(-2, 2, (H, W, 2))
    color = rng.uniform(0, 255, (H, W, 3))
    params = {"display": False, "guard_flow": guard, "max_iters": 2, "max_warping_iters": 3}
    oj, op = lj(family), lp(family)
    for o in (oj, op):
        o.parse_input_parameter(params)
    if family == "hs":
        from optical_flow_tpu.methods.hs import hs_level_step as sj
        from optical_flow_tpu_torch.methods.hs import hs_level_step as sp

        cj, cp = oj._level_cfg(), op._level_cfg()
        return (lambda uv: sp(cp, t(images), t(uv))), (lambda uv: sj(cj, j(images), j(uv)))
    if family == "ba":
        from optical_flow_tpu.methods.ba import ba_level_step as sj
        from optical_flow_tpu_torch.methods.ba import ba_level_step as sp

        cj, cp = oj._level_cfg(max_linear=1), op._level_cfg(max_linear=1)
        return (lambda uv: sp(cp, t(images), t(uv), 0.5)), (lambda uv: sj(cj, j(images), j(uv), jnp.asarray(0.5)))
    from optical_flow_tpu.methods.classic_nl import classic_nl_level_step as sj
    from optical_flow_tpu_torch.methods.classic_nl import classic_nl_level_step as sp

    cj, cp = oj._nl_cfg(True, 1), op._nl_cfg(True, 1)
    return ((lambda uv: sp(cp, t(images), t(color), t(uv), 0.5)),
            (lambda uv: sj(cj, j(images), j(color), j(uv), jnp.asarray(0.5))))


@pytest.mark.parametrize("family", ["ba", "classic+nl-fast", "hs"])
def test_guard_in_level_steps(family):
    """guard_flow 1e9 leaves a healthy level bit-identical to no guard; a
    threshold between the start's and the result's magnitudes rolls the level
    back to its start, and a NaN in the start rolls it back to zero flow, as
    in the JAX package."""
    uv = 0.05 * np.random.default_rng(6).standard_normal((24, 32, 2))
    plain = n(_level_case(family, None)[0](uv))
    np.testing.assert_array_equal(n(_level_case(family, 1e9)[0](uv)), plain)
    lo, hi = np.abs(uv).max(), np.abs(plain).max()
    assert hi > 1.5 * lo  # the level moved the flow past its start
    step_p, step_j = _level_case(family, (lo + hi) / 2)
    np.testing.assert_array_equal(n(step_p(uv)), uv)
    np.testing.assert_array_equal(n(step_j(uv)), uv)
    sick = uv.copy()
    sick[7, 9, 0] = np.nan
    np.testing.assert_array_equal(n(step_p(sick)), np.zeros_like(uv))
    np.testing.assert_array_equal(n(step_j(sick)), np.zeros_like(uv))


def test_classic_c_a_preset_diverges_and_guard_recovers():
    """The preset's default trajectory on the 40x44 pair of
    ``tests/test_guard.py``, in float32: without the guard both packages blow
    up (measured max |uv| 2.1e27 in JAX, 1.1e32 in the port); with the
    preset's guard both are finite and within 1e9."""
    from scipy.ndimage import gaussian_filter

    from optical_flow_tpu.config import load_of_method as lj
    from optical_flow_tpu_torch.config import load_of_method as lp

    base = gaussian_filter(np.random.default_rng(0).uniform(0, 255, (40, 44)), 1.0)
    images = np.stack([base, np.roll(base, 1, axis=1)], axis=2)
    for guard in (None, 1e9):
        oj, op = lj("classic-c-a"), lp("classic-c-a")
        assert oj.guard_flow == op.guard_flow == 1e9
        oj.display = False
        oj.dtype = jnp.float32
        oj.guard_flow = op.guard_flow = guard
        oj.images = jnp.asarray(images, jnp.float32)
        uv_j = np.asarray(oj.compute_flow())
        uv_p = n(op.compute_flow(t(images, torch.float32)))
        for uv in (uv_j, uv_p):
            if guard is None:
                assert (~np.isfinite(uv)).any() or np.abs(uv).max() > 1e20
            else:
                assert np.isfinite(uv).all() and np.abs(uv).max() <= 1e9


def test_guard_reaches_estimate_flow_in_every_family():
    """``{"guard_flow": 1e9}`` through ``estimate_flow`` on a healthy pair
    changes nothing, in each family."""
    from optical_flow_tpu_torch import estimate_flow

    im1 = np.random.default_rng(2).uniform(0, 255, (24, 32))
    im2 = np.roll(im1, 1, axis=1)
    for method, extra in (("hs-brightness", {}), ("ba-brightness", {"max_iters": 1}),
                          ("classic+nl-fast", {"max_iters": 1}), ("classic-c-a", {"max_iters": 1})):
        flows = [estimate_flow(im1, im2, method, {"display": False, "dtype": torch.float64, "guard_flow": g, **extra},
                               device="cpu") for g in (None, 1e9)]
        assert torch.isfinite(flows[0]).all(), method
        assert torch.equal(flows[0], flows[1]), method


def test_guard_makes_no_host_read():
    """guard.py reads nothing on the host but in ``flow_health``: no .item(),
    bool(), .cpu(), .tolist() or float() of a tensor, and no ``if`` on one."""
    import ast
    import inspect

    from optical_flow_tpu_torch.utils import guard

    tree = ast.parse(inspect.getsource(guard))
    for fn in (node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name != "flow_health"):
        for node in ast.walk(fn):
            assert not isinstance(node, (ast.If, ast.IfExp, ast.While, ast.Assert)), (fn.name, ast.dump(node))
            if isinstance(node, ast.Call):
                name = node.func.attr if isinstance(node.func, ast.Attribute) else getattr(node.func, "id", "")
                assert name not in ("item", "cpu", "tolist", "numpy", "bool", "float", "int"), (fn.name, name)


@pytest.mark.parametrize("method", ["bi-cubic", "cubic", "bi-linear"])
def test_warp_of_a_diverged_flow_matches_jax(method):
    """Inside a level the guard has not yet acted on, the warp sees NaN, ±inf
    and huge flow: it reads valid taps (NaN at index 0, as XLA converts it)
    and gives JAX's values, NaNs in the same places.  Unsafe indices made
    this raise on the CPU (and would fault on the card)."""
    from optical_flow_tpu.ops.derivatives import precompute_warp as pj, warp_deriv as wj
    from optical_flow_tpu_torch.ops.derivatives import precompute_warp as pp, warp_deriv as wp

    rng = np.random.default_rng(9)
    images = rng.uniform(0, 255, (13, 19, 2))
    uv = 2.0 * rng.standard_normal((13, 19, 2))
    uv[3, 4, 0] = np.nan
    uv[5, 6, 1] = np.nan
    uv[7, 8] = [np.inf, -np.inf]
    uv[9, 10, 0] = -1e30
    out_p = wp(pp(t(images), method), t(uv))
    out_j = wj(pj(j(images), method), j(uv))
    for a, b in zip(out_p, out_j):
        np.testing.assert_array_equal(np.isnan(n(a)), np.isnan(n(b)))
        np.testing.assert_allclose(n(a), n(b), rtol=1e-10, atol=1e-9)


def test_method_from_state_carries_a_guarded_hs():
    """``guard_flow`` carries across from the JAX object's attributes: a guarded
    hs built by ``method_from_state`` gives the JAX package's flow (float64,
    a smoothed 40x44 pair rolled by one pixel)."""
    from scipy.ndimage import gaussian_filter

    from optical_flow_tpu.config import load_of_method as lj
    from optical_flow_tpu_torch.config import method_from_state
    from torch_parity import jax_method_state

    base = gaussian_filter(np.random.default_rng(3).uniform(0, 255, (40, 44)), 1.0)
    images = np.stack([base, np.roll(base, 1, axis=1)], axis=2)
    oj = lj("hs")
    oj.guard_flow = 1e9
    oj.display = False
    oj.dtype = jnp.float64
    oj.images = jnp.asarray(images)
    uv_j = np.asarray(oj.compute_flow())
    op = method_from_state({**jax_method_state("hs"), "guard_flow": 1e9, "display": False, "dtype": "float64"})
    assert op._level_cfg().guard == 1e9
    uv_p = n(op.compute_flow(t(images)))
    assert np.abs(uv_p - uv_j).max() <= 1e-6 and np.abs(uv_p).max() > 0.5
