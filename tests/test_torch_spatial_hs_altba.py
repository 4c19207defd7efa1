"""The Horn–Schunck and alt-BA row-sharded levels of the port
(``parallel/spatial.py::hs_level_step_spatial``, ``alt_ba_level_step_spatial``)
and ``estimate_flow(mesh=)`` for ``hs``, ``hs-brightness`` and
``classic-c-a``, on the CPU in float64 with the shards as a list of row
blocks on one device (``flow_mesh(space=n, devices=["cpu"] * n)``).

The sharded levels are held to the port's own single-device levels at the
shapes of the JAX package's ``tests/test_spatial.py``, and one level of each
family to the JAX package's single-device level step.  JAX's sharded level
programs are not run here: the JAX package's own tests pin them to its
single-device steps.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_spatial import _level_inputs, _mesh, _smooth  # noqa: E402
from torch_parity import t  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """The shards are small tensors: one intra-op thread runs them fastest."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hs_cfg(method="hs-brightness", **settings):
    from optical_flow_tpu_torch.config import load_of_method

    ope = load_of_method(method)
    ope.parse_input_parameter({"display": False, **settings})
    return ope._level_cfg()


def _alt_cfg(**settings):
    from optical_flow_tpu_torch.config import load_of_method

    ope = load_of_method("classic-c-a")
    ope.parse_input_parameter({"display": False, "max_iters": 2, "itersLO": 2, **settings})
    return ope._alt_cfg()


def _counted_hs_solves(monkeypatch):
    """The unsharded HS level's solves (one a warp iteration), counted as they run."""
    from optical_flow_tpu_torch.methods import hs

    calls, solve = [], hs.solve_flow_system
    monkeypatch.setattr(hs, "solve_flow_system", lambda *a: calls.append(1) or solve(*a))
    return calls


def _alt_inputs(H, W, seed=11):
    """Images and flow as ``_level_inputs`` makes them, and a distinct
    auxiliary field that keeps the coupling live (``tests/test_spatial.py``)."""
    rng = np.random.default_rng(seed)
    images, _, uv = _level_inputs(rng, H, W)
    uvhat = uv + np.stack([_smooth(rng, (H, W), 0.6) - 0.3, _smooth(rng, (H, W), 0.6) - 0.3], -1)
    return t(images), t(uv), t(uvhat)


# ------------------------------------------------------------------ Horn–Schunck


# (interp, H, W, shards, tiles): cubic 64x48 over 8 shards is the JAX test's
# case, whose 8-row shards are too short for the halo and the B-spline margin
# (the unsharded step runs); over 4 shards it tiles; bi-linear 153x40 pads
HS_CASES = [("cubic", 64, 48, 8, False), ("cubic", 64, 48, 4, True), ("bi-linear", 153, 40, 8, True)]


def _hs_level_pair(cfg, images, start, n, tiles, calls):
    """The unsharded HS level from ``start`` and its warp iterations, after
    holding the sharded level to it: within 1e-8 and, where the level tiles,
    the same warp iterations (one distributed solve each); else the
    unsharded step itself."""
    from optical_flow_tpu_torch.methods.hs import hs_level_step
    from optical_flow_tpu_torch.parallel import dist
    from optical_flow_tpu_torch.parallel.spatial import hs_level_step_spatial

    del calls[:]
    ref = hs_level_step(cfg, images, start)
    warps, solves = len(calls), dist.solves
    out = hs_level_step_spatial(cfg, images, start, _mesh(n), halo=6)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-8)
    if tiles:
        assert dist.solves - solves == warps
    else:
        assert dist.solves == solves and torch.equal(out, ref)
    return ref, warps


@pytest.mark.parametrize("interp,H,W,n,tiles", HS_CASES)
def test_sharded_hs_level_equals_the_unsharded_level(interp, H, W, n, tiles, monkeypatch):
    """``tests/test_spatial.py``'s inputs: all 10 warp iterations run."""
    cfg = _hs_cfg(interpolation_method=interp)
    images, _, uv = (t(x) for x in _level_inputs(np.random.default_rng(5), H, W))
    _, warps = _hs_level_pair(cfg, images, uv, n, tiles, _counted_hs_solves(monkeypatch))
    assert warps == cfg.max_warping_iters


@pytest.mark.parametrize("interp,H,W,n,tiles", HS_CASES)
def test_sharded_hs_early_stop_at_the_unsharded_iteration(interp, H, W, n, tiles, monkeypatch):
    """A smooth pair shifted by 1 px (the edge column repeated): the update's
    norm over all the shards falls below 1e-3 at the unsharded level's warp
    iteration, from zero flow and again from the level's own result."""
    from scipy.ndimage import shift

    im1 = _smooth(np.random.default_rng(5), (H, W))
    images = t(np.stack([im1, shift(im1, (0, 1.0), mode="nearest")], -1))
    cfg = _hs_cfg(interpolation_method=interp)
    calls = _counted_hs_solves(monkeypatch)
    first, warps0 = _hs_level_pair(cfg, images, torch.zeros((H, W, 2), dtype=torch.float64), n, tiles, calls)
    _, warps1 = _hs_level_pair(cfg, images, first, n, tiles, calls)
    assert min(warps0, warps1) < cfg.max_warping_iters  # the early stop ran


def test_sharded_hs_guard_rolls_back_the_whole_level():
    from optical_flow_tpu_torch.methods.hs import hs_level_step
    from optical_flow_tpu_torch.parallel.spatial import hs_level_step_spatial

    cfg = _hs_cfg(interpolation_method="bi-linear", max_warping_iters=2)
    images, _, uv = (t(x) for x in _level_inputs(np.random.default_rng(5), 153, 40))
    uv = 0.3 * uv
    free = hs_level_step_spatial(cfg, images, uv, _mesh(), halo=6)
    m0, m1 = float(uv.abs().max()), float(free.abs().max())
    assert m1 > m0
    guarded = dataclasses.replace(cfg, guard=(m0 + m1) / 2)
    out = hs_level_step_spatial(guarded, images, uv, _mesh(), halo=6)
    assert torch.equal(out, uv) and torch.equal(out, hs_level_step(guarded, images, uv))


def test_sharded_hs_level_equals_jax_single_device_level():
    import jax.numpy as jnp

    from optical_flow_tpu.config import load_of_method as load_jax
    from optical_flow_tpu.methods.hs import hs_level_step as step_jax
    from optical_flow_tpu_torch.parallel.spatial import hs_level_step_spatial

    oj = load_jax("hs-brightness")
    oj.display = False
    oj.interpolation_method = "bi-linear"
    images, _, uv = _level_inputs(np.random.default_rng(5), 153, 40)
    ref = np.asarray(step_jax(oj._level_cfg(), jnp.asarray(images), jnp.asarray(uv)))
    out = hs_level_step_spatial(_hs_cfg(interpolation_method="bi-linear"), t(images), t(uv), _mesh(), halo=6)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-8)


# ------------------------------------------------------------------ alt-BA


# cubic 64x48 over 8 shards falls back as in the JAX test; over 4 it tiles
ALT_CASES = [("cubic", 64, 48, 8, False), ("cubic", 64, 48, 4, True), ("bi-cubic", 153, 40, 8, True)]


@pytest.mark.parametrize("replacement", [True, False])
@pytest.mark.parametrize("interp,H,W,n,tiles", ALT_CASES)
def test_sharded_alt_ba_level_equals_the_unsharded_level(interp, H, W, n, tiles, replacement):
    """The coupling masked to the true rows and the Li–Osher passes on the
    shards: (uv, uvhat) within 1e-8 of ``alt_ba_level_step``."""
    from optical_flow_tpu_torch.methods.alt_ba import alt_ba_level_step
    from optical_flow_tpu_torch.parallel import dist
    from optical_flow_tpu_torch.parallel.spatial import alt_ba_level_step_spatial

    cfg = _alt_cfg(interpolation_method=interp)
    images, uv, uvhat = _alt_inputs(H, W)
    ref = alt_ba_level_step(cfg, images, uv, uvhat, 0.4, replacement)
    solves = dist.solves
    out = alt_ba_level_step_spatial(cfg, images, uv, uvhat, 0.4, replacement, _mesh(n), halo=6)
    assert dist.solves - solves == (cfg.irls.max_iters if tiles else 0)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-8)
    if replacement:
        assert torch.equal(out[0], out[1])


def test_sharded_alt_ba_guard_rolls_back_the_pair():
    """The guard on the gathered (uv, uvhat) pair: a level whose result leaves
    the bound returns the pair it started from, as the unsharded level does."""
    from optical_flow_tpu_torch.methods.alt_ba import alt_ba_level_step
    from optical_flow_tpu_torch.parallel.spatial import alt_ba_level_step_spatial

    cfg = _alt_cfg(interpolation_method="bi-cubic", max_iters=1, itersLO=1)
    images, uv, uvhat = _alt_inputs(153, 40)
    uv, uvhat = 0.3 * uv, 0.3 * uvhat
    free = alt_ba_level_step_spatial(cfg, images, uv, uvhat, 0.4, False, _mesh(), halo=6)
    m0 = max(float(uv.abs().max()), float(uvhat.abs().max()))
    m1 = max(float(free[0].abs().max()), float(free[1].abs().max()))
    assert m1 > m0
    guarded = dataclasses.replace(cfg, irls=dataclasses.replace(cfg.irls, guard=(m0 + m1) / 2))
    out = alt_ba_level_step_spatial(guarded, images, uv, uvhat, 0.4, False, _mesh(), halo=6)
    ref = alt_ba_level_step(guarded, images, uv, uvhat, 0.4, False)
    assert torch.equal(out[0], uv) and torch.equal(out[1], uvhat)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_sharded_alt_ba_level_equals_jax_single_device_level():
    import jax.numpy as jnp

    from optical_flow_tpu.config import load_of_method as load_jax
    from optical_flow_tpu.methods.alt_ba import alt_ba_level_step as step_jax
    from optical_flow_tpu_torch.parallel.spatial import alt_ba_level_step_spatial

    oj = load_jax("classic-c-a")
    oj.display = False
    oj.max_iters, oj.itersLO, oj.interpolation_method = 2, 2, "bi-cubic"
    images, uv, uvhat = _alt_inputs(153, 40)
    ref = step_jax(oj._alt_cfg(), *(jnp.asarray(x.numpy()) for x in (images, uv, uvhat)),
                   jnp.asarray(0.4, jnp.float64), jnp.asarray(True))
    cfg = _alt_cfg(interpolation_method="bi-cubic", max_iters=2)
    out = alt_ba_level_step_spatial(cfg, images, uv, uvhat, 0.4, True, _mesh(), halo=6)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-8)


# ------------------------------------------------------------------ estimate_flow(mesh=)


def _gray_pair():
    im1 = _smooth(np.random.default_rng(13), (96, 64))
    return im1, np.roll(im1, 1, axis=1)


# HS's auto halo covers its 10 warp iterations: 96 rows tile over 4 shards, not 8
@pytest.mark.parametrize("method", ["hs-brightness", "hs"])
def test_estimate_flow_mesh_hs_end_to_end(method):
    """JAX's bounds (tests/test_spatial.py): atol 1e-3, mean < 1e-5, the 1 px
    shift recovered; the checkpointer sees every level's whole flow."""
    from optical_flow_tpu_torch import estimate_flow
    from optical_flow_tpu_torch.parallel import dist

    im1, im2 = _gray_pair()
    calls = {"single": [], "sharded": []}
    flows = {}
    for label, where in (("single", {"device": "cpu"}), ("sharded", {"mesh": _mesh(4)})):
        params = {"display": False, "dtype": torch.float64,
                  "checkpoint": lambda s, level, uv, c=calls[label]: c.append((s, level, tuple(uv.shape)))}
        solves = dist.solves
        flows[label] = estimate_flow(im1, im2, method, params, **where).numpy()
        assert (dist.solves > solves) == (label == "sharded")
    single, sharded = flows["single"], flows["sharded"]
    np.testing.assert_allclose(sharded, single, rtol=0, atol=1e-3)
    assert np.abs(sharded - single).mean() < 1e-5
    assert abs(sharded[8:-8, 8:-8, 0].mean() - 1.0) < 0.1
    assert calls["sharded"] == calls["single"] and calls["sharded"][-1] == (0, 0, (96, 64, 2))


def test_estimate_flow_mesh_alt_ba_end_to_end():
    """JAX's bounds for alt-BA (tests/test_spatial.py): atol 1e-6 in float64, the shift within 0.15;
    two GNC stages of two warp iterations keep the CPU time small."""
    from optical_flow_tpu_torch import estimate_flow
    from optical_flow_tpu_torch.parallel import dist

    im1, im2 = _gray_pair()
    params = {"display": False, "max_iters": 2, "itersLO": 1, "gnc_iters": 2, "dtype": torch.float64}
    single = estimate_flow(im1, im2, "classic-c-a", params, device="cpu").numpy()
    solves = dist.solves
    sharded = estimate_flow(im1, im2, "classic-c-a", params, mesh=_mesh()).numpy()
    assert dist.solves > solves
    np.testing.assert_allclose(sharded, single, rtol=0, atol=1e-6)
    assert abs(sharded[8:-8, 8:-8, 0].mean() - 1.0) < 0.15


def test_mesh_raises_for_sor():
    """SOR's sequential sweep does not shard, in the HS and alt-BA families either."""
    from optical_flow_tpu_torch import estimate_flow

    im1, im2 = _gray_pair()
    for method in ("hs", "classic-c-a"):
        with pytest.raises(ValueError, match="solver"):
            estimate_flow(im1, im2, method, {"display": False, "solver": "sor"}, mesh=_mesh())
