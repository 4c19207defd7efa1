"""The row-sharded path of the port (``parallel/mesh.py``, ``halo.py``,
``dist.py``, ``spatial.py`` and ``estimate_flow(mesh=)``) on the CPU in
float64, with the shards as a list of row blocks on one device
(``flow_mesh(space=8, devices=["cpu"] * 8)``).

The port's sharded levels are held to its own single-device levels, one of
them to the JAX package's single-device level step; the geometry and the
halo exchange are held to the JAX package's.  JAX's sharded level programs
are not run here: the JAX package's own tests pin them to its
single-device steps.  The test marked ``cuda`` runs the sharded level with
the CUDA weighted median on the card:
``python -m pytest tests/test_torch_spatial.py -m cuda --noconftest``.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import t  # noqa: E402

N = 8  # the shards of every CPU mesh here, as the JAX package's tests


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """The shards are small tensors: one intra-op thread runs them fastest,
    and keeps this module from oversubscribing the CPU beside other test
    workers.  The count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _smooth(rng, shape, scale=255.0):
    """Band-limited random field (stresses interpolation, avoids ties)."""
    from scipy.ndimage import gaussian_filter

    x = gaussian_filter(rng.uniform(0, 1, shape), sigma=1.5, mode="reflect")
    x = (x - x.min()) / max(np.ptp(x), 1e-9)
    return scale * x


def _level_inputs(rng, H, W):
    """(images (H, W, 2), colour guide (H, W, 3), flow (H, W, 2)) as numpy, as ``tests/test_spatial.py`` makes them."""
    im1 = _smooth(rng, (H, W))
    im2 = np.roll(im1, 1, axis=1) + 2.0 * rng.standard_normal((H, W))
    images = np.stack([im1, im2], -1)
    color = np.stack([_smooth(rng, (H, W)) for _ in range(3)], -1)
    uv = np.stack([_smooth(rng, (H, W), 3.0) - 1.5, _smooth(rng, (H, W), 2.0) - 1.0], -1)
    return images, color, uv


def _mesh(n=N):
    from optical_flow_tpu_torch.parallel.mesh import flow_mesh

    return flow_mesh(space=n, devices=["cpu"] * n)


def _nl_cfg(use_color, **settings):
    from optical_flow_tpu_torch.config import load_of_method

    ope = load_of_method("classic+nl-fast")
    ope.parse_input_parameter({"display": False, **settings})
    return ope._nl_cfg(use_color=use_color, max_linear=1)


# ------------------------------------------------------------------ geometry and halo


PLAN_GRID = [
    (H, W, n, r, halo, margin)
    for (H, W), n, r, (halo, margin) in itertools.product(
        [(64, 48), (153, 40), (388, 584), (25, 37), (97, 146), (9, 5), (1, 3)],
        [1, 2, 3, 8],
        [2, 7],
        [(6, 0), (8, 2), (16, 0)],
    )
]


@pytest.mark.parametrize("H,W,n,radius,halo,margin", PLAN_GRID)
def test_spatial_plan_equals_jax(H, W, n, radius, halo, margin):
    from optical_flow_tpu.parallel.spatial import spatial_plan as plan_jax
    from optical_flow_tpu_torch.parallel.spatial import spatial_plan as plan_port

    pj = plan_jax(H, W, n, radius, halo, warp_margin=margin)
    pp = plan_port(H, W, n, radius, halo, warp_margin=margin)
    assert (pp is None) == (pj is None)
    if pj is not None:
        ref = dataclasses.asdict(pj)
        assert ref.pop("sync_axes") == ()  # no JAX caller sets it; the port has no such field
        assert dataclasses.asdict(pp) == ref


def test_spatial_plan_grid_has_both_outcomes():
    from optical_flow_tpu_torch.parallel.spatial import spatial_plan

    plans = [spatial_plan(H, W, n, r, h, warp_margin=m) for H, W, n, r, h, m in PLAN_GRID]
    assert any(p is None for p in plans) and any(p is not None and p.pad for p in plans)
    assert any(p is not None and not p.pad for p in plans)


@pytest.fixture(scope="module")
def halo_field():
    return np.random.default_rng(0).uniform(size=(32, 5, 2))


@pytest.mark.parametrize("mode", ["zero", "edge", "symmetric", "reflect"])
@pytest.mark.parametrize("radius", [1, 3])
def test_halo_exchange_rows_equals_jax_bit_for_bit(halo_field, mode, radius):
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from optical_flow_tpu.parallel.halo import halo_exchange_rows as halo_jax
    from optical_flow_tpu.parallel.mesh import SPACE_AXIS, flow_mesh as mesh_jax
    from optical_flow_tpu_torch.parallel.halo import halo_exchange_rows
    from optical_flow_tpu_torch.parallel.mesh import shard_rows

    if len(jax.devices()) < N:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    fn = shard_map(partial(halo_jax, radius=radius, axis_name=SPACE_AXIS, mode=mode), mesh=mesh_jax(batch=1, space=N),
                   in_specs=P(SPACE_AXIS), out_specs=P(SPACE_AXIS), check_rep=False)
    ref = np.asarray(fn(jnp.asarray(halo_field)))  # the 8 extended blocks, stacked
    out = halo_exchange_rows(shard_rows(t(halo_field), _mesh()), radius, mode)
    np.testing.assert_array_equal(torch.cat(out).numpy(), ref)


def test_halo_exchange_rows_multi_equals_one_field_at_a_time(halo_field):
    from optical_flow_tpu_torch.parallel.halo import halo_exchange_rows, halo_exchange_rows_multi
    from optical_flow_tpu_torch.parallel.mesh import shard_rows

    fields = [shard_rows(t(halo_field[..., k]), _mesh()) for k in range(2)]
    for got, field in zip(halo_exchange_rows_multi(fields, 2), fields):
        assert all(torch.equal(a, b) for a, b in zip(got, halo_exchange_rows(field, 2, "zero")))


def test_shard_order_sum_repeats_bit_for_bit():
    from optical_flow_tpu_torch.parallel.dist import _dot2
    from optical_flow_tpu_torch.parallel.mesh import psum, shard_rows

    rng = np.random.default_rng(4)
    a, b = (shard_rows(t(rng.standard_normal((64, 48))), _mesh()) for _ in range(2))
    sums = [_dot2(a, b, b, a) for _ in range(3)]
    assert all(s.item() == sums[0].item() for s in sums)
    parts = [torch.sum(x * y) for x, y in zip(a, b)]
    expected = parts[0]
    for p in parts[1:]:  # in shard order, as a loop over the shards adds them
        expected = expected + p
    assert psum(parts).item() == expected.item()


def test_flow_mesh_and_row_shards():
    from optical_flow_tpu_torch.parallel.mesh import SPACE_AXIS, flow_mesh, gather_rows, shard_rows

    mesh = _mesh(4)
    assert mesh.shape == {"batch": 1, SPACE_AXIS: 4} and mesh.devices == (torch.device("cpu"),) * 4
    x = torch.arange(24.0).reshape(8, 3)
    shards = shard_rows(x, mesh)
    assert [tuple(s.shape) for s in shards] == [(2, 3)] * 4 and torch.equal(gather_rows(shards, "cpu"), x)
    with pytest.raises(ValueError, match="do not divide"):
        shard_rows(x[:7], mesh)
    with pytest.raises(ValueError, match="!= 4 devices"):
        flow_mesh(space=3, devices=["cpu"] * 4)
    assert flow_mesh(batch=2, devices=["cpu"] * 4).shape == {"batch": 2, SPACE_AXIS: 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            flow_mesh()


# ------------------------------------------------------------------ the distributed PCG


def test_distributed_pcg_equals_the_twin():
    from optical_flow_tpu_torch.ops.cuda.cg_kernel import cg_solve_plain
    from optical_flow_tpu_torch.ops.stencil import build_irls_system, weighted_laplacian_apply, weighted_laplacian_diag
    from optical_flow_tpu_torch.parallel import dist
    from optical_flow_tpu_torch.parallel.mesh import shard_rows

    rng = np.random.default_rng(2)
    H, W = 64, 40
    cfg = _nl_cfg(True).irls
    It, Ix, Iy = (t(_smooth(rng, (H, W), 20.0) - 10.0) for _ in range(3))
    uv = t(np.stack([_smooth(rng, (H, W), 2.0) - 1.0] * 2, -1))
    sysm = build_irls_system(uv, torch.zeros_like(uv), It, Ix, Iy, cfg.rho_spatial_u, cfg.rho_spatial_v, cfg.rho_data, 3.0)
    mesh = _mesh()
    w = [shard_rows(f, mesh) for f in (sysm.wu_h, sysm.wu_v)]
    np.testing.assert_allclose(torch.cat(dist.sharded_laplacian_diag_local(*w)).numpy(),
                               weighted_laplacian_diag(sysm.wu_h, sysm.wu_v).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(torch.cat(dist.sharded_laplacian_apply_local(*w, shard_rows(It, mesh))).numpy(),
                               weighted_laplacian_apply(sysm.wu_h, sysm.wu_v, It).numpy(), rtol=0, atol=1e-9)
    before = (dist.solves, dist.iterations)
    x = dist.solve_flow_system_sharded(sysm, mesh, 1e-7, 1000)
    assert dist.solves == before[0] + 1 and dist.iterations > before[1]
    np.testing.assert_allclose(x.numpy(), cg_solve_plain(sysm, 1e-7, 1000).numpy(), rtol=0, atol=1e-8)
    for algo in ("gear", "cheby"):
        with pytest.raises(NotImplementedError, match="item 14c"):
            dist.solve_flow_system_sharded(sysm, _mesh(), algo=algo)


# ------------------------------------------------------------------ sharded levels against single-device ones


@pytest.mark.parametrize("H,W,expect_pad,interp", [
    (64, 48, 0, "bi-cubic"),  # divisible: no pad
    (153, 40, 7, "bi-cubic"),  # 153 % 8 != 0: the masked bottom pad
    (153, 40, 7, "cubic"),  # the global B-spline tables, with the pad
])
def test_sharded_classic_nl_level_equals_the_unsharded_level(H, W, expect_pad, interp):
    from optical_flow_tpu_torch.methods.classic_nl import classic_nl_level_step
    from optical_flow_tpu_torch.parallel.spatial import classic_nl_level_step_spatial, spatial_plan

    cfg = _nl_cfg(True, interpolation_method=interp)
    scfg = spatial_plan(H, W, N, cfg.area_hsz, halo=6, warp_margin=2 if interp == "cubic" else 0)
    assert scfg is not None and scfg.pad == expect_pad
    images, color, uv = (t(x) for x in _level_inputs(np.random.default_rng(7), H, W))
    ref = classic_nl_level_step(cfg, images, color, uv, 0.4)
    out = classic_nl_level_step_spatial(cfg, images, color, uv, 0.4, _mesh(), halo=6)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-8)


def test_sharded_level_no_color_median_path():
    from optical_flow_tpu_torch.methods.classic_nl import classic_nl_level_step
    from optical_flow_tpu_torch.parallel.spatial import classic_nl_level_step_spatial

    cfg = _nl_cfg(False)
    images, _, uv = (t(x) for x in _level_inputs(np.random.default_rng(0), 56, 40))
    ref = classic_nl_level_step(cfg, images, None, uv, 0.0)
    out = classic_nl_level_step_spatial(cfg, images, None, uv, 0.0, _mesh(), halo=6)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-8)


@pytest.mark.parametrize("interp,H,W", [("bi-cubic", 64, 48), ("bi-linear", 153, 40), ("cubic", 72, 48)])
def test_sharded_ba_level_equals_the_unsharded_level(interp, H, W):
    from optical_flow_tpu_torch.config import load_of_method
    from optical_flow_tpu_torch.methods.ba import ba_level_step
    from optical_flow_tpu_torch.parallel import dist
    from optical_flow_tpu_torch.parallel.spatial import ba_level_step_spatial

    ope = load_of_method("ba")
    ope.parse_input_parameter({"display": False, "max_iters": 3, "interpolation_method": interp})
    cfg = ope._level_cfg(max_linear=1)
    images, _, uv = (t(x) for x in _level_inputs(np.random.default_rng(3), H, W))
    ref = ba_level_step(cfg, images, uv, 0.4)
    solves = dist.solves
    out = ba_level_step_spatial(cfg, images, uv, 0.4, _mesh(), halo=6)
    assert dist.solves == solves + 3  # sharded: the level tiles
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-8)


def test_sharded_level_equals_jax_single_device_level():
    import jax.numpy as jnp

    from optical_flow_tpu.config import load_of_method as load_jax
    from optical_flow_tpu.methods.classic_nl import classic_nl_level_step as step_jax
    from optical_flow_tpu_torch.parallel.spatial import classic_nl_level_step_spatial

    oj = load_jax("classic+nl-fast")
    oj.display = False
    cfg_j = oj._nl_cfg(use_color=True, max_linear=1)
    images, color, uv = _level_inputs(np.random.default_rng(7), 153, 40)
    ref = np.asarray(step_jax(cfg_j, *(jnp.asarray(x) for x in (images, color, uv)), jnp.asarray(0.4, jnp.float64)))
    out = classic_nl_level_step_spatial(_nl_cfg(True), t(images), t(color), t(uv), 0.4, _mesh(), halo=6)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-8)


def test_level_too_short_for_its_halo_runs_unsharded():
    from optical_flow_tpu_torch.methods.classic_nl import classic_nl_level_step
    from optical_flow_tpu_torch.parallel import dist
    from optical_flow_tpu_torch.parallel.spatial import classic_nl_level_step_spatial

    cfg = _nl_cfg(True, max_iters=1)
    images, color, uv = (t(x) for x in _level_inputs(np.random.default_rng(1), 48, 40))  # 6 rows a shard
    solves = dist.solves
    out = classic_nl_level_step_spatial(cfg, images, color, uv, 0.4, _mesh(), halo=6)
    assert dist.solves == solves
    assert torch.equal(out, classic_nl_level_step(cfg, images, color, uv, 0.4))


def test_sharded_guard_runs_on_the_whole_level():
    """A guard between the level's start and its result rolls the whole level
    back to its start, as the unsharded guard does."""
    from optical_flow_tpu_torch.methods.classic_nl import classic_nl_level_step
    from optical_flow_tpu_torch.parallel.spatial import classic_nl_level_step_spatial

    cfg = _nl_cfg(True, max_iters=1)
    images, color, uv = (t(x) for x in _level_inputs(np.random.default_rng(7), 64, 48))
    uv = 0.3 * uv  # a start the update leaves
    free = classic_nl_level_step_spatial(cfg, images, color, uv, 0.4, _mesh(), halo=6)
    m0, m1 = float(uv.abs().max()), float(free.abs().max())
    assert m1 > m0
    guarded = dataclasses.replace(cfg, irls=dataclasses.replace(cfg.irls, guard=(m0 + m1) / 2))
    out = classic_nl_level_step_spatial(guarded, images, color, uv, 0.4, _mesh(), halo=6)
    assert torch.equal(out, uv) and torch.equal(out, classic_nl_level_step(guarded, images, color, uv, 0.4))


# ------------------------------------------------------------------ estimate_flow(mesh=)


def _flow_pair(gray=False):
    rng = np.random.default_rng(13 if gray else 11)
    if gray:
        im1 = _smooth(rng, (96, 64))
    else:
        im1 = np.stack([_smooth(rng, (96, 64)) for _ in range(3)], -1)
    return im1, np.roll(im1, 1, axis=1)


# ba's auto halo covers its 10 warp iterations: 96 rows tile over 4 shards, not 8
@pytest.mark.parametrize("method,gray,n", [("classic+nl-fast", False, 8), ("ba", True, 4)])
def test_estimate_flow_mesh_end_to_end(method, gray, n):
    """JAX's bounds (tests/test_spatial.py): atol 1e-3, mean < 1e-5, the 1 px shift recovered."""
    from optical_flow_tpu_torch import estimate_flow
    from optical_flow_tpu_torch.parallel import dist

    im1, im2 = _flow_pair(gray)
    params = {"display": False, "dtype": torch.float64}
    single = estimate_flow(im1, im2, method, params, device="cpu").numpy()
    solves = dist.solves
    sharded = estimate_flow(im1, im2, method, params, mesh=_mesh(n)).numpy()
    assert dist.solves > solves
    np.testing.assert_allclose(sharded, single, rtol=0, atol=1e-3)
    assert np.abs(sharded - single).mean() < 1e-5
    assert abs(sharded[8:-8, 8:-8, 0].mean() - 1.0) < (0.05 if method == "classic+nl-fast" else 0.1)


def test_checkpointer_sees_the_whole_flow_of_every_sharded_level():
    from optical_flow_tpu_torch import estimate_flow

    im1, im2 = _flow_pair()
    calls = {"single": [], "sharded": []}
    for label, mesh in (("single", None), ("sharded", _mesh())):
        params = {"display": False, "dtype": torch.float64, "max_iters": 1,
                  "checkpoint": lambda s, level, uv, c=calls[label]: c.append((s, level, uv.clone()))}
        estimate_flow(im1, im2, "classic+nl-fast", params, device="cpu", mesh=mesh)
    assert [c[:2] for c in calls["sharded"]] == [c[:2] for c in calls["single"]]
    assert len(calls["sharded"]) == 5  # 3 + 2 levels
    for (_, _, a), (_, _, b) in zip(calls["sharded"], calls["single"]):
        assert a.shape == b.shape and float((a - b).abs().max()) <= 1e-8
    assert calls["sharded"][-1][2].shape == (96, 64, 2)


def test_mesh_unsupported_requests_raise_loudly(monkeypatch):
    from optical_flow_tpu_torch import estimate_flow
    from optical_flow_tpu_torch.methods.ba import BAOpticalFlow

    im1, im2 = _flow_pair(gray=True)
    mesh = _mesh()
    with pytest.raises(ValueError, match="solver"):
        estimate_flow(im1, im2, "classic+nl-fast", {"display": False, "solver": "sor"}, mesh=mesh)
    with pytest.raises(ValueError, match="interpolation_method"):
        estimate_flow(im1, im2, "ba", {"display": False, "interpolation_method": "nearest"}, mesh=mesh)
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        estimate_flow(im1, im2, "ba", {"display": False}, device="cuda", mesh=mesh)
    with pytest.raises(TypeError, match="flow_mesh"):
        estimate_flow(im1, im2, "ba", {"display": False}, mesh=object())
    with pytest.raises(ValueError, match="limit_update"):
        estimate_flow(im1, im2, "ba", {"display": False, "limit_update": False}, mesh=mesh)
    # every family shards; a method class without a sharded level raises JAX's ValueError
    monkeypatch.setattr(BAOpticalFlow, "spatial_mesh_supported", False)
    with pytest.raises(ValueError, match="does not support spatial sharding"):
        estimate_flow(im1, im2, "ba", {"display": False}, mesh=mesh)


def test_resolve_spatial_halo_equals_jax():
    from optical_flow_tpu.config import load_of_method as load_jax
    from optical_flow_tpu_torch.config import load_of_method

    oj, op = load_jax("classic+nl-fast"), load_of_method("classic+nl-fast")
    assert op.spatial_halo == oj.spatial_halo == "auto" and op.spatial_mesh is None
    uv = np.zeros((16, 16, 2))
    for value in (0.0, -21.7, 5.0, np.nan):
        uv[3, 4, 0] = value
        assert op._resolve_spatial_halo(t(uv), 3) == oj._resolve_spatial_halo(uv, 3)
    op.spatial_halo = 6
    assert op._resolve_spatial_halo(t(uv), 3) == 6


def test_method_from_state_carries_an_integer_spatial_halo():
    from optical_flow_tpu_torch.config import method_from_state

    assert method_from_state({"__class__": "BAOpticalFlow", "spatial_halo": 16}).spatial_halo == 16
    assert method_from_state({"spatial_halo": "auto"}).spatial_halo == "auto"
    with pytest.raises(TypeError):
        method_from_state({"spatial_halo": 6.5})
    with pytest.raises(ValueError, match="no counterpart"):
        method_from_state({"spatial_mesh": "a JAX mesh"})


# ------------------------------------------------------------------ on the card


@pytest.mark.cuda
def test_sharded_level_runs_the_weighted_median_kernel_once_per_device():
    from optical_flow_tpu_torch.ops.cuda import wmedian_kernel
    from optical_flow_tpu_torch.parallel.mesh import flow_mesh
    from optical_flow_tpu_torch.parallel.spatial import classic_nl_level_step_spatial

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = _nl_cfg(True, max_iters=1, solver="pcg")
    images, color, uv = (t(x, torch.float32).cuda() for x in _level_inputs(np.random.default_rng(7), 153, 40))
    before = (wmedian_kernel.launches, wmedian_kernel.items)
    out = classic_nl_level_step_spatial(cfg, images, color, uv, 0.4, flow_mesh(space=3, devices=["cuda"] * 3), 6)
    assert (wmedian_kernel.launches, wmedian_kernel.items) == (before[0] + 1, before[1] + 3)
    assert out.shape == uv.shape and bool(torch.isfinite(out).all())
