"""The three kernel modules: plain twins against the JAX functions, wrappers' dispatch,
and (on a card only) each CUDA kernel against its plain twin.

CPU tests hold each plain twin to the JAX function that the Pallas kernel
is held to on the CPU: the weighted median's sort path exactly, the PCG
solve to solver precision, ROF to float rounding.  Tests marked ``cuda``
compare the kernels with their twins on the card; on a GPU host without
JAX run them with ``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import close, j, n, t  # noqa: E402


@pytest.fixture()
def rng():
    # also defined here so that ``-m cuda --noconftest`` runs on a GPU host without JAX
    return np.random.default_rng(0)


@pytest.fixture()
def jnp():
    return pytest.importorskip("jax.numpy")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _wmedian_inputs(rng, H, W, C, ties=False):
    uv = (3 * rng.standard_normal((H, W, 2))).astype(np.float32)
    if ties:
        uv = (np.round(rng.standard_normal((H, W, 2)) * 4) / 4).astype(np.float32)
    color = rng.uniform(0, 255, (H, W, C)).astype(np.float32)
    occ = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    return uv, color, occ


# the shapes of the Pallas kernel's own tests, plus its many-ties case
WMEDIAN_CASES = [((19, 23), 3, 3, False), ((40, 300), 7, 3, False), ((16, 260), 2, 1, False), ((12, 140), 4, 3, True)]


@pytest.mark.parametrize("shape,hsz,C,ties", WMEDIAN_CASES)
def test_wmedian_twin_equals_jax_sort_path(jnp, rng, shape, hsz, C, ties):
    from optical_flow_tpu.ops.wmedian import denoise_color_weighted_medfilt2 as dj
    from optical_flow_tpu_torch.ops.wmedian import denoise_color_weighted_medfilt2 as dp

    uv, color, occ = _wmedian_inputs(rng, *shape, C, ties)
    f32 = torch.float32
    out_p = dp(t(uv, f32), t(color, f32), t(occ, f32), hsz, [5, 5], 7.0)
    out_j = dj(jnp.asarray(uv), jnp.asarray(color), jnp.asarray(occ), hsz, [5, 5], 7.0)
    np.testing.assert_array_equal(n(out_p), n(out_j))


def test_wmedian_twin_float64_and_gray_guide(jnp, rng):
    from optical_flow_tpu.ops.wmedian import denoise_color_weighted_medfilt2 as dj
    from optical_flow_tpu_torch.ops.wmedian import denoise_color_weighted_medfilt2 as dp

    uv, color, occ = _wmedian_inputs(rng, 15, 21, 1)
    guide = color[:, :, 0]  # a gray pair's guide is (H, W)
    out_p = dp(t(uv), t(guide), t(occ), 7, [5, 5], 7.0)  # hsz 7 > the 15-row image's pad
    out_j = dj(j(uv), j(guide), j(occ), 7, [5, 5], 7.0)
    np.testing.assert_array_equal(n(out_p), n(out_j))


def test_weighted_median_stable_ties(jnp):
    """lax.sort is stable and so must torch.sort be: with tied values the
    weights keep their original order, and the selection is the same sample."""
    from optical_flow_tpu.ops.wmedian import _weighted_median_lastaxis as mj
    from optical_flow_tpu_torch.ops.wmedian import _weighted_median_lastaxis as mp

    vals = np.array([[2.0, 1.0, 2.0, 1.0, 3.0, 1.0], [5.0, 5.0, 5.0, -1.0, 5.0, -1.0]])
    wts = np.array([[0.1, 0.3, 0.25, 0.05, 0.2, 0.1], [0.2, 0.1, 0.3, 0.25, 0.1, 0.05]])
    np.testing.assert_array_equal(n(mp(t(vals), t(wts))), n(mj(j(vals), j(wts))))
    np.testing.assert_array_equal(n(mp(t(vals), t(wts))), [2.0, 5.0])


def test_wmedian_no_guide_fallback_not_ported():
    from optical_flow_tpu_torch.ops.wmedian import denoise_color_weighted_medfilt2

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        denoise_color_weighted_medfilt2(t(np.zeros((8, 8, 2))), None, t(np.ones((8, 8))), 3, [5, 5], 7.0)


def _random_system(rng, H, W, lib, dtype):
    """The seeded random SPD system of the Pallas CG test, as numpy -> ``lib``."""

    def u(*s):
        return rng.uniform(0.1, 1.0, s)

    wu_h, wu_v, wv_h, wv_v = u(H, W), u(H, W), u(H, W), u(H, W)
    wu_h[:, -1] = 0
    wv_h[:, -1] = 0
    wu_v[-1, :] = 0
    wv_v[-1, :] = 0
    fields = [u(H, W) + 1.0, 0.5 * u(H, W), u(H, W) + 1.0, wu_h, wu_v, wv_h, wv_v, u(H, W), u(H, W)]
    return [lib(f, dtype) for f in fields]


@pytest.mark.parametrize("solver,dtype", [("pcg", "float64"), ("backslash", "float64"), ("pcg", "float32")])
def test_solve_flow_system_twin_matches_jax(jnp, rng, solver, dtype):
    from optical_flow_tpu.ops.stencil import FlowSystem as FJ
    from optical_flow_tpu.solvers.cg import solve_flow_system as sj
    from optical_flow_tpu_torch.ops.stencil import FlowSystem as FP, system_apply
    from optical_flow_tpu_torch.solvers.cg import solve_flow_system as sp

    H, W = 30, 44
    seed = int(rng.integers(1 << 30))
    sys_p = FP(*_random_system(np.random.default_rng(seed), H, W, t, getattr(torch, dtype)))
    sys_j = FJ(*_random_system(np.random.default_rng(seed), H, W, j, getattr(jnp, dtype)))
    x_p = sp(sys_p, solver)
    x_j = sj(sys_j, solver)
    scale = max(float(np.abs(n(x_j)).max()), 1.0)
    # reductions sum in another order, so the iterates differ at rounding
    # level; the solutions agree well inside the solver's own tolerance
    tol = {"float64": 1e-9, "float32": 1e-5}[dtype]
    np.testing.assert_allclose(n(x_p), n(x_j), atol=tol * scale)
    rtol = 1e-3 if solver == "pcg" else 1e-7
    r = n(system_apply(sys_p, x_p)) - np.stack([n(sys_p.b_u), n(sys_p.b_v)], -1)
    assert np.linalg.norm(r) <= 10 * rtol * np.linalg.norm(np.stack([n(sys_p.b_u), n(sys_p.b_v)]))


def test_pcg_twin_iteration_count_and_unported_solvers(jnp, rng):
    from optical_flow_tpu.ops.stencil import FlowSystem as FJ, system_apply_split as aj, weighted_laplacian_diag as dj
    from optical_flow_tpu.solvers.cg import pcg_solve_split as pj
    from optical_flow_tpu_torch.ops.stencil import FlowSystem as FP, system_apply_split as ap, weighted_laplacian_diag as dp
    from optical_flow_tpu_torch.solvers.cg import pcg_solve_split as pp, solve_flow_system

    seed = int(rng.integers(1 << 30))
    sp_ = FP(*_random_system(np.random.default_rng(seed), 20, 24, t, torch.float64))
    sj_ = FJ(*_random_system(np.random.default_rng(seed), 20, 24, j, jnp.float64))

    def run(S, lib_apply, lib_diag, solve):
        du = S.a11 + lib_diag(S.wu_h, S.wu_v)
        dv = S.a22 + lib_diag(S.wv_h, S.wv_v)
        return solve(lambda xu, xv: lib_apply(S, xu, xv), S.b_u, S.b_v, du, dv, 1e-6, 400, a12=S.a12, return_iters=True)

    xu_p, xv_p, k_p = run(sp_, ap, dp, pp)
    xu_j, xv_j, k_j = run(sj_, aj, dj, pj)
    assert k_p == int(k_j) and 0 < k_p < 400
    close(xu_p, xu_j, rtol=1e-9, atol=1e-10)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve_flow_system(sp_, "sor")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rof_twin_matches_jax(jnp, rng, dtype):
    from optical_flow_tpu.ops.rof import rof_structure_2d as rj, structure_texture_decomposition_rof as dj
    from optical_flow_tpu_torch.ops.rof import rof_structure_2d as rp, structure_texture_decomposition_rof as dp

    im = rng.uniform(-1, 1, (33, 47))
    pair = rng.uniform(0, 255, (21, 30, 2))
    if dtype == "float64":
        close(rp(t(im)), rj(j(im)), rtol=1e-12, atol=1e-12)
        close(dp(t(pair), 1.0 / 8, 100, 0.95), dj(j(pair), 1.0 / 8, 100, 0.95), rtol=1e-11, atol=1e-10)
    else:  # the Pallas kernel's own criterion
        np.testing.assert_allclose(n(rp(t(im, torch.float32))), n(rj(j(im, jnp.float32))), atol=1e-6)
        out = dp(t(pair, torch.float32), 1.0 / 8, 100, 0.95)
        np.testing.assert_allclose(n(out), n(dj(j(pair, jnp.float32), 1.0 / 8, 100, 0.95)), atol=1e-3)


def test_rof_twin_batch_axis_is_per_image(rng):
    from optical_flow_tpu_torch.ops.cuda.rof_kernel import rof_structure

    ims = t(rng.uniform(-1, 1, (2, 9, 13)))
    both = rof_structure(ims, 1.0 / 8, 30)
    for b in range(2):
        close(both[b], rof_structure(ims[b], 1.0 / 8, 30), rtol=0, atol=0)


def test_wrappers_take_cpu_tensors_to_the_twin_and_refuse_other_devices(rng):
    """On a CPU tensor every wrapper runs its twin and launches nothing; on a
    tensor of another device type it raises (it never falls back)."""
    from optical_flow_tpu_torch.ops.cuda import cg_kernel, rof_kernel, wmedian_kernel
    from optical_flow_tpu_torch.ops.stencil import FlowSystem

    before = (wmedian_kernel.launches, cg_kernel.launches, rof_kernel.launches)
    im = t(rng.uniform(-1, 1, (6, 7)), torch.float32)
    rof_kernel.rof_structure(im, 1.0 / 8, 5)
    pad = t(rng.uniform(0, 1, (10, 11)), torch.float32)
    wmedian_kernel.wmedian(pad, pad, pad, pad[None], (6, 7), 2, 7.0)
    sysm = FlowSystem(*_random_system(rng, 6, 7, t, torch.float32))
    cg_kernel.cg_solve(sysm, 1e-3, 50)
    assert (wmedian_kernel.launches, cg_kernel.launches, rof_kernel.launches) == before

    meta = torch.zeros((6, 7), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rof_kernel.rof_structure(meta)
    with pytest.raises(ValueError, match="CUDA"):
        wmedian_kernel.wmedian(meta, meta, meta, meta[None], (2, 3), 2, 7.0)
    with pytest.raises(ValueError, match="CUDA"):
        cg_kernel.cg_solve(FlowSystem(*[meta] * 9), 1e-3, 10)


# ------------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("shape,hsz,C,ties", WMEDIAN_CASES)
def test_wmedian_kernel_bit_exact(cuda_device, rng, shape, hsz, C, ties):
    from optical_flow_tpu_torch.ops.cuda.wmedian_kernel import wmedian, wmedian_plain
    from optical_flow_tpu_torch.ops.filters import pad2d

    uv, color, occ = _wmedian_inputs(rng, *shape, C, ties)

    def pad(x):
        return pad2d(torch.as_tensor(x, device=cuda_device), hsz, hsz, hsz, hsz, "mirror").contiguous()

    args = (pad(uv[:, :, 0]), pad(uv[:, :, 1]), pad(occ), pad(np.moveaxis(color, 2, 0)), shape, hsz, 7.0)
    out = wmedian(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, wmedian_plain(*args))


@pytest.mark.cuda
def test_cg_kernel_matches_twin(cuda_device, rng):
    from optical_flow_tpu_torch.ops.cuda.cg_kernel import cg_solve, cg_solve_plain
    from optical_flow_tpu_torch.ops.stencil import FlowSystem, system_apply

    sysm = FlowSystem(*[f.to(cuda_device) for f in _random_system(rng, 30, 132, t, torch.float32)])
    x_k = cg_solve(sysm, 1e-6, 1000)
    x_t = cg_solve_plain(sysm, 1e-6, 1000)
    torch.cuda.synchronize()
    scale = max(float(x_t.abs().max()), 1.0)
    assert float((x_k - x_t).abs().max()) <= 1e-5 * scale
    b = torch.stack([sysm.b_u, sysm.b_v], -1)
    assert float(torch.linalg.norm(system_apply(sysm, x_k) - b)) <= 10 * 1e-6 * float(torch.linalg.norm(b))


@pytest.mark.cuda
def test_rof_kernel_matches_twin(cuda_device, rng):
    from optical_flow_tpu_torch.ops.cuda.rof_kernel import rof_structure, rof_structure_2d

    im = torch.as_tensor(rng.uniform(-1, 1, (2, 33, 47)), dtype=torch.float32, device=cuda_device)
    out = rof_structure(im, 1.0 / 8, 100)
    torch.cuda.synchronize()
    assert float((out - rof_structure_2d(im, 1.0 / 8, 100)).abs().max()) <= 1e-6
