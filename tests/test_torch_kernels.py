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

from torch_parity import close, j, n, one_cpu_thread, t  # noqa: E402,F401


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


@pytest.mark.parametrize("guide", ["none", "placeholder"])
def test_wmedian_no_guide_fallback(jnp, rng, guide):
    """Without a guide (None, or the presets' (1, 1, 3) placeholder) both
    packages apply a plain median of size mfsz[0] with scipy-'reflect' padding."""
    from optical_flow_tpu.ops.wmedian import denoise_color_weighted_medfilt2 as dj
    from optical_flow_tpu_torch.ops.wmedian import denoise_color_weighted_medfilt2 as dp

    uv = rng.standard_normal((15, 21, 2))
    uv[4, 6, 1] = np.nan
    occ = rng.uniform(0.1, 1.0, (15, 21))
    color = None if guide == "none" else np.ones((1, 1, 3))
    out_p = dp(t(uv), None if color is None else t(color), t(occ), 7, [7, 5], 7.0)
    out_j = dj(j(uv), None if color is None else j(color), j(occ), 7, [7, 5], 7.0)
    np.testing.assert_array_equal(n(out_p), n(out_j))


INT32_MIN, INT32_MAX = np.int32(np.iinfo(np.int32).min), np.int32(np.iinfo(np.int32).max)


def _lanes_for(hsz):
    """Lanes per output pixel, as ``lanes_for`` in csrc/wmedian.cu: the fewest
    (a power of two) that leave each lane at most 29 window samples."""
    g = 1
    while -(-((2 * hsz + 1) ** 2) // g) > 29:
        g *= 2
    return g


def _encode_keys(x):
    """float32 -> order-isomorphic int32 key, as ``encode_f32`` in the kernel."""
    b = np.ascontiguousarray(x, np.float32).view(np.int32)
    return np.where(b < 0, np.invert(b) ^ INT32_MIN, b)


def _decode_keys(k):
    b = np.where(k < 0, np.invert(k ^ INT32_MIN), k).astype(np.int32)
    return b.view(np.float32)


def _group_sum(part):
    """Xor butterfly over the G lanes of (N, G) float32 partial sums; every lane
    adds the same two values at each step, so all lanes end bit-identical."""
    G = part.shape[1]
    m = 1
    while m < G:
        part = part + part[:, np.arange(G) ^ m]
        m *= 2
    assert (part == part[:, :1]).all()
    return part[:, 0]


def wmedian_select_model(values, weights, lanes, early_exit=True):
    """Numpy model of the kernel's selection for (N, K2) float32 windows.

    Lane l of a pixel's group holds the samples o = s * lanes + l (slots past
    the window: key INT32_MAX, weight 0).  Sums are per lane in slot order,
    then the butterfly.  lo = min - 1, hi = max; bisection while hi - lo > 1,
    at most 32 rounds.  Returns (medians, rounds per window).
    """
    N, K2 = values.shape
    NS = -(-K2 // lanes)
    pad = NS * lanes - K2
    keys = np.concatenate([_encode_keys(values), np.full((N, pad), INT32_MAX)], 1).reshape(N, NS, lanes)
    w = np.concatenate([weights.astype(np.float32), np.zeros((N, pad), np.float32)], 1).reshape(N, NS, lanes)
    valid = (np.arange(NS * lanes) < K2).reshape(NS, lanes)

    def S(take):  # (N, NS, lanes) bool -> (N,) float32
        acc = np.zeros((N, lanes), np.float32)
        for s in range(NS):
            acc = acc + np.where(take[:, s], w[:, s], np.float32(0.0))
        return _group_sum(acc)

    half = S(np.ones_like(valid, shape=keys.shape)) * np.float32(0.5)
    lo = np.where(valid, keys, INT32_MAX).min(axis=(1, 2)) - np.int32(1)
    hi = np.where(valid, keys, INT32_MIN).max(axis=(1, 2))
    rounds = np.zeros(N, np.int64)
    for _ in range(32):
        active = hi.astype(np.int64) - lo > 1 if early_exit else np.ones(N, bool)
        if not active.any():
            break
        mid = (lo & hi) + ((lo ^ hi) >> 1)
        ge = S(keys <= mid[:, None, None]) >= half
        hi = np.where(active & ge, mid, hi)
        lo = np.where(active & ~ge, mid, lo)
        rounds += active
    return _decode_keys(hi), rounds


def _hard_windows(kind, rng, N, K2):
    """(values, weights) of N windows of K2 samples that stress the selection.

    Weights are multiples of 1/64 (below 2^24 / 64 in total) unless the case
    says otherwise, so every partial sum is exact in float32 in any order and
    the model must equal the sort twin exactly."""
    w = rng.integers(1, 65, (N, K2)) / 64.0
    if kind == "all_equal":
        v = np.repeat(rng.standard_normal((N, 1)), K2, 1)
    elif kind == "signed_zeros":
        v = rng.choice(np.array([-0.0, 0.0, -1.5, 2.0]), (N, K2), p=[0.4, 0.4, 0.1, 0.1])
    elif kind == "straddle_zero":
        v = rng.standard_normal((N, K2)) * 10.0 ** rng.integers(-30, 3, (N, 1))
    elif kind == "ties_unequal_weights":
        v = np.round(rng.standard_normal((N, K2)) * 2) / 4
        w = w * rng.choice([1.0, 16.0], (N, K2))
    elif kind == "dominant_weight":
        v = rng.standard_normal((N, K2)) * 3
        w = np.full((N, K2), 1e-10)
        w[np.arange(N), rng.integers(0, K2, N)] = rng.uniform(0.1, 1.0, N)
    elif kind == "half_split":  # two blocks of equal weight: S(m) lands exactly on total/2
        v = rng.standard_normal((N, K2))
        w = np.ones((N, K2)) / 2 ** rng.integers(0, 6, (N, 1))
    else:
        raise ValueError(kind)
    return v.astype(np.float32), w.astype(np.float32)


WINDOW_KINDS = ["all_equal", "signed_zeros", "straddle_zero", "ties_unequal_weights", "dominant_weight", "half_split"]


@pytest.mark.parametrize("hsz", [0, 1, 7, 12])
@pytest.mark.parametrize("kind", WINDOW_KINDS)
def test_wmedian_kernel_selection_model_matches_sort_twin(rng, kind, hsz):
    """The kernel's lane-group selection (register slots, butterfly sums, exact
    early exit) picks the sort twin's sample on hard windows."""
    from optical_flow_tpu_torch.ops.cuda.wmedian_kernel import _weighted_median_lastaxis

    K2 = (2 * hsz + 1) ** 2
    v, w = _hard_windows(kind, rng, 48, K2)
    got, rounds = wmedian_select_model(v, w, _lanes_for(hsz))
    want = _weighted_median_lastaxis(torch.from_numpy(v), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)  # -0.0 == 0.0: the twin's zero may carry the other sign
    full, _ = wmedian_select_model(v, w, _lanes_for(hsz), early_exit=False)
    assert got.tobytes() == full.tobytes()  # the early exit is the 32-round result bit for bit
    assert rounds.max() <= 32
    if kind == "all_equal":
        assert (rounds == 0).all()


@pytest.mark.parametrize("hsz", [1, 7, 12])
def test_wmedian_kernel_selection_model_float_weights(rng, hsz):
    """With the filter's own float weights, the sums' order may move the total/2
    crossing by one sample: every differing median is the twin's neighbour in
    sorted order, as chip_smoke.py requires of the kernel."""
    from optical_flow_tpu_torch.ops.cuda.wmedian_kernel import _weighted_median_lastaxis

    K2 = (2 * hsz + 1) ** 2
    v = (3 * rng.standard_normal((256, K2))).astype(np.float32)
    cdiff = (rng.uniform(0, 24, (256, K2, 3)) ** 2).sum(-1).astype(np.float32)
    w = np.maximum(np.exp(-cdiff / np.float32(98.0)) * rng.uniform(0.1, 1, (256, K2)).astype(np.float32), 1e-10)
    w = w.astype(np.float32)
    got, rounds = wmedian_select_model(v, w, _lanes_for(hsz))
    want = _weighted_median_lastaxis(torch.from_numpy(v), torch.from_numpy(w)).numpy()
    for i in np.flatnonzero(got != want):
        lo, hi = sorted((got[i], want[i]))
        assert not ((v[i] > lo) & (v[i] < hi)).any()
    assert (got == want).mean() >= 0.99
    assert 0 < rounds.min() and rounds.max() <= 32


@pytest.mark.parametrize("lanes", [4, 8, 16])
def test_wmedian_kernel_selection_model_lane_counts(rng, lanes):
    """At hsz 7 every lane count timed on the card (4, 8, 16; the kernel uses
    8) selects alike on exact-sum windows."""
    from optical_flow_tpu_torch.ops.cuda.wmedian_kernel import _weighted_median_lastaxis

    v, w = _hard_windows("ties_unequal_weights", rng, 64, 225)
    got, _ = wmedian_select_model(v, w, lanes)
    np.testing.assert_array_equal(got, _weighted_median_lastaxis(torch.from_numpy(v), torch.from_numpy(w)).numpy())


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
    # 'sor', once unported, solves through the dispatch as in the JAX package
    from optical_flow_tpu.solvers.cg import solve_flow_system as sfj

    close(solve_flow_system(sp_, "sor"), sfj(sj_, "sor"), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="Unknown solver"):
        solve_flow_system(sp_, "gauss-seidel")


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


# beside the Pallas shapes: the window half-sizes at the ends of the kernel's
# range (1 and 32 lanes a pixel) and a shape that is no multiple of any tile
WMEDIAN_KERNEL_CASES = WMEDIAN_CASES + [((27, 41), 0, 1, False), ((29, 43), 12, 3, False), ((37, 53), 7, 3, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,hsz,C,ties", WMEDIAN_KERNEL_CASES)
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
