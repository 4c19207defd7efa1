"""The resident schedules of the whole-PCG and ROF kernels, modelled on the CPU.

``csrc/cg.cu`` and ``csrc/rof.cu`` run their resident path as one block per
band of rows, each band holding its state with one halo row each side.
The models below run that schedule in PyTorch on the CPU, band by band,
with only the data a band holds: PCG with per-band double partials summed
in band order and the halo rows of p recomputed as ``z_halo + beta p_halo``
(two barriers an iteration); ROF with the dual field's halo rows swapped
after each step.  They are held against the plain twins and the JAX package,
and the path choice (``cg_plan``, ``rof_plan``) against the main path's
shapes.  Tests marked ``cuda`` run the kernels on the card:
``python -m pytest tests/test_torch_resident.py -m cuda --noconftest``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from optical_flow_tpu_torch.ops.cuda.cg_kernel import (  # noqa: E402
    RES_STATIC_SMEM, RES_THREADS, CgPlan, _block_jacobi_split, band_bounds, cg_plan, cg_solve_plain, pcg_solve_split,
)
from optical_flow_tpu_torch.ops.cuda.rof_kernel import rof_plan, rof_structure_2d  # noqa: E402
from optical_flow_tpu_torch.ops.stencil import FlowSystem, system_apply, system_apply_split, weighted_laplacian_diag  # noqa: E402

H100 = (132, 232448)  # SMs, shared memory a block may opt in to
# the (H, W) of the main path's pyramid levels (RubberWhale 584x388, classic+nl-fast)
MAIN_PATH_LEVELS = [(388, 584), (310, 467), (194, 292), (97, 146), (49, 73), (25, 37)]


@pytest.fixture()
def rng():
    # also defined here so that ``-m cuda --noconftest`` runs on a GPU host without JAX
    return np.random.default_rng(0)


@pytest.fixture()
def jnp():
    return pytest.importorskip("jax.numpy")


def _random_system(rng, H, W, dtype, device="cpu"):
    """A seeded random SPD flow system, the Pallas CG test's recipe."""

    def u(*s):
        return rng.uniform(0.1, 1.0, s)

    wu_h, wu_v, wv_h, wv_v = u(H, W), u(H, W), u(H, W), u(H, W)
    wu_h[:, -1] = 0
    wv_h[:, -1] = 0
    wu_v[-1, :] = 0
    wv_v[-1, :] = 0
    fields = [u(H, W) + 1.0, 0.5 * u(H, W), u(H, W) + 1.0, wu_h, wu_v, wv_h, wv_v, u(H, W), u(H, W)]
    return FlowSystem(*[torch.as_tensor(f, dtype=dtype, device=device) for f in fields])


# ------------------------------------------------------------------ path choice


@pytest.mark.parametrize("H,nb", [(388, 132), (310, 132), (97, 97), (20, 7), (7, 7), (133, 132), (5, 1)])
def test_band_bounds_cover_the_rows_in_order(H, nb):
    bounds = band_bounds(H, nb)
    assert len(bounds) == nb
    assert bounds[0][0] == 0 and sum(r for _, r in bounds) == H
    for (r0, rows), (r1, _) in zip(bounds, bounds[1:]):
        assert r1 == r0 + rows
    sizes = [r for _, r in bounds]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)  # a ragged band is a last one


@pytest.mark.parametrize("shape", MAIN_PATH_LEVELS)
def test_cg_plan_main_path_levels_are_resident(shape):
    plan = cg_plan(1, *shape, *H100)
    assert plan.path in ("single", "resident")
    rows = max(r for _, r in band_bounds(shape[0], plan.blocks))
    assert rows * shape[1] <= plan.ppt * RES_THREADS
    assert plan.smem <= H100[1] - RES_STATIC_SMEM
    if plan.path == "resident":
        assert plan.blocks == min(132, shape[0])


def test_cg_plan_large_systems_stream_and_small_ones_take_one_block():
    assert cg_plan(1, 2160, 3840, *H100) == CgPlan("streaming")
    assert cg_plan(1, 1200, 1600, *H100) == CgPlan("streaming")
    assert cg_plan(1, 25, 37, *H100).path == "single"
    assert cg_plan(1, 388, 584, *H100).blocks == 132
    # fewer SMs or less shared memory: the same shape may have to stream
    assert cg_plan(1, 388, 584, 40, 232448).path == "streaming"
    assert cg_plan(1, 49, 73, 132, 48 * 1024).path == "resident"


@pytest.mark.parametrize("shape", [(2, 388, 584), (1, 388, 584), (2, 33, 47), (2, 25, 37)])
def test_rof_plan_main_path_is_resident(shape):
    plan = rof_plan(*shape, *H100)
    assert plan.path == "resident"
    assert shape[0] * plan.per_image <= 132 and plan.per_image <= shape[1]
    assert plan.smem <= H100[1]


@pytest.mark.parametrize("shape", [(2, 2160, 3840), (2, 1080, 1920), (133, 8, 8)])
def test_rof_plan_large_inputs_stream(shape):
    assert rof_plan(*shape, *H100).path == "streaming"


def test_every_c_entry_is_defined_in_the_sources():
    """Each name the wrapper binds with ctypes is an ``extern "C"`` function of
    csrc/ (the library fails to load on the card otherwise)."""
    import re

    from optical_flow_tpu_torch.ops.cuda.build import CSRC_DIR, SIGNATURES

    text = "".join(p.read_text() for p in sorted(CSRC_DIR.glob("*.cu")))
    defined = set(re.findall(r'extern "C" int (\w+)\(', text))
    assert set(SIGNATURES) == defined


# ------------------------------------------------------------------ PCG model


class _Band:
    """One band's state: rows [i0, i0 + rows) with a halo row each side."""

    def __init__(self, sys, i0, rows):
        H, W = sys.a11.shape
        self.i0, self.rows, self.H = i0, rows, H
        own = slice(i0, i0 + rows)
        self.a11, self.a12, self.a22 = sys.a11[own], sys.a12[own], sys.a22[own]
        self.wuh, self.wvh = sys.wu_h[own], sys.wv_h[own]
        zero_row = torch.zeros((1, W), dtype=sys.a11.dtype)
        up = slice(i0 - 1, i0) if i0 > 0 else None
        # vertical weights with the row above (zeros above the image)
        self.wuv = torch.cat([sys.wu_v[up] if up else zero_row, sys.wu_v[own]])
        self.wvv = torch.cat([sys.wv_v[up] if up else zero_row, sys.wv_v[own]])
        self.gi = torch.arange(i0, i0 + rows)[:, None]
        du = self.a11 + self._diag(self.wuh, self.wuv)
        dv = self.a22 + self._diag(self.wvh, self.wvv)
        self.precond = _block_jacobi_split(du, dv, self.a12)
        self.ru, self.rv = sys.b_u[own], sys.b_v[own]
        self.xu, self.xv = torch.zeros_like(self.ru), torch.zeros_like(self.rv)
        zu, zv = self.precond(self.ru, self.rv)
        # p = z with the halo rows recomputed from the inputs of those rows
        self.pu = torch.cat([_p0_row(sys, i0 - 1), zu, _p0_row(sys, i0 + rows)])
        self.pv = torch.cat([_p0_row(sys, i0 - 1, 1), zv, _p0_row(sys, i0 + rows, 1)])

    @staticmethod
    def _diag(wh, wv_ext):
        # ((wh + wh_left) + wv) + wv_up, as the twin's weighted_laplacian_diag
        return ((wh + F.pad(wh[:, :-1], (1, 0))) + wv_ext[1:]) + wv_ext[:-1]

    def _lap(self, wh, wv_ext, p):
        zero = torch.zeros((), dtype=p.dtype)
        pc = p[1:-1]
        eh = wh * (pc - F.pad(pc[:, 1:], (0, 1)))
        ev = wv_ext[1:] * (pc - torch.where(self.gi < self.H - 1, p[2:], zero))
        ehl = F.pad(eh[:, :-1], (1, 0))
        evu = torch.where(self.gi > 0, wv_ext[:-1] * (p[:-2] - pc), zero)
        return ((eh + ev) - ehl) - evu

    def apply(self):
        pu, pv = self.pu[1:-1], self.pv[1:-1]
        apu = (self.a11 * pu + self.a12 * pv) + self._lap(self.wuh, self.wuv, self.pu)
        apv = (self.a12 * pu + self.a22 * pv) + self._lap(self.wvh, self.wvv, self.pv)
        return apu, apv


def _p0_row(sys, i, field=0):
    """z = M^-1 b on row i alone, from the inputs (zeros outside the image)."""
    H, W = sys.a11.shape
    if not 0 <= i < H:
        return torch.zeros((1, W), dtype=sys.a11.dtype)
    rows = slice(max(i - 1, 0), i + 1)
    sub = FlowSystem(*[f[rows] for f in sys])
    du = sub.a11 + weighted_laplacian_diag(sub.wu_h, sub.wu_v)
    dv = sub.a22 + weighted_laplacian_diag(sub.wv_h, sub.wv_v)
    z = _block_jacobi_split(du, dv, sub.a12)(sub.b_u, sub.b_v)[field]
    return z[-1:]


def _dot64(*pairs):
    """Per-pixel sum of products in double, summed over the band."""
    return float(sum((a.double() * b.double()) for a, b in pairs).sum())


def cg_band_model(sys, rtol, maxiter, bands):
    """The resident PCG schedule of csrc/cg.cu on ``bands`` bands of rows.

    Returns (x (H, W, 2), iterations, halo rows of p that differ from their
    owner's rows, summed over the solve)."""
    H, W = sys.a11.shape
    dt = sys.a11.dtype
    zero = torch.zeros((), dtype=dt)
    B = [_Band(sys, i0, rows) for i0, rows in band_bounds(H, bands)]

    def fixed_order(parts):  # every block adds the bands' double partials in band order
        total = 0.0
        for v in parts:
            total += v
        return torch.tensor(total, dtype=dt)

    def halo_mismatches():
        bad = 0
        for up, down in zip(B, B[1:]):
            bad += not torch.equal(down.pu[0], up.pu[-2]) or not torch.equal(down.pv[0], up.pv[-2])
            bad += not torch.equal(up.pu[-1], down.pu[1]) or not torch.equal(up.pv[-1], down.pv[1])
        return bad

    zs = [b.precond(b.ru, b.rv) for b in B]
    rz = fixed_order([_dot64((b.ru, z[0]), (b.rv, z[1])) for b, z in zip(B, zs)])
    rr = fixed_order([_dot64((b.ru, b.ru), (b.rv, b.rv)) for b in B])
    tol2 = torch.tensor(rtol**2, dtype=dt) * rr
    bad = halo_mismatches()
    it = 0
    while it < maxiter and bool(rr > tol2):
        # (A) A p and p.Ap; barrier 1
        aps = [b.apply() for b in B]
        pap = fixed_order([_dot64((b.pu[1:-1], a[0]), (b.pv[1:-1], a[1])) for b, a in zip(B, aps)])
        alpha = torch.where(pap != 0.0, rz / pap, zero)
        # (B) x, r, z, r.z, r.r; z's first and last rows published; barrier 2
        zs, rz_parts, rr_parts = [], [], []
        for b, (apu, apv) in zip(B, aps):
            b.xu = b.xu + alpha * b.pu[1:-1]
            b.xv = b.xv + alpha * b.pv[1:-1]
            b.ru = b.ru - alpha * apu
            b.rv = b.rv - alpha * apv
            zs.append(b.precond(b.ru, b.rv))
            rz_parts.append(_dot64((b.ru, zs[-1][0]), (b.rv, zs[-1][1])))
            rr_parts.append(_dot64((b.ru, b.ru), (b.rv, b.rv)))
        rz_new, rr = fixed_order(rz_parts), fixed_order(rr_parts)
        beta = torch.where(rz != 0.0, rz_new / rz, zero)
        # (C) p = z + beta p on the band; the halo rows from the neighbours' z
        for k, (b, (zu, zv)) in enumerate(zip(B, zs)):
            top_u = zs[k - 1][0][-1:] if k > 0 else torch.zeros_like(zu[:1])
            top_v = zs[k - 1][1][-1:] if k > 0 else torch.zeros_like(zv[:1])
            bot_u = zs[k + 1][0][:1] if k + 1 < len(B) else torch.zeros_like(zu[:1])
            bot_v = zs[k + 1][1][:1] if k + 1 < len(B) else torch.zeros_like(zv[:1])
            b.pu = torch.cat([top_u, zu, bot_u]) + beta * b.pu
            b.pv = torch.cat([top_v, zv, bot_v]) + beta * b.pv
        bad += halo_mismatches()
        rz = rz_new
        it += 1
    x = torch.stack([torch.cat([b.xu for b in B]), torch.cat([b.xv for b in B])], -1)
    return x, it, bad


# bands of: one band, two, a ragged last band (20 rows in 7), one row each,
# 132 bands as on the card (one of two rows, 131 of one)
BAND_CASES = [((20, 24), 1), ((20, 24), 2), ((20, 24), 7), ((7, 9), 7), ((133, 5), 132)]


def _twin(sys, rtol, maxiter):
    du = sys.a11 + weighted_laplacian_diag(sys.wu_h, sys.wu_v)
    dv = sys.a22 + weighted_laplacian_diag(sys.wv_h, sys.wv_v)
    xu, xv, k = pcg_solve_split(lambda a, b: system_apply_split(sys, a, b), sys.b_u, sys.b_v, du, dv,
                                rtol, maxiter, a12=sys.a12, return_iters=True)
    return torch.stack([xu, xv], -1), k


@pytest.mark.parametrize("shape,bands", BAND_CASES)
def test_cg_band_model_float64_matches_twin_and_jax(jnp, rng, shape, bands):
    from optical_flow_tpu.ops.stencil import FlowSystem as FJ, system_apply_split as aj, weighted_laplacian_diag as dj
    from optical_flow_tpu.solvers.cg import pcg_solve_split as pj

    seed = int(rng.integers(1 << 30))
    sysm = _random_system(np.random.default_rng(seed), *shape, torch.float64)
    x_m, k_m, bad = cg_band_model(sysm, 1e-6, 400, bands)
    x_t, k_t = _twin(sysm, 1e-6, 400)
    sj = FJ(*[jnp.asarray(f.numpy()) for f in sysm])
    du = sj.a11 + dj(sj.wu_h, sj.wu_v)
    dv = sj.a22 + dj(sj.wv_h, sj.wv_v)
    xu_j, xv_j, k_j = pj(lambda a, b: aj(sj, a, b), sj.b_u, sj.b_v, du, dv, 1e-6, 400, a12=sj.a12, return_iters=True)
    assert bad == 0
    assert k_m == k_t == int(k_j) and 0 < k_m < 400
    scale = max(float(x_t.abs().max()), 1.0)
    # the sums run in another order (per band, then over bands): rounding level at float64
    np.testing.assert_allclose(x_m.numpy(), x_t.numpy(), rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(x_m.numpy(), np.stack([np.asarray(xu_j), np.asarray(xv_j)], -1), rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize("shape,bands", BAND_CASES)
def test_cg_band_model_float32_matches_twin(rng, shape, bands):
    """At float32 the model sums in double per band (as the kernel does) and
    the twin in float32 over the image, so the iterates differ at float32
    rounding; the limits are chip_smoke.py's for the kernel: max |dx| <=
    1e-5 x scale and a relative residual <= 10 x rtol."""
    sysm = _random_system(rng, *shape, torch.float32)
    x_m, k_m, bad = cg_band_model(sysm, 1e-6, 400, bands)
    x_t, k_t = _twin(sysm, 1e-6, 400)
    assert bad == 0  # the recomputed halo p is the owner's p bit for bit
    assert abs(k_m - k_t) <= 2
    scale = max(float(x_t.abs().max()), 1.0)
    assert float((x_m - x_t).abs().max()) <= 1e-5 * scale
    s64 = FlowSystem(*[f.double() for f in sysm])
    b = torch.stack([s64.b_u, s64.b_v], -1)
    assert float(torch.linalg.norm(system_apply(s64, x_m.double()) - b) / torch.linalg.norm(b)) <= 10 * 1e-6


def test_cg_band_model_stops_before_the_first_iteration_and_at_maxiter(rng):
    sysm = _random_system(rng, 9, 11, torch.float64)
    x, k, _ = cg_band_model(sysm, 1e-6, 0, 3)
    assert k == 0 and not x.abs().any()
    sysm = sysm._replace(b_u=torch.zeros_like(sysm.b_u), b_v=torch.zeros_like(sysm.b_v))
    x, k, _ = cg_band_model(sysm, 1e-6, 50, 3)  # ||b|| = 0: nothing to do
    assert k == 0 and not x.abs().any()
    x, k, bad = cg_band_model(_random_system(rng, 9, 11, torch.float64), 0.0, 5, 4)
    assert k == 5 and bad == 0


# ------------------------------------------------------------------ ROF model


def rof_band_model(im, theta, n_iters, bands):
    """The resident ROF schedule of csrc/rof.cu: every (H, W) image of ``im``
    (B, H, W) in ``bands`` bands of rows, each holding its image, px and
    the primal on the band and the row below and py with a row each side;
    the halo rows come from the neighbours after every step."""
    B_, H, W = im.shape
    delta = 1.0 / (4.0 * theta)
    out = torch.empty_like(im)
    for n in range(B_):
        bounds = band_bounds(H, bands)
        zero_row = torch.zeros((1, W), dtype=im.dtype)
        S = []
        for i0, rows in bounds:
            below = i0 + rows < H
            S.append({"i0": i0, "rows": rows, "below": below,
                      "im": torch.cat([im[n, i0:i0 + rows], im[n, i0 + rows:i0 + rows + 1] if below else zero_row]),
                      "px": torch.zeros((rows + 1, W), dtype=im.dtype),
                      "py": torch.zeros((rows + 2, W), dtype=im.dtype),
                      "gi": torch.arange(i0, i0 + rows + 1)[:, None]})

        def primal(s):
            px, py = s["px"], s["py"]
            pyu = torch.where(s["gi"] > 0, py[:-1], torch.zeros((), dtype=im.dtype))
            return s["im"] + theta * ((px - F.pad(px[:, :-1], (1, 0))) + (py[1:] - pyu))

        for _ in range(n_iters):
            for s in S:
                rows = s["rows"]
                u = primal(s)
                if not s["below"]:
                    u[rows:] = 0.0
                gx = F.pad(u[:rows, 1:] - u[:rows, :-1], (0, 1))
                gy = torch.where(s["gi"][:rows] < H - 1, u[1:] - u[:-1], torch.zeros((), dtype=im.dtype))
                px = s["px"][:rows] + delta * gx
                py = s["py"][1:rows + 1] + delta * gy
                norm = torch.clamp(torch.sqrt(px**2 + py**2), min=1.0)
                s["px"] = torch.cat([px / norm, s["px"][rows:]])
                s["py"] = torch.cat([s["py"][:1], py / norm, s["py"][rows + 1:]])
            for k, s in enumerate(S):  # after the barrier: the neighbours' rows
                if k > 0:
                    s["py"] = torch.cat([S[k - 1]["py"][-2:-1], s["py"][1:]])
                if s["below"]:
                    s["px"] = torch.cat([s["px"][:-1], S[k + 1]["px"][:1]])
                    s["py"] = torch.cat([s["py"][:-1], S[k + 1]["py"][1:2]])
        out[n] = torch.cat([primal(s)[: s["rows"]] for s in S])
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape,bands,n_iters", [((2, 33, 47), 33, 40), ((2, 33, 47), 5, 100), ((2, 20, 13), 7, 100),
                                                  ((2, 12, 9), 1, 100)])
def test_rof_band_model_equals_twin_bit_for_bit(rng, dtype, shape, bands, n_iters):
    im = torch.as_tensor(rng.uniform(-1, 1, shape), dtype=getattr(torch, dtype))
    assert torch.equal(rof_band_model(im, 1.0 / 8, n_iters, bands), rof_structure_2d(im, 1.0 / 8, n_iters))


# ------------------------------------------------------------------ on the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MAIN_PATH_LEVELS + [(7, 9), (133, 5), (1200, 1600)])
def test_cg_kernel_paths_match_twin(cuda_device, rng, shape):
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits

    sysm = _random_system(rng, *shape, torch.float32, cuda_device)
    before = (cg_kernel.launches_resident, cg_kernel.launches_streaming)
    x_k = cg_kernel.cg_solve(sysm, 1e-6, 100)
    path = cg_kernel.cg_plan(1, *shape, *device_limits(cuda_device)).path
    after = (cg_kernel.launches_resident, cg_kernel.launches_streaming)
    assert after[path == "streaming"] == before[path == "streaming"] + 1
    x_t = cg_solve_plain(sysm, 1e-6, 100)
    again = cg_kernel.cg_solve(sysm, 1e-6, 100)
    torch.cuda.synchronize()
    scale = max(float(x_t.abs().max()), 1.0)
    assert float((x_k - x_t).abs().max()) <= 1e-5 * scale
    b = torch.stack([sysm.b_u, sysm.b_v], -1)
    assert float(torch.linalg.norm(system_apply(sysm, x_k) - b)) <= 10 * 1e-6 * float(torch.linalg.norm(b))
    assert torch.equal(x_k, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 388, 584), (2, 33, 47), (2, 100, 47), (1, 25, 37), (2, 1080, 1920)])
def test_rof_kernel_paths_equal_twin(cuda_device, rng, shape):
    from optical_flow_tpu_torch.ops.cuda.rof_kernel import rof_structure

    im = torch.as_tensor(rng.uniform(-1, 1, shape), dtype=torch.float32, device=cuda_device)
    out = rof_structure(im, 1.0 / 8, 100)
    torch.cuda.synchronize()
    assert torch.equal(out, rof_structure_2d(im, 1.0 / 8, 100))
