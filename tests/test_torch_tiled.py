"""The large-image kernels' schedules, modelled on the CPU.

``csrc/rof.cu``'s tiled ROF runs overlap-and-discard windows, ``k <= halo``
iterations on chip a pass; ``csrc/cg.cu``'s streaming PCG runs two sweeps an
iteration, with z recomputed and x updated one iteration late.  The models
below run those schedules in PyTorch on the CPU with the kernels' geometry
scaled down, and hold them against the plain twins: the tiled ROF bit for
bit, the two-sweep PCG in iterations and within 1e-12 in float64.  The
plans (``rof_plan``, ``cg_plan``) are pinned at the 4K harness's shapes on
an H100's limits.  Tests marked ``cuda`` run the kernels on the card:
``python -m pytest tests/test_torch_tiled.py -m cuda --noconftest``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from optical_flow_tpu_torch.ops.cuda.cg_kernel import (  # noqa: E402
    STREAM_COLS, CgPlan, _block_jacobi_split, cg_plan, cg_solve_plain, streaming_plan,
)
from optical_flow_tpu_torch.ops.cuda.rof_kernel import (  # noqa: E402
    WINDOW, RofPlan, device_launches, rof_plan, rof_structure_2d, tiled_schedule, tiled_smem,
)
from optical_flow_tpu_torch.ops.stencil import FlowSystem, system_apply_split, weighted_laplacian_diag  # noqa: E402
from test_torch_resident import _random_system, _twin  # noqa: E402
from torch_parity import one_cpu_thread  # noqa: E402,F401

H100 = (132, 232448)  # SMs, shared memory a block may opt in to


@pytest.fixture()
def rng():
    # also defined here so that ``-m cuda --noconftest`` runs on a GPU host without JAX
    return np.random.default_rng(0)


# ------------------------------------------------------------------ plans


def test_plans_at_the_4k_harness_shapes():
    tiled = RofPlan("tiled", 0, tiled_smem(), 8, 13, (80, 112))
    for shape in ((2160, 3840), (1728, 3072), (1080, 1920)):
        assert rof_plan(2, *shape, *H100) == tiled
    assert rof_plan(8, 388, 584, *H100) == tiled  # the B = 4 batch's 8 images
    assert device_launches(tiled) == 13
    assert rof_plan(2, 540, 960, *H100).path == "resident"
    assert tiled_smem() == 151552 <= H100[1]
    assert WINDOW == (96, 128)
    rows = {(2160, 3840): 128, (1728, 3072): 79, (1080, 1920): 33, (864, 1536): 20, (540, 960): 9}
    for (H, W), r in rows.items():
        plan = cg_plan(1, H, W, *H100)
        assert plan == CgPlan("streaming", 264, 0, 0, 1, r), (H, W)
        tiles = -(-W // STREAM_COLS) * -(-H // r)
        assert tiles <= plan.blocks  # one tile a block a sweep
    assert cg_plan(1, 388, 584, *H100).path == "resident"  # the main path is unchanged
    assert cg_plan(4, 2160, 3840, *H100) == streaming_plan(2160, 3840, 132)


@pytest.mark.parametrize("n_iters", [0, 1, 7, 8, 10, 99, 100, 104, 1000])
def test_tiled_schedule_keeps_every_pass_inside_its_halo(n_iters):
    halo, iters = tiled_schedule(n_iters)
    assert sum(iters) == n_iters and halo <= 8
    assert max(iters) <= halo and iters[-1] <= halo - 1
    assert len(iters) == -(-(n_iters + 1) // 8)


# ------------------------------------------------------------------ tiled ROF


def rof_tiled_model(im, theta, n_iters, tile, max_halo, halo=None, passes=None):
    """csrc/rof.cu's tiled schedule on (B, H, W) ``im``: windows of ``tile``
    plus ``halo`` pixels a side (``tiled_schedule`` unless given), each pass
    ``k`` iterations on the window alone, its zero boundary only at the
    image's true edges, then (px, py) of the tile out; the last pass writes
    u = im + theta div p.  Every operation in the kernel's order."""
    Bn, H, W = im.shape
    dt = im.dtype
    zero = torch.zeros((), dtype=dt)
    delta = 1.0 / (4.0 * theta)
    h, iters = tiled_schedule(n_iters, max_halo)
    h = h if halo is None else halo
    iters = iters if passes is None else passes
    tr, tc = tile
    R, C = tr + 2 * h, tc + 2 * h
    px_buf = py_buf = None
    for q, k in enumerate(iters):
        last = q == len(iters) - 1
        px_out, py_out, out = torch.empty_like(im), torch.empty_like(im), torch.empty_like(im)
        for n in range(Bn):
            for ty in range(-(-H // tr)):
                for tx in range(-(-W // tc)):
                    gi = torch.arange(ty * tr - h, ty * tr - h + R)[:, None]
                    gj = torch.arange(tx * tc - h, tx * tc - h + C)[None, :]
                    a = torch.arange(R)[:, None]
                    b = torch.arange(C)[None, :]
                    inside = (gi >= 0) & (gi < H) & (gj >= 0) & (gj < W)
                    gic, gjc = gi.clamp(0, H - 1), gj.clamp(0, W - 1)

                    def window(plane):
                        return torch.where(inside, plane[n][gic, gjc], zero)

                    imw = window(im)
                    px = window(px_buf) if q > 0 else torch.zeros((R, C), dtype=dt)
                    py = window(py_buf) if q > 0 else torch.zeros((R, C), dtype=dt)

                    def primal(px, py):
                        pxl = torch.where((gj > 0) & (b > 0), torch.roll(px, 1, 1), zero)
                        pyu = torch.where((gi > 0) & (a > 0), torch.roll(py, 1, 0), zero)
                        return imw + theta * ((px - pxl) + (py - pyu))

                    for _ in range(k):
                        u = primal(px, py)
                        ur = torch.where(b < C - 1, torch.roll(u, -1, 1), u)
                        ud = torch.where(a < R - 1, torch.roll(u, -1, 0), u)
                        gx = torch.where(gj < W - 1, ur - u, zero)
                        gy = torch.where(gi < H - 1, ud - u, zero)
                        pxn = px + delta * gx
                        pyn = py + delta * gy
                        n2 = pxn * pxn + pyn * pyn
                        norm = torch.sqrt(n2)
                        px = torch.where(n2 > 1.0, pxn / norm, pxn)
                        py = torch.where(n2 > 1.0, pyn / norm, pyn)
                    rows = slice(ty * tr, min(ty * tr + tr, H))
                    cols = slice(tx * tc, min(tx * tc + tc, W))
                    wr, wc = slice(h, h + rows.stop - rows.start), slice(h, h + cols.stop - cols.start)
                    if last:
                        out[n, rows, cols] = primal(px, py)[wr, wc]
                    else:
                        px_out[n, rows, cols] = px[wr, wc]
                        py_out[n, rows, cols] = py[wr, wc]
        px_buf, py_buf = px_out, py_out
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rof_tiled_model_equals_twin_bit_for_bit(rng, dtype):
    """8x12 tiles, passes of k <= 3 (halo 3), an odd 37x53 image, 10
    iterations: the halo covers the dependency cone and the masks put the
    zero boundary at the true edges only."""
    im = torch.as_tensor(rng.uniform(-1, 1, (2, 37, 53)), dtype=getattr(torch, dtype))
    assert tiled_schedule(10, 3) == (3, [3, 3, 2, 2])
    assert torch.equal(rof_tiled_model(im, 1.0 / 8, 10, (8, 12), 3), rof_structure_2d(im, 1.0 / 8, 10))


def test_rof_tiled_model_with_a_pass_longer_than_its_halo_differs(rng):
    """The test has teeth: a pass of 4 iterations in a halo of 3 reads the
    window's edge, and the result is no longer the twin's."""
    im = torch.as_tensor(rng.uniform(-1, 1, (1, 37, 53)), dtype=torch.float64)
    out = rof_tiled_model(im, 1.0 / 8, 10, (8, 12), 3, halo=3, passes=[4, 4, 2])
    assert not torch.equal(out, rof_structure_2d(im, 1.0 / 8, 10))


# ------------------------------------------------------------------ two-sweep PCG


def _irls_system(rng, H, W):
    """A small IRLS-like system: data term from random image gradients, robust
    spatial weights of a smooth random flow (as the flow methods build them)."""
    Ix, Iy = rng.normal(0, 1, (H, W)), rng.normal(0, 1, (H, W))
    It = rng.normal(0, 0.5, (H, W))
    wd = 1.0 / np.sqrt(It**2 + 1e-3)
    lam = 0.5

    def spatial():
        w = lam / np.sqrt(rng.normal(0, 1, (H, W)) ** 2 + 1e-2)
        return w

    wu_h, wu_v, wv_h, wv_v = spatial(), spatial(), spatial(), spatial()
    wu_h[:, -1] = wv_h[:, -1] = 0
    wu_v[-1, :] = wv_v[-1, :] = 0
    fields = [wd * Ix * Ix, wd * Ix * Iy, wd * Iy * Iy, wu_h, wu_v, wv_h, wv_v, -wd * Ix * It, -wd * Iy * It]
    return FlowSystem(*[torch.as_tensor(f, dtype=torch.float64) for f in fields])


def cg_two_sweep_model(sys, rtol, maxiter, plan):
    """csrc/cg.cu's streaming schedule on one (H, W) system: sweep 1 on the
    plan's tiles (z recomputed from r, p = z + beta p_old, x += alpha p_old one
    iteration late, A p and the tiles' p.Ap), sweep 2 on contiguous ranges of
    the pixels (r, z, r.z, r.r), each block's double partials summed in
    block order; then the last x update.  Returns (x (H, W, 2), iterations)."""
    H, W = sys.a11.shape
    dt = sys.a11.dtype
    zero = torch.zeros((), dtype=dt)
    G, tr = plan.blocks, plan.rows
    tiles = [(i0, j0) for i0 in range(0, H, tr) for j0 in range(0, W, STREAM_COLS)]
    n = H * W
    chunk = (-(-n // G) + 3) // 4 * 4
    ranges = [(min(n, g * chunk), min(n, g * chunk + chunk)) for g in range(G)]

    def by_block(parts):  # block g's partial is its tiles' (or range's) sums; blocks in order
        total = 0.0
        for v in parts:
            total += v
        return torch.tensor(total, dtype=dt)

    def tile_sums(f):
        per_block = [0.0] * G
        for t, (i0, j0) in enumerate(tiles):
            per_block[t % G] += float(f(slice(i0, i0 + tr), slice(j0, j0 + STREAM_COLS)).double().sum())
        return by_block(per_block)

    def range_sums(f):
        flat = f().reshape(-1).double()
        return by_block([float(flat[lo:hi].sum()) for lo, hi in ranges])

    du = sys.a11 + weighted_laplacian_diag(sys.wu_h, sys.wu_v)
    dv = sys.a22 + weighted_laplacian_diag(sys.wv_h, sys.wv_v)
    precond = _block_jacobi_split(du, dv, sys.a12)

    ru, rv = sys.b_u, sys.b_v
    zu, zv = precond(ru, rv)
    rz = range_sums(lambda: ru.double() * zu + rv.double() * zv)
    rr = range_sums(lambda: ru.double() * ru + rv.double() * rv)
    tol2 = torch.tensor(rtol**2, dtype=dt) * rr
    xu = xv = torch.zeros_like(ru)
    alpha = beta = zero
    pou = pov = None
    k = 0
    while k < maxiter and bool(rr > tol2):
        # sweep 1
        zu, zv = precond(ru, rv)
        if k == 0:
            pu, pv = zu, zv
        else:
            pu, pv = zu + beta * pou, zv + beta * pov
            xu, xv = xu + alpha * pou, xv + alpha * pov
        apu, apv = system_apply_split(sys, pu, pv)
        pap = tile_sums(lambda r, c: pu[r, c].double() * apu[r, c] + pv[r, c].double() * apv[r, c])
        alpha = torch.where(pap != 0.0, rz / pap, zero)
        # sweep 2
        ru, rv = ru - alpha * apu, rv - alpha * apv
        zu, zv = precond(ru, rv)
        rz_new = range_sums(lambda: ru.double() * zu + rv.double() * zv)
        rr = range_sums(lambda: ru.double() * ru + rv.double() * rv)
        beta = torch.where(rz != 0.0, rz_new / rz, zero)
        rz = rz_new
        pou, pov = pu, pv
        k += 1
    if k > 0:
        xu, xv = xu + alpha * pou, xv + alpha * pov
    return torch.stack([xu, xv], -1), k


@pytest.mark.parametrize("shape,sms", [((30, 41), 2), ((13, 300), 1)])
def test_cg_two_sweep_model_matches_twin_float64(rng, shape, sms):
    """A small IRLS system, on 4 (then 2) blocks of tiles 256 columns wide:
    the same iterations as the twin and within 1e-12 of it."""
    sys = _irls_system(rng, *shape)
    plan = streaming_plan(*shape, sms)
    assert plan.blocks == 2 * sms
    x, k = cg_two_sweep_model(sys, 1e-8, 400, plan)
    x_t, k_t = _twin(sys, 1e-8, 400)
    assert k == k_t and k > 20
    assert float((x - x_t).abs().max()) <= 1e-12 * max(float(x_t.abs().max()), 1.0)
    assert torch.equal(x_t, cg_solve_plain(sys, 1e-8, 400))


def test_cg_two_sweep_model_stops_before_the_first_iteration_and_at_maxiter(rng):
    sys = _random_system(rng, 9, 11, torch.float64)
    plan = streaming_plan(9, 11, 1)
    x, k = cg_two_sweep_model(sys, 1e-6, 0, plan)
    assert k == 0 and not x.abs().any()
    zero_rhs = sys._replace(b_u=torch.zeros_like(sys.b_u), b_v=torch.zeros_like(sys.b_v))
    x, k = cg_two_sweep_model(zero_rhs, 1e-6, 50, plan)
    assert k == 0 and not x.abs().any()
    x, k = cg_two_sweep_model(sys, 0.0, 5, plan)
    x_t, k_t = _twin(sys, 0.0, 5)
    assert k == k_t == 5 and float((x - x_t).abs().max()) <= 1e-12


# ------------------------------------------------------------------ on the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 388, 584), (2, 1080, 1920), (1, 37, 53)])
def test_tiled_rof_kernel_equals_twin(cuda_device, rng, shape):
    from optical_flow_tpu_torch.ops.cuda import rof_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits

    im = torch.as_tensor(rng.uniform(-1, 1, shape), dtype=torch.float32, device=cuda_device)
    plan = rof_plan(*shape, *device_limits(cuda_device))
    if plan.path != "tiled":
        plan = rof_plan(200, 8, 8, *device_limits(cuda_device))
    out = rof_kernel.launch(im, 1.0 / 8, 100, plan)
    torch.cuda.synchronize()
    assert torch.equal(out, rof_structure_2d(im, 1.0 / 8, 100))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1080, 1920), (1201, 1599), (25, 37)])
def test_streaming_cg_kernel_matches_twin(cuda_device, rng, shape):
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits

    sysm = _random_system(rng, *shape, torch.float32, cuda_device)
    plan = streaming_plan(*shape, device_limits(cuda_device)[0])
    x_k = cg_kernel.launch(list(sysm), 1e-6, 100, plan)
    again = cg_kernel.launch(list(sysm), 1e-6, 100, plan)
    x_t = cg_solve_plain(sysm, 1e-6, 100)
    torch.cuda.synchronize()
    assert float((x_k - x_t).abs().max()) <= 1e-5 * max(float(x_t.abs().max()), 1.0)
    assert torch.equal(x_k, again)
