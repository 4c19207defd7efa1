"""Red-black SOR and the dense exact solve against the JAX package, and
``solver="sor"`` through whole flows, in float64."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_parity import SLICE_CROP32, flows, j, n, rubberwhale_crop, t  # noqa: E402


def _random_system(seed, H, W, lib):
    """The seeded random SPD system of the Pallas CG test (diagonally
    dominant data block, edge weights in [0.1, 1))."""
    rng = np.random.default_rng(seed)

    def u(*s):
        return rng.uniform(0.1, 1.0, s)

    wu_h, wu_v, wv_h, wv_v = u(H, W), u(H, W), u(H, W), u(H, W)
    wu_h[:, -1] = 0
    wv_h[:, -1] = 0
    wu_v[-1, :] = 0
    wv_v[-1, :] = 0
    fields = [u(H, W) + 1.0, 0.5 * u(H, W), u(H, W) + 1.0, wu_h, wu_v, wv_h, wv_v, u(H, W), u(H, W)]
    return [lib(f) for f in fields]


def _systems(seed, H=12, W=14):
    from optical_flow_tpu.ops.stencil import FlowSystem as FJ
    from optical_flow_tpu_torch.ops.stencil import FlowSystem as FP

    return FP(*_random_system(seed, H, W, t)), FJ(*_random_system(seed, H, W, j))


# (seed, tol, max_iters, sweeps the JAX loop runs): converged on a chunk's last
# sweep, in the middle of a chunk, at a tight tolerance, and cut by a
# max_iters that is no multiple of the chunk of 8
SOR_CASES = [(1, 1e-2, 10000, 48), (2, 1e-6, 10000, 135), (3, 1e-10, 10000, 223), (4, 1e-10, 13, 13)]


@pytest.mark.parametrize("seed,tol,max_iters,sweeps", SOR_CASES)
def test_sor_matches_jax_sweep_for_sweep(seed, tol, max_iters, sweeps):
    """Equal sweep counts (JAX's loop has converged after the port's count and
    not one sweep earlier), solutions within 1e-12, and at tol 1e-10 both
    within 1e-8 of the exact dense solve."""
    from optical_flow_tpu.solvers.sor import sor_solve as sj
    from optical_flow_tpu_torch.solvers.direct import dense_solve
    from optical_flow_tpu_torch.solvers.sor import CHUNK, sor_solve as sp

    sys_p, sys_j = _systems(seed)
    x_p, k = sp(sys_p, 1.9, max_iters, tol, return_iters=True)
    x_j = n(sj(sys_j, 1.9, max_iters, tol))
    assert k == sweeps
    assert (k % CHUNK != 0) == (seed != 1)
    np.testing.assert_array_equal(n(sj(sys_j, 1.9, k, tol)), x_j)
    assert not np.array_equal(n(sj(sys_j, 1.9, k - 1, tol)), x_j)
    assert np.abs(n(x_p) - x_j).max() <= 1e-12
    if tol == 1e-10 and k < max_iters:
        exact = dense_solve(sys_p)
        assert np.abs(n(x_p) - exact).max() <= 1e-8 and np.abs(x_j - exact).max() <= 1e-8


def test_sor_reads_the_host_once_a_chunk():
    """ceil(sweeps / CHUNK) host reads of the convergence flag a solve."""
    import optical_flow_tpu_torch.solvers.sor as sor

    sys_p, _ = _systems(2)
    reads = []
    real = torch.Tensor.__bool__

    def counting(self):
        reads.append(self.shape)
        return real(self)

    torch.Tensor.__bool__ = counting
    try:
        _, k = sor.sor_solve(sys_p, 1.9, 10000, 1e-6, return_iters=True)
    finally:
        torch.Tensor.__bool__ = real
    assert len(reads) == -(-k // sor.CHUNK) == 17


def test_dense_solve_equals_jax_and_holds_pcg():
    """The dense matrix and the exact solve equal the JAX package's bit for bit;
    the port's PCG twin at rtol 1e-12 lands within 1e-8 of the exact solve."""
    from optical_flow_tpu.solvers.direct import dense_matrix as mj, dense_solve as dj
    from optical_flow_tpu_torch.ops.cuda.cg_kernel import cg_solve_plain
    from optical_flow_tpu_torch.solvers.direct import dense_matrix as mp, dense_solve as dp

    sys_p, sys_j = _systems(5, 9, 13)
    A = mp(sys_p)
    np.testing.assert_array_equal(A, mj(sys_j))
    assert A.shape == (234, 234) and np.array_equal(A, A.T)
    exact = dp(sys_p)
    np.testing.assert_array_equal(exact, dj(sys_j))
    assert np.abs(n(cg_solve_plain(sys_p, 1e-12, 2000)) - exact).max() <= 1e-8


def test_hs_flow_with_sor_matches_jax():
    """``hs`` with ``solver="sor"`` from RGB frames on the 48x64 RubberWhale
    crop: within 1e-6 px of the JAX package."""
    a, b, _, _ = rubberwhale_crop(**SLICE_CROP32)
    uv_j, uv_p = flows(a, b, "hs", {"display": False, "solver": "sor"})
    assert np.abs(uv_p - uv_j).max() <= 1e-6
    assert np.abs(uv_p).max() > 0.1


@pytest.mark.parametrize("method,extra", [("ba-brightness", {}), ("classic+nl-fast", {}), ("classic-c-a", {"lambda2": 0.01})])
def test_sor_runs_in_every_family(method, extra):
    """``solver="sor"`` in the BA, Classic+NL and alt-BA (at its stable lambda2)
    families on a rolled 24x32 frame: finite, and the flow's mean u is near
    the +1 px shift."""
    from optical_flow_tpu_torch import estimate_flow

    im1 = np.random.default_rng(4).uniform(0, 255, (24, 32))
    params = {"display": False, "dtype": torch.float64, "solver": "sor", "max_iters": 2, **extra}
    uv = estimate_flow(im1, np.roll(im1, 1, axis=1), method, params, device="cpu")
    assert torch.isfinite(uv).all()
    assert abs(float(uv[4:-4, 4:-4, 0].mean()) - 1.0) < 0.5
