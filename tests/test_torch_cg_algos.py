"""The Chronopoulos–Gear and Chebyshev PCG recurrences of the port
(``solvers/cg.py::pcg_solve_split_gear``, ``solvers/chebyshev.py``,
``parallel/dist.py`` with ``algo="gear"`` / ``"cheby"``) against the JAX
package's, in float64 on the CPU.

Single systems run the JAX functions under ``jax.jit`` (rtol and maxiter
traced, so one compile serves every case); the sharded solves run JAX's
``solve_flow_system_sharded`` over a mesh of its virtual CPU devices and the
port's over ``flow_mesh(space=n, devices=["cpu"] * n)``.  Solutions agree
within 1e-9 x max|x| and iteration counts are equal (JAX's gear returns no
count: its count is the smallest ``maxiter`` that gives its unbounded
solution).  The sharded JAX solves run under ``jax.jit`` (eager
``shard_map`` takes ~15 s a call here).
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_parity import j, n, one_cpu_thread, t  # noqa: E402,F401

RTOL = 1e-9  # |dx| <= RTOL * max|x|
H, W, SHARDS = 32, 24, 4


def _fields(seed, kind):
    """The nine planes of a seeded SPD flow system: ``"dominant"`` (the data
    block dominates the edge weights, few iterations) or ``"weak"`` (a weak
    data term, as in flat regions: many iterations)."""
    rng = np.random.default_rng(seed)

    def u(lo=0.1):
        return rng.uniform(lo, 1.0, (H, W))

    wu_h, wu_v, wv_h, wv_v = u(), u(), u(), u()
    wu_h[:, -1] = wv_h[:, -1] = 0
    wu_v[-1, :] = wv_v[-1, :] = 0
    if kind == "dominant":
        a11, a12, a22 = u() + 1.0, 0.5 * u(), u() + 1.0
    else:
        a11, a22 = 0.02 * u(), 0.02 * u()
        a12 = 0.9 * np.sqrt(a11 * a22) * rng.uniform(-1.0, 1.0, (H, W))
    b = rng.standard_normal((2, H, W))
    return [a11, a12, a22, wu_h, wu_v, wv_h, wv_v, b[0], b[1]]


def _systems(seed, kind):
    from optical_flow_tpu.ops.stencil import FlowSystem as FJ
    from optical_flow_tpu_torch.ops.stencil import FlowSystem as FP

    f = _fields(seed, kind)
    return FP(*[t(x) for x in f]), FJ(*[j(x) for x in f])


def _split(sys, lib):
    """(apply_A, du, dv) of a system, with the stencil of ``lib``'s package."""
    if lib == "jax":
        from optical_flow_tpu.ops.stencil import system_apply_split, weighted_laplacian_diag
    else:
        from optical_flow_tpu_torch.ops.stencil import system_apply_split, weighted_laplacian_diag
    du = sys.a11 + weighted_laplacian_diag(sys.wu_h, sys.wu_v)
    dv = sys.a22 + weighted_laplacian_diag(sys.wv_h, sys.wv_v)
    return (lambda xu, xv: system_apply_split(sys, xu, xv)), du, dv


def _close(got, ref):
    ref = np.asarray(ref)
    assert np.abs(np.asarray(got) - ref).max() <= RTOL * np.abs(ref).max()


@functools.lru_cache(maxsize=None)
def _jitted(name):
    """JAX's gear or cheby solve of a system, jitted once with rtol and
    maxiter as traced arguments (one compile serves every case)."""
    import jax
    from optical_flow_tpu.solvers.cg import _block_jacobi_split, pcg_solve_split_gear
    from optical_flow_tpu.solvers.chebyshev import cheby_solve_split, lanczos_bounds_split

    def gear(sj, rtol, maxiter):
        A, du, dv = _split(sj, "jax")
        return pcg_solve_split_gear(A, sj.b_u, sj.b_v, du, dv, rtol, maxiter, a12=sj.a12)

    def cheby(sj, rtol, maxiter):
        A, du, dv = _split(sj, "jax")
        lo, hi = lanczos_bounds_split(A, _block_jacobi_split(du, dv, sj.a12), sj.b_u, sj.b_v)
        xu, xv, k = cheby_solve_split(A, sj.b_u, sj.b_v, du, dv, lo, hi, rtol, 4 * maxiter, a12=sj.a12,
                                      return_iters=True)
        return xu, xv, k, lo, hi

    return jax.jit({"gear": gear, "cheby": cheby}[name])


def _jax_gear(sj, rtol, maxiter):
    xu, xv = _jitted("gear")(sj, rtol, maxiter)
    return np.stack([n(xu), n(xv)], -1)


def _jax_cheby(sj, rtol, maxiter):
    xu, xv, k, lo, hi = _jitted("cheby")(sj, rtol, maxiter)
    return np.stack([n(xu), n(xv)], -1), int(k), (float(lo), float(hi))


CASES = [(1, "dominant", 1e-8), (2, "weak", 1e-3), (3, "weak", 1e-8)]  # (seed, kind, rtol)


@pytest.mark.parametrize("seed,kind,rtol", CASES)
def test_gear_equals_jax(seed, kind, rtol):
    from optical_flow_tpu_torch.solvers.cg import solve_split_algo

    sp, sj = _systems(seed, kind)
    x, k = solve_split_algo(sp, rtol, 1000, "gear", return_iters=True)
    ref = _jax_gear(sj, rtol, 1000)
    _close(x.numpy(), ref)
    assert 2 < k < 1000
    # JAX's count: its solution at maxiter k is its unbounded one, at k - 1 it is not
    assert np.array_equal(_jax_gear(sj, rtol, k), ref) and not np.array_equal(_jax_gear(sj, rtol, k - 1), ref)


@pytest.mark.parametrize("seed,kind,rtol", CASES)
def test_lanczos_bounds_and_cheby_equal_jax(seed, kind, rtol):
    from optical_flow_tpu_torch.ops.cuda.cg_kernel import _block_jacobi_split
    from optical_flow_tpu_torch.solvers.chebyshev import lanczos_bounds_split
    from optical_flow_tpu_torch.solvers.cg import solve_split_algo

    sp, sj = _systems(seed, kind)
    A, du, dv = _split(sp, "torch")
    lo, hi = lanczos_bounds_split(A, _block_jacobi_split(du, dv, sp.a12), sp.b_u, sp.b_v)
    ref, k_ref, (lo_ref, hi_ref) = _jax_cheby(sj, rtol, 1000)
    assert lo.dtype == torch.float64 and 0 < float(lo) < float(hi)
    np.testing.assert_allclose([float(lo), float(hi)], [lo_ref, hi_ref], rtol=1e-12)
    x, k = solve_split_algo(sp, rtol, 1000, "cheby", return_iters=True)
    _close(x.numpy(), ref)
    assert k == k_ref and k % 16 == 0 and k < 4000


@pytest.mark.parametrize("algo", ["classic", "gear", "cheby"])
@pytest.mark.parametrize("seed,kind,rtol", CASES[2:])
def test_sharded_solve_equals_jax(algo, seed, kind, rtol):
    """``solve_flow_system_sharded(algo=)`` over 4 CPU shards against JAX's
    over 4 of its devices; the port's sharded iterations equal its single
    system's."""
    import jax
    from optical_flow_tpu.parallel.dist import solve_flow_system_sharded as sharded_jax
    from optical_flow_tpu.parallel.mesh import flow_mesh as mesh_jax
    from optical_flow_tpu_torch.parallel import dist
    from optical_flow_tpu_torch.parallel.mesh import flow_mesh
    from optical_flow_tpu_torch.solvers.cg import solve_split_algo

    sp, sj = _systems(seed, kind)
    dist.reset_counts()
    x = dist.solve_flow_system_sharded(sp, flow_mesh(space=SHARDS, devices=["cpu"] * SHARDS), rtol, 1000, algo=algo)
    mesh = mesh_jax(batch=1, space=SHARDS, devices=jax.devices()[:SHARDS])
    ref = jax.jit(lambda s: sharded_jax(s, mesh, rtol, 1000, algo=algo))(sj)
    _close(x.numpy(), n(ref))
    if algo != "classic":
        assert dist.iterations == solve_split_algo(sp, rtol, 1000, algo, return_iters=True)[1]


@pytest.mark.parametrize("algo,psums,halos", [
    ("classic", lambda k: 3 * k + 3, lambda k: k + 1),  # p·Ap, r·z, ||r||² an iteration
    ("gear", lambda k: k + 2, lambda k: k + 3),  # one stacked psum an iteration
    ("cheby", lambda k: k // 16 + 27, lambda k: k + 14),  # 25 Lanczos rounds, then one a 16-iteration block
])
def test_collective_rounds_an_iteration(algo, psums, halos):
    from optical_flow_tpu_torch.parallel import dist
    from optical_flow_tpu_torch.parallel.mesh import flow_mesh

    sp, _ = _systems(2, "weak")
    dist.reset_counts()
    dist.solve_flow_system_sharded(sp, flow_mesh(space=SHARDS, devices=["cpu"] * SHARDS), 1e-3, 200, algo=algo)
    k = dist.iterations
    assert dist.solves == 1 and k > 16
    assert (dist.psum_rounds, dist.halo_rounds) == (psums(k), halos(k))


def test_cg_algo_routes_the_plain_solve(monkeypatch):
    """``CG_ALGO`` picks the plain recurrence of ``solve_flow_system`` on CPU
    tensors, batched planes item by item; classic is the twin."""
    from optical_flow_tpu_torch.ops.cuda.cg_kernel import cg_solve_plain
    from optical_flow_tpu_torch.ops.stencil import FlowSystem
    from optical_flow_tpu_torch.solvers import cg

    sp, _ = _systems(3, "weak")
    batch = FlowSystem(*[torch.stack([f, 2.0 * f]) for f in sp])
    for algo in ("classic", "gear", "cheby"):
        monkeypatch.setattr(cg, "CG_ALGO", algo)
        x = cg.solve_flow_system(batch, "backslash")
        for i in range(2):
            item = FlowSystem(*[f[i] for f in batch])
            ref = cg_solve_plain(item, 1e-7, 1000) if algo == "classic" else cg.solve_split_algo(item, 1e-7, 1000, algo)
            assert torch.equal(x[i], ref)


def test_misspelt_cg_algo_raises_on_every_route(monkeypatch):
    """The value is checked before any route: the card's kernel (here a
    stand-in that must not be reached), the plain solves and the sharded
    solve, as JAX's ``solve_flow_system`` and ``solve_flow_system_local``."""
    from optical_flow_tpu_torch.parallel import dist
    from optical_flow_tpu_torch.parallel.mesh import flow_mesh
    from optical_flow_tpu_torch.solvers import cg

    sp, _ = _systems(1, "dominant")
    mesh = flow_mesh(space=SHARDS, devices=["cpu"] * SHARDS)
    monkeypatch.setattr(cg, "cg_solve", lambda *a: pytest.fail("the kernel route ran"))
    monkeypatch.setattr(cg, "CG_ALGO", "Gear")
    for solver in ("pcg", "backslash"):
        with pytest.raises(ValueError, match="Unknown CG algo 'Gear'"):
            cg.solve_flow_system(sp, solver)
    with pytest.raises(ValueError, match="Unknown CG algo 'Gear'"):
        dist.solve_flow_system_sharded(sp, mesh)
    monkeypatch.setattr(cg, "CG_ALGO", "classic")
    with pytest.raises(ValueError, match="Unknown CG algo 'chebyshev'"):
        dist.solve_flow_system_sharded(sp, mesh, algo="chebyshev")


def test_cg_algo_is_read_from_the_environment(monkeypatch):
    from optical_flow_tpu_torch.solvers import cg

    try:
        monkeypatch.setenv("OFTPU_CG_ALGO", "cheby")
        assert importlib.reload(cg).CG_ALGO == "cheby"
        monkeypatch.delenv("OFTPU_CG_ALGO")
        assert importlib.reload(cg).CG_ALGO == "classic"
    finally:
        monkeypatch.undo()
        importlib.reload(cg)
