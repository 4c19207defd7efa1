"""The batched Horn–Schunck family, SOR with a batch axis and the zero
right-hand side of a stopped item, against the JAX package in float64 on
the CPU and against the port's own single-pair calls.

The batch (``torch_parity.family_batch``) is the 24x32 crop of RubberWhale
and Hydrangea and a static pair, gray as the JAX package's
``preprocess_color_batch`` makes it.  JAX's side is its fused batched route
(``params={"fuse": True}``): ``jax.vmap`` of the whole-flow program, each
item stopped on its own by the vmapped ``while_loop``.  The JAX batches are
computed once for the module.  The ``cuda`` test runs the kernel on the
card: ``python -m pytest tests/test_torch_batch_hs.py -m cuda --noconftest``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import STATIC, family_batch, jax_family_flows, port_batched, port_single, t  # noqa: E402

PARAMS = {"display": False}
# label -> (method, params): JAX's default batched method, the texture route, and SOR
CASES = {"hs-brightness": ("hs-brightness", {}), "hs": ("hs", {}), "hs sor": ("hs", {"solver": "sor"})}


@pytest.fixture(scope="module")
def batch():
    return jax_family_flows(CASES)


@pytest.mark.parametrize("label", list(CASES))
def test_batched_flow_matches_jax_and_the_single_pair_flows(batch, label):
    """Each item within 1e-6 px of JAX's fused batch (measured <= 1.2e-12) and
    within 1e-12 px of the port's single-pair flow of the same pair."""
    method, params = CASES[label]
    got = port_batched(batch["images"], method, params)
    assert got.shape == (3, 24, 32, 2) and got.dtype == np.float64
    for k in range(3):
        assert np.abs(got[k] - batch[label][k]).max() <= 1e-6, k
        single = port_single(batch["images"][k], method, params)
        np.testing.assert_allclose(got[k], single, rtol=0, atol=1e-12)
    assert np.abs(got[0]).max() > 0.1  # a real flow


def _solves(monkeypatch):
    """Record every PCG system the block solves on the CPU: a list of
    (level shape, [each item's iterations]), from the plain twin, which
    solves a batch item by item."""
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.solvers import cg as cg_solvers

    calls, twin = [], cg_kernel.pcg_solve_split

    def counting(*args, **kwargs):
        xu, xv, k = twin(*args, **{**kwargs, "return_iters": True})
        calls[-1][1].append(k)
        return xu, xv

    def solving(sysm, rtol, maxiter):
        calls.append((tuple(sysm.a11.shape[-2:]), []))
        return cg_kernel.cg_solve(sysm, rtol, maxiter)

    monkeypatch.setattr(cg_kernel, "pcg_solve_split", counting)
    monkeypatch.setattr(cg_solvers, "cg_solve", solving)
    return calls


def _warps(calls, item):
    """{level shape: the warp iterations ``item`` ran}: the solves of its level
    with a non-zero right-hand side; once it stops, every later solve of the
    level must cost it no iteration."""
    out = {}
    for shape, its in calls:
        ran = out.setdefault(shape, [])
        assert not (ran and ran[-1] == 0 and its[item] > 0), "an item ran again after it stopped"
        ran.append(its[item])
    return {shape: sum(k > 0 for k in its) for shape, its in out.items()}


@pytest.mark.parametrize("method", ["hs-brightness", "hs"])
def test_each_item_stops_on_its_own(batch, method, monkeypatch):
    """The per-item early stop, as JAX's vmapped ``while_loop``: each item's
    warp iterations at each level equal its single-pair run's; the static pair
    stops at its first and keeps a flow of exactly 0; once an item stops, its
    later PCG calls run 0 iterations while the other items go on."""
    images = batch["images"]
    calls = _solves(monkeypatch)
    uv = port_batched(images, method, {})
    batched = [_warps(calls, k) for k in range(3)]
    for k in range(3):
        calls.clear()
        port_single(images[k], method, {})
        assert batched[k] == _warps(calls, 0), k
    assert all(n == 1 for n in batched[STATIC].values()) and not uv[STATIC].any()
    assert max(sum(w.values()) for w in batched) > sum(batched[STATIC].values())


@pytest.mark.parametrize("method", ["hs-brightness", "hs"])
def test_items_are_normalised_on_their_own(batch, method):
    """A batch of one pair and the same pair at a quarter of its range plus 10:
    the rescale (and, for ``hs``, ROF) normalise each item on its own, so both
    items get the same flow, each its single-pair flow; one normalisation over
    the batch would give the dimmer item another input."""
    pair = batch["images"][0]
    images = np.stack([pair, 0.25 * pair + 10.0])
    got = port_batched(images, method, {})
    np.testing.assert_allclose(got[1], got[0], rtol=0, atol=1e-9)
    for k in range(2):
        np.testing.assert_allclose(got[k], port_single(images[k], method, {}), rtol=0, atol=1e-12)
    assert np.abs(got[0]).max() > 0.1


def test_rgb_batch_matches_jax(batch):
    """``estimate_flow_batched_rgb`` with JAX's default method: the gray pairs
    (no Lab guide), then the batch; within 1e-6 px of JAX's batch of the same
    gray pairs, which is JAX's RGB route on the CPU."""
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched_rgb

    p = {**PARAMS, "dtype": torch.float64}
    got = estimate_flow_batched_rgb(batch["im1"], batch["im2"], "hs-brightness", params=p, device="cpu").numpy()
    assert np.abs(got - batch["hs-brightness"]).max() <= 1e-6
    np.testing.assert_array_equal(got, port_batched(batch["images"], "hs-brightness", {}))


def test_video_matches_jax():
    """``estimate_flow_video`` with ``hs-brightness`` on 4 gray frames (rolled
    1 px, 2 px, then still): JAX's video of the same frames within 1e-6 px."""
    import jax.numpy as jnp

    from optical_flow_tpu.parallel.video import estimate_flow_video as video_j
    from optical_flow_tpu_torch.parallel.video import estimate_flow_video as video_p

    gray = np.asarray(family_batch()[0][0].mean(axis=-1))
    frames = np.stack([gray, np.roll(gray, 1, axis=1), np.roll(gray, 2, axis=1), np.roll(gray, 2, axis=1)])
    ref = np.asarray(video_j(frames, "hs-brightness", params={**PARAMS, "dtype": jnp.float64, "fuse": True}))
    got = video_p(frames, "hs-brightness", params={**PARAMS, "dtype": torch.float64}, device="cpu").numpy()
    assert got.shape == (3, 24, 32, 2) and np.abs(got - ref).max() <= 1e-6
    assert not got[2].any()  # the still pair


# ------------------------------------------------------------------ the solvers on a batch


def _random_systems(rng, B, H, W, scales):
    """Seeded SPD flow systems, one an item, each scaled differently so that
    the items converge after different numbers of sweeps / iterations."""
    def u(*s):
        return rng.uniform(0.1, 1.0, s)

    scale = np.asarray(scales, dtype=float).reshape(B, 1, 1)
    w = [u(B, H, W) * scale for _ in range(4)]
    for k in (0, 2):
        w[k][..., :, -1] = 0
    for k in (1, 3):
        w[k][..., -1, :] = 0
    return [u(B, H, W) + 1.0, 0.5 * u(B, H, W), u(B, H, W) + 1.0, *w, u(B, H, W) - 0.5, u(B, H, W) - 0.5]


def test_sor_sweeps_per_item_equal_jax_vmap():
    """Batched SOR against ``jax.vmap(sor_solve)`` on the same systems: each
    item's sweeps are JAX's (JAX's item reaches its result in exactly that
    many sweeps and not in one fewer, shown by capping its ``max_iters``), x
    within 1e-10, and each item equals its own unbatched solve."""
    import jax
    import jax.numpy as jnp

    from optical_flow_tpu.ops.stencil import FlowSystem as FlowSystemJ
    from optical_flow_tpu.solvers.sor import sor_solve as sor_j
    from optical_flow_tpu_torch.ops.stencil import FlowSystem
    from optical_flow_tpu_torch.solvers.sor import sor_solve

    fields = _random_systems(np.random.default_rng(0), 3, 12, 16, [1.0, 30.0, 0.01])
    x, sweeps = sor_solve(FlowSystem(*[t(f) for f in fields]), 1.9, 10000, 1e-2, return_iters=True)
    assert x.shape == (3, 12, 16, 2) and len(set(sweeps)) == 3

    solve = jax.jit(jax.vmap(lambda fs, m: sor_j(FlowSystemJ(*fs), 1.9, m, 1e-2)))
    js = [jnp.asarray(f) for f in fields]
    ref = np.asarray(solve(js, jnp.full(3, 10000)))
    assert np.array_equal(np.asarray(solve(js, jnp.asarray(sweeps))), ref)
    fewer = np.asarray(solve(js, jnp.asarray(sweeps) - 1))
    assert all(not np.array_equal(fewer[k], ref[k]) for k in range(3))
    np.testing.assert_allclose(x.numpy(), ref, rtol=0, atol=1e-10)
    for k in range(3):
        xk, sk = sor_solve(FlowSystem(*[t(f[k]) for f in fields]), 1.9, 10000, 1e-2, return_iters=True)
        assert sk == sweeps[k] and torch.equal(xk, x[k])


def test_solvers_stop_a_zero_item_at_once():
    """An item with a zero right-hand side (a stopped HS item) costs no sweep
    and no PCG iteration and gets x = 0; the other items are unchanged."""
    from optical_flow_tpu_torch.ops.cuda.cg_kernel import cg_solve, pcg_solve_split
    from optical_flow_tpu_torch.ops.stencil import FlowSystem, system_apply_split
    from optical_flow_tpu_torch.solvers.sor import sor_solve

    fields = _random_systems(np.random.default_rng(1), 3, 9, 11, [1.0, 1.0, 5.0])
    fields[7][1] = fields[8][1] = 0.0
    sysm = FlowSystem(*[t(f) for f in fields])
    items = [FlowSystem(*[f[k] for f in sysm]) for k in range(3)]

    x, sweeps = sor_solve(sysm, 1.9, 10000, 1e-2, return_iters=True)
    assert sweeps[1] == 0 and not x[1].any()
    for k in (0, 2):
        xk, sk = sor_solve(items[k], 1.9, 10000, 1e-2, return_iters=True)
        assert sk == sweeps[k] > 0 and torch.equal(xk, x[k])

    zero = items[1]
    du, dv = zero.a11 + 1.0, zero.a22 + 1.0
    xu, xv, k = pcg_solve_split(lambda a, b: system_apply_split(zero, a, b), zero.b_u, zero.b_v, du, dv, 1e-7, 1000,
                                a12=zero.a12, return_iters=True)
    assert k == 0 and not xu.any() and not xv.any()
    x = cg_solve(sysm, 1e-7, 1000)
    assert not x[1].any()
    for k in (0, 2):
        assert torch.equal(x[k], cg_solve(items[k], 1e-7, 1000))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,shape,path,items", [(4, (25, 37), "single", 4), (4, (49, 73), "resident", 4),
                                                (2, (388, 584), "resident", 1), (2, (1200, 1600), "streaming", 1)])
def test_cg_kernel_stops_a_zero_item_at_iteration_0(cuda_device, B, shape, path, items):
    """On every plan (one block an item; bands, all items a launch; bands, one
    item a launch; streaming) a zero right-hand side stops its item at
    iteration 0 with x = 0, and every other item agrees with its own solve
    within 1e-5 x scale (its sums run over its own band layout)."""
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits
    from optical_flow_tpu_torch.ops.stencil import FlowSystem

    plan = cg_kernel.cg_plan(B, *shape, *device_limits(cuda_device))
    assert (plan.path, plan.items) == (path, items)
    fields = _random_systems(np.random.default_rng(B), B, *shape, [1.0, 30.0, 0.01, 3.0][:B])
    fields[7][1] = fields[8][1] = 0.0
    sysm = FlowSystem(*[torch.as_tensor(f, dtype=torch.float32, device=cuda_device) for f in fields])
    x = cg_kernel.cg_solve(sysm, 1e-6, 300)
    its = cg_kernel.item_iterations(cuda_device)
    assert its[1] == 0 and not x[1].any() and all(its[k] > 0 for k in range(B) if k != 1)
    for k in range(B):
        if k != 1:
            single = cg_kernel.cg_solve(FlowSystem(*[f[k] for f in sysm]), 1e-6, 300)
            assert float((x[k] - single).abs().max()) <= 1e-5 * max(float(single.abs().max()), 1.0)
