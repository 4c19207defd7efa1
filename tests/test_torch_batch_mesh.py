"""The batch x space mesh of the port (``parallel/mesh.py::flow_mesh(batch, space)``)
and ``mesh=`` on the batched entry points (``parallel/batch.py``,
``parallel/video.py``), on the CPU in float64 over ``["cpu"] * n``.

A meshed batch splits its pairs into one contiguous group a batch row and
runs each group as one batched call: each item must equal the unmeshed
batch's bit for bit, for every family.  One anchor holds the meshed
``hs-brightness`` batch to the JAX package's meshed route
(``flow_mesh(batch=8, space=1)`` over its 8 virtual CPU devices).  The test
marked ``cuda`` runs the PCG and ROF kernels on a second card:
``python -m pytest tests/test_torch_batch_mesh.py -m cuda --noconftest``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_spatial import _smooth  # noqa: E402
from torch_parity import one_cpu_thread  # noqa: E402,F401


def _mesh(batch, space):
    from optical_flow_tpu_torch.parallel.mesh import flow_mesh

    return flow_mesh(batch=batch, space=space, devices=["cpu"] * (batch * space))


@pytest.fixture(scope="module")
def rgb_batch():
    """Four (32, 48, 3) smooth RGB frames and their copies shifted by 1-4 px."""
    rng = np.random.default_rng(0)
    im1 = np.stack([np.stack([_smooth(rng, (32, 48)) for _ in range(3)], -1) for _ in range(4)])
    im2 = np.stack([np.roll(im1[k], k + 1, axis=1) for k in range(4)])
    return im1, im2


def test_flow_mesh_shapes_and_errors_as_jax():
    from optical_flow_tpu.parallel.mesh import flow_mesh as mesh_jax
    from optical_flow_tpu_torch.parallel.mesh import BATCH_AXIS, SPACE_AXIS, flow_mesh

    import jax

    devices = ["cpu"] * 8
    for batch, space in ((2, 4), (8, 1), (1, 8), (4, None)):
        mesh = flow_mesh(batch=batch, space=space, devices=devices)
        ref = mesh_jax(batch=batch, space=space, devices=jax.devices()[:8])
        assert mesh.shape == dict(ref.shape) and mesh.shape[BATCH_AXIS] * mesh.shape[SPACE_AXIS] == 8
    mesh = flow_mesh(batch=2, space=3, devices=[f"cpu:{i}" for i in range(6)])
    assert mesh.batch_row(1) == tuple(torch.device("cpu", i) for i in (3, 4, 5))
    for kwargs, match in (({"batch": 3, "space": 4}, "!= 8 devices"), ({"batch": 3}, "not divisible")):
        with pytest.raises(ValueError, match=match):
            flow_mesh(devices=devices, **kwargs)
        with pytest.raises(ValueError, match=match):
            mesh_jax(devices=jax.devices()[:8], **kwargs)


def test_single_pair_flow_shards_over_the_first_batch_row():
    """``estimate_flow(mesh=)`` with batch > 1 shards over the first row's
    space axis: the flow of the (1, space) mesh, bit for bit."""
    from optical_flow_tpu_torch import estimate_flow

    im1 = _smooth(np.random.default_rng(13), (96, 64))
    params = {"display": False, "dtype": torch.float64, "max_warping_iters": 3}
    one_row = estimate_flow(im1, np.roll(im1, 1, axis=1), "hs-brightness", params, mesh=_mesh(1, 4))
    two_rows = estimate_flow(im1, np.roll(im1, 1, axis=1), "hs-brightness", params, mesh=_mesh(2, 4))
    assert torch.equal(one_row, two_rows)


FAMILIES = [  # (method, params): one preset a family, short schedules
    ("classic+nl-fast", {"max_iters": 1}),
    ("hs-brightness", {"max_warping_iters": 3}),
    ("ba", {"max_iters": 1}),
    ("classic-c-a", {"max_iters": 1}),
]


@pytest.mark.parametrize("method,settings", FAMILIES)
def test_meshed_batch_is_the_unmeshed_batch_bit_for_bit(rgb_batch, method, settings):
    from optical_flow_tpu_torch.parallel import batch as bp

    params = {"display": False, "dtype": torch.float64, **settings}
    ref = bp.estimate_flow_batched_rgb(*rgb_batch, method, params=params, device="cpu")
    meshed = bp.estimate_flow_batched_rgb(*rgb_batch, method, mesh=_mesh(2, 2), params=params)
    assert meshed.shape == ref.shape == (4, 32, 48, 2) and torch.equal(meshed, ref)


def test_meshed_batch_runs_one_batched_call_a_row(rgb_batch, monkeypatch):
    """Two batch rows: two batched calls of 2 items, each on its row's first device."""
    from optical_flow_tpu_torch.methods import hs
    from optical_flow_tpu_torch.parallel import batch as bp

    calls, program = [], hs.hs_flow_program
    monkeypatch.setattr(bp, "hs_flow_program", lambda plan, images, uv: calls.append(images.shape[0]) or
                        program(plan, images, uv))
    pairs = np.stack([rgb_batch[0][..., 0], rgb_batch[1][..., 0]], -1)
    bp.estimate_flow_batched(pairs, "hs-brightness", mesh=_mesh(2, 2), params={"max_iters": 1})
    assert calls == [2, 2]


def test_meshed_video_is_the_unmeshed_video(rgb_batch):
    from optical_flow_tpu_torch.parallel.video import estimate_flow_video

    frames = np.concatenate([rgb_batch[0][:1, ..., 0], rgb_batch[1][:, ..., 0]])  # 5 frames: 4 pairs
    params = {"display": False, "dtype": torch.float64, "max_warping_iters": 3}
    ref = estimate_flow_video(frames, "hs-brightness", params=params, device="cpu")
    assert torch.equal(estimate_flow_video(frames, "hs-brightness", mesh=_mesh(2, 1), params=params), ref)


def test_meshed_batch_raises_as_jax():
    """B not dividing over the batch rows raises, as JAX's ``device_put``; so
    do a device other than the mesh's first and an object that is no mesh."""
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched, estimate_flow_batched_rgb

    images = np.zeros((3, 16, 16, 2))
    with pytest.raises(ValueError, match="does not divide"):
        estimate_flow_batched(images, mesh=_mesh(2, 1))
    with pytest.raises(ValueError, match="does not divide"):
        estimate_flow_batched_rgb(np.zeros((3, 16, 16, 3)), np.zeros((3, 16, 16, 3)), mesh=_mesh(2, 1))
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        estimate_flow_batched(images[:2], mesh=_mesh(2, 1), device="cuda")
    with pytest.raises(TypeError, match="flow_mesh"):
        estimate_flow_batched(images[:2], mesh=object())


def test_meshed_batch_equals_jax_meshed_route():
    """JAX's ``tests/test_parallel.py`` batch: B = 8 random 40x48 pairs shifted
    by 1 px, ``hs-brightness`` over ``flow_mesh(batch=8, space=1)`` (JAX's
    unfused per-level route, whose preprocessing equals the fused one's for
    this preset): within 1e-6 px, as ``test_torch_batch_hs.py`` holds JAX's
    batches (measured 2.6e-10: PCG at rtol 1e-7 over ten warp iterations of
    random frames), and the shift recovered."""
    import jax

    from optical_flow_tpu.parallel.batch import estimate_flow_batched as batched_jax
    from optical_flow_tpu.parallel.mesh import flow_mesh as mesh_jax
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched

    rng = np.random.default_rng(3)
    im1 = rng.uniform(0, 255, (8, 40, 48))
    batch = np.stack([im1, np.roll(im1, 1, axis=2)], axis=-1)
    ref = np.asarray(batched_jax(batch, "hs-brightness", mesh=mesh_jax(batch=8, space=1, devices=jax.devices()[:8]),
                                 params={"dtype": "float64"}))
    out = estimate_flow_batched(batch, "hs-brightness", mesh=_mesh(8, 1), params={"dtype": torch.float64}).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[:, 8:-8, 8:-8, 0].mean(axis=(1, 2)), 1.0, atol=0.05)


@pytest.mark.cuda
def test_kernels_launch_on_their_inputs_card():
    """The PCG and ROF launchers make their input's card current: a call on
    card 1 runs there and equals the same call on card 0."""
    from optical_flow_tpu_torch.ops.cuda.cg_kernel import cg_solve
    from optical_flow_tpu_torch.ops.cuda.rof_kernel import rof_structure
    from optical_flow_tpu_torch.ops.stencil import FlowSystem

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    rng = np.random.default_rng(1)
    H, W = 97, 146
    planes = [rng.uniform(0.5, 1.5, (H, W)), rng.uniform(-0.1, 0.1, (H, W)), rng.uniform(0.5, 1.5, (H, W))]
    planes += [rng.uniform(0, 1, (H, W)) for _ in range(4)] + [rng.standard_normal((H, W)) for _ in range(2)]
    im = rng.uniform(-1, 1, (2, H, W))
    out = {}
    for i in (0, 1):
        dev = torch.device("cuda", i)
        sysm = FlowSystem(*[torch.as_tensor(p, dtype=torch.float32, device=dev) for p in planes])
        with torch.cuda.device(0):  # the other card stays current
            x = cg_solve(sysm, 1e-3, 200)
            s = rof_structure(torch.as_tensor(im, dtype=torch.float32, device=dev))
        assert x.device == dev and s.device == dev
        out[i] = (x.cpu(), s.cpu())
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
