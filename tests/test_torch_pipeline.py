"""Pipeline parallelism across frames in the port (``parallel/pipeline.py``):
the schedule, the partition and the frame preparation against the JAX
package's, and the pipelined flows against the port's ``estimate_flow`` on
the CPU in float64 over ``devices=["cpu"] * 4``.

The pipeline runs the same level functions in the same order as
``estimate_flow``, so on one device its flows are the same bit for bit
(JAX's 5e-3 bound in ``tests/test_pipeline.py`` allowed for its per-device
executables).  The schedule and the partition are pure Python and compile
nothing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

DEVICES = ["cpu"] * 4


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _smooth_pair(seed, h, w, rgb=False):
    """``tests/test_pipeline.py``'s pair: a smooth random frame and its 1 px roll."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.uniform(0, 255, (h, w, 3) if rgb else (h, w)), 1.5)
    base = 255 * (base - base.min()) / np.ptp(base)
    return base, np.roll(base, 1, axis=1)


# the four families of tests/test_pipeline.py, with and without a colour guide
SCHEDULES = [(m, c) for m in ("hs-brightness", "classic-c-brightness", "classic+nl-fast", "classic-c-a")
             for c in (True, False)]


@pytest.mark.parametrize("method,use_color", SCHEDULES)
def test_schedule_and_partition_equal_jax(method, use_color):
    """RubberWhale's 388x584: the same step labels and costs, the same final
    median, and the same partition into 1-9 groups."""
    from optical_flow_tpu.config import load_of_method as load_jax
    from optical_flow_tpu.parallel import pipeline as pj
    from optical_flow_tpu_torch.config import load_of_method
    from optical_flow_tpu_torch.parallel import pipeline as pp

    ref = pj.build_pipeline_schedule(load_jax(method), (388, 584), use_color=use_color)
    got = pp.build_pipeline_schedule(load_of_method(method), (388, 584), use_color=use_color)
    costs = [s.cost for s in got.steps]
    assert [(s.label, s.cost) for s in got.steps] == [(s.label, s.cost) for s in ref.steps]
    assert (got.finish is None) == (ref.finish is None) == (method != "hs-brightness")
    for k in range(1, 10):
        assert pp._partition(costs, k) == pj._partition(costs, k)
    if method == "classic+nl-fast":  # the finest level does not share a group with the coarse tail
        groups = pp._partition(costs, 4)
        assert len(groups) == 4 and len(groups[-1]) <= len(costs) // 2


def test_partition_edge_cases_equal_jax():
    from optical_flow_tpu.parallel.pipeline import _partition as part_jax
    from optical_flow_tpu_torch.parallel.pipeline import _partition

    rng = np.random.default_rng(0)
    for costs in ([5], [1, 1, 1], [3, 1, 4, 1, 5, 9, 2, 6], list(rng.integers(1, 1000, 13))):
        for k in (1, 2, 3, len(costs), len(costs) + 2):
            assert _partition(costs, k) == part_jax(costs, k)


@pytest.mark.parametrize("kind", ["gray", "rgb", "two-channel"])
def test_prep_pair_equals_jax(kind):
    """Gray and RGB pairs as ``estimate_flow`` prepares them; (H, W, 2)
    frames concatenated without a colour guide, as JAX's pipeline does
    (its ``estimate_flow`` takes the raw first frame as the guide).  The
    frames bit for bit; the Lab guide within 1e-10 (XLA and PyTorch round
    the Lab conversion's powers differently, by ~2e-13)."""
    import jax.numpy as jnp

    from optical_flow_tpu.config import load_of_method as load_jax
    from optical_flow_tpu.parallel.pipeline import _prep_pair as prep_jax
    from optical_flow_tpu_torch.config import load_of_method
    from optical_flow_tpu_torch.parallel.pipeline import _prep_pair

    shape = {"gray": (24, 32), "rgb": (24, 32, 3), "two-channel": (24, 32, 2)}[kind]
    rng = np.random.default_rng(1)
    im1, im2 = rng.uniform(0, 255, shape), rng.uniform(0, 255, shape)
    oj, op = load_jax("classic+nl-fast"), load_of_method("classic+nl-fast")
    oj.dtype, op.dtype = jnp.float64, torch.float64
    images_j, color_j = prep_jax(oj, im1, im2)
    images, color = _prep_pair(op, im1, im2, torch.device("cpu"))
    np.testing.assert_array_equal(images.numpy(), np.asarray(images_j))
    assert (color is None) == (color_j is None) == (kind == "two-channel")
    if color is not None:
        np.testing.assert_allclose(color.numpy(), np.asarray(color_j), rtol=0, atol=1e-10)


# tests/test_pipeline.py's cases, at fewer warp iterations a level to keep
# the CPU time small (the schedule of levels and stages is the presets')
PIPELINE_CASES = [
    ("hs-brightness", False, {}),
    ("classic-c-brightness", False, {"max_iters": 1}),
    ("classic+nl-fast", True, {"max_iters": 2}),
    ("classic-c-a", False, {"max_iters": 2}),
]


@pytest.mark.parametrize("method,rgb,settings", PIPELINE_CASES)
def test_pipelined_flows_are_estimate_flow_bit_for_bit(method, rgb, settings):
    from optical_flow_tpu_torch import estimate_flow, estimate_flow_pipelined

    im1, im2 = _smooth_pair(0, 48, 64, rgb=rgb)
    params = {"display": False, "dtype": torch.float64, **settings}
    ref = estimate_flow(im1, im2, method, params, device="cpu")
    out = list(estimate_flow_pipelined([(im1, im2)] * 2, method, params, devices=DEVICES))
    assert len(out) == 2 and all(torch.equal(uv, ref) for uv in out)


def test_pipeline_keeps_the_order_and_at_most_depth_frames_in_flight():
    """4 frames at depth 2: each flow its own pair's, in input order, each
    yielded once 2 later frames have been issued."""
    from optical_flow_tpu_torch import estimate_flow, estimate_flow_pipelined

    pairs = [_smooth_pair(k + 10, 40, 48) for k in range(4)]
    params = {"display": False, "dtype": torch.float64, "max_warping_iters": 3}
    issued = []

    def source():
        for k, pair in enumerate(pairs):
            issued.append(k)
            yield pair

    out = []
    for uv in estimate_flow_pipelined(source(), "hs-brightness", params, devices=DEVICES, depth=2):
        out.append((len(issued), uv))
    assert [n for n, _ in out] == [3, 4, 4, 4]
    for (_, uv), (a, b) in zip(out, pairs):
        assert torch.equal(uv, estimate_flow(a, b, "hs-brightness", params, device="cpu"))


def test_pipeline_raises_on_another_frame_shape_and_without_devices():
    from optical_flow_tpu_torch import estimate_flow_pipelined

    pairs = [_smooth_pair(0, 40, 48), _smooth_pair(1, 48, 48)]
    stream = estimate_flow_pipelined(pairs, "hs-brightness", {"display": False, "max_warping_iters": 1},
                                     devices=DEVICES, depth=1)
    with pytest.raises(ValueError, match="consistent frame shape"):
        list(stream)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(estimate_flow_pipelined(pairs, "hs-brightness"))
