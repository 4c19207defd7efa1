"""The port's ``utils/warmup.py::warmup_classic_nl`` against the JAX package's, in float64 on the CPU.

The warm-up walks the (image, flow) shape pairs of JAX's ``_level_schedule``
(compared as shapes: the level programs are stubbed in both packages, so
nothing compiles), mutates ``ope.color_images`` as JAX's does, and leaves
nothing that changes a later flow.  Without a GPU its default device
raises; one ``cuda`` test runs it on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import one_cpu_thread  # noqa: E402,F401

P64 = {"display": False, "dtype": torch.float64, "solver": "pcg"}
SIZES = [(388, 584), (2160, 3840), (17, 23)]


def _port_ope(params=P64):
    from optical_flow_tpu_torch import load_of_method

    ope = load_of_method("classic+nl-fast")
    ope.parse_input_parameter(params)
    return ope


def _jax_ope():
    from optical_flow_tpu.config import load_of_method

    ope = load_of_method("classic+nl-fast")
    ope.parse_input_parameter({"display": False, "solver": "pcg"})
    return ope


def _jax_schedule(sz, color):
    from optical_flow_tpu.utils.warmup import _level_schedule

    ope = _jax_ope()
    ope.color_images = np.ones((1, 1, 3)) if color else None
    calls, levels = _level_schedule(ope, sz)
    return [(tuple(img), tuple(uv)) for _, img, uv in calls], levels, calls[0][0].use_color


@pytest.mark.parametrize("sz", SIZES)
def test_level_schedule_matches_jax(sz):
    """The port's schedule, which the warm-up walks, lists JAX's (image, flow)
    shape pairs in JAX's order, with JAX's level count and colour flag, and
    leaves ``ope.pyramid_levels`` as it was."""
    from optical_flow_tpu_torch.utils.warmup import level_schedule

    for color in (True, False):
        ope = _port_ope()
        ope.color_images = np.ones((1, 1, 3)) if color else None
        calls, plan = level_schedule(ope, sz)
        jax_pairs, jax_levels, jax_color = _jax_schedule(sz, color)
        assert [(img, uv) for _, img, uv in calls] == jax_pairs
        assert plan.levels == jax_levels and ope.pyramid_levels == 4
        assert all(cfg.use_color == jax_color == color for cfg, _, _ in calls)


def _stub_port(monkeypatch):
    """Stub the port's level step, pyramids and colour conversion; return the
    log of (image shape, incoming flow shape) a level and of the other calls."""
    from optical_flow_tpu_torch.methods import ba, classic_nl
    from optical_flow_tpu_torch.ops import resample
    from optical_flow_tpu_torch.utils import compat

    log = {"levels": [], "incoming": [], "calls": []}

    def level_step(cfg, images, color, uv, alpha):
        log["levels"].append((tuple(images.shape[:2]), log["incoming"].pop(), color is not None))
        return uv

    def resample_flow(uv, hw):
        log["incoming"].append(tuple(uv.shape[:2]))
        return torch.zeros((*hw, 2), dtype=uv.dtype)

    monkeypatch.setattr(classic_nl, "classic_nl_level_step", level_step)
    monkeypatch.setattr(resample, "resample_flow", resample_flow)
    monkeypatch.setattr(ba, "irls_pyramids", lambda kind, alp, plan, images: log["calls"].append(("irls", kind)))
    monkeypatch.setattr(classic_nl, "color_pyramids", lambda plan, guide: log["calls"].append(("color",)))
    monkeypatch.setattr(compat, "preprocess_color_pair", lambda a, b: (log["calls"].append(("rgb",)),
                                                                     a[..., :2], a)[1:])
    return log


def _stub_jax(monkeypatch):
    """Stub JAX's level program, prepare, colour conversion and pyramids:
    its warm-up then compiles nothing.  Returns its log of (image shape,
    incoming flow shape) a level (threads: in any order)."""
    from optical_flow_tpu import interface
    from optical_flow_tpu.methods import ba, classic_nl
    from optical_flow_tpu.ops import pyramid

    log = []

    def level(cfg, images, guide, uv, alpha):
        log.append((tuple(images.shape[:2]), tuple(uv.shape[:2]), guide.ndim == 3))
        return uv

    monkeypatch.setattr(classic_nl, "classic_nl_level_resampled", level)
    monkeypatch.setattr(ba, "irls_prepare", lambda *a: None)
    monkeypatch.setattr(interface, "_preprocess_color_pair", lambda a, b: None)
    monkeypatch.setattr(pyramid, "pyramid_pair", lambda *a: None)
    return log


@pytest.mark.parametrize("sz", [SIZES[0], SIZES[2]])
@pytest.mark.parametrize("color", [True, False])
def test_warmup_visits_jax_schedule(monkeypatch, sz, color):
    """``warmup_classic_nl(device="cpu")`` runs one level step at each (image,
    flow) shape pair of JAX's schedule, in its order, with the guide where
    ``color`` is set, the preprocessing once and the colour pyramids with
    colour; JAX's own warm-up (its programs stubbed) visits the same pairs."""
    from optical_flow_tpu.utils.warmup import warmup_classic_nl as warm_jax
    from optical_flow_tpu_torch.utils.warmup import warmup_classic_nl

    log = _stub_port(monkeypatch)
    warmup_classic_nl(_port_ope(), sz, color=color, device="cpu")
    jax_log = _stub_jax(monkeypatch)
    warm_jax(_jax_ope(), sz, color=color, max_workers=2)

    pairs, _, _ = _jax_schedule(sz, color)
    assert [(img, uv) for img, uv, _ in log["levels"]] == pairs
    assert all(guided == color for _, _, guided in log["levels"])
    assert sorted(jax_log) == sorted((img, uv, color) for img, uv in pairs)
    assert log["calls"] == ([("rgb",), ("color",)] if color else []) + [("irls", "texture")]


def test_warmup_mutates_color_images_as_jax():
    """color=True keeps a guide and sets the (1, 1, 3) placeholder on an ope
    without one; color=False sets None; the rest of the ope is untouched."""
    from optical_flow_tpu_torch.utils.warmup import warmup_classic_nl

    guide = np.full((4, 5, 3), 7.0)
    for start, color, want in ((None, True, np.ones((1, 1, 3))), (guide, True, guide), (guide, False, None)):
        ope = _port_ope()
        ope.color_images = start
        before = {k: v for k, v in vars(ope).items() if k != "color_images"}
        warmup_classic_nl(ope, (17, 23), color=color, device="cpu")
        after = {k: v for k, v in vars(ope).items() if k != "color_images"}
        assert before.keys() == after.keys() and all(after[k] is v for k, v in before.items())
        if want is None:
            assert ope.color_images is None
        else:
            np.testing.assert_array_equal(ope.color_images, want)


@pytest.mark.parametrize("color", [True, False])
def test_flow_after_warmup_is_unchanged(color):
    """A 32x36 flow computed after the warm-up is ``torch.equal`` to the same
    flow computed without it."""
    from optical_flow_tpu_torch.utils.compat import preprocess_color_pair
    from optical_flow_tpu_torch.utils.warmup import warmup_classic_nl

    rng = np.random.default_rng(3)
    rgb1 = rng.uniform(0, 255, (32, 36, 3))
    rgb2 = np.roll(rgb1, 1, axis=1)

    def flow(warm):
        ope = _port_ope()
        if warm:
            warmup_classic_nl(ope, (32, 36), color=color, device="cpu")
        ope.images, lab = preprocess_color_pair(torch.as_tensor(rgb1), torch.as_tensor(rgb2))
        ope.color_images = lab if color else None
        return ope.compute_flow()

    cold, warmed = flow(False), flow(True)
    assert torch.isfinite(cold).all() and torch.equal(cold, warmed)


def test_warmup_default_device_raises_without_a_gpu(monkeypatch):
    from optical_flow_tpu_torch.utils.warmup import warmup_classic_nl

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="warmup_classic_nl"):
        warmup_classic_nl(_port_ope(), (17, 23))


@pytest.mark.cuda
def test_warmup_on_the_card_launches_every_kernel_and_changes_no_flow():
    """On the card at 388x584: the warm-up launches the weighted median, PCG
    and ROF kernels, and a float32 flow after it is ``torch.equal`` to one before."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from optical_flow_tpu_torch.ops.cuda import cg_kernel, rof_kernel, wmedian_kernel
    from optical_flow_tpu_torch.utils.compat import preprocess_color_pair
    from optical_flow_tpu_torch.utils.warmup import warmup_classic_nl

    rng = np.random.default_rng(3)
    rgb1 = torch.as_tensor(rng.uniform(0, 255, (388, 584, 3)), dtype=torch.float32, device="cuda")
    rgb2 = torch.roll(rgb1, 1, dims=1)
    params = {"display": False, "solver": "pcg"}

    def flow():
        ope = _port_ope(params)
        ope.images, ope.color_images = preprocess_color_pair(rgb1, rgb2)
        with torch.no_grad():
            return ope.compute_flow()

    before = flow()
    counts = (wmedian_kernel.launches, cg_kernel.launches, rof_kernel.launches)
    warmup_classic_nl(_port_ope(params), (388, 584), color=True)
    after = (wmedian_kernel.launches, cg_kernel.launches, rof_kernel.launches)
    assert all(a > b for a, b in zip(after, counts)), (counts, after)
    assert torch.equal(flow(), before)
