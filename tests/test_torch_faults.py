"""Three faults of the port against the JAX package, repaired and pinned:
frames with 1 or 2 channels, the per-level checkpointer passed through
``params``, and weighted-median windows wider than the CUDA kernel's
(``area_hsz`` > 12, the CUDA source's wide kernel).  All on the CPU in
float64, against the JAX package; the tests marked ``cuda`` run the wide
kernel on the card:
``python -m pytest tests/test_torch_faults.py -m cuda --noconftest``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import flows, rubberwhale_crop  # noqa: E402

CROP = dict(h=32, w=40, y0=220, x0=200)
# schedules whose levels share JAX's level programs: the main and the GNC
# pyramids at one level each, or at one spacing (2 levels, 2 compiles, not 4)
ONE_LEVEL = {"auto_level": False, "pyramid_levels": 1, "gnc_pyramid_levels": 1}
SHARED_SPACING = {"gnc_pyramid_spacing": 2.0}


@pytest.mark.parametrize("method,channels,extra", [
    ("hs", 1, {}),
    ("ba", 2, {}),
    ("classic+nl-fast", 1, {"solver": "pcg"}),  # the raw (H, W, 1) first frame is the guide
    # two raw channels as the guide amplify rounding warp after warp (1e-11,
    # 4e-9, 4e-6 px after 1, 2, 3 iterations a level), so compare one
    ("classic+nl-fast", 2, {"solver": "pcg", "max_iters": 1}),
])
def test_frames_with_fewer_than_three_channels_match_jax(method, channels, extra):
    a, b, _, _ = rubberwhale_crop(**CROP)
    uv_j, uv_p = flows(a[..., :channels], b[..., :channels], method, {"display": False, **extra})
    assert uv_p.shape == (32, 40, 2)
    assert np.abs(uv_p - uv_j).max() <= 1e-6  # the whole-flow tolerance of test_torch_slice.py


class Recorder:
    """A checkpoint hook that keeps (stage, level, flow as numpy) of every call."""

    def __init__(self):
        self.calls = []

    def __call__(self, stage, level, uv):
        arr = uv.detach().cpu().numpy() if hasattr(uv, "detach") else np.asarray(uv)
        self.calls.append((stage, level, arr))


@pytest.mark.parametrize("method,extra", [
    ("classic+nl-fast", {"solver": "pcg", "max_iters": 1, **SHARED_SPACING}),
    ("ba", {"max_iters": 1}),
    ("hs", {"max_warping_iters": 2}),
    ("classic-c-a", {"max_iters": 2, "lambda2": 0.01, "gnc_iters": 2}),  # a stable trajectory
])
def test_checkpointer_is_called_after_every_level_as_in_jax(method, extra, tmp_path):
    import jax.numpy as jnp

    from optical_flow_tpu.interface import estimate_flow as ej
    from optical_flow_tpu.utils.checkpoint import FlowCheckpointer as CJ
    from optical_flow_tpu_torch import estimate_flow as ep
    from optical_flow_tpu_torch.utils.checkpoint import FlowCheckpointer as CP

    a, b, _, _ = rubberwhale_crop(**CROP)  # two levels a pyramid
    rec_j, rec_p = Recorder(), Recorder()
    ckpt_j, ckpt_p = CJ(str(tmp_path / "jax")), CP(str(tmp_path / "port"))

    def both(rec, ckpt):
        def hook(stage, level, uv):
            rec(stage, level, uv)
            ckpt(stage, level, uv)
        return hook

    params = {"display": False, **extra}
    uv_j = np.asarray(ej(a, b, method, {**params, "dtype": jnp.float64, "checkpoint": both(rec_j, ckpt_j)}))
    uv_p = ep(a, b, method, {**params, "dtype": torch.float64, "checkpoint": both(rec_p, ckpt_p)}, device="cpu").numpy()
    assert [c[:2] for c in rec_p.calls] == [c[:2] for c in rec_j.calls]
    assert len(rec_p.calls) >= 2
    for (_, _, fp), (_, _, fj) in zip(rec_p.calls, rec_j.calls):
        assert fp.shape == fj.shape and np.abs(fp - fj).max() <= 1e-6
    assert np.abs(uv_p - uv_j).max() <= 1e-6

    # the checkpointer on disk: the same last (stage, level) and flow, the same files
    (sj, lj, fj), (sp, lp, fp) = ckpt_j.latest(), ckpt_p.latest()
    assert (sp, lp) == (sj, lj) == rec_j.calls[-1][:2]
    assert fp.dtype == np.float32 and np.abs(fp - fj).max() <= 1e-6
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(p.name for p in (tmp_path / "jax").iterdir())


def test_write_flo_equals_jax_byte_for_byte(tmp_path):
    from optical_flow_tpu.io.flo import write_flo as wj
    from optical_flow_tpu_torch.io.flo import read_flo, write_flo as wp

    flow = np.random.default_rng(0).normal(0, 3, (7, 9, 2))
    wj(flow, str(tmp_path / "j.flo"))
    wp(torch.as_tensor(flow), str(tmp_path / "p.flo"))  # a tensor is written as its values
    assert (tmp_path / "p.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(read_flo(str(tmp_path / "p.flo")), flow.astype(np.float32))
    with pytest.raises(ValueError, match="H, W, 2"):
        wp(np.zeros((3, 4, 3)), str(tmp_path / "bad.flo"))


def test_no_checkpointer_means_no_hook():
    """The methods read the flow on the host only through the hook: without a
    checkpointer (the default) none is called."""
    from optical_flow_tpu_torch.config import available_methods, load_of_method

    for name in available_methods():
        assert load_of_method(name).checkpoint is None


@pytest.mark.parametrize("hsz", [13, 15])
def test_weighted_median_wider_than_the_kernel_matches_jax(hsz):
    import jax.numpy as jnp

    from optical_flow_tpu.ops.wmedian import denoise_color_weighted_medfilt2 as dj
    from optical_flow_tpu_torch.ops.cuda.wmedian_kernel import MAX_HSZ
    from optical_flow_tpu_torch.ops.wmedian import denoise_color_weighted_medfilt2 as dp

    assert hsz > MAX_HSZ
    rng = np.random.default_rng(hsz)
    uv = 3 * rng.standard_normal((31, 37, 2))
    color = rng.uniform(0, 255, (31, 37, 3))
    occ = rng.uniform(0.1, 1.0, (31, 37))
    out_p = dp(*(torch.as_tensor(x) for x in (uv, color, occ)), hsz, [5, 5], 7.0)
    out_j = dj(*(jnp.asarray(x) for x in (uv, color, occ)), hsz, [5, 5], 7.0)
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(out_j))


def test_flow_with_area_hsz_13_matches_jax():
    """The whole flow at hsz 13 (JAX's sort route, the port's wide-window
    path), both GNC stages at one pyramid level each: JAX then compiles one
    level program (~25 s alone) instead of four."""
    a, b, _, _ = rubberwhale_crop(**CROP)
    uv_j, uv_p = flows(a, b, "classic+nl-fast", {"display": False, "solver": "pcg", "area_hsz": 13, "max_iters": 1,
                                                 **ONE_LEVEL})
    assert np.abs(uv_p - uv_j).max() <= 1e-6


def test_wide_kernel_window_limit():
    from optical_flow_tpu_torch.ops.cuda.wmedian_kernel import wide_fits

    # one warp's 2 x 169^2 words fit 232,448 B; 2 x 171^2 do not
    assert wide_fits(13) and wide_fits(84) and not wide_fits(85)


@pytest.mark.cuda
@pytest.mark.parametrize("hsz", [13, 20])
def test_wide_window_runs_the_wide_kernel_on_the_card(hsz):
    from optical_flow_tpu_torch.ops.cuda import wmedian_kernel
    from optical_flow_tpu_torch.ops.filters import pad2d

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(2)
    H, W = 31, 37

    def pad(x):
        return pad2d(torch.as_tensor(x, dtype=torch.float32, device="cuda"), hsz, hsz, hsz, hsz, "mirror").contiguous()

    # a narrow colour range spreads the weights
    args = (pad(rng.normal(0, 3, (H, W))), pad(rng.normal(0, 3, (H, W))), pad(rng.uniform(0.1, 1, (H, W))),
            pad(rng.uniform(0, 24, (3, H, W))), (H, W), hsz, 7.0)
    before = wmedian_kernel.launches
    out = wmedian_kernel.wmedian(*args)
    assert wmedian_kernel.launches == before + 1
    assert torch.equal(out, wmedian_kernel.wmedian_plain(*args))
