"""The port's tensor ops against the JAX package's, on the same seeded numpy inputs.

Elementwise and stencil code agrees to rtol 1e-10 in float64 (the
operation order is the same; only reductions and matrix products may sum
in another order).  Each MATLAB / numpy trap the port has to get right has
its own test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch_parity import REPO_DATA_DIR, close, j, n, t  # noqa: E402


# --------------------------------------------------------------------- compat


def test_compat_scalars_match():
    from optical_flow_tpu.utils import compat as J
    from optical_flow_tpu_torch.utils import compat as P

    for x in (0.5, 1.5, 2.4999, 96.5, 193.75):
        assert P.matlab_round(x) == J.matlab_round(x)
    for size, sigma in ((5, 1.0), (3, 0.79), ((3, 5), 1.5)):
        np.testing.assert_array_equal(P.fspecial_gaussian(size, sigma), J.fspecial_gaussian(size, sigma))


@pytest.mark.parametrize("bounds", [None, (10.0, 200.0), "flat"])
def test_scale_image_global_minmax(rng, bounds):
    from optical_flow_tpu.utils.compat import scale_image as sj
    from optical_flow_tpu_torch.utils.compat import scale_image as sp

    im = rng.uniform(-3, 7, (9, 11, 3))
    if bounds == "flat":
        im = np.full((9, 11, 3), 4.0)
        bounds = None
    kw = {} if bounds is None else {"ilow": bounds[0], "ihigh": bounds[1]}
    close(sp(t(im), 0, 255, **kw), sj(j(im), 0, 255, **kw))


def test_rgb2gray_rounds_half_away_from_zero():
    """MATLAB's uint8 quantisation rounds x.5 up: floor(x + 0.5), not torch.round."""
    from optical_flow_tpu.utils.compat import rgb2gray as gj
    from optical_flow_tpu_torch.utils.compat import rgb2gray as gp

    im = np.zeros((1, 4, 3))
    im[0, :, 0] = [0.5, 1.5, 2.5, 254.5]  # ties in the uint8 quantisation
    im[0, :, 1] = [10.0, 10.0, 10.0, 10.0]
    out = n(gp(t(im)))
    np.testing.assert_array_equal(out, n(gj(j(im))))
    q = np.floor(im + 0.5)
    expect = np.floor(0.2989 * q[..., 0] + 0.5870 * q[..., 1] + 0.1140 * q[..., 2] + 0.5)
    np.testing.assert_array_equal(out, expect)
    banker = torch.round(0.2989 * torch.round(t(im[..., 0])) + 0.5870 * 10.0)
    assert not np.array_equal(n(banker), out)  # torch.round would be wrong here


@pytest.mark.parametrize("scale", [255.0, 1.0])
def test_rgb2lab_and_preprocess(rng, scale):
    from optical_flow_tpu.utils import compat as J
    from optical_flow_tpu_torch.utils import compat as P

    im1 = rng.uniform(0, scale, (13, 17, 3))
    im2 = rng.uniform(0, scale, (13, 17, 3))
    # torch has no cbrt: sign(x)*|x|^(1/3) is within a few ulp of jnp.cbrt
    close(P.rgb2lab(t(im1)), J.rgb2lab(j(im1)), rtol=1e-12, atol=1e-11)
    g_p, lab_p = P.preprocess_color_pair(t(im1), t(im2))
    g_j, lab_j = J.preprocess_color_pair(j(im1), j(im2))
    close(g_p, g_j, rtol=0, atol=0)
    close(lab_p, lab_j, rtol=1e-12, atol=1e-10)


# -------------------------------------------------------------------- filters


@pytest.mark.parametrize("boundary", ["reflect", "nearest"])
@pytest.mark.parametrize("kshape", [(5, 5), (1, 5), (5, 1), (3, 3)])
def test_correlate2d(rng, boundary, kshape):
    from optical_flow_tpu.ops.filters import correlate2d as cj, correlate2d_multi as cmj
    from optical_flow_tpu_torch.ops.filters import correlate2d as cp, correlate2d_multi as cmp_

    im = rng.standard_normal((12, 15))
    k = rng.standard_normal(kshape)
    close(cp(t(im), k, boundary), cj(j(im), k, boundary))
    im3 = rng.standard_normal((12, 15, 2))
    close(cmp_(t(im3), k, boundary), cmj(j(im3), k, boundary))


def test_pad_reflect_is_numpy_symmetric_not_torch_reflect():
    """scipy 'reflect' repeats the edge (numpy 'symmetric'); torch's
    F.pad(mode='reflect') does not (numpy 'reflect').  The port pads by index."""
    from optical_flow_tpu_torch.ops.filters import pad2d

    x = np.arange(12.0).reshape(3, 4)
    for boundary, mode in (("reflect", "symmetric"), ("mirror", "reflect"), ("nearest", "edge")):
        for p in (1, 2, 5):  # pads wider than the axis fold again, as numpy does
            got = n(pad2d(t(x), p, p, p, p, boundary))
            np.testing.assert_array_equal(got, np.pad(x, p, mode=mode))
    torch_reflect = torch.nn.functional.pad(t(x)[None], (1, 1, 1, 1), mode="reflect")[0]
    assert not np.array_equal(n(torch_reflect), np.pad(x, 1, mode="symmetric"))


# --------------------------------------------------------- interp / pyramid


def test_resize_matrix_and_imresize(rng):
    from optical_flow_tpu.ops import interp as J
    from optical_flow_tpu_torch.ops import interp as P

    for n_in, n_out in ((20, 10), (97, 49), (49, 61), (7, 7)):
        np.testing.assert_array_equal(P.matlab_resize_matrix(n_in, n_out), J.matlab_resize_matrix(n_in, n_out))
    im = rng.standard_normal((20, 33))
    close(P.matlab_imresize_bilinear(t(im), (10, 17)), J.matlab_imresize_bilinear(j(im), (10, 17)))
    im3 = rng.standard_normal((20, 33, 3))
    close(P.matlab_imresize_bilinear(t(im3), (16, 26)), J.matlab_imresize_bilinear(j(im3), (16, 26)))


@pytest.mark.parametrize("mode", ["nearest", "constant"])
def test_sample_bilinear(rng, mode):
    from optical_flow_tpu.ops.interp import sample_bilinear as sj
    from optical_flow_tpu_torch.ops.interp import sample_bilinear as sp

    im = rng.standard_normal((11, 14))
    ys = rng.uniform(-2, 13, (11, 14))
    xs = rng.uniform(-2, 16, (11, 14))
    ys[0, :3] = [0.0, 10.0, 5.0]  # exact grid points and the far edge
    xs[0, :3] = [13.0, 0.0, 13.0]
    out_p = sp(t(im), t(ys), t(xs), mode=mode)
    out_j = sj(j(im), j(ys), j(xs), mode=mode)
    if mode == "nearest":
        close(out_p, out_j)
    else:
        close(out_p[0], out_j[0])
        np.testing.assert_array_equal(n(out_p[1]), n(out_j[1]))


def test_pyramid_schedule_and_build(rng):
    from optical_flow_tpu.ops import pyramid as J
    from optical_flow_tpu_torch.ops import pyramid as P

    for hw, spacing in (((388, 584), 2.0), ((388, 584), 1.25), ((64, 96), 2.0), ((480, 640), 2.0)):
        levels = J.auto_pyramid_levels(hw, spacing)
        assert P.auto_pyramid_levels(hw, spacing) == levels
        assert P.pyramid_shapes(hw, levels, 1 / spacing) == J.pyramid_shapes(hw, levels, 1 / spacing)
        np.testing.assert_array_equal(P.pyramid_filter(spacing), J.pyramid_filter(spacing))
    assert P.auto_pyramid_levels((388, 584), 2.0) == 5  # the main path's 5 levels
    im = rng.uniform(0, 255, (40, 52, 2))
    for spacing, levels in ((2.0, 3), (1.25, 2)):
        for a, b in zip(P.build_pyramid(t(im), levels, spacing), J.build_pyramid(j(im), levels, spacing)):
            close(a, b)


def test_resample_flow_scales_both_components_by_height_ratio(rng):
    from optical_flow_tpu.ops.resample import resample_flow as rj
    from optical_flow_tpu_torch.ops.resample import resample_flow as rp

    uv = rng.standard_normal((20, 30, 2))
    out = rp(t(uv), (40, 45))  # height x2, width x1.5
    close(out, rj(j(uv), (40, 45)))
    ones = n(rp(t(np.ones((20, 30, 2))), (40, 45)))
    np.testing.assert_allclose(ones, 2.0, rtol=1e-12)  # v AND u scale by 40/20
    assert rp(t(uv), (20, 30)) is not None and np.array_equal(n(rp(t(uv), (20, 30))), uv)


# ------------------------------------------------------------- derivatives


@pytest.mark.parametrize("nc", [1, 2])
def test_bicubic_warp_deriv(rng, nc):
    from optical_flow_tpu.ops.derivatives import precompute_warp as pj, warp_deriv as wj
    from optical_flow_tpu_torch.ops.derivatives import precompute_warp as pp, warp_deriv as wp

    H, W = 17, 23
    images = rng.uniform(0, 255, (H, W, 2 * nc))
    uv = 2.5 * rng.standard_normal((H, W, 2))
    uv[0, 0] = [W - 1.0, 0.0]  # lands exactly on the last column: out (ceil neighbour leaves)
    uv[1, 1] = [-1.0, -1.0]  # exact grid point on the leading edge
    out_p = wp(pp(t(images), "bi-cubic"), t(uv))
    out_j = wj(pj(j(images), "bi-cubic"), j(uv))
    for a, b in zip(out_p, out_j):
        close(a, b, rtol=1e-10, atol=1e-9)
    assert not n(out_p[0]).reshape(H, W, -1)[0, 0].any()


@pytest.mark.parametrize("nc", [1, 2])
@pytest.mark.parametrize("method", ["cubic", "bi-linear"])
def test_spline_and_bilinear_warp_deriv(rng, method, nc):
    """The 'cubic' and 'bi-linear' routes mask with the strictly-outside mask
    B: a point exactly on the last column is inside (the Hermite route's
    mask counts it as out)."""
    from optical_flow_tpu.ops.derivatives import precompute_warp as pj, warp_deriv as wj
    from optical_flow_tpu_torch.ops.derivatives import precompute_warp as pp, warp_deriv as wp

    H, W = 17, 23
    images = rng.uniform(0, 255, (H, W, 2 * nc))
    uv = 2.5 * rng.standard_normal((H, W, 2))
    uv[0, 0] = [W - 1.0, 0.0]  # exactly on the last column: inside
    uv[1, 1] = [-1.0, -1.0]  # exact grid point on the leading edge
    uv[2, 2] = [-2.0 - 1e-9, 0.0]  # just outside the leading edge
    out_p = wp(pp(t(images), method), t(uv))
    out_j = wj(pj(j(images), method), j(uv))
    for a, b in zip(out_p, out_j):
        close(a, b, rtol=1e-10, atol=1e-9)
    It = n(out_p[0]).reshape(H, W, -1)
    assert It[0, 0].all() and not It[2, 2].any()


def test_unknown_interpolation_raises():
    from optical_flow_tpu_torch.ops.derivatives import precompute_warp

    with pytest.raises(ValueError, match="Unknown interpolation"):
        precompute_warp(t(np.zeros((4, 4, 2))), "lanczos")


def test_bspline_prefilter_matrix_equals_jax():
    from optical_flow_tpu.ops.interp import bspline_prefilter_matrix as mj
    from optical_flow_tpu_torch.ops.interp import bspline_prefilter_matrix as mp

    for size in (1, 2, 5, 38, 97):
        np.testing.assert_array_equal(mp(size), mj(size))


@pytest.mark.parametrize("shape", [(12, 17), (1, 9), (30, 4)])
def test_spline_coeffs_and_samples(rng, shape):
    """Coefficients and samples to rtol 1e-10, points beyond both edges
    included (their base index is clamped, their weights are not)."""
    from optical_flow_tpu.ops.interp import sample_cubic_spline as sj, spline_coeffs_2d as cj
    from optical_flow_tpu_torch.ops.interp import sample_cubic_spline as sp, spline_coeffs_2d as cp

    H, W = shape
    im = rng.uniform(0, 255, shape)
    c_p, c_j = cp(t(im)), cj(j(im))
    close(c_p, c_j, rtol=1e-10, atol=1e-10 * 255)
    ys = rng.uniform(-3, H + 2, (8, 11))
    xs = rng.uniform(-3, W + 2, (8, 11))
    ys[0, :3] = [0.0, H - 1.0, -0.5]
    xs[0, :3] = [W - 1.0, 0.0, W - 0.5]
    (v_p, oob_p), (v_j, oob_j) = sp(c_p, t(ys), t(xs)), sj(c_j, j(ys), j(xs))
    close(v_p, v_j, rtol=1e-10, atol=1e-10 * 255)
    np.testing.assert_array_equal(n(oob_p), n(oob_j))
    # a stack of planes samples each plane as one call would
    v3, _ = sp(torch.stack([c_p, 2 * c_p]), t(ys), t(xs))
    close(v3[1], 2 * n(v_p), rtol=1e-12, atol=1e-12)


def test_spline_pad_is_numpy_reflect():
    """The coefficients pad with numpy 'reflect' (no repeated edge), the
    port's "mirror": a sample just inside the edge reads c[1] past it."""
    from optical_flow_tpu.ops.interp import sample_cubic_spline as sj
    from optical_flow_tpu_torch.ops.interp import sample_cubic_spline as sp

    c = np.arange(20.0).reshape(4, 5) ** 2
    ys, xs = np.full((1, 3), 1.5), np.array([[0.0, 0.25, 4.0]])
    close(sp(t(c), t(ys), t(xs))[0], sj(j(c), j(ys), j(xs))[0], rtol=1e-12)


# ----------------------------------------------------------------- stencil


def _irls_inputs(rng, H=14, W=19, nc=1):
    uv = rng.standard_normal((H, W, 2))
    duv = 0.3 * rng.standard_normal((H, W, 2))
    shape = (H, W) if nc == 1 else (H, W, nc)
    return uv, duv, rng.standard_normal(shape), rng.standard_normal(shape), rng.standard_normal(shape)


@pytest.mark.parametrize("nc", [1, 3])
def test_build_irls_system_blend_and_apply(rng, nc):
    from optical_flow_tpu.ops import penalties as PJ, stencil as SJ
    from optical_flow_tpu_torch.ops import penalties as PP, stencil as SP

    args = _irls_inputs(rng, nc=nc)
    gc = ("generalized_charbonnier", (1e-3, 0.45))
    q = ("quadratic", (1e-3,))

    def build(S, P, lib, pen, lam):
        r = P.Robust(*pen)
        return S.build_irls_system(*[lib(a) for a in args], (r, r), (r, r), r, lam)

    sys_p = SP.blend_systems(0.3, build(SP, PP, t, q, 3.0), build(SP, PP, t, gc, 3.0))
    sys_j = SJ.blend_systems(0.3, build(SJ, PJ, j, q, 3.0), build(SJ, PJ, j, gc, 3.0))
    for a, b in zip(sys_p, sys_j):
        close(a, b, rtol=1e-10, atol=1e-12 * float(np.abs(n(b)).max()))
    x = rng.standard_normal((14, 19, 2))
    close(SP.system_apply(sys_p, t(x)), SJ.system_apply(sys_j, j(x)), rtol=1e-9, atol=1e-9)
    close(
        SP.weighted_laplacian_diag(sys_p.wu_h, sys_p.wu_v),
        SJ.weighted_laplacian_diag(sys_j.wu_h, sys_j.wu_v),
        rtol=1e-10,
    )


PENALTY_CASES = [
    ("quadratic", (0.03,)),
    ("generalized_charbonnier", (1e-3, 0.45)),
    ("lorentzian", (0.03,)),
    ("charbonnier", (1e-3,)),
    ("geman_mcclure", (0.5,)),
    ("huber", (0.8,)),
    ("tukey", (1.1,)),
    ("gaussian", (0.7,)),
    ("tdist", (3.0, 0.4)),
    ("tdist_unnorm", (3.0, 0.4)),
]


@pytest.mark.parametrize("name,params", PENALTY_CASES)
def test_penalties(rng, name, params):
    """All ten penalties in their three modes, to rtol 1e-12; the inputs
    straddle the thresholds of huber (sigma^2) and tukey (sigma)."""
    from optical_flow_tpu.ops.penalties import PENALTIES
    from optical_flow_tpu.ops.penalties import Robust as RJ
    from optical_flow_tpu_torch.ops.penalties import Robust as RP

    assert len(PENALTY_CASES) == len(PENALTIES)
    x = np.concatenate([rng.standard_normal(50), [0.0, 0.64, -0.64, 1.1, -1.1, 1e-4]])
    rp, rj = RP(name, params), RJ(name, params)
    for f in ("evaluate", "deriv", "deriv_over_x"):
        close(getattr(rp, f)(t(x)), getattr(rj, f)(j(x)), rtol=1e-12, atol=1e-300)


def test_unimplemented_penalties_raise():
    """``mixture`` and ``spline_penalty`` are named but unimplemented, as in the JAX package."""
    from optical_flow_tpu.ops.penalties import Robust as RJ
    from optical_flow_tpu_torch.ops.penalties import Robust as RP

    for name in ("mixture", "spline_penalty"):
        for R in (RP, RJ):
            with pytest.raises(NotImplementedError):
                R(name, (1.0,))
    with pytest.raises(ValueError, match="Unknown penalty"):
        RP("cauchy", (1.0,))


def test_build_hs_system(rng):
    from optical_flow_tpu.ops import stencil as SJ
    from optical_flow_tpu_torch.ops import stencil as SP

    for nc in (1, 3):
        uv, _, It, Ix, Iy = _irls_inputs(rng, nc=nc)
        sys_p = SP.build_hs_system(t(uv), t(It), t(Ix), t(Iy), 40.0, 1.0, 2.0)
        sys_j = SJ.build_hs_system(j(uv), j(It), j(Ix), j(Iy), 40.0, 1.0, 2.0)
        for a, b in zip(sys_p, sys_j):
            close(a, b, rtol=1e-12, atol=1e-12)
        assert not n(sys_p.wu_h)[:, -1].any() and not n(sys_p.wu_v)[-1, :].any()
        assert np.array_equal(n(sys_p.a12), n(SP._channel_mean(t(Ix) * t(Iy))) / 1.0)


# ------------------------------------------------------------------ median


@pytest.mark.parametrize("with_nans", [False, True])
@pytest.mark.parametrize("size", [3, 5, 7, 9, (3, 5)])
def test_median_filter2d_equals_jax(rng, size, with_nans):
    """Equal to the JAX median bit for bit, NaN positions included: the
    Batcher network (at most 49 values) and the sort (more).  A window that
    is more than half NaN gives NaN; fewer NaNs sort past every value."""
    from optical_flow_tpu.ops.filters import median_filter2d as mj
    from optical_flow_tpu_torch.ops.filters import median_filter2d as mp

    im = rng.standard_normal((19, 23))
    im[3, 4] = im[3, 5]  # a tie
    if with_nans:
        im[rng.uniform(size=im.shape) < 0.15] = np.nan
        im[8:16, 8:16] = np.nan  # windows that are mostly NaN
    out_p, out_j = n(mp(t(im), size)), n(mj(j(im), size))
    np.testing.assert_array_equal(out_p, out_j)  # NaN positions equal too
    assert np.isnan(out_p).any() == with_nans
    if not with_nans:
        from scipy.ndimage import median_filter

        np.testing.assert_array_equal(out_p, median_filter(im, size=size, mode="reflect"))
    # a leading batch axis filters each plane as one call would
    stack = n(mp(t(np.stack([im, -im])), size))
    np.testing.assert_array_equal(stack[0], out_p)


def test_median_filter2d_float32_and_pair(rng):
    from optical_flow_tpu.methods.base import jit_median_pair
    from optical_flow_tpu_torch.methods.base import median_pair

    uv = rng.standard_normal((21, 30, 2)).astype(np.float32)
    uv[5, 5, 0] = np.nan
    out_p = n(median_pair(t(uv, torch.float32), (5, 5)))
    out_j = n(jit_median_pair(jnp.asarray(uv), (5, 5)))
    assert out_p.dtype == np.float32
    np.testing.assert_array_equal(out_p, out_j)


# --------------------------------------------------------------- occlusion


def test_detect_occlusion(rng):
    from optical_flow_tpu.ops.occlusion import detect_occlusion as dj
    from optical_flow_tpu_torch.ops.occlusion import detect_occlusion as dp

    uv = 2 * rng.standard_normal((15, 21, 2))
    images = rng.uniform(0, 255, (15, 21, 2))
    close(dp(t(uv), t(images)), dj(j(uv), j(images)), rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------- io


@pytest.mark.parametrize(
    "rel",
    [
        "RubberWhale/frame10.png",
        "RubberWhale/frame11.png",
        "Venus/frame10.png",  # 420x380
        "Beanbags/frame10.png",  # 640x480
    ],
)
def test_png_reader_matches_jax_package(rel):
    import os

    from optical_flow_tpu.io.png import read_png as rj
    from optical_flow_tpu_torch.io.png import read_png as rp

    path = os.path.join(REPO_DATA_DIR, "other-data", rel)
    a = rp(path)
    assert a.dtype == np.uint8 and a.ndim == 3
    np.testing.assert_array_equal(a, rj(path))


def test_flo_reader_and_metrics():
    import os

    from optical_flow_tpu.evaluation.metrics import flow_angular_error as fj
    from optical_flow_tpu.io.flo import read_flo as rj
    from optical_flow_tpu_torch.evaluation.metrics import flow_angular_error as fp
    from optical_flow_tpu_torch.io.flo import read_flo as rp, read_flow_file

    path = os.path.join(REPO_DATA_DIR, "other-gt-flow", "RubberWhale", "flow10.flo")
    gt = rp(path)
    np.testing.assert_array_equal(gt, rj(path))
    im1, im2, tu, tv = read_flow_file("RubberWhale", 10)  # the in-repo data/ default
    assert im1.shape == (388, 584, 3) and im1.dtype == np.float64
    u = tu + 0.1
    v = np.where(np.abs(tv) < 1e9, tv - 0.2, tv)
    assert fp(tu, tv, u, v) == fj(tu, tv, u, v)
    assert fp(tu, tv, u, v, 3) == fj(tu, tv, u, v, 3)
