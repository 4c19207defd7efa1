"""The single-frame API of the port against the JAX package, in float64 on the CPU.

The method objects (``ope.images = ...; ope.compute_flow(init, gt)``,
``compute_flow_base(uv)``) of classic+nl-fast, ``ba``, ``hs`` and the stable
``classic-c-a`` on the 24x32 tie-free RubberWhale crop
(``torch_parity.FAMILY_CROP``; hs on the 48x64 ``SLICE_CROP32``); the known-answer pair of the JAX package's
4K harness (``benchmarks/throughput.py::bench_4k``) at 96x128; the generic
``pcg_solve`` and the ops with the reference's names; the package exports.
One module-scoped fixture runs each family's JAX calls once.  The 4K kernel
calls run only on the card (``cuda`` marker; JAX is imported only by the
tests that compare with it, so they run where JAX is absent).
"""
import contextlib
import io
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import FAMILY_CROP, SLICE_CROP32, j, n, one_cpu_thread, rubberwhale_crop, t  # noqa: E402,F401

# Each family at its preset but for a one-level GNC pyramid, which keeps the
# JAX side to one level compile a family: ba at three warp iterations (ten
# are chaotic); alt-BA at its stable configuration (the preset's own diverges
# by design) at three warp iterations, with test_torch_alt_ba.py's tight backslash (at rtol 1e-7 the
# solves' stopping rounding grows to 1e-2 px over its warp iterations).
# hs runs on a 48x64 crop: two levels, so the warm start is resampled.
ALT_STABLE = {"lambda2": 0.01, "max_iters": 3, "gnc_iters": 2, "backslash_rtol": 1e-12, "backslash_maxiter": 8000}
FAMILIES = {
    "classic+nl-fast": {"solver": "pcg", "gnc_pyramid_levels": 1},
    "ba": {"max_iters": 3, "gnc_pyramid_levels": 1},
    "hs": {},
    "classic-c-a": {**ALT_STABLE, "gnc_pyramid_levels": 1},
}
CROPS = {"hs": SLICE_CROP32}
TOL = 1e-9
# the 4K harness's construction, cut to 96x128: seeded uniform frame rolled 2 px
KNOWN_HW = (96, 128)
KNOWN_SHIFT = 2
INTERIOR = np.s_[16:-16, 18:-16]  # 16 px at every border and the columns the roll wraps
MINUTES = re.compile(r"\d+\.\d+ minutes")


def _configure(ope, name, dtype):
    ope.parse_input_parameter({"display": False, **FAMILIES[name], "dtype": dtype})
    return ope


def _run(ope, images, color, init, gt, base_uv, uvhat=None, display=False):
    """(compute_flow from zero, printed text, compute_flow(init), compute_flow_base(base_uv), and with uvhat)."""
    ope.images, ope.color_images = images, color
    ope.display = display
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cold = ope.compute_flow(gt=gt)
    ope.display = False
    warm = ope.compute_flow(init=init)
    base = ope.compute_flow_base(base_uv)
    base_hat = ope.compute_flow_base(base_uv, uvhat) if uvhat is not None else None
    return cold, out.getvalue(), warm, base, base_hat


@pytest.fixture(scope="module")
def api_cases():
    """Each family's inputs and both packages' results, as numpy."""
    jnp = pytest.importorskip("jax.numpy")
    from optical_flow_tpu.config import load_of_method as lj
    from optical_flow_tpu_torch.config import load_of_method as lp
    from optical_flow_tpu_torch.utils.compat import preprocess_color_pair

    cases = {}
    for name in FAMILIES:
        im1, im2, tu, tv = rubberwhale_crop(**CROPS.get(name, FAMILY_CROP))
        images, lab = (x.numpy() for x in preprocess_color_pair(t(im1), t(im2)))
        gt = np.stack([tu, tv], -1)
        rng = np.random.default_rng(11)
        init = 0.5 * rng.standard_normal((*images.shape[:2], 2))
        base_uv = 0.3 * rng.standard_normal(init.shape)
        uvhat = base_uv + 0.05 * rng.standard_normal(init.shape)
        guided = name == "classic+nl-fast"
        hat = uvhat if name == "classic-c-a" else None
        oj = _configure(lj(name), name, jnp.float64)
        res_j = _run(oj, j(images), j(lab) if guided else oj.color_images, j(init), gt, j(base_uv),
                     None if hat is None else j(hat), display=guided)
        op = _configure(lp(name), name, torch.float64)
        res_p = _run(op, t(images), t(lab) if guided else op.color_images, t(init), gt, t(base_uv),
                     None if hat is None else t(hat), display=guided)
        cases[name] = {"jax": res_j, "port": res_p, "images": images, "lab": lab, "init": init}
    return cases


def _flows(res):
    """The four results as numpy, alt-BA's level pairs flattened."""
    cold, _, warm, base, base_hat = res
    out = {"cold": n(cold), "warm": n(warm)}
    for key, r in (("base", base), ("base_hat", base_hat)):
        if isinstance(r, tuple):
            out[key], out[key + " uvhat"] = n(r[0]), n(r[1])
        elif r is not None:
            out[key] = n(r)
    return out


@pytest.mark.parametrize("name", list(FAMILIES))
def test_method_object_calls_match_jax(api_cases, name):
    """``compute_flow()``, ``compute_flow(init=uv0)`` with a seeded non-zero
    uv0 and ``compute_flow_base(uv0)`` (alt-BA with and without ``uvhat``),
    each within 1e-9 px of the JAX package's same call; the warm start and
    the base step move the flow away from the cold one."""
    case = api_cases[name]
    fj, fp = _flows(case["jax"]), _flows(case["port"])
    assert fj.keys() == fp.keys()
    for key in fj:
        assert fp[key].shape == fj[key].shape and np.isfinite(fp[key]).all(), key
        assert np.abs(fp[key] - fj[key]).max() <= TOL, (key, np.abs(fp[key] - fj[key]).max())
    assert np.abs(fp["warm"] - fp["cold"]).max() > 1e-3
    assert np.abs(fp["cold"]).max() > 0.05  # a real flow


def test_classic_nl_display_prints_the_jax_lines(api_cases):
    """Under ``display`` with ``gt`` the port prints the JAX package's lines:
    the stages, the levels, and each stage's AAE / STD / EPE, minutes aside."""
    _, text_j, _, _, _ = api_cases["classic+nl-fast"]["jax"]
    _, text_p, _, _, _ = api_cases["classic+nl-fast"]["port"]
    assert "AAE" in text_p and text_p.count("finished") == 2  # the preset's two GNC stages
    assert MINUTES.sub("M minutes", text_p) == MINUTES.sub("M minutes", text_j)


def test_color_guide_placeholder_and_device(api_cases):
    """The presets' (1, 1, 3) placeholder is no guide, and a float32 numpy
    guide follows the images' device and dtype."""
    from optical_flow_tpu_torch.config import load_of_method

    case = api_cases["classic+nl-fast"]
    ope = _configure(load_of_method("classic+nl-fast"), "classic+nl-fast", torch.float64)
    assert ope.color_images.shape == (1, 1, 3)
    ope.images = t(case["images"])
    images, color, uv = ope._flow_inputs()
    assert color is None and not uv.any() and images.dtype == torch.float64
    ope.color_images = case["lab"].astype(np.float32)
    uv = ope.compute_flow()
    np.testing.assert_array_equal(uv.numpy(), n(case["port"][0]))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_numpy_images_without_a_gpu_raise(monkeypatch, name):
    """numpy images go to "cuda": without a GPU ``compute_flow`` and
    ``compute_flow_base`` raise before any work, and never run on the CPU."""
    from optical_flow_tpu_torch.config import load_of_method

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ope = _configure(load_of_method(name), name, torch.float64)
    ope.images = np.zeros((24, 32, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ope.compute_flow()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ope.compute_flow_base(np.zeros((24, 32, 2)))


def test_known_answer_pair_of_the_4k_harness():
    """The 4K harness's construction at 96x128 (seeded uniform frame, rolled
    2 px) through both packages' method-object call, classic+nl-fast in
    float64: AEPE against (2, 0) on the interior <= 0.1 px (measured 7.3e-13
    in both), the port within 1e-9 px of JAX there; the CPU anchor of
    chip_smoke.py's 4K gate."""
    jnp = pytest.importorskip("jax.numpy")
    from optical_flow_tpu.config import load_of_method as lj
    from optical_flow_tpu_torch.config import load_of_method as lp

    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, KNOWN_HW).astype(np.float32)
    im2 = np.roll(base, KNOWN_SHIFT, axis=1)
    oj = lj("classic+nl-fast")
    oj.display, oj.dtype = False, jnp.float64
    oj.images = jnp.stack([jnp.asarray(base, jnp.float64), jnp.asarray(im2, jnp.float64)], 2)
    uv_j = np.asarray(oj.compute_flow())
    op = lp("classic+nl-fast")
    op.display, op.dtype = False, torch.float64
    op.images = torch.stack([torch.as_tensor(base), torch.as_tensor(im2)], 2)  # float32, cast by compute_flow
    uv_p = op.compute_flow().numpy()
    assert uv_p.dtype == np.float64 and np.isfinite(uv_p).all()
    for uv in (uv_j, uv_p):
        inner = uv[INTERIOR]
        aepe = float(np.sqrt((inner[..., 0] - KNOWN_SHIFT) ** 2 + inner[..., 1] ** 2).mean())
        assert aepe <= 0.1
    assert np.abs(uv_p[INTERIOR] - uv_j[INTERIOR]).max() <= TOL


# ------------------------------------------------------------------ solver and ops


def _random_system(rng, H, W):
    """A seeded SPD flow system as numpy planes (the stencil's edge layout)."""
    u = lambda: rng.uniform(0.1, 1.0, (H, W))  # noqa: E731
    w = [u() for _ in range(4)]
    w[0][:, -1] = w[2][:, -1] = 0.0
    w[1][-1, :] = w[3][-1, :] = 0.0
    return [u() + 1.0, 0.5 * u(), u() + 1.0, *w, u(), u()]


@pytest.mark.parametrize("x0", [False, True])
@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize("rtol,maxiter", [(1e-10, 500), (1e-10, 4)])
def test_pcg_solve_matches_jax(x0, coupled, rtol, maxiter):
    """``pcg_solve`` on a stacked (H, W, 2) system, from zero or a seeded x0,
    with the 2x2 block preconditioner or the diagonal one, converged or
    stopped at ``maxiter``: within 1e-9 of JAX's."""
    from optical_flow_tpu.ops import stencil as sj
    from optical_flow_tpu.solvers.cg import pcg_solve as pj
    from optical_flow_tpu_torch.ops import stencil as sp
    from optical_flow_tpu_torch.solvers import pcg_solve as pp

    rng = np.random.default_rng(5)
    planes = _random_system(rng, 12, 15)
    start = rng.standard_normal((12, 15, 2)) if x0 else None
    out = []
    for S, solve, conv in ((sj, pj, j), (sp, pp, t)):
        sysm = S.FlowSystem(*[conv(p) for p in planes])
        x = solve(lambda v, sysm=sysm, S=S: S.system_apply(sysm, v), S.system_rhs(sysm), S.system_diag(sysm), rtol,
                  maxiter, x0=None if start is None else conv(start), a12=sysm.a12 if coupled else None)
        out.append(n(x))
    assert np.abs(out[1] - out[0]).max() <= TOL
    b = np.stack(planes[-2:], -1)
    sysm = sp.FlowSystem(*[t(p) for p in planes])
    res = np.linalg.norm(n(sp.system_apply(sysm, t(out[1]))) - b) / np.linalg.norm(b)
    assert (res <= rtol * 1.01) == (maxiter == 500)


def test_pcg_solve_refuses_sync_axes():
    from optical_flow_tpu_torch.solvers import pcg_solve

    b = torch.ones(3, 4, 2, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        pcg_solve(lambda x: x, b, torch.ones_like(b), 1e-3, 10, sync_axes=("batch",))


def test_interp2_bicubic_matches_jax_with_points_out_of_bounds():
    """1-based points inside, on the last row and column, outside and NaN:
    values and derivatives within 1e-9, NaN at the same places."""
    from optical_flow_tpu.ops.derivatives import interp2_bicubic as ij
    from optical_flow_tpu_torch.ops.derivatives import interp2_bicubic as ip

    rng = np.random.default_rng(2)
    Z = rng.uniform(0, 255, (9, 11))
    XI = rng.uniform(-1.0, 13.0, (6, 7))
    YI = rng.uniform(-1.0, 11.0, (6, 7))
    XI[0, :3], YI[0, :3] = (11.0, 10.5, np.nan), (9.0, 4.0, 3.0)
    rj = ij(j(Z), j(XI), j(YI))
    rp = ip(t(Z), t(XI), t(YI))
    assert np.isnan(n(rp[0])).any() and (~np.isnan(n(rp[0]))).any()
    for a, b in zip(rj, rp):
        a, b = n(a), n(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(a)
        assert np.abs(a[ok] - b[ok]).max() <= TOL
    flat = ip(t(Z), t(XI.ravel()), t(YI.ravel()))  # any one shape of points
    np.testing.assert_array_equal(n(flat[1]).reshape(6, 7), n(rp[1]))


@pytest.mark.parametrize("interp", ["bi-cubic", "cubic", "bi-linear"])
def test_partial_deriv_matches_jax(interp):
    from optical_flow_tpu.ops.derivatives import partial_deriv as dj
    from optical_flow_tpu_torch.ops.derivatives import partial_deriv as dp

    rng = np.random.default_rng(3)
    images = rng.uniform(0, 255, (14, 17, 2))
    uv = 1.5 * rng.standard_normal((14, 17, 2))
    for a, b in zip(dj(j(images), j(uv), interp), dp(t(images), t(uv), interp)):
        assert np.abs(n(a) - n(b)).max() <= TOL


@pytest.mark.parametrize("channels", [None, 3])
def test_pyramids_match_jax(channels):
    """``compute_image_pyramid`` at ratio 0.5 and ``pyramid_pair`` (2.0 and 1.25
    ladders) of an (H, W) and an (H, W, 3) image."""
    from optical_flow_tpu.ops import pyramid as J
    from optical_flow_tpu_torch.ops import pyramid as P

    shape = (37, 45) if channels is None else (37, 45, channels)
    img = np.random.default_rng(4).uniform(0, 255, shape)
    f = J.pyramid_filter(2.0)
    np.testing.assert_array_equal(f, P.pyramid_filter(2.0))
    lj, lp = J.compute_image_pyramid(j(img), f, 3, 0.5), P.compute_image_pyramid(t(img), f, 3, 0.5)
    pj, pp = J.pyramid_pair(j(img), 3, 2.0, 2, 1.25), P.pyramid_pair(t(img), 3, 2.0, 2, 1.25)
    for a, b in zip([*lj, *pj[0], *pj[1]], [*lp, *pp[0], *pp[1]]):
        assert a.shape == b.shape and np.abs(n(a) - n(b)).max() <= TOL
    assert [tuple(x.shape[:2]) for x in pp[1]] == [(37, 45), (30, 36)]


def test_system_diag_and_rhs_match_jax():
    from optical_flow_tpu.ops import stencil as J
    from optical_flow_tpu_torch.ops import stencil as P

    planes = _random_system(np.random.default_rng(6), 10, 13)
    sj, sp = J.FlowSystem(*[j(p) for p in planes]), P.FlowSystem(*[t(p) for p in planes])
    for a, b in ((J.system_diag(sj), P.system_diag(sp)), (J.system_rhs(sj), P.system_rhs(sp))):
        assert tuple(b.shape) == (10, 13, 2) and np.abs(n(a) - n(b)).max() <= TOL


def test_weighted_median_1d_with_ties_matches_jax():
    """Tied values keep their weights' order (a stable sort): equal to JAX, bit for bit."""
    from optical_flow_tpu.ops.wmedian import weighted_median_1d as wj
    from optical_flow_tpu_torch.ops.wmedian import weighted_median_1d as wp

    rng = np.random.default_rng(8)
    u = np.round(rng.standard_normal((40, 25)) * 2) / 2  # many ties
    w = rng.uniform(0.01, 1.0, (40, 25))
    w[0] = 1.0  # a row of equal weights: the median sits on a tie of the cumulative sum
    np.testing.assert_array_equal(n(wp(t(w), t(u))), n(wj(j(w), j(u))))
    assert float(wp([1.0, 1.0, 5.0], [3.0, 1.0, 2.0])) == 2.0


# ------------------------------------------------------------------ exports

SUBPACKAGES = ["", ".io", ".viz", ".solvers", ".evaluation", ".methods", ".utils", ".robust"]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_jax_exports_import_from_the_port(sub):
    """Every name in the ``__all__`` of JAX's top level and subpackage imports
    from the port's counterpart."""
    import importlib

    names = importlib.import_module("optical_flow_tpu" + sub).__all__
    port = importlib.import_module("optical_flow_tpu_torch" + sub)
    missing = [name for name in names if not hasattr(port, name)]
    assert not missing and set(names) <= set(port.__all__)


def test_import_loads_neither_jax_nor_matplotlib():
    """A fresh interpreter: importing the port, its subpackages (``robust``
    and ``ops.sparse_compat`` included) and every export leaves JAX, the JAX
    package and matplotlib unloaded."""
    code = ("import sys, optical_flow_tpu_torch as p\n"
            "import optical_flow_tpu_torch.viz, optical_flow_tpu_torch.utils.profiling\n"
            "import optical_flow_tpu_torch.robust.penalties, optical_flow_tpu_torch.ops.sparse_compat\n"
            "from optical_flow_tpu_torch.robust import *\n"
            "from optical_flow_tpu_torch.utils.warmup import warmup_classic_nl\n"
            "from optical_flow_tpu_torch import *\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'optical_flow_tpu', 'matplotlib')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------------------ 4K kernel calls on the card


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_4k_weighted_median_kernel_matches_twin(cuda_device):
    """The weighted median at 2160x3840, hsz 7, a Lab-like guide: at least
    0.9999 of the values equal to the twin's (the rest differ only by the
    order of the float32 sums, as chip_smoke.py's ``wmedian_valid`` shows)."""
    from optical_flow_tpu_torch.ops.cuda.wmedian_kernel import wmedian, wmedian_plain
    from optical_flow_tpu_torch.ops.filters import pad2d

    H, W, hsz = 2160, 3840, 7
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def pad(x):
        return pad2d(x, hsz, hsz, hsz, hsz, "mirror").contiguous()

    uv = 3 * torch.randn(2, H, W, device=cuda_device, generator=g)
    occ = torch.rand(H, W, device=cuda_device, generator=g) * 0.9 + 0.1
    guide = torch.rand(3, H, W, device=cuda_device, generator=g) * 255
    args = (pad(uv[0]), pad(uv[1]), pad(occ), pad(guide), (H, W), hsz, 7.0)
    out, ref = wmedian(*args), wmedian_plain(*args)
    assert out.shape == (H, W, 2) and float((out == ref).double().mean()) >= 0.9999


@pytest.mark.cuda
def test_4k_streaming_pcg_and_rof_match_their_twins(cuda_device):
    """At 2160x3840 PCG takes its streaming path and ROF its tiled one, each
    within chip_smoke.py's limits of its twin (PCG 1e-5 x scale, ROF 1e-6)."""
    from optical_flow_tpu_torch.ops.cuda import cg_kernel, rof_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits
    from optical_flow_tpu_torch.ops.stencil import FlowSystem

    H, W = 2160, 3840
    limits = device_limits(cuda_device)
    assert cg_kernel.cg_plan(1, H, W, *limits).path == "streaming"
    assert rof_kernel.rof_plan(2, H, W, *limits).path == "tiled"
    sysm = FlowSystem(*[torch.as_tensor(p, dtype=torch.float32, device=cuda_device)
                        for p in _random_system(np.random.default_rng(0), H, W)])
    x = cg_kernel.cg_solve(sysm, 1e-3, 50)
    x_t = cg_kernel.cg_solve_plain(sysm, 1e-3, 50)
    assert float((x - x_t).abs().max()) <= 1e-5 * max(float(x_t.abs().max()), 1.0)
    im = torch.rand(2, H, W, device=cuda_device) * 2 - 1
    out = rof_kernel.rof_structure(im, 1.0 / 8, 100)
    assert float((out - rof_kernel.rof_structure_2d(im, 1.0 / 8, 100)).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_method_object_on_the_card_equals_estimate_flow(cuda_device):
    """On the card, the JAX-style call on ``preprocess_color_pair``'s output
    equals ``estimate_flow`` bit for bit (RubberWhale crop, classic+nl-fast)."""
    from optical_flow_tpu_torch import estimate_flow
    from optical_flow_tpu_torch.config import load_of_method
    from optical_flow_tpu_torch.utils.compat import preprocess_color_pair

    im1, im2, _, _ = rubberwhale_crop(h=96, w=128)
    ope = load_of_method("classic+nl-fast")
    ope.parse_input_parameter({"display": False, "solver": "pcg"})
    f32 = torch.float32
    ope.images, ope.color_images = preprocess_color_pair(torch.as_tensor(im1, dtype=f32, device=cuda_device),
                                                         torch.as_tensor(im2, dtype=f32, device=cuda_device))
    uv = ope.compute_flow()
    ref = estimate_flow(im1, im2, "classic+nl-fast", {"display": False, "solver": "pcg"}, device=cuda_device)
    assert torch.equal(uv, ref)
