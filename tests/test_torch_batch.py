"""The batched serving path: ``parallel/batch.py`` and every op it runs with a
leading batch axis, against the JAX package's ``parallel/batch.py`` in
float64 on the CPU and against the port's own single-pair calls.

The batch is the 48x64 crop at row 220, column 200 of RubberWhale,
Hydrangea, Dimetrodon and RubberWhale again.  No pixel of the crop sits on
an exact .5 gray tie in any of the three sequences
(``test_batch_crop_has_no_gray_ties``): XLA:CPU contracts the jitted gray
conversion's weighted sum into FMAs and rounds such ties up, where the port
rounds them down, and JAX's batched RGB route is jitted.  The JAX batches
are computed once per module (each compiles a vmapped level program).
Tests marked ``cuda`` run the batched kernels on the card:
``python -m pytest tests/test_torch_batch.py -m cuda --noconftest``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import REPO_DATA_DIR, SLICE_CROP32, t  # noqa: E402

SEQS = ("RubberWhale", "Hydrangea", "Dimetrodon", "RubberWhale")
PARAMS = {"display": False, "solver": "pcg"}
# the JAX batches' schedule: both GNC stages at the one 48x64 level, so JAX
# compiles one level program a route instead of four (the batched levels of a
# pyramid are held to JAX by test_torch_video.py and test_torch_batch_irls.py)
FLOW_PARAMS = {**PARAMS, "auto_level": False, "pyramid_levels": 1, "gnc_pyramid_levels": 1}
H100 = (132, 232448)  # SMs, shared memory a block may opt in to
MAIN_PATH_LEVELS = [(388, 584), (310, 467), (194, 292), (97, 146), (49, 73), (25, 37)]


def _crop_batch():
    from optical_flow_tpu_torch.io.flo import read_flow_file

    c = SLICE_CROP32
    sl = np.s_[c["y0"] : c["y0"] + c["h"], c["x0"] : c["x0"] + c["w"]]
    pairs = [read_flow_file(s, 10, REPO_DATA_DIR)[:2] for s in SEQS]
    return np.stack([a[sl] for a, _ in pairs]), np.stack([b[sl] for _, b in pairs])


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="module")
def batch():
    """The RGB crops, JAX's preprocessed batch, and JAX's and the port's
    batched flows (with the guide, without it, and from RGB), as numpy."""
    import jax.numpy as jnp

    from optical_flow_tpu.parallel import batch as bj
    from optical_flow_tpu_torch.parallel import batch as bp

    im1, im2 = _crop_batch()
    images, color = (np.asarray(x) for x in bj.preprocess_color_batch(im1, im2, dtype=jnp.float64))
    pj = {**FLOW_PARAMS, "dtype": jnp.float64}
    pp = {**FLOW_PARAMS, "dtype": torch.float64}
    out = {"im1": im1, "im2": im2, "images": images, "color": color}
    out["jax_guided"] = np.asarray(bj.estimate_flow_batched(images, "classic+nl-fast", params=pj, color_batch=color))
    out["jax_plain"] = np.asarray(bj.estimate_flow_batched(images, "classic+nl-fast", params=pj))
    out["jax_rgb"] = np.asarray(bj.estimate_flow_batched_rgb(im1, im2, "classic+nl-fast", params=pj))
    out["guided"] = bp.estimate_flow_batched(images, "classic+nl-fast", params=pp, color_batch=color, device="cpu").numpy()
    out["plain"] = bp.estimate_flow_batched(images, "classic+nl-fast", params=pp, device="cpu").numpy()
    out["rgb"] = bp.estimate_flow_batched_rgb(im1, im2, "classic+nl-fast", params=pp, device="cpu").numpy()
    return out


def test_batch_crop_has_no_gray_ties(batch):
    import jax

    from optical_flow_tpu.utils.compat import rgb2gray

    for im in (*batch["im1"], *batch["im2"]):
        x = jax.numpy.asarray(im)
        np.testing.assert_array_equal(np.asarray(jax.jit(rgb2gray)(x)), np.asarray(rgb2gray(x)))
    np.testing.assert_array_equal(batch["images"][..., 0], np.stack([np.asarray(rgb2gray(jax.numpy.asarray(a)))
                                                                     for a in batch["im1"]]))


def test_preprocess_color_batch_matches_jax(batch):
    from optical_flow_tpu_torch.parallel.batch import preprocess_color_batch

    images, color = preprocess_color_batch(t(batch["im1"]), t(batch["im2"]))
    np.testing.assert_array_equal(images.numpy(), batch["images"])
    # the cube root is pow(|t|, 1/3) here and cbrt in XLA: a few ulp of 255
    np.testing.assert_allclose(color.numpy(), batch["color"], rtol=0, atol=1e-10)


@pytest.mark.parametrize("route", ["guided", "plain", "rgb"])
def test_batched_flow_matches_jax_item_by_item(batch, route):
    port, ref = batch[route], batch[f"jax_{route}"]
    assert port.shape == (4, 48, 64, 2) and port.dtype == np.float64
    for k in range(4):
        assert np.abs(port[k] - ref[k]).max() <= 1e-6, (route, k)  # measured <= 5.6e-12
    assert np.array_equal(port[0], port[3])  # identical items, identical bits


@pytest.mark.parametrize("route", ["guided", "plain"])
def test_batched_items_equal_their_single_pair_flows(batch, route):
    """Each item equals the port's single-pair flow on the same pair and guide."""
    from optical_flow_tpu_torch.config import load_of_method

    ope = load_of_method("classic+nl-fast")
    ope.parse_input_parameter({**FLOW_PARAMS, "dtype": torch.float64})
    for k in range(4):
        color = t(batch["color"][k]) if route == "guided" else None
        single = ope.compute_flow(t(batch["images"][k]), color).numpy()
        np.testing.assert_allclose(batch[route][k], single, rtol=0, atol=1e-12)


# ------------------------------------------------------------------ ops with a leading B


def _stacked(fn, *items):
    return torch.stack([fn(*args) for args in zip(*items)])


def _equal(a, b, exact=False):
    """Bit for bit where the op only moves values; else within 1e-12
    relative: the CPU's vectorised pow / exp round a tensor's tail elements
    on another path, so the same value may differ in its last bit between
    two tensor sizes, and the resizes' matrix products sum more rows."""
    assert a.shape == b.shape
    if exact:
        assert torch.equal(a, b)
    else:
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def _warp_inputs(rng, B=3, H=13, W=17, C=2):
    images = t(rng.uniform(0, 255, (B, H, W, 2 * C)))
    uv = t(rng.normal(0, 1.5, (B, H, W, 2)))
    return images, uv


OPS = ["scale_image", "preprocess_color_pair", "rof_texture", "correlate2d_multi", "median_filter2d",
       "matlab_imresize_bilinear", "build_pyramid", "resample_flow", "sample_bilinear", "sample_cubic_spline",
       "warp bi-cubic", "warp cubic", "warp bi-linear", "build_irls_system", "system_apply", "penalties",
       "detect_occlusion", "weighted median", "plain median route", "cg_solve"]


@pytest.mark.parametrize("op", OPS)
def test_op_with_a_leading_batch_axis_equals_its_unbatched_calls(rng, op):
    """Every op the batched program runs, on a (B, ...) input, equals stacking
    its calls on each item (see ``_equal`` for which bit for bit)."""
    from optical_flow_tpu_torch.ops import derivatives as D, filters, interp, stencil
    from optical_flow_tpu_torch.ops.occlusion import detect_occlusion
    from optical_flow_tpu_torch.ops.penalties import Robust
    from optical_flow_tpu_torch.ops.pyramid import build_pyramid
    from optical_flow_tpu_torch.ops.resample import resample_flow
    from optical_flow_tpu_torch.ops.rof import structure_texture_decomposition_rof
    from optical_flow_tpu_torch.ops.wmedian import denoise_color_weighted_medfilt2
    from optical_flow_tpu_torch.utils.compat import preprocess_color_pair, scale_image

    B, H, W = 3, 13, 17
    images, uv = _warp_inputs(rng, B, H, W)
    planes = t(rng.normal(0, 1, (B, H, W)))
    if op == "scale_image":
        _equal(scale_image(images, 0, 255, batch_dims=1), _stacked(lambda x: scale_image(x, 0, 255), images), True)
    elif op == "preprocess_color_pair":
        rgb1, rgb2 = t(rng.uniform(0, 255, (B, H, W, 3))), t(rng.uniform(0, 255, (B, H, W, 3)))
        got = preprocess_color_pair(rgb1, rgb2, batch_dims=1)
        for g, ref in zip(got, zip(*[preprocess_color_pair(a, b) for a, b in zip(rgb1, rgb2)])):
            _equal(g, torch.stack(ref))
    elif op == "rof_texture":
        _equal(structure_texture_decomposition_rof(images, 1.0 / 8, 20, 0.95, 1),
               _stacked(lambda x: structure_texture_decomposition_rof(x, 1.0 / 8, 20, 0.95), images))
    elif op == "correlate2d_multi":
        k = np.arange(15.0).reshape(3, 5) / 100
        _equal(filters.correlate2d_multi(images, k, "reflect", 1),
               _stacked(lambda x: filters.correlate2d_multi(x, k, "reflect"), images))
        _equal(filters.correlate2d_multi(planes, k, "reflect", 1),
               _stacked(lambda x: filters.correlate2d_multi(x, k, "reflect"), planes))
    elif op == "median_filter2d":
        _equal(filters.median_filter2d(planes, 5), _stacked(lambda x: filters.median_filter2d(x, 5), planes), True)
    elif op == "matlab_imresize_bilinear":
        _equal(interp.matlab_imresize_bilinear(images, (7, 9), 1),
               _stacked(lambda x: interp.matlab_imresize_bilinear(x, (7, 9)), images))
        _equal(interp.matlab_imresize_bilinear(planes, (7, 9), 1),
               _stacked(lambda x: interp.matlab_imresize_bilinear(x, (7, 9)), planes))
    elif op == "build_pyramid":
        for got, ref in zip(build_pyramid(images, 3, 1.25, 1), zip(*[build_pyramid(x, 3, 1.25) for x in images])):
            _equal(got, torch.stack(ref))
    elif op == "resample_flow":
        _equal(resample_flow(uv, (7, 9)), _stacked(lambda x: resample_flow(x, (7, 9)), uv))
    elif op in ("sample_bilinear", "sample_cubic_spline"):
        ys = t(rng.uniform(-2, H + 1, (B, 5, 6)))
        xs = t(rng.uniform(-2, W + 1, (B, 5, 6)))
        if op == "sample_bilinear":
            _equal(interp.sample_bilinear(planes, ys, xs), _stacked(interp.sample_bilinear, planes, ys, xs), True)
        else:
            stack = t(rng.normal(0, 1, (B, 3, H, W)))
            for coeffs in (planes, stack):
                got, oob = interp.sample_cubic_spline(coeffs, ys, xs)
                ref = [interp.sample_cubic_spline(c, y, x) for c, y, x in zip(coeffs, ys, xs)]
                _equal(got, torch.stack([r[0] for r in ref]), True)
                _equal(oob, torch.stack([r[1] for r in ref]), True)
    elif op.startswith("warp"):
        method = op.split()[1]
        f = np.array(D.DEFAULT_DERIV_FILTER)
        got = D.warp_deriv(D.precompute_warp(images, method, f, 0.5), uv)
        ref = [D.warp_deriv(D.precompute_warp(im, method, f, 0.5), u) for im, u in zip(images, uv)]
        for g, r in zip(got, zip(*ref)):
            _equal(g, torch.stack(r), method == "bi-linear")
    elif op in ("build_irls_system", "system_apply"):
        rho = (Robust("generalized_charbonnier", (1e-3, 0.45)),) * 2
        It, Ix, Iy = (t(rng.normal(0, 1, (B, H, W, 2))) for _ in range(3))
        duv = t(rng.normal(0, 0.3, (B, H, W, 2)))
        got = stencil.build_irls_system(uv, duv, It, Ix, Iy, rho, rho, rho[0], 0.7)
        ref = [stencil.build_irls_system(*a, rho, rho, rho[0], 0.7) for a in zip(uv, duv, It, Ix, Iy)]
        for g, r in zip(got, zip(*ref)):
            _equal(g, torch.stack(r))
        if op == "system_apply":
            _equal(stencil.system_apply(got, duv),
                   torch.stack([stencil.system_apply(stencil.FlowSystem(*r), d) for r, d in zip(zip(*got), duv)]))
    elif op == "penalties":
        for name, p in (("generalized_charbonnier", (1e-3, 0.45)), ("lorentzian", (0.03,)), ("charbonnier", (1e-3,))):
            r = Robust(name, p)
            _equal(r.deriv_over_x(planes), _stacked(r.deriv_over_x, planes))
    elif op == "detect_occlusion":
        _equal(detect_occlusion(uv, images), _stacked(detect_occlusion, uv, images))
    elif op in ("weighted median", "plain median route"):
        color = t(rng.uniform(0, 255, (B, H, W, 3))) if op == "weighted median" else None
        occ = t(rng.uniform(0.1, 1.0, (B, H, W)))
        got = denoise_color_weighted_medfilt2(uv, color, occ, 3, (5, 5), 7.0)
        ref = [denoise_color_weighted_medfilt2(u, None if color is None else color[k], o, 3, (5, 5), 7.0)
               for k, (u, o) in enumerate(zip(uv, occ))]
        _equal(got, torch.stack(ref), True)
    elif op == "cg_solve":
        from optical_flow_tpu_torch.ops.cuda.cg_kernel import cg_solve

        sysm = stencil.FlowSystem(*[t(f) for f in _random_system_np(rng, B, H, W)])
        _equal(cg_solve(sysm, 1e-6, 300),
               torch.stack([cg_solve(stencil.FlowSystem(*item), 1e-6, 300) for item in zip(*sysm)]))


def _random_system_np(rng, B, H, W):
    """Seeded random SPD flow systems, one an item, each scaled differently so
    that the items need different iteration counts."""
    def u(*s):
        return rng.uniform(0.1, 1.0, s)

    scale = np.resize([1.0, 30.0, 0.01, 3.0], B).reshape(B, 1, 1)
    w = [u(B, H, W) * scale for _ in range(4)]
    for k in (0, 2):
        w[k][..., :, -1] = 0
    for k in (1, 3):
        w[k][..., -1, :] = 0
    return [u(B, H, W) + 1.0, 0.5 * u(B, H, W), u(B, H, W) + 1.0, *w, u(B, H, W), u(B, H, W)]


def test_guard_rolls_back_only_the_item_that_diverged(rng):
    from optical_flow_tpu_torch.utils.guard import flow_is_healthy, guard_level

    init = t(rng.normal(0, 1, (3, 6, 7, 2)))
    new = t(rng.normal(0, 1, (3, 6, 7, 2)))
    new[1, 2, 3, 0] = float("nan")
    init_bad = init.clone()
    init_bad[2, 0, 0, 1] = 2e9
    assert flow_is_healthy(new, 1e9).tolist() == [True, False, True]
    out = guard_level(new, init, 1e9)
    assert torch.equal(out[0], new[0]) and torch.equal(out[1], init[1]) and torch.equal(out[2], new[2])
    new[2, 1, 1, 1] = float("inf")
    out = guard_level(new, init_bad, 1e9)  # item 2: the new and the start both unhealthy -> zero flow
    assert torch.equal(out[0], new[0]) and torch.equal(out[1], init[1]) and not out[2].any()
    assert flow_is_healthy(new[0], 1e9).shape == ()  # one field: a 0-d bool, as before


def test_guarded_batch_rolls_back_one_item_alone():
    """classic+nl-fast with the guard at 0.5 px on a batch whose middle pair
    moves 1 px and whose others move ~0.1 px: the middle item's levels roll
    back (to zero flow), the others keep their unguarded flows bit for bit,
    and each item equals its single-pair run."""
    from scipy.ndimage import gaussian_filter

    from optical_flow_tpu_torch.config import load_of_method
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched

    base = gaussian_filter(np.random.default_rng(3).uniform(0, 255, (24, 32)), 1.0)
    shifted = np.roll(base, 1, axis=1)
    small = np.stack([base, 0.9 * base + 0.1 * shifted], -1)
    images = np.stack([small, np.stack([base, shifted], -1), small])
    params = {**PARAMS, "dtype": torch.float64, "max_iters": 1}
    guarded = estimate_flow_batched(images, "classic+nl-fast", params={**params, "guard_flow": 0.5}, device="cpu")
    free = estimate_flow_batched(images, "classic+nl-fast", params=params, device="cpu")
    assert float(free[1].abs().max()) > 1.0 and not guarded[1].any()
    assert torch.equal(guarded[0], free[0]) and torch.equal(guarded[2], free[2]) and bool(guarded[0].any())
    ope = load_of_method("classic+nl-fast")
    ope.parse_input_parameter({**params, "guard_flow": 0.5})
    for k in range(3):
        _equal(guarded[k], ope.compute_flow(t(images[k]), None))


# ------------------------------------------------------------------ the batched PCG plans


def test_cg_plan_batched_main_path_levels():
    """B = 1 keeps the single-solve plans; B = 3 and 4 fit the three coarser
    resident levels in sms // B bands an item, one launch; the two finest
    levels run the single-solve plan once per item; 25x37 is one block an item."""
    from optical_flow_tpu_torch.ops.cuda.cg_kernel import CgPlan, cg_plan

    expected = {
        1: [("resident", 132, 8, 98112, 1), ("resident", 132, 8, 78456, 1), ("resident", 132, 4, 35040, 1),
            ("resident", 97, 1, 10512, 1), ("resident", 49, 1, 5256, 1), ("single", 1, 4, 45288, 1)],
        3: [("resident", 132, 8, 98112, 1), ("resident", 132, 8, 78456, 1), ("resident", 44, 8, 77088, 3),
            ("resident", 44, 2, 24528, 3), ("resident", 44, 1, 8760, 3), ("single", 1, 4, 45288, 3)],
        4: [("resident", 132, 8, 98112, 1), ("resident", 132, 8, 78456, 1), ("resident", 33, 8, 91104, 4),
            ("resident", 33, 2, 24528, 4), ("resident", 33, 1, 8760, 4), ("single", 1, 4, 45288, 4)],
    }
    for B, plans in expected.items():
        assert [tuple(cg_plan(B, *s, *H100)) for s in MAIN_PATH_LEVELS] == plans, B
    assert cg_plan(4, 2160, 3840, *H100) == CgPlan("streaming")
    assert cg_plan(200, 49, 73, *H100).items == 1  # too many items to share the SMs: one at a time
    assert tuple(cg_plan(132, 97, 146, *H100)) == ("resident", 97, 1, 10512, 1)


def test_cg_device_launches_follow_the_plan():
    """The launch counter counts device launches: one a call, or one an item
    where the plan takes one item a launch, or streams."""
    from optical_flow_tpu_torch.ops.cuda.cg_kernel import device_launches, cg_plan

    for B, counts in ((1, [1] * 6), (3, [3, 3, 1, 1, 1, 1]), (4, [4, 4, 1, 1, 1, 1])):
        assert [device_launches(B, cg_plan(B, *s, *H100)) for s in MAIN_PATH_LEVELS] == counts, B
    assert device_launches(4, cg_plan(4, 2160, 3840, *H100)) == 4
    assert device_launches(200, cg_plan(200, 49, 73, *H100)) == 200


# ------------------------------------------------------------------ what raises


def test_default_method_mesh_sor_and_device_raise():
    """JAX's default method (hs-brightness) and SOR run batched; a ``mesh`` that is
    no ``flow_mesh`` raises (``tests/test_torch_batch_mesh.py`` runs real
    meshes), and the default device is the card."""
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched

    images = np.zeros((2, 16, 16, 2))
    assert estimate_flow_batched(images, device="cpu").shape == (2, 16, 16, 2)
    with pytest.raises(TypeError, match="flow_mesh"):
        estimate_flow_batched(images, "classic+nl-fast", mesh=object(), device="cpu")
    uv = estimate_flow_batched(images, "classic+nl-fast", params={"solver": "sor"}, device="cpu")
    assert uv.shape == (2, 16, 16, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            estimate_flow_batched(images, "classic+nl-fast")  # the default device is the card


def test_fuse_is_accepted_and_ignored():
    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched

    rng = np.random.default_rng(5)
    images = rng.uniform(0, 255, (2, 20, 24, 2))
    p = {**PARAMS, "dtype": torch.float64, "max_iters": 1}
    assert torch.equal(estimate_flow_batched(images, "classic+nl-fast", params={**p, "fuse": True}, device="cpu"),
                       estimate_flow_batched(images, "classic+nl-fast", params=p, device="cpu"))


# ------------------------------------------------------------------ on the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,shape", [(4, (49, 73)), (4, (97, 146)), (3, (194, 292)), (4, (25, 37)), (2, (388, 584)),
                                     (2, (1200, 1600))])
def test_batched_cg_kernel_matches_twin_item_by_item(cuda_device, B, shape):
    from optical_flow_tpu_torch.ops.cuda import cg_kernel
    from optical_flow_tpu_torch.ops.cuda.build import device_limits
    from optical_flow_tpu_torch.ops.stencil import FlowSystem

    rng = np.random.default_rng(B)
    sysm = FlowSystem(*[torch.as_tensor(f, dtype=torch.float32, device=cuda_device)
                        for f in _random_system_np(rng, B, *shape)])
    before = cg_kernel.launches
    x = cg_kernel.cg_solve(sysm, 1e-6, 300)
    plan = cg_kernel.cg_plan(B, *shape, *device_limits(cuda_device))
    assert cg_kernel.launches - before == cg_kernel.device_launches(B, plan)
    its = cg_kernel.item_iterations(cuda_device)
    for k in range(B):
        item = FlowSystem(*[f[k] for f in sysm])
        x_t = cg_kernel.cg_solve_plain(item, 1e-6, 300)
        single = cg_kernel.cg_solve(item, 1e-6, 300)
        assert float((x[k] - x_t).abs().max()) <= 1e-5 * max(float(x_t.abs().max()), 1.0)
        assert abs(its[k] - cg_kernel.iteration_counts(cuda_device)[0]) <= 2
        assert float((x[k] - single).abs().max()) <= 1e-5 * max(float(single.abs().max()), 1.0)


@pytest.mark.cuda
def test_batched_wmedian_kernel_bit_exact(cuda_device):
    from optical_flow_tpu_torch.ops.cuda.wmedian_kernel import wmedian, wmedian_plain
    from optical_flow_tpu_torch.ops.filters import pad2d

    rng = np.random.default_rng(1)
    B, H, W, hsz = 3, 29, 41, 4

    def pad(x):
        return pad2d(torch.as_tensor(x, dtype=torch.float32, device=cuda_device), hsz, hsz, hsz, hsz,
                     "mirror").contiguous()

    args = (pad(rng.normal(0, 3, (B, H, W))), pad(rng.normal(0, 3, (B, H, W))), pad(rng.uniform(0.1, 1, (B, H, W))),
            pad(rng.uniform(0, 255, (B, 3, H, W))), (H, W), hsz, 7.0)
    out = wmedian(*args)
    torch.cuda.synchronize()
    assert out.shape == (B, H, W, 2) and torch.equal(out, wmedian_plain(*args))
