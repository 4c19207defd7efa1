"""Classic+NL, the paper's full preset (``classic+nl``), as the benchmark's configuration ``classic_nl`` states it.

``flowbench/configs/classic_nl.json`` lists the preset's settings: each one
must be what ``load_of_method("classic+nl")`` holds, so that the file cannot
drift from the preset.  On a 48x64 crop of Grove2 in float64 the port's plain
path (the kernels' CPU twins) equals the benchmark's plain reference and the
JAX package's ``classic+nl`` (within 1e-9, as ``tests/test_torch_api.py``),
the batched entry equals its single calls (within 1e-12), and
``classic+nl-full`` equals ``classic+nl`` bit for bit.  Ten warps a level are
chaotic in float64 too, so the flows run three (the batch and the span one).
The weighted-median wrapper counts its launches and items (``stats()`` /
``reset_stats()``), and the ``nonlocal`` span names the batch and the
level's shape.

On a card (``-m cuda``) the preset's batched call counts one weighted-median
launch of B items a warp iteration.
"""
import inspect
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from torch_parity import one_cpu_thread  # noqa: E402,F401

from flowbench.lib import frames, manifest  # noqa: E402
from flowbench.reference.flow import reference_flow  # noqa: E402
from optical_flow_tpu_torch import estimate_flow, load_of_method  # noqa: E402
from optical_flow_tpu_torch.methods import ba  # noqa: E402
from optical_flow_tpu_torch.ops.cuda import wmedian_kernel  # noqa: E402
from optical_flow_tpu_torch.ops.occlusion import detect_occlusion  # noqa: E402
from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched_rgb  # noqa: E402
from optical_flow_tpu_torch.utils import profiling  # noqa: E402

CONFIG = json.loads((manifest.BENCH_DIR / "configs" / "classic_nl.json").read_text())
WARPS = 3  # warp iterations a level in the flows below (the preset's 10 in the settings check)
PARAMS = dict(CONFIG["params"], dtype=torch.float64, max_iters=WARPS)


@pytest.fixture(scope="module")
def crop():
    """Grove2's frames 10 and 11, rows 100-147 and columns 200-263 (the reference test's crop)."""
    pool = json.loads((manifest.BENCH_DIR / "pools" / "mbo_vga.json").read_text())
    pair = next(p for p in pool["pairs"] if p["name"] == "Grove2")
    a, b = (frames.load_frame(manifest.ROOT / pool["dir"] / f["file"], f["sha256"]) for f in pair["frames"])
    return a[100:148, 200:264].copy(), b[100:148, 200:264].copy()


@pytest.fixture(scope="module")
def nl_flow(crop):
    return estimate_flow(crop[0], crop[1], CONFIG["method"], PARAMS, device="cpu")


def test_every_setting_of_the_configuration_is_the_presets(monkeypatch):
    ope = load_of_method(CONFIG["method"])
    ope.parse_input_parameter(CONFIG["params"])
    s = CONFIG["settings"]
    rof = []  # (theta, iterations) of the ROF call that the preset's preprocessing makes
    monkeypatch.setattr(ba, "structure_texture_decomposition_rof", lambda im, theta, n_iters, *_: rof.append(
        (theta, n_iters)))
    ba._preprocess_traced(ope._preprocess_kind(), None, ope.alp)
    penalty = [[r.name, list(r.params)] for r in (*ope.rho_spatial_u, *ope.rho_spatial_v)]
    occ = inspect.signature(detect_occlusion).parameters
    qsu, qsv, qd = ope._quadratic_relaxation()  # the first stage's penalties: each robust one's own sigma
    quadratic, robust = (*qsu, *qsv, qd), (*ope.rho_spatial_u, *ope.rho_spatial_v, ope.rho_data)
    held = {
        "nonlocal": ope.median_filter_size is not None and ope.area_hsz > 0,
        "relaxation": [(q.name, q.params) for q in quadratic] == [("quadratic", (r.params[0],)) for r in robust],
        "rho_spatial": all(p == s["rho_spatial"] for p in penalty),
        "rho_data": [ope.rho_data.name, list(ope.rho_data.params)] == s["rho_data"],
        "lambda": ope.lambda_ == s["lambda"],
        "lambda_q": ope.lambda_q == s["lambda_q"],
        "gnc_iters": ope.gnc_iters == s["gnc_iters"] == 3,
        "max_iters": ope.max_iters == s["max_iters"] == 10,
        "max_linear": ope.max_linear == s["max_linear"],
        "pyramid_levels": ope.auto_level is True,
        "pyramid_spacing": ope.pyramid_spacing == s["pyramid_spacing"],
        "gnc_pyramid_levels": ope.gnc_pyramid_levels == s["gnc_pyramid_levels"],
        "gnc_pyramid_spacing": ope.gnc_pyramid_spacing == s["gnc_pyramid_spacing"],
        "interpolation": ope.interpolation_method == s["interpolation"],
        "blend": ope.blend == s["blend"],
        "texture": ope.texture is s["texture"] and ope._preprocess_kind() == "texture",
        "rof_theta": rof[0][0] == s["rof_theta"],
        "rof_iters": rof[0][1] == s["rof_iters"],
        "alp": ope.alp == s["alp"],
        "solver": ope.solver == "backslash" and s["solver"].startswith("backslash"),
        "pcg_rtol": ope.backslash_rtol == s["pcg_rtol"] == 1e-7,
        "pcg_maxiter": ope.backslash_maxiter == s["pcg_maxiter"] == 1000,
        "limit_update": ope.limit_update == s["limit_update"] == 1.0,
        "area_hsz": ope.area_hsz == s["area_hsz"] == 7,
        "sigma_i": ope.sigma_i == s["sigma_i"] == 7,
        "median_filter_size": list(ope.median_filter_size) == [s["median_filter_size"]] * 2,
        "occlusion_sigma_d": occ["sigma_d"].default == s["occlusion_sigma_d"],
        "occlusion_sigma_i": occ["sigma_i"].default == s["occlusion_sigma_i"],
    }
    assert set(held) == set(s)
    assert [k for k, ok in held.items() if not ok] == []
    assert ope.lambda_ == 3 and CONFIG["reduced"] == [] and "pcg" not in json.dumps(CONFIG["params"])
    plan = ope._make_nl_plan((480, 640), use_color=True)
    assert len(plan.stages) == 3 and all(cfg.irls.max_iters == 10 for cfg, _ in plan.stages)


def test_the_ports_plain_path_equals_the_reference(crop, nl_flow):
    ref = reference_flow(crop[0], crop[1], dict(CONFIG["settings"], max_iters=WARPS), "cpu", torch.float64)
    assert np.abs(nl_flow.numpy()).mean() > 0.5
    np.testing.assert_allclose(ref.numpy(), nl_flow.numpy(), rtol=0, atol=1e-10)


def test_the_preset_equals_the_jax_packages(crop, nl_flow):
    import jax.numpy as jnp

    from optical_flow_tpu.interface import estimate_flow as jax_estimate_flow

    params = dict(CONFIG["params"], dtype=jnp.float64, max_iters=WARPS)
    uv = np.asarray(jax_estimate_flow(crop[0], crop[1], CONFIG["method"], params))
    np.testing.assert_allclose(uv, nl_flow.numpy(), rtol=0, atol=1e-9)  # tests/test_torch_api.py's TOL


def test_the_batched_entry_equals_its_single_calls(crop):
    params = dict(PARAMS, max_iters=1)  # one warp a level: the batch axis, not the warps, is under test
    a, b = np.stack([crop[0], np.flip(crop[0], 1)]), np.stack([crop[1], np.flip(crop[1], 1)])
    batched = estimate_flow_batched_rgb(a, b, CONFIG["method"], params=params, device="cpu")
    assert batched.shape == (2, 48, 64, 2)
    for i in range(2):  # within 1e-12, as tests/test_torch_batch.py: vectorised exp rounds a tensor's tail apart
        single = estimate_flow(a[i], b[i], CONFIG["method"], params, device="cpu")
        torch.testing.assert_close(batched[i], single, rtol=1e-12, atol=1e-12)


def test_the_full_preset_is_the_same_computation(crop, nl_flow):
    ope = load_of_method("classic+nl-full")
    assert ope.fullVersion is True and load_of_method("classic+nl").fullVersion is False
    assert torch.equal(estimate_flow(crop[0], crop[1], "classic+nl-full", PARAMS, device="cpu"), nl_flow)


def test_the_weighted_median_counters_read_and_reset(monkeypatch):
    monkeypatch.setattr(wmedian_kernel, "launches", 90)
    monkeypatch.setattr(wmedian_kernel, "items", 720)
    assert wmedian_kernel.stats() == {"launches": 90, "items": 720}
    wmedian_kernel.reset_stats()
    assert wmedian_kernel.stats() == {"launches": 0, "items": 0}


def test_the_nonlocal_span_names_the_batch_and_the_levels_shape(crop, tmp_path):
    a, b = np.stack([crop[0], np.flip(crop[0], 0)]), np.stack([crop[1], np.flip(crop[1], 0)])
    with profiling.trace(str(tmp_path)):
        estimate_flow_batched_rgb(a, b, CONFIG["method"], params={"display": False, "max_iters": 1}, device="cpu")
    records = profiling.span_records()
    profiling.clear_span_records()
    levels = [r["attrs"] for r in records if r["name"] == "level"]
    nonlocal_ = [r["attrs"] for r in records if r["name"] == "nonlocal"]
    assert len({lv["stage"] for lv in levels}) == 3 and len(nonlocal_) == len(levels)
    assert nonlocal_ == [{"hsz": 7, "B": 2, "H": lv["H"], "W": lv["W"]} for lv in levels]


@pytest.mark.cuda
def test_one_weighted_median_launch_a_warp_for_the_whole_batch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the weighted-median kernel runs there")
    rng = np.random.default_rng(19)
    frame = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    a, b = np.stack([frame] * 3), np.stack([np.roll(frame, 1, axis=1)] * 3)
    ope = load_of_method(CONFIG["method"])
    ope.parse_input_parameter(CONFIG["params"])
    plan = ope._make_nl_plan((48, 64), use_color=True)
    warps = sum(cfg.irls.max_iters * (plan.levels if i == 0 else plan.gnc_levels)
                for i, (cfg, _) in enumerate(plan.stages))
    estimate_flow_batched_rgb(a, b, CONFIG["method"], params=CONFIG["params"], device="cuda")
    wmedian_kernel.reset_stats()
    uv = estimate_flow_batched_rgb(a, b, CONFIG["method"], params=CONFIG["params"], device="cuda").cpu()
    assert wmedian_kernel.stats() == {"launches": warps, "items": 3 * warps}
    assert torch.equal(uv[0], uv[1]) and torch.equal(uv[0], uv[2])

