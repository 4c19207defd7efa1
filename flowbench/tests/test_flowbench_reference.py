"""The frozen reference against the port's plain path (the kernels' CPU twins), float64, at a tiny size."""
import json

import numpy as np
import pytest
import torch

from flowbench.lib import frames, manifest
from flowbench.reference.flow import gnc_alphas, reference_flow


@pytest.fixture(scope="module")
def crop():
    pool = frames.load_pool("mbo_vga")
    name, a, b = pool[2]
    return a[100:148, 200:264].copy(), b[100:148, 200:264].copy()


@pytest.mark.parametrize("cfg", ["classic_nl_fast", "classic_pp"])
def test_reference_equals_the_ports_plain_path(crop, cfg):
    from optical_flow_tpu_torch import estimate_flow

    torch.set_num_threads(1)
    c = json.loads((manifest.BENCH_DIR / "configs" / f"{cfg}.json").read_text())
    settings, params = dict(c["settings"]), dict(c["params"], dtype=torch.float64)
    if cfg == "classic_pp":  # ten warps a level are chaotic in float64 too; three keep it a check of the code
        settings["max_iters"] = params["max_iters"] = 3
    uv = estimate_flow(crop[0], crop[1], c["method"], params, device="cpu").numpy()
    ref = reference_flow(crop[0], crop[1], settings, "cpu", torch.float64).numpy()
    assert np.abs(uv).mean() > 0.5
    np.testing.assert_allclose(ref, uv, rtol=0, atol=1e-10)


def test_gnc_alphas():
    assert gnc_alphas(2) == [1.0, 0.0] and gnc_alphas(3) == [1.0, 0.5, 0.0]
