"""The video and stream serving shapes (``parallel/video.py``), the prefetching
loader (``io/loader.py``) and the copied accuracy gates, against the JAX
package on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import REPO_DATA_DIR  # noqa: E402

PARAMS = {"display": False, "solver": "pcg"}


def _rolled_sequence(T=5, H=40, W=48):
    """A smoothed random gray frame rolled right one pixel a frame: u = +1."""
    from scipy.ndimage import gaussian_filter

    base = gaussian_filter(np.random.default_rng(7).uniform(0, 255, (H, W)), 1.0)
    return np.stack([np.roll(base, k, axis=1) for k in range(T)])


def test_estimate_flow_video_matches_jax():
    import jax.numpy as jnp

    from optical_flow_tpu.parallel.video import estimate_flow_video as vj
    from optical_flow_tpu_torch.parallel.video import estimate_flow_video as vp

    frames = _rolled_sequence()
    uv_j = np.asarray(vj(frames, "classic+nl-fast", params={**PARAMS, "dtype": jnp.float64}))
    uv_p = vp(frames, "classic+nl-fast", params={**PARAMS, "dtype": torch.float64}, device="cpu").numpy()
    assert uv_p.shape == (4, 40, 48, 2) and uv_p.dtype == np.float64
    for k in range(4):
        assert np.abs(uv_p[k] - uv_j[k]).max() <= 1e-6, k  # measured ~1e-13
    inner = uv_p[:, 8:-8, 8:-8]
    assert abs(inner[..., 0].mean() - 1.0) < 0.05 and abs(inner[..., 1].mean()) < 0.05


def test_estimate_flow_video_rejects_other_shapes():
    from optical_flow_tpu_torch.parallel.video import estimate_flow_video

    with pytest.raises(ValueError, match="T, H, W"):
        estimate_flow_video(np.zeros((3, 8, 8, 3)), device="cpu")


@pytest.mark.parametrize("max_in_flight", [1, 2, 8])
def test_estimate_flow_stream_equals_one_call_per_pair_in_order(max_in_flight):
    from optical_flow_tpu_torch import estimate_flow
    from optical_flow_tpu_torch.parallel.video import estimate_flow_stream

    frames = _rolled_sequence(T=4, H=24, W=32)
    frames[2] = frames[2][::-1]  # pairs that differ, so the order shows
    pairs = [(frames[k], frames[k + 1]) for k in range(3)]
    params = {**PARAMS, "dtype": torch.float64, "max_iters": 1}
    got = list(estimate_flow_stream(iter(pairs), "classic+nl-fast", params, max_in_flight, device="cpu"))
    assert len(got) == 3
    for out, (a, b) in zip(got, pairs):
        assert isinstance(out, np.ndarray)
        assert np.array_equal(out, estimate_flow(a, b, "classic+nl-fast", params, device="cpu").numpy())


def test_prefetch_loader_matches_jax():
    from optical_flow_tpu.io.loader import PrefetchLoader as LJ, middlebury_loader as mj
    from optical_flow_tpu_torch.io.loader import PrefetchLoader as LP, middlebury_loader as mp

    items = [("RubberWhale", 10), ("Hydrangea", 10), ("Dimetrodon", 10)]
    for prefetch in (1, 2, 5):
        lj, lp = LJ(items, REPO_DATA_DIR, prefetch), LP(items, REPO_DATA_DIR, prefetch)
        assert len(lj) == len(lp) == 3 and lj.prefetch == lp.prefetch
        for got, ref in zip(lp, lj):
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)
    seqs = ["Venus", "Grove2"]
    assert mp(seqs, REPO_DATA_DIR).items == mj(seqs, REPO_DATA_DIR).items == [("Venus", 10), ("Grove2", 10)]
    assert LP([], prefetch=0).prefetch == LJ([], prefetch=0).prefetch == 1


def test_copied_gates_equal_the_benchmark_constants():
    import json
    import os
    import sys

    from optical_flow_tpu_torch.evaluation import gates

    repo = os.path.dirname(REPO_DATA_DIR)
    with open(os.path.join(repo, "benchmarks", "results_ref_oracle.json")) as f:
        oracle = json.load(f)
    assert gates.REF_ORACLE == {k: (v["aae"], v["aepe"]) for k, v in oracle.items() if not k.startswith("_")}
    sys.path.insert(0, repo)
    try:
        from benchmarks import middlebury
    finally:
        sys.path.remove(repo)
    assert gates.GATES == middlebury.GATES and gates.SEQ_GATES == middlebury.SEQ_GATES


def test_copied_method_oracle_equals_the_benchmark_json():
    import json
    import os

    from optical_flow_tpu_torch.evaluation import gates

    with open(os.path.join(os.path.dirname(REPO_DATA_DIR), "benchmarks", "results_ref_oracle_methods.json")) as f:
        oracle = json.load(f)
    methods = {m: {k: (v["aae"], v["aepe"]) for k, v in seqs.items() if not k.startswith("_")}
               for m, seqs in oracle.items() if not m.startswith("_")}
    assert gates.METHOD_ORACLE == methods and set(methods) == {"hs", "classic++", "classic+nl", "ba"}
