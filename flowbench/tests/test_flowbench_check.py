"""The harness's check sees each fault of the timed path: a run driven on the CPU (the card's look skipped)
at a small size, with the path broken underneath, comes out not correct; the sound run comes out correct.

On the CPU the port runs its kernels' plain twins in float32, whose sums run in another order than the
reference's float64 sums: a sound run in another order, which the check has to pass."""
import importlib
import time

import numpy as np
import pytest
import torch

from flowbench.lib import bench, frames, manifest

SEED = 2**31 + 4242
CELLS = ["nlfast_4k_single", "classicpp_mbo_b8"]


@pytest.fixture(scope="module")
def crops():
    pool = frames.load_pool("mbo_vga")
    return [(n, a[180:228, 260:324].copy(), b[180:228, 260:324].copy()) for n, a, b in pool[:2]]


def _run(cell, crops, wrap_entry=None, seconds=0.01):
    torch.set_num_threads(2)
    spec = manifest.resolve_cell(manifest.load_manifest(), cell)
    mix = dict(spec["traffic"], scale=1, crop_rows=None, distinct_calls=2)
    if mix["entry"] == "batched_rgb":
        mix["batch"] = len(crops)
    spec = dict(spec, traffic=mix, check=dict(spec["check"], sample_pairs=2))
    return bench.run_cell(spec, SEED, seconds, False, "cpu", time.time(), pairs=crops, wrap_entry=wrap_entry)


def _half_batch(entry):
    def call(c):
        out = entry(c._replace(im1=c.im1[: len(c.im1) // 2], im2=c.im2[: len(c.im2) // 2]))
        return torch.cat([out, out])  # the other half left out, the first half's flows in its place
    return call


def _altered(entry):
    def call(c):
        out = entry(c).clone()
        out[..., 0] += 1.0  # every answer moved by 1 px where it is produced
        return out
    return call


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, crops):
    r = _run(cell, crops)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_step_returning_its_state_unchanged_is_caught(cell, crops, monkeypatch):
    ba = importlib.import_module("optical_flow_tpu_torch.methods.ba")
    monkeypatch.setattr(ba, "solve_flow_system", lambda sys, *a, **k: torch.zeros((*sys.a11.shape, 2),
                                                                                 dtype=sys.a11.dtype))
    r = _run(cell, crops)
    assert not r["correct"], r["checks"]


def test_half_the_batch_left_out_is_caught(crops):
    r = _run("classicpp_mbo_b8", crops, _half_batch)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced_is_caught(cell, crops):
    r = _run(cell, crops, _altered)
    assert not r["correct"], r["checks"]


def test_non_finite_answer_is_caught(crops):
    def nan(entry):
        def call(c):
            out = entry(c).clone()
            out[..., 0, 0, 0] = float("nan")
            return out
        return call
    r = _run("nlfast_4k_single", crops, nan)
    assert not r["correct"] and np.isinf(r["checks"]["flow_gap_mean_px"]["value"])


def test_a_call_that_raises_counts_as_failed(crops):
    def flaky(entry):
        n = [0]

        def call(c):
            n[0] += 1
            if n[0] == 2:  # the warm-up passes, the window's first call raises
                raise RuntimeError("lost")
            return entry(c)
        return call
    r = _run("nlfast_4k_single", crops, flaky, seconds=1.0)
    assert r["failed"] == 1 and r["attempted"] >= 2 and not r["correct"]
