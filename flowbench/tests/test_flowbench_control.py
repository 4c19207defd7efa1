"""The control comes out not correct through the harness's own comparison: a run of each cell, at the
cell's own entry point, with the reference on bfloat16 planes (one precision below the configurations'
float32) put in the program's place.

On the CPU at a small size (the card's look skipped); on a card at the cell's own sizes:

    python -m pytest flowbench/tests/test_flowbench_control.py -m cuda
"""
import time

import pytest
import torch

from flowbench.lib import bench, check, frames, manifest, port

SEED = 2**31 + 6161
CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


def control_in_place(settings, device):
    """``wrap_entry``: the cell's entry replaced by the control, pair by pair, flows on the host as the entry's."""
    def wrap(entry):
        def call(c):
            if c.im1.ndim == 3:
                return torch.as_tensor(check.reference_of(c.im1, c.im2, settings, device, control=True))
            return torch.stack([torch.as_tensor(check.reference_of(a, b, settings, device, control=True))
                                for a, b in zip(c.im1, c.im2)])
        return call
    return wrap


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' own sizes run there")
    port.load_port()
    return "cuda"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_cpu(cell):
    torch.set_num_threads(2)
    pool = frames.load_pool("mbo_vga")
    crops = [(n, a[180:228, 260:324].copy(), b[180:228, 260:324].copy()) for n, a, b in pool[:2]]
    spec = manifest.resolve_cell(manifest.load_manifest(), cell)
    mix = dict(spec["traffic"], scale=1, crop_rows=None, distinct_calls=2)
    if mix["entry"] == "batched_rgb":
        mix["batch"] = len(crops)
    spec = dict(spec, traffic=mix, check=dict(spec["check"], sample_pairs=2))
    r = bench.run_cell(spec, SEED, 0.01, False, "cpu", time.time(), pairs=crops,
                       wrap_entry=control_in_place(spec["config"]["settings"], "cpu"))
    assert r["failed"] == 0 and not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(card, cell):
    spec = manifest.resolve_cell(manifest.load_manifest(), cell)
    r = bench.run_cell(spec, SEED, 1.0, False, card, time.time(),
                       wrap_entry=control_in_place(spec["config"]["settings"], card))
    print(cell, {name: c for name, c in r["checks"].items()})
    assert r["failed"] == 0 and not r["correct"], r["checks"]
