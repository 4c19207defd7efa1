"""The traffic generator: the same seed gives the same calls, every seed the same set of pairs."""
import numpy as np
import pytest

from flowbench.lib import traffic

MIXES = ["mbo_vga_b8", "mbo_4k_single"]


def _pairs(n=8, h=6, w=8):
    rng = np.random.default_rng(0)
    return [(f"p{i}", rng.integers(0, 256, (h, w, 3), dtype=np.uint8), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            for i in range(n)]


def _small(mix):
    t = traffic.load_traffic(mix)
    if t["crop_rows"]:  # the same proportions on 6-row frames
        t = dict(t, crop_rows=t["crop_rows"] * 6 // 480)
    return t


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_calls(mix):
    t, pairs = _small(mix), _pairs()
    seed = 2**31 + 977
    a, b = traffic.make_calls(t, pairs, seed), traffic.make_calls(t, pairs, seed)
    assert len(a) == len(b) == t.get("distinct_calls", len(pairs) * len(t["flips"]))
    for x, y in zip(a, b):
        assert x.items == y.items and np.array_equal(x.im1, y.im1) and np.array_equal(x.im2, y.im2)
        assert x.im1.dtype == np.uint8 and x.im1.flags["C_CONTIGUOUS"]


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_gets_the_same_pairs_and_sizes(mix):
    t, pairs = _small(mix), _pairs()
    orders, combos = [], []
    for seed in (1, 2, 3**20):
        calls = traffic.make_calls(t, pairs, seed)
        items = [it for c in calls for it in c.items]
        combos.append(sorted(items))
        names = sorted(n for c in calls for n, _, _ in c.items)
        orders.append([n for c in calls for n, _, _ in c.items])
        assert names == sorted([p[0] for p in pairs] * (len(names) // len(pairs)))
        shapes = {c.im1.shape for c in calls}
        assert len(shapes) == 1
        rows = 6 * t["scale"] if not t["crop_rows"] else t["crop_rows"]
        assert next(iter(shapes))[-3:] == (rows, 8 * t["scale"], 3)
        for c in calls:
            for _, flip, row0 in c.items:
                assert flip in t["flips"] and 0 <= row0 <= 6 * t["scale"] - rows
        if t["entry"] == "single":  # rounds: each run of 8 calls holds every pair once
            for r in range(0, len(calls), len(pairs)):
                assert sorted(c.items[0][0] for c in calls[r : r + len(pairs)]) == sorted(p[0] for p in pairs)
    assert orders[0] != orders[1]
    assert combos[0] == combos[1] == combos[2]  # the same variants for every seed: the same work


def test_flips_are_the_pair_flipped():
    pairs = _pairs(1)
    t = {"entry": "single", "batch": 1, "scale": 1, "crop_rows": None, "flips": ["hv"]}
    c = traffic.make_calls(t, pairs, 5)[0]
    assert np.array_equal(c.im1, pairs[0][1][::-1, ::-1]) and np.array_equal(c.im2, pairs[0][2][::-1, ::-1])


def test_upscale_is_torch_bicubic_rounded():
    f = _pairs(1, 4, 4)[0][1]
    up = traffic.upscale(f, 3, "cpu")
    assert up.shape == (12, 12, 3) and up.dtype == np.uint8
