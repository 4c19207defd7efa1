"""The one traffic generator: a mix's parameters (``flowbench/traffic/<name>.json``) and a seed -> calls.

A mix names a pool of frame pairs, the entry point (``single``: one pair
a call through ``estimate_flow``; ``batched_rgb``: ``batch`` pairs a call
through ``estimate_flow_batched_rgb``), an upscale factor with a row
crop, the flips and, for a batched mix, how many distinct calls to
prepare.  Every seed gets the same pairs, flips and crop rows, so the
same work; the seed sets only the order (:func:`make_calls`).  The window
cycles through the prepared calls in order, one call in flight (a closed
loop).  Frames stay uint8 RGB in host memory, as users hand them over.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, NamedTuple

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
FLIPS = {"none": (), "h": (1,), "v": (0,), "hv": (0, 1)}


class Call(NamedTuple):
    """One call's inputs: ``im1``, ``im2`` (H, W, 3) or (B, H, W, 3) uint8, and per pair (name, flip, crop row)."""

    im1: np.ndarray
    im2: np.ndarray
    items: tuple


def load_traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def upscale(frame: np.ndarray, scale: int, device) -> np.ndarray:
    """(H, W, 3) uint8 -> (scale H, scale W, 3) uint8 by torch's bicubic interpolation, rounded and clamped."""
    import torch
    import torch.nn.functional as F

    if scale == 1:
        return frame
    x = torch.as_tensor(frame).to(device).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, scale_factor=scale, mode="bicubic", align_corners=False)
    return torch.round(y.clamp(0, 255))[0].permute(1, 2, 0).to(torch.uint8).cpu().numpy()


def _variant(frames2, crop_rows, row0: int, flip: str):
    """The (upscaled) pair cropped to ``crop_rows`` rows from ``row0`` and flipped."""
    out = []
    for g in frames2:
        if crop_rows:
            g = g[row0 : row0 + crop_rows]
        axes = FLIPS[flip]
        out.append(np.ascontiguousarray(np.flip(g, axes) if axes else g))
    return out


def make_calls(traffic: dict, pairs: List[tuple], seed: int, device="cpu") -> List[Call]:
    """The distinct calls of ``traffic`` over ``pairs`` [(name, frame 1, frame 2)] for ``seed``.

    Each pair has one variant per flip: flip j with the j-th of as many crop rows, evenly spaced
    from the top to the bottom of the upscaled frame.  Every seed gets the same variants, so the
    same work; the seed sets only the order.  The calls come in rounds, one a flip: in round r each
    pair appears once, under variant (o_i + r) mod len(flips) with a seeded offset o_i, in seeded
    order: one call a pair (``single``), or ``batch`` pairs a call (``batched_rgb``, ``distinct_calls``
    calls, which need not fill whole rounds).  So any run of whole rounds holds each pair equally often."""
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    n, B, scale = len(pairs), int(traffic["batch"]), int(traffic["scale"])
    crop = traffic.get("crop_rows")
    flips = list(traffic["flips"])
    rows = pairs[0][1].shape[0] * scale
    if crop and crop > rows:
        raise ValueError(f"a crop of {crop} rows from {rows}")
    up = [(name, upscale(f1, scale, device), upscale(f2, scale, device)) for name, f1, f2 in pairs]
    rows0 = np.round(np.linspace(0, rows - crop, len(flips))).astype(int) if crop else np.zeros(len(flips), int)
    offset = rng.integers(0, len(flips), n)

    def variant(i, r):
        j = (int(offset[i]) + r) % len(flips)
        a, b = _variant(up[i][1:], crop, int(rows0[j]), flips[j])
        return a, b, (up[i][0], flips[j], int(rows0[j]))

    calls = []
    if traffic["entry"] == "batched_rgb":
        if B != n:
            raise ValueError(f"a batched mix takes the whole pool a call: batch {B}, pool {n}")
        for k in range(int(traffic["distinct_calls"])):
            f1s, f2s, items = zip(*(variant(i, k) for i in rng.permutation(n)))
            calls.append(Call(np.stack(f1s), np.stack(f2s), tuple(items)))
    elif traffic["entry"] == "single":
        if B != 1:
            raise ValueError("a single-pair mix has batch 1")
        for r in range(len(flips)):
            for i in rng.permutation(n):
                a, b, item = variant(i, r)
                calls.append(Call(a, b, (item,)))
    else:
        raise ValueError(f"unknown entry {traffic['entry']!r}")
    return calls
