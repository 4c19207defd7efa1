"""The comparison that decides ``correct``: the timed path's flows against the plain reference.

Once the window has closed, a sample of the pairs it completed, drawn from
the seed, is recomputed by ``flowbench/reference`` from the same uint8
frames, on the same device, on float32 planes with its sums in float64
(the control: on bfloat16 planes).  Each pair gives the endpoint distance,
pixel by pixel, between the two flows; a number of the check is a
statistic of it (``of``), the worst over the sampled pairs, and is held to
its limit from ``flowbench/checks/<cell>.json``.
"""
from __future__ import annotations

import numpy as np

SHARES = (0.1, 0.5, 1.0)  # px: the statistics "share_over_<t>", the share of pixels farther apart than t


def gap_stats(uv: np.ndarray, ref: np.ndarray) -> dict:
    """Statistics of the endpoint distance between two (H, W, 2) flows (NaN anywhere reads as inf)."""
    epe = np.sqrt(np.sum((np.asarray(uv, np.float64) - np.asarray(ref, np.float64)) ** 2, axis=-1))
    if not np.all(np.isfinite(epe)):
        return {k: float("inf") for k in ("mean", "p50", "p90", "p99", "max")} | {f"share_over_{t}": 1.0
                                                                                  for t in SHARES}
    return {
        "mean": float(epe.mean()),
        "p50": float(np.percentile(epe, 50)),
        "p90": float(np.percentile(epe, 90)),
        "p99": float(np.percentile(epe, 99)),
        "max": float(epe.max()),
    } | {f"share_over_{t}": float(np.mean(epe > t)) for t in SHARES}


def sample_items(call_ids, batch: int, k: int, seed: int):
    """``k`` (call, item) positions among the kept calls ``call_ids`` of ``batch`` pairs, from the seed: as
    many distinct items (batch slots) as there are, each from a seeded kept call, so that seeds cover
    every slot."""
    rng = np.random.Generator(np.random.PCG64([int(seed), 7]))
    if batch == 1:
        picks = rng.choice(len(call_ids), size=min(k, len(call_ids)), replace=False)
        return [(call_ids[int(p)], 0) for p in sorted(picks)]
    items = rng.choice(batch, size=min(k, batch), replace=False)
    return sorted((call_ids[int(rng.integers(len(call_ids)))], int(i)) for i in items)


def reference_of(rgb1, rgb2, settings, device, control: bool = False, dtype: str = "float32") -> np.ndarray:
    """The reference flow of one pair on ``dtype`` planes; the control computes it on bfloat16 planes."""
    import torch

    from flowbench.reference.flow import reference_flow

    dt = torch.bfloat16 if control else getattr(torch, dtype)
    uv = reference_flow(rgb1, rgb2, settings, device=device, dtype=dt)
    return uv.float().cpu().numpy()


def compare(pairs, settings, numbers: dict, device, dtype: str = "float32") -> dict:
    """``pairs``: [(rgb1, rgb2, the program's flow)]; ``numbers``: name -> {"of", "limit"}.
    Returns name -> {"value": worst over the pairs, "limit"}."""
    worst = {name: 0.0 for name in numbers}
    for rgb1, rgb2, uv in pairs:
        stats = gap_stats(uv, reference_of(rgb1, rgb2, settings, device, dtype=dtype))
        for name, spec in numbers.items():
            worst[name] = max(worst[name], stats[spec["of"]])
    return {name: {"value": worst[name], "limit": numbers[name]["limit"]} for name in numbers}
