"""Video-sequence flow: consecutive-pair batching and streaming (port of ``optical_flow_tpu/parallel/video.py``).

* **batched**: a (T, H, W) sequence becomes its T-1 consecutive pairs,
  run as one batched program (:func:`estimate_flow_batched`);
* **streamed**: pairs are dispatched back to back, up to ``max_in_flight``
  frames before the oldest result is read.  Each frame's upload from
  pageable host memory synchronises the stream, so frames do not yet
  overlap on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched


def estimate_flow_video(frames, method: str = "classic+nl-fast", mesh=None, params=None, device="cuda"):
    """Flow for every consecutive pair of a (T, H, W) grayscale sequence -> (T-1, H, W, 2).

    Every method family runs, as one batch (:func:`estimate_flow_batched`).
    """
    frames = frames if torch.is_tensor(frames) else torch.as_tensor(np.array(frames))
    if frames.ndim != 3:
        raise ValueError(f"expected (T, H, W) grayscale frames, got {tuple(frames.shape)}")
    pairs = torch.stack([frames[:-1], frames[1:]], dim=-1)  # (T-1, H, W, 2)
    return estimate_flow_batched(pairs, method, mesh=mesh, params=params, device=device)


def estimate_flow_stream(frame_pairs, method: str = "classic+nl-fast", params=None, max_in_flight: int = 8,
                         device="cuda"):
    """Pipelined flow over an iterable of (im1, im2) frame pairs.

    Dispatches up to ``max_in_flight`` single-pair flows before reading the
    oldest result.  Yields (H, W, 2) numpy flows in input order.  Any
    iterable works; a generator reading frames from disk (``io.loader``)
    overlaps decoding with the card's work too.
    """
    from optical_flow_tpu_torch.interface import estimate_flow

    in_flight = []
    for im1, im2 in frame_pairs:
        in_flight.append(estimate_flow(im1, im2, method, params, device=device))
        if len(in_flight) >= max_in_flight:
            yield in_flight.pop(0).cpu().numpy()
    while in_flight:
        yield in_flight.pop(0).cpu().numpy()
