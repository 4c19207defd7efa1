"""Checkpoint / resume for coarse-to-fine flow estimation (port of ``optical_flow_tpu/utils/checkpoint.py``).

The flow field at any (GNC stage, pyramid level) boundary is the whole
state of a coarse-to-fine run.  :class:`FlowCheckpointer` persists that
state after every level and lets a later run resume mid-pyramid.

Usage:
    ckpt = FlowCheckpointer("run1")
    estimate_flow(im1, im2, "classic+nl-fast", {"checkpoint": ckpt})
    stage, level, uv0 = FlowCheckpointer("run1").latest()

Each save reads the flow on the host, so a frame with a checkpointer
synchronises once a level; without one the methods make no such read.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from optical_flow_tpu_torch.io.flo import read_flo, write_flo


class FlowCheckpointer:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._meta_path = os.path.join(directory, "checkpoint.json")

    def save(self, stage: int, level: int, uv, extra=None):
        """Persist the flow state (numpy or a tensor) at a (stage, level) boundary."""
        uv = uv.detach().cpu().numpy() if hasattr(uv, "detach") else np.asarray(uv)
        flo = os.path.join(self.directory, f"uv_s{stage}_l{level}.flo")
        write_flo(uv, flo)
        meta = {
            "stage": int(stage),
            "level": int(level),
            "file": os.path.basename(flo),
            "shape": list(uv.shape),
        }
        if extra:
            meta["extra"] = extra
        with open(self._meta_path, "w") as f:
            json.dump(meta, f)

    def latest(self) -> Optional[Tuple[int, int, np.ndarray]]:
        """(stage, level, uv) of the most recent checkpoint, or None."""
        if not os.path.exists(self._meta_path):
            return None
        with open(self._meta_path) as f:
            meta = json.load(f)
        uv = read_flo(os.path.join(self.directory, meta["file"]))
        return meta["stage"], meta["level"], uv

    def __call__(self, stage: int, level: int, uv):
        self.save(stage, level, uv)
