"""Middlebury ``.flo`` I/O and frame-pair loading in numpy (port of ``optical_flow_tpu/io/flo.py``).

Format: float32 magic 202021.25, int32 width and height, then row-major
interleaved (u, v) float32 pairs.
"""
from __future__ import annotations

import os

import numpy as np

from optical_flow_tpu_torch.io.png import read_png

TAG_FLOAT = 202021.25

# the repository's own Middlebury subset, beside the package
REPO_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "data")


def read_flo(filename):
    """Read a ``.flo`` file into an (H, W, 2) float32 array."""
    with open(filename, "rb") as f:
        tag = np.fromfile(f, np.float32, count=1)[0]
        if tag != np.float32(TAG_FLOAT):
            raise ValueError(f"Invalid .flo file tag: {tag} (expected {TAG_FLOAT})")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32)
    return data.reshape((h, w, 2))


def write_flo(flow, filename):
    """Write an (H, W, 2) flow field (numpy or a tensor on any device) as ``.flo``."""
    if hasattr(flow, "detach"):
        flow = flow.detach().cpu().numpy()
    flow = np.ascontiguousarray(np.asarray(flow, dtype=np.float32))
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"Flow must be (H, W, 2) array, got shape {flow.shape}")
    h, w = flow.shape[:2]
    with open(filename, "wb") as f:
        np.array([TAG_FLOAT], dtype=np.float32).tofile(f)
        np.array([w, h], dtype=np.int32).tofile(f)
        flow.tofile(f)


def read_flow_file(seq_name, i_seq, data_dir=None):
    """Load a Middlebury image pair (float64) + ground-truth flow (tu, tv or None).

    Layout: ``data_dir/other-data/{seq}/frame{i:02d}.png`` and
    ``data_dir/other-gt-flow/{seq}/flow{i:02d}.flo``.  ``data_dir`` defaults
    to ``$OPTICAL_FLOW_DATA_DIR``, then to the repository's ``data/``.
    """
    if data_dir is None:
        data_dir = os.environ.get("OPTICAL_FLOW_DATA_DIR") or REPO_DATA_DIR
    if not os.path.isdir(data_dir):
        raise FileNotFoundError(f"No Middlebury data directory at {data_dir}; set OPTICAL_FLOW_DATA_DIR.")
    img_dir = os.path.join(data_dir, "other-data", seq_name)
    im1 = read_png(os.path.join(img_dir, f"frame{i_seq:02d}.png")).astype(np.float64)
    im2 = read_png(os.path.join(img_dir, f"frame{i_seq + 1:02d}.png")).astype(np.float64)
    gt_path = os.path.join(data_dir, "other-gt-flow", seq_name, f"flow{i_seq:02d}.flo")
    if os.path.exists(gt_path):
        gt = read_flo(gt_path)
        tu, tv = gt[:, :, 0], gt[:, :, 1]
    else:
        tu = tv = None
    return im1, im2, tu, tv
