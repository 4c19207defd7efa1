"""Frames of a pool (``flowbench/pools/<name>.json``), decoded once and kept beside the benchmark.

A pool lists frame pairs as PNG files of the repository, each with its
SHA-256: a file that differs stops the run, since the yardstick would
have changed under it.  The PNG decoder is numpy and ``zlib`` (8-bit,
non-interlaced gray, RGB, palette, gray+alpha and RGBA files).  Its
Paeth and average filters run a byte at a time in Python, ~0.7 s a VGA
frame, so decoded frames are kept as ``.npy`` files named by their hash
under ``flowbench/_cache/frames/``, a fixed directory of the checkout:
only the first run in a checkout decodes.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / "_cache" / "frames"

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth_row(raw: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _avg_row(raw: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prev[i]) >> 1)) & 0xFF
    return out


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    out = np.empty((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    pos = 0
    for y in range(height):
        ftype = data[pos]
        raw = np.frombuffer(data, dtype=np.uint8, count=stride, offset=pos + 1)
        pos += stride + 1
        if ftype == 0:
            row = raw
        elif ftype == 1:  # Sub: running sum along the row, per byte lane
            row = (np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint64) & 0xFF).astype(np.uint8).ravel()
        elif ftype == 2:  # Up
            row = raw + prev
        elif ftype == 3:
            row = np.frombuffer(bytes(_avg_row(raw.tobytes(), prev.tobytes(), bpp)), dtype=np.uint8)
        elif ftype == 4:
            row = np.frombuffer(bytes(_paeth_row(raw.tobytes(), prev.tobytes(), bpp)), dtype=np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = row
        prev = out[y]
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """uint8 pixels of a PNG: (H, W) for gray, else (H, W, C); palette images expand to RGB."""
    if blob[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, palette, header = 8, [], None, None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        ctype = blob[pos + 4 : pos + 8]
        body = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("no IHDR chunk")
    width, height, depth, code, _comp, _filt, interlace = header
    if depth != 8 or interlace != 0 or code not in _CHANNELS:
        raise ValueError("only 8-bit non-interlaced PNGs are supported")
    ch = _CHANNELS[code]
    img = _unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch).reshape(height, width, ch)
    if code == 3:
        return palette[img[:, :, 0]]
    return img[:, :, 0] if ch == 1 else img


def load_frame(path: Path, sha256: str) -> np.ndarray:
    """The (H, W, 3) uint8 RGB frame at ``path``, whose bytes must hash to ``sha256``."""
    cached = CACHE_DIR / f"{sha256}.npy"
    if cached.exists():
        return np.load(cached)
    blob = path.read_bytes()
    digest = hashlib.sha256(blob).hexdigest()
    if digest != sha256:
        raise ValueError(f"{path}: SHA-256 {digest} differs from the pool's {sha256}")
    rgb = np.ascontiguousarray(decode_png(blob)[..., :3])
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = CACHE_DIR / f"{sha256}.{os.getpid()}.npy"
    np.save(tmp, rgb)
    os.replace(tmp, cached)
    return rgb


def load_pool(name: str):
    """[(pair name, frame 1, frame 2)] of the pool ``flowbench/pools/<name>.json``."""
    pool = json.loads((BENCH_DIR / "pools" / f"{name}.json").read_text())
    base = ROOT / pool["dir"]
    out = []
    for pair in pool["pairs"]:
        f1, f2 = (load_frame(base / f["file"], f["sha256"]) for f in pair["frames"])
        if list(f1.shape) != pool["shape"] or f1.shape != f2.shape:
            raise ValueError(f"pool {name}: pair {pair['name']} is {f1.shape}, expected {pool['shape']}")
        out.append((pair["name"], f1, f2))
    return out
