"""PNG decoding in numpy + the standard library's ``zlib``.

Covers 8-bit, non-interlaced gray / RGB / palette / gray+alpha / RGBA files
(every Middlebury frame in ``data/``), and matches
``np.array(PIL.Image.open(path))`` there, with palette images expanded to
RGB.  Anything else raises ``ValueError``.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth_row(raw: bytes, prev: bytes, bpp: int) -> bytearray:
    """Undo the Paeth filter of one scanline (sequential along the row)."""
    out = bytearray(raw)
    n = len(out)
    for i in range(n):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
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


def read_png(path) -> np.ndarray:
    """Decode a PNG into uint8: (H, W) for grayscale, else (H, W, C)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    palette = None
    header = None
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
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype_code, _comp, _filt, interlace = header
    if depth != 8 or interlace != 0 or ctype_code not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNGs are supported")
    ch = _CHANNELS[ctype_code]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch)
    img = pixels.reshape(height, width, ch)
    if ctype_code == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        return palette[img[:, :, 0]]
    return img[:, :, 0] if ch == 1 else img
