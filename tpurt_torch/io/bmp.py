"""24-bit BMP writer, byte-compatible with the reference (tpurt_torch's
own copy of tpurt/io/bmp.py: numpy only).

placeImageDataIntoBMP (src/math.hpp:117-164): 54-byte header (file
size, data offset 54, BITMAPINFOHEADER 40, 1 plane, 24 bpp, every other
field zero — including biSizeImage and the resolution fields), rows
bottom-up, BGR order, each row padded to 4 bytes with zeros.
"""

from __future__ import annotations

import struct

import numpy as np


def bmp_bytes(rgb: np.ndarray) -> bytes:
    """rgb: (H, W, 3) or (H, W, 4) uint8, row 0 = top (as rendered)."""
    rgb = np.asarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    pad = (4 - (w * 3) % 4) % 4
    row_size = 3 * w + pad
    data_size = row_size * h
    file_size = 54 + data_size

    header = bytearray(54)
    header[0:2] = b"BM"
    struct.pack_into("<I", header, 2, file_size)
    header[10] = 54
    header[14] = 40
    struct.pack_into("<i", header, 18, w)
    struct.pack_into("<i", header, 22, h)
    header[26] = 1
    header[28] = 24

    bgr = rgb[::-1, :, 2::-1]  # bottom-up rows, BGR
    if pad:
        padded = np.zeros((h, row_size), np.uint8)
        padded[:, : 3 * w] = bgr.reshape(h, 3 * w)
        body = padded.tobytes()
    else:
        body = np.ascontiguousarray(bgr).tobytes()
    return bytes(header) + body


def write_bmp(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(bmp_bytes(rgb))


def read_bmp(path: str) -> np.ndarray:
    """Minimal reader for round-trip tests (24 bpp, bottom-up only)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[0:2] == b"BM"
    offset = struct.unpack_from("<I", data, 10)[0]
    w = struct.unpack_from("<i", data, 18)[0]
    h = struct.unpack_from("<i", data, 22)[0]
    bpp = struct.unpack_from("<H", data, 28)[0]
    assert bpp == 24, "only 24-bit BMPs supported"
    pad = (4 - (w * 3) % 4) % 4
    row_size = 3 * w + pad
    rows = np.frombuffer(data, np.uint8, count=row_size * h, offset=offset)
    rows = rows.reshape(h, row_size)[:, : 3 * w].reshape(h, w, 3)
    return rows[::-1, :, ::-1].copy()  # back to top-down RGB
