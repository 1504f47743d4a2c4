"""A small PNG encoder (8-bit RGB) on the standard library.

The port writes its images without PIL, which the machines it runs on may
lack: an IHDR chunk, one IDAT chunk of zlib-compressed rows (each with
filter type 0, None) and IEND, with their CRCs.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray, level: int = 6) -> bytes:
    """The PNG file of an [H, W, 3] uint8 image."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("encode_png takes an [H, W, 3] uint8 image")
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)   # filter byte 0 per row
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 image to ``path`` as PNG."""
    data = encode_png(rgb)
    with open(path, "wb") as f:
        f.write(data)
