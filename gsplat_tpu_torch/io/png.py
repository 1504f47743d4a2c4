"""PNG files and Pillow's bicubic resize, on the standard library and numpy.

The port reads and writes its images without PIL, which the machines it runs
on may lack.

- :func:`encode_png` writes 8-bit RGB: an IHDR chunk, one IDAT chunk of
  zlib-compressed rows (each with filter type 0, None) and IEND, with their
  CRCs.
- :func:`decode_png` reads what ``np.asarray(Image.open(p).convert("RGB"))``
  reads from a PNG of any colour type and bit depth, Adam7-interlaced or
  not: all five row filters, sub-byte samples unpacked, the palette looked
  up, alpha dropped, grey replicated, every CRC checked.
- :func:`resize_rgb` is ``Image.resize((w, h))`` of an RGB image under
  Pillow's default filter (BICUBIC), bit for bit: the fixed-point two-pass
  resampler of Pillow's ``Resample.c``.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# channels of each colour type: grey, RGB, palette, grey+alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# the bit depths each colour type allows (PNG spec 11.2.2)
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7's passes: (x0, y0, dx, dy) of each pass's sub-image
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor (PNG spec 9.4) on int arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """[H, W, bpp] uint8 filter units of the decompressed scanlines
    ``data``: W units of ``bpp`` bytes a row (a pixel's bytes at 8 and 16
    bits; single bytes, ``bpp`` 1, below 8 bits, as the filters take them).

    Rows filtered None, Sub or Up depend on no other byte of their own row
    but the one ``bpp`` before, so each takes one vectorised step. Average
    and Paeth make every pixel wait for its left, upper and upper-left
    neighbours: an image that uses them is reconstructed one anti-diagonal
    of pixels at a time, W + H - 1 vectorised steps."""
    stride = w * bpp
    if data.size != h * (stride + 1):
        raise ValueError(f"image data holds {data.size} bytes where "
                         f"{h * (stride + 1)} were expected")
    rows = data.reshape(h, stride + 1)
    ftype = rows[:, 0].astype(np.int64)
    filt = rows[:, 1:].reshape(h, w, bpp)
    if (ftype > 4).any():
        raise ValueError(f"row filter type {int(ftype.max())} does not exist")
    if not (ftype >= 3).any():
        out = np.empty((h, w, bpp), np.uint8)
        prev = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            if ftype[r] == 1:
                out[r] = np.cumsum(filt[r], axis=0, dtype=np.uint8)
            elif ftype[r] == 2:
                out[r] = filt[r] + prev
            else:
                out[r] = filt[r]
            prev = out[r]
        return out
    # Pixel (r, x) lies on anti-diagonal t = r + x and waits only for
    # diagonals t - 1 (left, up) and t - 2 (up-left). Stored skewed,
    # skew[t + 2, r + 1] = pixel (r, x), each diagonal is one row of the
    # array and its neighbours are slices of the two rows before it; row 0
    # of the image's side and the column left of it read the zeros that
    # nothing writes.
    skew = np.zeros((w + h + 1, h + 1, bpp), np.int16)
    rr, xx = np.mgrid[0:h, 0:w]
    fskew = np.zeros((w + h - 1, h, bpp), np.int16)
    fskew[rr + xx, rr] = filt
    masks = [(ftype == k)[:, None].astype(np.int16) for k in (1, 2, 3, 4)]
    for t in range(w + h - 1):
        r0, r1 = max(0, t - w + 1), min(h, t + 1)
        a = skew[t + 1, r0 + 1:r1 + 1]
        b = skew[t + 1, r0:r1]
        c = skew[t, r0:r1]
        m1, m2, m3, m4 = (m[r0:r1] for m in masks)
        pred = (m1 * a + m2 * b + m3 * ((a + b) >> 1)
                + m4 * _paeth(a, b, c))
        skew[t + 2, r0 + 1:r1 + 1] = (fskew[t, r0:r1] + pred) & 0xFF
    return skew[rr + xx + 2, rr + 1].astype(np.uint8)


def _name(source) -> str:
    return "<bytes>" if isinstance(source, (bytes, bytearray)) else str(source)


def _samples(data: np.ndarray, h: int, w: int, depth: int,
             channels: int) -> np.ndarray:
    """[H, W, channels] samples (uint8, or uint16 at 16 bits) of one
    non-interlaced image's decompressed scanlines ``data``."""
    if depth >= 8:
        bpp = channels * depth // 8
        px = _unfilter(data, h, w, bpp)
        if depth == 8:
            return px
        be = px.reshape(h, w, channels, 2).astype(np.uint16)
        return be[..., 0] << 8 | be[..., 1]
    stride = -(-w * channels * depth // 8)
    rows = _unfilter(data, h, stride, 1)[..., 0]
    bits = np.unpackbits(rows, axis=1)[:, :w * channels * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    vals = (bits.reshape(h, w * channels, depth) * weights).sum(
        axis=2, dtype=np.uint8)
    return vals.reshape(h, w, channels)


def _interlaced(data: np.ndarray, h: int, w: int, depth: int,
                channels: int) -> np.ndarray:
    """Samples of an Adam7-interlaced image: each pass a sub-image with its
    own scanlines and filters, placed on its lattice."""
    out = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    off = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        n = ph * (1 + -(-pw * channels * depth // 8))
        out[y0::dy, x0::dx] = _samples(data[off:off + n], ph, pw, depth,
                                       channels)
        off += n
    if off != data.size:
        raise ValueError(f"image data holds {data.size} bytes where {off} "
                         "were expected")
    return out


def _name(source) -> str:
    return "<bytes>" if isinstance(source, (bytes, bytearray)) else str(source)


def decode_png(path_or_bytes: Union[str, os.PathLike, bytes]) -> np.ndarray:
    """[H, W, 3] uint8 pixels of a PNG, as ``Image.open(p).convert("RGB")``
    gives them, for every colour type and bit depth the format allows,
    interlaced or not. Pillow's conversions: grey at 1, 2 and 4 bits scaled
    to 8 (x 255, 85, 17), 16-bit grey clipped at 255, the high byte of
    every other 16-bit sample, palette indices looked up (past the palette:
    black). A bad CRC, truncated data or a depth the colour type does not
    allow raises a ``ValueError`` naming the file."""
    name = _name(path_or_bytes)
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    off, idat, header, palette = 8, [], None, None
    while True:
        if off + 12 > len(data):
            raise ValueError(f"{name}: truncated before IEND")
        n, = struct.unpack(">I", data[off:off + 4])
        kind, body = data[off + 4:off + 8], data[off + 8:off + 8 + n]
        crc, = struct.unpack(">I", data[off + 8 + n:off + 12 + n] or b"\0" * 4)
        if len(body) != n or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: bad CRC or truncated {kind!r} chunk")
        off += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{name}: no IHDR or no IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{name}: colour type {ctype} does not exist")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"{name}: bit depth {depth} is not allowed for "
                         f"colour type {ctype}")
    if interlace not in (0, 1):
        raise ValueError(f"{name}: interlace method {interlace} does not "
                         "exist")
    channels = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    unpack = _interlaced if interlace else _samples
    try:
        px = unpack(raw, h, w, depth, channels)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette image without PLTE")
        # indices past the palette read black, as Pillow's zero-filled
        # palette gives them
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[px[..., 0]]
    if depth == 16:
        # Pillow opens 16-bit grey as I;16 and clips it into L; every other
        # 16-bit mode keeps the high byte
        px = (np.minimum(px, 255) if ctype == 0 else px >> 8).astype(np.uint8)
    elif depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


# ---------------------------------------------------------------------------
# Pillow's resize
# ---------------------------------------------------------------------------

PRECISION_BITS = 32 - 8 - 2   # Resample.c's fixed point: 22 fraction bits
BICUBIC_SUPPORT = 2.0


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Resample.c's ``bicubic_filter`` (a = -0.5) in double, its operations
    in its order."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first source index [out], fixed-point weights [out, ksize]) of one
    pass: Resample.c's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``.
    Weights past a window's end are 0."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = BICUBIC_SUPPORT * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    ss = 1.0 / filterscale
    taps = np.arange(ksize)
    w = _bicubic((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * ss)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    total = np.zeros(out_size)
    for x in range(ksize):          # summed in the C loop's order
        total = total + w[:, x]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0,
                                                     total)[:, None], w)
    scaled = w * (1 << PRECISION_BITS)
    fixed = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5))
    return xmin, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along ``axis`` (1: horizontal, 0: vertical), accumulated in
    int32 from 1 << 21 as Resample.c does (no sum leaves int32: the
    weights' absolute values add up to under 1.2 << 22) and clipped to
    uint8."""
    in_size = img.shape[axis]
    xmin, k = _coeffs(in_size, out_size)
    k = k.astype(np.int32)
    shape = list(img.shape)
    shape[axis] = out_size
    acc = np.full(shape, 1 << (PRECISION_BITS - 1), np.int32)
    bcast = (slice(None), None) if axis == 0 else (None, slice(None))
    for x in range(k.shape[1]):
        idx = np.minimum(xmin + x, in_size - 1)   # weight 0 past the window
        acc += np.take(img, idx, axis=axis) * k[:, x][bcast + (None,)]
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_rgb(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.fromarray(img).resize((width, height))`` of an [H, W, 3]
    uint8 image, bit for bit: Pillow's BICUBIC (its default filter for RGB),
    a horizontal pass and then a vertical one, each skipped when its size
    does not change and each clipped to uint8."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("resize_rgb takes an [H, W, 3] uint8 image")
    if width < 1 or height < 1:
        raise ValueError(f"cannot resize to {width}x{height}")
    out = img
    if width != img.shape[1]:
        out = _resample_axis(out, width, axis=1)
    if height != img.shape[0]:
        out = _resample_axis(out, height, axis=0)
    return out.copy() if out is img else out
