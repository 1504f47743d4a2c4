"""The port's I/O as an installed package and on every PNG Pillow reads.

- An installed port (``pip install --no-deps --no-build-isolation
  --prefix`` of the files git would commit) reads a PLY through the native
  codec, built from the C++ source the package ships into a user cache.
- The shipped source is byte-equal to the repository's
  ``native/gsplat_native.cpp``.
- ``io/png.py::decode_png`` equals Pillow's ``Image.open(p).convert("RGB")``
  on grey and palette images at 1, 2 and 4 bits, on 16 bits for every
  colour type and on Adam7-interlaced files, each with random row filters.
  Pillow writes the files it can write (1-bit grey, 2- and 4-bit palette,
  16-bit grey); the others are written here, byte by byte, and read by
  Pillow as the reference.

No jax import: the JAX package has no PNG reader, and Pillow is the JAX
CLIs' reader (``gsplat_tpu/cli/train.py:84``).
"""

from __future__ import annotations

import glob
import io
import os
import shutil
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from gsplat_tpu_torch.io.png import decode_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys
import numpy as np
from gsplat_tpu_torch.io import native, ply
from gsplat_tpu_torch.io.synthetic import random_scene

path = sys.argv[1]
scene = random_scene(300, seed=4, num_labels=3, device="cpu")
ply.scene_to_ply(path, scene)
back = ply.scene_from_ply(path, device="cpu")
assert native._lib is not None, "the native codec did not load"
assert native.SOURCE.is_file(), native.SOURCE
for f in ("means", "log_scales", "quats", "opacities", "sh", "labels"):
    np.testing.assert_array_equal(getattr(back, f).numpy(),
                                  getattr(scene, f).numpy())
print("NATIVE", native.BUILD_DIR)
"""


def _committable_tree(dst: str) -> None:
    """Copy what git would commit (tracked and untracked files that
    ``.gitignore`` does not list) into ``dst``; outside a git checkout, the
    packages and build files."""
    if os.path.isdir(os.path.join(ROOT, ".git")):
        files = subprocess.run(
            ["git", "ls-files", "-co", "--exclude-standard", "-z"],
            cwd=ROOT, capture_output=True, check=True).stdout.split(b"\0")
        for rel in filter(None, (f.decode() for f in files)):
            src = os.path.join(ROOT, rel)
            if os.path.isfile(src):
                os.makedirs(os.path.dirname(os.path.join(dst, rel)),
                            exist_ok=True)
                shutil.copy2(src, os.path.join(dst, rel))
        return
    skip = shutil.ignore_patterns("__pycache__", "*.so", "build")
    for d in ("gsplat_tpu", "gsplat_tpu_torch", "native"):
        shutil.copytree(os.path.join(ROOT, d), os.path.join(dst, d),
                        ignore=skip)
    for f in ("pyproject.toml", "setup.py", "README.md"):
        shutil.copy2(os.path.join(ROOT, f), dst)


def test_installed_port_reads_ply_natively(tmp_path):
    src, prefix = tmp_path / "src", tmp_path / "prefix"
    _committable_tree(str(src))
    r = subprocess.run(
        [sys.executable, "-m", "pip", "install", "--no-deps",
         "--no-build-isolation", "--quiet", "--prefix", str(prefix),
         str(src)], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    site = glob.glob(str(prefix / "lib" / "python*" / "site-packages"))
    assert site and os.path.isfile(os.path.join(
        site[0], "gsplat_tpu_torch", "native", "gsplat_native.cpp"))
    cache = tmp_path / "cache"
    env = dict(os.environ, PYTHONPATH=site[0], XDG_CACHE_HOME=str(cache),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _CHILD,
                        str(tmp_path / "s.ply")], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    # built into the cache, not beside the installed package
    assert str(cache / "gsplat_tpu_torch" / "native") in r.stdout, r.stdout
    assert not os.path.exists(os.path.join(site[0], "build"))


def test_shipped_native_source_is_the_repos():
    with open(os.path.join(ROOT, "native", "gsplat_native.cpp"), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "gsplat_tpu_torch", "native",
                           "gsplat_native.cpp"), "rb") as f:
        assert f.read() == want


# ---------------------------------------------------------------------------
# PNG files of every colour type, depth and interlace, against Pillow
# ---------------------------------------------------------------------------

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _scanlines(samples: np.ndarray, depth: int):
    """Unfiltered scanline bytes of [H, W, C] samples at ``depth`` bits."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in flat]
    if depth == 8:
        return [r.astype(np.uint8).tobytes() for r in flat]
    shifts = np.arange(depth - 1, -1, -1)
    return [np.packbits(((r[:, None] >> shifts) & 1).astype(np.uint8)
                        .reshape(-1)).tobytes() for r in flat]


def _filtered(lines, bpp: int, rng) -> bytes:
    """The scanlines, each under a random filter type (PNG spec 9)."""
    out, prev = [], np.zeros(len(lines[0]), np.int32)
    for line in lines:
        cur = np.frombuffer(line, np.uint8).astype(np.int32)
        kind = int(rng.integers(0, 5))
        f = np.empty_like(cur)
        for i in range(cur.size):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            paeth = (a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c)
                     else b if abs(p - b) <= abs(p - c) else c)
            pred = (0, a, b, (a + b) >> 1, paeth)[kind]
            f[i] = (cur[i] - pred) & 0xFF
        out.append(bytes([kind]) + f.astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def _png_file(samples, depth, ctype, interlace, palette, rng) -> bytes:
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        subs = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7]
        data = b"".join(_filtered(_scanlines(s, depth), bpp, rng)
                        for s in subs if s.size)
    else:
        data = _filtered(_scanlines(samples, depth), bpp, rng)
    head = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    plte = _chunk(b"PLTE", palette.tobytes()) if palette is not None else b""
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", head) + plte
            + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


def _pillow_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


CASES = [(ctype, depth, interlace)
         for ctype, depths in ((0, (1, 2, 4, 16)), (2, (16,)),
                               (3, (1, 2, 4)), (4, (16,)), (6, (16,)))
         for depth in depths for interlace in (0, 1)]
CASES += [(ctype, 8, 1) for ctype in (0, 2, 3, 4, 6)]


@pytest.mark.parametrize("ctype,depth,interlace", CASES)
def test_decode_png_written_here_equals_pillow(ctype, depth, interlace):
    rng = np.random.default_rng(100 * ctype + 10 * depth + interlace)
    for h, w in ((1, 1), (5, 3), (13, 17)):
        palette = None
        hi = 1 << depth
        if ctype == 3:   # a short palette: some indices fall past it
            palette = rng.integers(0, 256, (min(hi, 12), 3)).astype(np.uint8)
            hi = min(hi, 16)
        samples = rng.integers(0, hi, (h, w, _CHANNELS[ctype]))
        if depth == 16 and ctype == 0:
            # 16-bit grey clips at 255 in Pillow: values on both sides
            samples = rng.integers(0, 600, samples.shape)
        data = _png_file(samples, depth, ctype, interlace, palette, rng)
        np.testing.assert_array_equal(decode_png(data), _pillow_rgb(data),
                                      err_msg=f"{h}x{w}")


@pytest.mark.parametrize("mode,bits", [("1", None), ("P", 1), ("P", 2),
                                       ("P", 4), ("I;16", None)])
def test_decode_png_written_by_pillow_equals_pillow(tmp_path, mode, bits):
    rng = np.random.default_rng(7)
    h, w = 19, 23
    if mode == "1":
        img = Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))
    elif mode == "P":
        img = Image.fromarray(rng.integers(0, 1 << bits, (h, w))
                              .astype(np.uint8), "P")
        img.putpalette(rng.integers(0, 256, 3 << bits).astype(np.uint8)
                       .tolist())
    else:
        img = Image.frombytes("I;16", (w, h), rng.integers(
            0, 700, (h, w)).astype("<u2").tobytes())
    path = tmp_path / "x.png"
    img.save(path, bits=bits) if bits else img.save(path)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(decode_png(str(path)), want)
