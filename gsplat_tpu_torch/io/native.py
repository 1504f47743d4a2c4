"""ctypes bindings for the native C++ data path (``native/gsplat_native.cpp``).

Counterpart of ``gsplat_tpu.io.native`` over a copy of the same source that
ships with the package (``gsplat_tpu_torch/native/gsplat_native.cpp``,
byte-equal to the repository's ``native/gsplat_native.cpp``): fast gaussian
PLY parsing, importance ordering and ``.splat`` packing, multithreaded C++
in place of the reference's hot JS loops (gaussians_selection.js:464-585).

The library is built from that copy with ``native/Makefile``'s flags into
``native/`` under ``_kernels.BUILD_ROOT`` (the repository's ``build/`` in a
checkout, a user cache when the package is installed), at first use (never
at import); no source directory is written. The
flags hold ``-march=native``, so a library is only for a machine with the
same instruction set: its name hashes the source, the flags and the
compiler's description of the target ``-march=native`` selects here, and a
``build/`` copied to another machine rebuilds there.

Unlike the JAX bindings, a failure to build or load the library raises, with
the compiler's message: a run must not measure the numpy reader while
believing it measured the codec. What the codec declines to parse (its probe
returns nonzero: ascii, list properties) gives None, and callers take the
numpy reader, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from gsplat_tpu_torch._kernels import BUILD_ROOT
from gsplat_tpu_torch.scene import DeviceLike, GaussianScene, scene_from_numpy

SOURCE = Path(__file__).resolve().parents[1] / "native" / "gsplat_native.cpp"
BUILD_DIR = BUILD_ROOT / "native"
# native/Makefile:2-3, CXXFLAGS then LDFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-Wextra", "-shared", "-pthread")

_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    """Where the library of the current source, flags and host instruction
    set is built."""
    target = subprocess.run([_cxx(), "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True).stdout
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                         + target.encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgsplat_native-{key}.so"


def build() -> Path:
    """Compile the library unless the current one exists; returns its path.
    Raises ``RuntimeError`` with the compiler's output if ``g++`` fails.
    The object is written under a temporary name and moved into place, so
    concurrent builds (test workers) never load a half-written file."""
    if not SOURCE.exists():
        raise FileNotFoundError(f"native source {SOURCE} is missing")
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        res = subprocess.run(
            [_cxx(), *CXX_FLAGS, "-o", tmp,
             str(SOURCE)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed:\n{res.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.gsplat_ply_probe.restype = ctypes.c_int
    lib.gsplat_ply_probe.argtypes = [
        u8p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64), i32p, i32p,
        i32p]
    lib.gsplat_ply_extract.restype = ctypes.c_int
    lib.gsplat_ply_extract.argtypes = [
        u8p, ctypes.c_size_t, f32p, f32p, f32p, f32p, f32p, ctypes.c_int32,
        i32p]
    lib.gsplat_importance_order.restype = None
    lib.gsplat_importance_order.argtypes = [f32p, f32p, ctypes.c_int64, i32p]
    lib.gsplat_pack_splat.restype = None
    lib.gsplat_pack_splat.argtypes = [f32p, f32p, f32p, f32p, f32p, i32p,
                                      ctypes.c_int64, u8p]
    _lib = lib
    return _lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: Optional[np.ndarray]):
    if a is None:
        return ctypes.cast(None, ctypes.POINTER(ctypes.c_int32))
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def scene_from_ply_native(path_or_bytes, device: DeviceLike = None
                          ) -> Optional[GaussianScene]:
    """Parse a binary little-endian gaussian PLY with the C++ codec onto
    ``device`` (the card unless named). Returns None where the codec
    declines the file (ascii, list properties); callers then take the numpy
    reader."""
    lib = _load()
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            raw = f.read()
    buf = np.frombuffer(raw, dtype=np.uint8)
    data = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    n = ctypes.c_int64()
    bands = ctypes.c_int32()
    has_label = ctypes.c_int32()
    has_normals = ctypes.c_int32()
    rc = lib.gsplat_ply_probe(data, len(raw), ctypes.byref(n),
                              ctypes.byref(bands), ctypes.byref(has_label),
                              ctypes.byref(has_normals))
    if rc != 0:
        return None
    nv, k = n.value, bands.value
    means = np.zeros((nv, 3), np.float32)
    log_scales = np.zeros((nv, 3), np.float32)
    quats = np.zeros((nv, 4), np.float32)
    opac = np.zeros((nv,), np.float32)
    sh = np.zeros((nv, k, 3), np.float32)
    labels = np.zeros((nv,), np.int32) if has_label.value else None
    rc = lib.gsplat_ply_extract(
        data, len(raw), _fp(means), _fp(log_scales), _fp(quats), _fp(opac),
        _fp(sh), k, _ip(labels))
    if rc != 0:
        return None
    return scene_from_numpy(means, log_scales, quats, opac, sh, labels,
                            device=device)


def importance_order_native(log_scales: np.ndarray, opacities: np.ndarray
                            ) -> np.ndarray:
    """[N] i32 rows by descending exp(sum log_scales) * sigmoid(opacity),
    stable (js:513-528)."""
    lib = _load()
    n = log_scales.shape[0]
    order = np.zeros((n,), np.int32)
    lib.gsplat_importance_order(
        _fp(np.ascontiguousarray(log_scales, np.float32)),
        _fp(np.ascontiguousarray(opacities, np.float32)), n, _ip(order))
    return order


def pack_splat_native(scene: GaussianScene,
                      order: Optional[np.ndarray] = None) -> bytes:
    """The scene's 32-byte ``.splat`` rows in ``order`` (the importance
    order when not given)."""
    lib = _load()
    s = scene.to_numpy()
    n = s["means"].shape[0]
    if order is None:
        order = importance_order_native(s["log_scales"], s["opacities"])
    out = np.zeros((n * 32,), np.uint8)
    lib.gsplat_pack_splat(
        _fp(np.ascontiguousarray(s["means"], np.float32)),
        _fp(np.ascontiguousarray(s["log_scales"], np.float32)),
        _fp(np.ascontiguousarray(s["quats"], np.float32)),
        _fp(np.ascontiguousarray(s["opacities"], np.float32)),
        _fp(np.ascontiguousarray(s["sh"][:, 0, :], np.float32)),
        _ip(np.ascontiguousarray(order, np.int32)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.tobytes()
