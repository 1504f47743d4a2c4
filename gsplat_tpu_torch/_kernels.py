"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, which ``ctypes`` loads; no source includes
PyTorch's headers, so a build takes seconds. Libraries go to
``torch_kernels/`` under :data:`BUILD_ROOT` (the repo's ``build/`` in a
checkout, a user cache when the package is installed), named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, and are
built at first use,
never at import: importing the package does not need ``nvcc``. :func:`build`
compiles every missing library with one ``nvcc`` process per source, all
started together.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0, so a launch
the card refuses (too many threads or too much shared memory) cannot pass
unseen.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_root() -> Path:
    """Where the port builds its libraries: ``build/`` of the repository
    when the package lies in a checkout (``pyproject.toml`` beside it),
    else ``$XDG_CACHE_HOME/gsplat_tpu_torch`` (``~/.cache`` without it),
    since an installed package's directory need not be writable."""
    root = Path(__file__).resolve().parent.parent
    if (root / "pyproject.toml").is_file():
        return root / "build"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "gsplat_tpu_torch"


BUILD_ROOT = _build_root()
BUILD_DIR = BUILD_ROOT / "torch_kernels"

# -fmad=false: no contraction of a*b+c into FMA, so the kernels round like
# the plain torch versions (one rounding per operation); see the sources.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# source name -> (C entry point, argument types)
SIGNATURES = {
    "enum_keys": ("gsplat_enum_keys",
                  [_P] * 12 + [_I, _I, _I, _F, _I] + [_I] * 4
                  + [_P, _P, _P]),
    "blend_fwd": ("gsplat_blend_fwd",
                  [_P] * 3 + [_I] * 10 + [_F] * 3 + [_I] + [_P] * 5),
    "blend_bwd": ("gsplat_blend_bwd",
                  [_P] * 3 + [_I] * 10 + [_F] * 3 + [_P] * 4 + [_I]
                  + [_P] * 2),
    "cumsum_rows": ("gsplat_cumsum_rows", [_P, _I, _P, _I, _P, _P]),
    "fold_segments": ("gsplat_fold_segments", [_P, _I, _P, _P, _I, _P, _P]),
    "blend_vis": ("gsplat_blend_vis",
                  [_P] * 3 + [_I] * 5 + [_F] * 2 + [_I] + [_P] * 5
                  + [_I, _P]),
    "peak_probe": ("gsplat_peak_probe",
                   [_I, _P, _I, _P, _I, _I, _F, _F, _P]),
    "scan_probe": ("gsplat_scan_probe", [_I, _I, _P, _I, _P, _I, _P]),
}

_functions: Dict[str, ctypes._CFuncPtr] = {}
# source name -> {"seconds": build time, "ptxas": nvcc's -Xptxas -v report};
# only sources built by this process appear
build_log: Dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=tuple(SIGNATURES)) -> Dict[str, dict]:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source, all running at once. Returns :data:`build_log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       time.perf_counter(), tmp, out)
    failed = []
    for name, (proc, t0, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        build_log[name] = {"seconds": seconds, "ptxas": stdout + stderr}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return build_log


def function(name: str):
    """The C entry point of ``csrc/<name>.cu``, built and loaded on first
    use."""
    fn = _functions.get(name)
    if fn is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def occupancy(name: str) -> dict:
    """Registers, local (spill) bytes, static shared memory and resident
    blocks an SM of the kernel of ``csrc/<name>.cu``, from its
    ``gsplat_<name>_occupancy`` entry point (B1, B5 and B2 have one)."""
    function(name)
    fn = getattr(ctypes.CDLL(str(library_path(name))),
                 f"gsplat_{name}_occupancy")
    fn.argtypes = [_P]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    check(f"{name} occupancy", fn(out))
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "blocks_per_sm"), out))


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")

