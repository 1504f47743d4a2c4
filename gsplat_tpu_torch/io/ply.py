"""PLY codec (pure NumPy) and gaussian-scene adapters.

A copy of the numpy codec of ``gsplat_tpu.io.ply``: the JS binary parser's
scalar TYPE_MAP (gaussians_selection.js:481-489) and the plyfile round trip
that appends a ``('label', 'i4')`` property (deep_learning_segmentation.py:
311-332, k_means.py:169-194).

Gaussian PLY schema (gaussians_selection.js:491-579): per-vertex properties
``x y z [nx ny nz] f_dc_0..2 [f_rest_0..44] opacity scale_0..2 rot_0..3
[label]``. :func:`load_scene` tells a PLY from packed ``.splat`` rows
(``io/splat_format.py``) by its magic bytes.
"""

from __future__ import annotations

import io as _io
import re
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from gsplat_tpu_torch.config import NO_SELECTION
from gsplat_tpu_torch.io import native
from gsplat_tpu_torch.io.splat_format import read_splat
from gsplat_tpu_torch.scene import DeviceLike, GaussianScene, scene_from_numpy

# PLY scalar name -> numpy dtype (little-endian fixed for binary).
_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    "int8": "char", "uint8": "uchar", "int16": "short", "uint16": "ushort",
    "int32": "int", "uint32": "uint", "float32": "float", "float64": "double",
}

PlyElements = Dict[str, np.ndarray]  # element name -> structured array


def _parse_header(data: bytes) -> Tuple[str, List[Tuple[str, int, List[Tuple[str, str]]]], int]:
    end = data.find(b"end_header")
    if not data.startswith(b"ply") or end < 0:
        raise ValueError("Unable to parse PLY header")
    header = data[:end].decode("ascii", errors="replace")
    body_off = end + len(b"end_header")
    if data[body_off:body_off + 2] == b"\r\n":
        body_off += 2
    elif data[body_off:body_off + 1] == b"\n":
        body_off += 1
    fmt = None
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    for line in header.splitlines():
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                raise NotImplementedError("PLY list properties not supported")
            elements[-1][2].append((tok[-1], tok[1]))
    if fmt is None:
        raise ValueError("PLY header missing format line")
    return fmt, elements, body_off


def read_ply(path_or_bytes: Union[str, bytes]) -> PlyElements:
    """Read a PLY file into {element_name: structured ndarray}."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    fmt, elements, off = _parse_header(data)
    out: PlyElements = {}
    if fmt in ("binary_little_endian", "binary_big_endian"):
        bo = "<" if fmt == "binary_little_endian" else ">"
        for name, count, props in elements:
            dtype = np.dtype([(p, bo + _PLY_TO_NP[t]) for p, t in props])
            arr = np.frombuffer(data, dtype=dtype, count=count, offset=off)
            off += dtype.itemsize * count
            out[name] = arr.astype(np.dtype([(p, _PLY_TO_NP[t]) for p, t in props]))
    elif fmt == "ascii":
        text = data[off:].decode("ascii")
        rows = text.split("\n")
        r = 0
        for name, count, props in elements:
            dtype = np.dtype([(p, _PLY_TO_NP[t]) for p, t in props])
            flat = np.loadtxt(
                _io.StringIO("\n".join(rows[r:r + count])), ndmin=2)
            r += count
            arr = np.zeros(count, dtype=dtype)
            for i, (p, _) in enumerate(props):
                arr[p] = flat[:, i]
            out[name] = arr
    else:
        raise ValueError(f"Unsupported PLY format: {fmt}")
    return out


def write_ply(path: str, elements: PlyElements, *, binary: bool = True) -> None:
    """Write {element: structured array} as PLY (binary LE or ascii)."""
    lines = ["ply",
             "format binary_little_endian 1.0" if binary else "format ascii 1.0"]
    for name, arr in elements.items():
        lines.append(f"element {name} {len(arr)}")
        for p in arr.dtype.names:
            lines.append(f"property {_NP_TO_PLY[arr.dtype[p].name]} {p}")
    lines.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(lines).encode("ascii"))
        for name, arr in elements.items():
            if binary:
                le = np.dtype([(p, arr.dtype[p].newbyteorder("<"))
                               for p in arr.dtype.names])
                f.write(arr.astype(le).tobytes())
            else:
                cols = [arr[p] for p in arr.dtype.names]
                for row in zip(*cols):
                    f.write((" ".join(_fmt_ascii(v) for v in row) + "\n")
                            .encode("ascii"))


def _fmt_ascii(v) -> str:
    if np.issubdtype(type(v), np.integer) or isinstance(v, (int, np.integer)):
        return str(int(v))
    return repr(float(v))


_REST_RE = re.compile(r"^f_rest_(\d+)$")


def scene_from_ply(path_or_bytes: Union[str, bytes], use_native: bool = True,
                   device: DeviceLike = None) -> GaussianScene:
    """Parse a gaussian PLY (schema of gaussians_selection.js:491-579) onto
    ``device``.

    With ``use_native`` the multithreaded C++ codec (``io/native.py``)
    parses binary files; what it declines (ascii, list properties) goes to
    the generic numpy reader, as in the JAX package. Unlike the JAX version,
    a codec that fails to build or load raises instead of falling back;
    ``use_native=False`` takes the numpy reader."""
    if use_native:
        scene = native.scene_from_ply_native(path_or_bytes, device=device)
        if scene is not None:
            return scene
    v = read_ply(path_or_bytes)["vertex"]
    names = set(v.dtype.names)
    n = len(v)
    means = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    log_scales = np.stack(
        [v[f"scale_{i}"] for i in range(3)], axis=-1).astype(np.float32)
    quats = np.stack(
        [v[f"rot_{i}"] for i in range(4)], axis=-1).astype(np.float32)
    opac = np.asarray(v["opacity"], dtype=np.float32)
    dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=-1)  # [N, 3]
    rest_ids = sorted(
        (int(_REST_RE.match(p).group(1)) for p in names if _REST_RE.match(p)))
    if rest_ids:
        # Standard 3DGS layout: f_rest is [3, K-1] flattened channel-major.
        k_hi = len(rest_ids) // 3
        rest = np.stack([v[f"f_rest_{i}"] for i in rest_ids], axis=-1)
        rest = rest.reshape(n, 3, k_hi).transpose(0, 2, 1)  # [N, K-1, 3]
        sh = np.concatenate([dc[:, None, :], rest], axis=1)
    else:
        sh = dc[:, None, :]
    labels = (np.asarray(v["label"], dtype=np.int32)
              if "label" in names else None)
    return scene_from_numpy(means, log_scales, quats, opac, sh, labels,
                            device=device)


def scene_to_ply(
    path: str,
    scene: GaussianScene,
    *,
    binary: bool = True,
    with_label: Optional[bool] = None,
    with_normals: bool = True,
) -> None:
    """Write a GaussianScene as a gaussian PLY, optionally with labels
    (``binary=True`` is deep_learning_segmentation.py:332's writer,
    ``binary=False`` k_means.py:193's ascii writer)."""
    s = scene.to_numpy()
    n = s["means"].shape[0]
    if with_label is None:
        with_label = bool(np.any(s["labels"] != NO_SELECTION))
    fields: List[Tuple[str, str]] = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    if with_normals:
        fields += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
    fields += [(f"f_dc_{i}", "f4") for i in range(3)]
    k_hi = s["sh"].shape[1] - 1
    fields += [(f"f_rest_{i}", "f4") for i in range(3 * k_hi)]
    fields += [("opacity", "f4")]
    fields += [(f"scale_{i}", "f4") for i in range(3)]
    fields += [(f"rot_{i}", "f4") for i in range(4)]
    if with_label:
        fields += [("label", "i4")]
    arr = np.zeros(n, dtype=np.dtype(fields))
    arr["x"], arr["y"], arr["z"] = s["means"].T
    for i in range(3):
        arr[f"f_dc_{i}"] = s["sh"][:, 0, i]
        arr[f"scale_{i}"] = s["log_scales"][:, i]
    if k_hi:
        rest = s["sh"][:, 1:, :].transpose(0, 2, 1).reshape(n, -1)  # channel-major
        for i in range(3 * k_hi):
            arr[f"f_rest_{i}"] = rest[:, i]
    for i in range(4):
        arr[f"rot_{i}"] = s["quats"][:, i]
    arr["opacity"] = s["opacities"]
    if with_label:
        arr["label"] = s["labels"]
    write_ply(path, {"vertex": arr}, binary=binary)


def add_labels_to_ply(
    src_path: str, dst_path: str, labels, *, binary: bool = True
) -> None:
    """Round-trip an existing PLY adding/overwriting a ``label:i4`` property,
    preserving all other vertex properties (deep_learning_segmentation.py:
    311-332). ``labels`` is an [N] array or tensor."""
    if hasattr(labels, "cpu"):
        labels = labels.cpu().numpy()
    elements = read_ply(src_path)
    v = elements["vertex"]
    labels = np.asarray(labels, dtype=np.int32)
    if len(labels) != len(v):
        raise ValueError(f"labels ({len(labels)}) != vertices ({len(v)})")
    base = [p for p in v.dtype.names if p != "label"]
    dtype = np.dtype([(p, v.dtype[p]) for p in base] + [("label", "i4")])
    out = np.zeros(len(v), dtype=dtype)
    for p in base:
        out[p] = v[p]
    out["label"] = labels
    elements["vertex"] = out
    write_ply(dst_path, elements, binary=binary)


def load_scene(path: str, device: DeviceLike = None) -> GaussianScene:
    """Auto-detecting scene loader (the drag-drop dispatch of
    gaussians_selection.js:1644-1673): PLY magic bytes -> PLY codec;
    anything else is read as packed 32-byte .splat rows. Matches on
    ``b"ply"`` alone, so a PLY whose header lines end in CRLF is not taken
    for .splat rows."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic[:3] == b"ply":
        return scene_from_ply(path, device=device)
    return read_splat(path, device=device)


def load_scene_bytes(data: bytes, device: DeviceLike = None) -> GaussianScene:
    """In-memory :func:`load_scene` (the live viewer's drag-drop ingestion,
    gaussians_selection.js:1660-1673)."""
    if data[:3] == b"ply":
        return scene_from_ply(data, device=device)
    return read_splat(data, device=device)
