"""Viewer-compatible ``.splat`` packing (gaussians_selection.js conventions).

A numpy copy of ``gsplat_tpu.io.splat_format`` on the port's scene. The
reference's PLY parser emits a packed 32-byte/row buffer for its WebGL
viewer (js:464-585): position f32x3, exp-activated scale f32x3, color rgba
u8x4 (SH DC -> color via SH_C0, sigmoid opacity), normalized quaternion
quantized to u8x4 via (q/|q|)*128+128 (js:536-554, 566-576), rows ordered by
descending importance ``exp(sx+sy+sz) * sigmoid(opacity)`` (js:513-528).
The rows are byte-identical to the JAX package's for the same scene, and
reading them back is lossy by the quantization.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from gsplat_tpu_torch.scene import (DeviceLike, GaussianScene, color_to_dc,
                                    dc_color, scene_from_numpy)

ROW_BYTES = 32  # js:237, 845
ROW_DTYPE = np.dtype([
    ("position", np.float32, 3),
    ("scale", np.float32, 3),
    ("rgba", np.uint8, 4),
    ("rot", np.uint8, 4),
])


def _importance(s: Dict[str, np.ndarray]) -> np.ndarray:
    vol = np.exp(s["log_scales"].sum(axis=1))
    return vol / (1.0 + np.exp(-s["opacities"]))


def importance(scene: GaussianScene) -> np.ndarray:
    """exp(sum log_scales) * sigmoid(opacity) (js:513-528)."""
    return _importance(scene.to_numpy())


def pack_splat(
    scene: GaussianScene,
    *,
    sort_by_importance: bool = True,
) -> Tuple[bytes, np.ndarray]:
    """-> (packed buffer, row-order indices). Labels ride via the order
    array (the viewer keeps labels in a side Int32Array, js:579)."""
    s = scene.to_numpy()
    n = s["means"].shape[0]
    order = (np.argsort(-_importance(s), kind="stable")
             if sort_by_importance else np.arange(n))

    buf = np.zeros(n, dtype=ROW_DTYPE)
    buf["position"] = s["means"][order]
    buf["scale"] = np.exp(s["log_scales"][order])
    rgb = dc_color(s["sh"][order, 0, :])
    alpha = 1.0 / (1.0 + np.exp(-s["opacities"][order]))
    buf["rgba"][:, :3] = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    buf["rgba"][:, 3] = np.clip(alpha * 255.0, 0, 255).astype(np.uint8)
    q = s["quats"][order]
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    buf["rot"] = np.clip(q * 128.0 + 128.0, 0, 255).astype(np.uint8)
    return buf.tobytes(), order.astype(np.int32)


def write_splat(path: str, scene: GaussianScene, *,
                labels_path: Optional[str] = None,
                sort_by_importance: bool = True) -> None:
    data, order = pack_splat(scene, sort_by_importance=sort_by_importance)
    with open(path, "wb") as f:
        f.write(data)
    if labels_path is not None:
        labels = scene.labels.cpu().numpy()
        labels[order].astype("<i4").tofile(labels_path)


def read_splat(path_or_bytes, labels: Optional[np.ndarray] = None,
               device: DeviceLike = None) -> GaussianScene:
    """Unpack a .splat buffer into a scene on ``device`` (the card by
    default); u8-lossy: colors, opacity and rotation carry quantization,
    the viewer treats this as display data."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            raw = f.read()
    if len(raw) % ROW_BYTES:
        raise ValueError(f".splat data of {len(raw)} bytes is not whole "
                         f"{ROW_BYTES}-byte rows")
    buf = np.frombuffer(raw, dtype=ROW_DTYPE)
    alpha = np.clip(buf["rgba"][:, 3].astype(np.float64) / 255.0,
                    1e-6, 1.0 - 1e-6)
    rgb = buf["rgba"][:, :3].astype(np.float64) / 255.0
    quats = (buf["rot"].astype(np.float64) - 128.0) / 128.0
    return scene_from_numpy(
        means=buf["position"],
        log_scales=np.log(np.maximum(buf["scale"], 1e-12)),
        quats=quats,
        opacities=np.log(alpha / (1.0 - alpha)),
        sh=color_to_dc(rgb)[:, None, :],
        labels=labels,
        device=device,
    )
