"""Selection and per-label editing as transforms of the scene.

Counterpart of ``gsplat_tpu.interact.edit``: every edit is a transform of
the scene, or of an ``EditState`` applied before rendering, on the device
the scene lies on.

- hit_test: brute-force nearest projected center within a pixel radius,
  the nearest in depth among the hits (gaussians_selection.js:361-395,
  10 px radius js:387);
- EditState: label-keyed displacement / visibility / recolor maps
  (js:15-64, 892-971, 281-320) with session persistence (the localStorage
  analogue, js:955-971), a copy of the JAX class with the same session
  JSON;
- apply_edits: displacement shifts means, hidden labels take a -30 opacity
  logit (the alpha-zeroing of js:303-320), custom colors mix into the DC
  band by ``custom_color_mix`` (js:773-780), the selection highlight mixes
  red by ``highlight_mix`` (js:795-797).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

import numpy as np
import torch

from gsplat_tpu_torch.config import NO_SELECTION, InteractConfig
from gsplat_tpu_torch.io.cameras import Camera
from gsplat_tpu_torch.scene import (GaussianScene, color_to_dc, dc_color,
                                    scene_from_numpy)

HIDDEN_LOGIT = -30.0


def hit_test(
    scene: GaussianScene,
    camera: Camera,
    x: float,
    y: float,
    *,
    radius_px: float = 10.0,
) -> int:
    """Label of the nearest gaussian center within ``radius_px`` of (x, y);
    the nearest in camera depth wins, and of equal depths the lowest index
    (gaussians_selection.js:361-395). Returns NO_SELECTION when nothing is
    hit. The camera transform is written out elementwise, so no matrix
    product (and no TF32) enters on the card."""
    means = scene.means
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=means.device)
    rot, pos = f32(camera.rotation), f32(camera.position)
    trans = -(rot[:, 0] * pos[0] + rot[:, 1] * pos[1] + rot[:, 2] * pos[2])
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    pcx = mx * rot[0, 0] + my * rot[0, 1] + mz * rot[0, 2] + trans[0]
    pcy = mx * rot[1, 0] + my * rot[1, 1] + mz * rot[1, 2] + trans[1]
    z = mx * rot[2, 0] + my * rot[2, 1] + mz * rot[2, 2] + trans[2]
    front = z > 0
    zs = torch.where(front, z, torch.ones_like(z))
    u = camera.fx * pcx / zs + camera.width / 2.0
    v = camera.fy * pcy / zs + camera.height / 2.0
    d2 = (u - x) ** 2 + (v - y) ** 2
    hit = front & (d2 <= radius_px * radius_px)
    key = torch.where(hit, z, torch.full_like(z, float("inf")))
    if not bool(torch.isfinite(key).any()):
        return NO_SELECTION
    # the first minimum, by index, on every device
    idx = torch.nonzero(key == key.min())[0, 0]
    return int(scene.labels[idx])


@dataclasses.dataclass
class EditState:
    """Label-keyed edit maps (the js uniform managers + worker maps)."""

    displacements: Dict[int, Tuple[float, float, float]] = \
        dataclasses.field(default_factory=dict)
    hidden: Dict[int, bool] = dataclasses.field(default_factory=dict)
    colors: Dict[int, Tuple[float, float, float]] = \
        dataclasses.field(default_factory=dict)
    selected_label: int = NO_SELECTION
    selection_mode: bool = False

    # -- mutations (return self for chaining) -------------------------------
    def displace(self, label: int, delta, step: float = 1.0) -> "EditState":
        """Accumulate a displacement (js:926-937; arrow-key step js:1465)."""
        cur = np.asarray(self.displacements.get(label, (0.0, 0.0, 0.0)))
        self.displacements[int(label)] = tuple(
            (cur + step * np.asarray(delta, dtype=np.float64)).tolist())
        return self

    def toggle_visibility(self, label: int) -> "EditState":
        self.hidden[int(label)] = not self.hidden.get(int(label), False)
        return self

    def set_color(self, label: int, rgb) -> "EditState":
        self.colors[int(label)] = tuple(float(c) for c in rgb)
        return self

    def reset_displacements(self) -> "EditState":  # js:1360-1369 'R'
        self.displacements.clear()
        return self

    def reset_visibility(self) -> "EditState":     # js:614-622 reset
        self.hidden.clear()
        return self

    def reset_colors(self) -> "EditState":         # js 'C'
        self.colors.clear()
        return self

    # -- session persistence (localStorage analogue, js:955-971) -----------
    def to_json(self) -> str:
        return json.dumps(dict(
            displacements={str(k): list(v)
                           for k, v in self.displacements.items()},
            hidden={str(k): v for k, v in self.hidden.items()},
            colors={str(k): list(v) for k, v in self.colors.items()},
            selected_label=self.selected_label,
            selection_mode=self.selection_mode))

    @classmethod
    def from_json(cls, s: str) -> "EditState":
        d = json.loads(s)
        return cls(
            displacements={int(k): tuple(v)
                           for k, v in d.get("displacements", {}).items()},
            hidden={int(k): bool(v) for k, v in d.get("hidden", {}).items()},
            colors={int(k): tuple(v) for k, v in d.get("colors", {}).items()},
            selected_label=int(d.get("selected_label", NO_SELECTION)),
            selection_mode=bool(d.get("selection_mode", False)))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "EditState":
        with open(path) as f:
            return cls.from_json(f.read())


def apply_edits(
    scene: GaussianScene,
    edits: EditState,
    cfg: InteractConfig = InteractConfig(),
) -> GaussianScene:
    """Apply the edit maps to a scene before rendering; returns a new scene
    on the same device and leaves ``scene`` as it was."""
    labels = scene.labels
    means, opac, sh = scene.means, scene.opacities, scene.sh
    dev = means.device
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)

    for lab, dxyz in edits.displacements.items():
        means = means + torch.where((labels == lab)[:, None], f32(dxyz),
                                    f32(0.0))

    for lab, hid in edits.hidden.items():
        if hid:
            opac = torch.where(labels == lab, f32(HIDDEN_LOGIT), opac)

    def mix_dc(sh, lab, rgb, mix):
        base = dc_color(sh[:, 0, :])
        mixed = (1.0 - mix) * base + mix * f32(rgb)
        dc = torch.where((labels == lab)[:, None], color_to_dc(mixed),
                         sh[:, 0, :])
        return torch.cat([dc[:, None, :], sh[:, 1:, :]], dim=1)

    for lab, rgb in edits.colors.items():
        sh = mix_dc(sh, lab, rgb, cfg.custom_color_mix)

    if edits.selection_mode and edits.selected_label != NO_SELECTION:
        sh = mix_dc(sh, edits.selected_label, (1.0, 0.0, 0.0),
                    cfg.highlight_mix)

    return dataclasses.replace(scene, means=means, opacities=opac, sh=sh)


def delete_labels(scene: GaussianScene, labels_to_delete) -> GaussianScene:
    """Permanently drop gaussians with the given labels (the viewer's
    hide/delete, made literal: returns a smaller scene on the same
    device)."""
    s = scene.to_numpy()
    keep = ~np.isin(s["labels"], np.asarray(list(labels_to_delete)))
    return scene_from_numpy(**{k: v[keep] for k, v in s.items()},
                            device=scene.device)
