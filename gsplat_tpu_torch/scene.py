"""GaussianScene: the parameters of a splat scene as torch tensors on one device.

Storage follows the raw-PLY convention of the JAX package's ``GaussianScene``
(and of the reference, gaussians_selection.js:491-579):

- ``means``      [N, 3] f32   world-space centers
- ``log_scales`` [N, 3] f32   per-axis log scale (activated with ``exp``)
- ``quats``      [N, 4] f32   rotation quaternion ``(w, x, y, z)``, unnormalized
- ``opacities``  [N]    f32   pre-sigmoid logit
- ``sh``         [N, K, 3] f32 spherical-harmonic coefficients, K in {1,4,9,16}
- ``labels``     [N]    i32   segmentation label; ``NO_SELECTION`` when absent

``scene_from_numpy`` is the weights carry-across: it takes the arrays of a JAX
scene (``gsplat_tpu.scene.GaussianScene.to_numpy()``) and returns the port's
scene with the same bits; ``GaussianScene.to_numpy`` goes back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from gsplat_tpu_torch.config import NO_SELECTION, SH_C0

FIELDS = ("means", "log_scales", "quats", "opacities", "sh", "labels")

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Without a card the default raises; it never falls back to the
    CPU, so a run that was meant for the card cannot silently measure the
    host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


@dataclasses.dataclass
class GaussianScene:
    means: torch.Tensor       # [N, 3] f32
    log_scales: torch.Tensor  # [N, 3] f32
    quats: torch.Tensor       # [N, 4] f32, (w, x, y, z)
    opacities: torch.Tensor   # [N] f32 logits
    sh: torch.Tensor          # [N, K, 3] f32
    labels: torch.Tensor      # [N] i32

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    def to(self, device: DeviceLike) -> "GaussianScene":
        return GaussianScene(*(getattr(self, f).to(device) for f in FIELDS))

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The scene's arrays, keyed by field name (``scene_from_numpy(**d)``
        rebuilds the scene)."""
        return {f: getattr(self, f).detach().cpu().numpy() for f in FIELDS}


class SceneParams(NamedTuple):
    """The float trainable tensors (labels ride outside the optimizer), or
    their gradients."""

    means: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacities: torch.Tensor
    sh: torch.Tensor

    @classmethod
    def from_scene(cls, scene: GaussianScene) -> "SceneParams":
        return cls(scene.means, scene.log_scales, scene.quats,
                   scene.opacities, scene.sh)

    def to_scene(self, labels: torch.Tensor) -> GaussianScene:
        return GaussianScene(self.means, self.log_scales, self.quats,
                             self.opacities, self.sh, labels)


def scene_from_numpy(means, log_scales, quats, opacities, sh,
                     labels: Optional[np.ndarray] = None,
                     device: DeviceLike = None) -> GaussianScene:
    """Build a scene from numpy arrays with the JAX package's conversions
    (``GaussianScene.create``): floats to f32, labels to i32, opacities to [N],
    sh to [N, K, 3], missing labels to ``NO_SELECTION``."""
    device = resolve_device(device)
    n = np.asarray(means).shape[0]
    if labels is None:
        labels = np.full((n,), NO_SELECTION, dtype=np.int32)
    arrays = (
        np.asarray(means, dtype=np.float32),
        np.asarray(log_scales, dtype=np.float32),
        np.asarray(quats, dtype=np.float32),
        np.asarray(opacities, dtype=np.float32).reshape(n),
        np.asarray(sh, dtype=np.float32).reshape(n, -1, 3),
        np.asarray(labels, dtype=np.int32).reshape(n),
    )
    return GaussianScene(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                           for a in arrays))


def dc_color(sh_dc):
    """DC-band SH -> linear RGB in [0, inf) (reference js:566-569 clamps to u8)."""
    return 0.5 + SH_C0 * sh_dc


def color_to_dc(rgb):
    return (rgb - 0.5) / SH_C0
