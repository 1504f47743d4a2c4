"""Synthetic scene generators.

The same numpy draws as ``gsplat_tpu.io.synthetic``, in the same order from
``np.random.default_rng(seed)``, so both packages make identical scenes; the
arrays then go to ``device`` (the card unless the caller names another).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gsplat_tpu_torch.config import RasterConfig
from gsplat_tpu_torch.render.projection import Projected
from gsplat_tpu_torch.scene import (DeviceLike, GaussianScene, color_to_dc,
                                    resolve_device, scene_from_numpy)


def random_scene(
    n: int,
    *,
    seed: int = 0,
    extent: float = 1.0,
    scale_range: Sequence[float] = (0.01, 0.1),
    num_labels: Optional[int] = None,
    sh_degree: int = 0,
    device: DeviceLike = None,
) -> GaussianScene:
    """Random gaussian cloud in a cube of half-width ``extent``."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, size=(n, 3))
    log_scales = np.log(rng.uniform(*scale_range, size=(n, 3)))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacities = rng.uniform(-2.0, 4.0, size=(n,))  # sigmoid in ~[0.12, 0.98]
    k = (sh_degree + 1) ** 2
    sh = np.zeros((n, k, 3))
    sh[:, 0, :] = color_to_dc(rng.uniform(0.0, 1.0, size=(n, 3)))
    if k > 1:
        sh[:, 1:, :] = 0.1 * rng.normal(size=(n, k - 1, 3))
    labels = (rng.integers(0, num_labels, size=(n,)).astype(np.int32)
              if num_labels else None)
    return scene_from_numpy(means, log_scales, quats, opacities, sh, labels,
                            device=device)


def sphere_scene(
    n: int,
    *,
    radius: float = 1.0,
    seed: int = 0,
    scale: float = 0.05,
    noise: float = 0.0,
    device: DeviceLike = None,
) -> GaussianScene:
    """Gaussians on a sphere surface; colors encode the normal, labels split
    the sphere into octants."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    means = radius * d + noise * rng.normal(size=(n, 3))
    log_scales = np.full((n, 3), np.log(scale))
    quats = np.zeros((n, 4))
    quats[:, 0] = 1.0
    opacities = np.full((n,), 2.0)
    sh = color_to_dc(0.5 * (d + 1.0))[:, None, :]
    labels = ((d[:, 0] > 0).astype(np.int32) * 4
              + (d[:, 1] > 0).astype(np.int32) * 2
              + (d[:, 2] > 0).astype(np.int32)).astype(np.int32)
    return scene_from_numpy(means, log_scales, quats, opacities, sh, labels,
                            device=device)


def grid_scene(side: int, *, spacing: float = 0.2, scale: float = 0.05,
               opacity: float = 2.0, device: DeviceLike = None
               ) -> GaussianScene:
    """Deterministic axis-aligned grid of isotropic gaussians."""
    ax = (np.arange(side) - (side - 1) / 2) * spacing
    means = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    n = means.shape[0]
    quats = np.zeros((n, 4))
    quats[:, 0] = 1.0
    colors = (means / (np.abs(means).max() + 1e-9) + 1.0) / 2.0
    return scene_from_numpy(
        means, np.full((n, 3), np.log(scale)), quats,
        np.full((n,), opacity), color_to_dc(colors)[:, None, :],
        np.arange(n, dtype=np.int32), device=device)


def thin_splats_projection(
    n: int,
    *,
    width: int,
    height: int,
    seed: int = 0,
    device: DeviceLike = None,
) -> tuple[Projected, torch.Tensor]:
    """A projected frame of ``n`` high-opacity, thin, rotated splats on the
    16-px grid lines (the blend kernels' sub-tile and 32-px tile borders),
    and their [N] i32 labels (0-15): the hardest input for the skip test of the
    blend kernels (``csrc/blend_cull.cuh``). Means lie within 2 px of a
    vertical line, a horizontal one or a crossing; covariances are 4-40 px
    along a random angle and 0.2-1 px across it, plus the projection's 0.3
    px^2 blur, but a tenth have no blur and 0.05-0.2 px across (conics too
    thin for the rectangle test); opacity 0.9-1, but a tenth lie within 5%
    above ``alpha_min``. The extents, cutoff and validity follow
    ``render/projection.py`` at the default ``RasterConfig``."""
    alpha_min, sigma_cutoff = RasterConfig.alpha_min, RasterConfig.sigma_cutoff
    rng = np.random.default_rng(seed)
    line_x = rng.integers(0, width // 16 + 1, n) * 16 + rng.uniform(-2, 2, n)
    line_y = rng.integers(0, height // 16 + 1, n) * 16 + rng.uniform(-2, 2, n)
    kind = rng.integers(0, 3, n)   # on a vertical line, a horizontal, both
    u = np.where(kind == 1, rng.uniform(0, width, n), line_x)
    v = np.where(kind == 0, rng.uniform(0, height, n), line_y)
    ang = rng.uniform(0.0, np.pi, n)
    s_long = rng.uniform(4.0, 40.0, n)
    s_short = rng.uniform(0.2, 1.0, n)
    bare = rng.random(n) < 0.1
    s_short = np.where(bare, rng.uniform(0.05, 0.2, n), s_short)
    blur = np.where(bare, 0.0, 0.3)
    c, s = np.cos(ang), np.sin(ang)
    a = c * c * s_long ** 2 + s * s * s_short ** 2 + blur
    b = c * s * (s_long ** 2 - s_short ** 2)
    d = s * s * s_long ** 2 + c * c * s_short ** 2 + blur
    det = a * d - b * b
    opacity = np.where(rng.random(n) < 0.1,
                       alpha_min * (1.0 + rng.uniform(0.0, 0.05, n)),
                       rng.uniform(0.9, 1.0, n))
    cutoff = np.minimum(np.sqrt(2.0 * np.log(np.maximum(
        opacity / alpha_min, 1.0))), sigma_cutoff)
    mid = 0.5 * (a + d)
    lam1 = mid + np.sqrt(np.maximum(mid * mid - det, 0.0))
    ex, ey = cutoff * np.sqrt(a), cutoff * np.sqrt(d)
    rgb = rng.uniform(0.0, 1.0, (n, 3))
    labels = rng.integers(0, 16, n).astype(np.int32)
    dev = resolve_device(device)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    valid = ((opacity >= alpha_min) & (u + ex > 0) & (u - ex < width)
             & (v + ey > 0) & (v - ey < height))
    proj = Projected(
        u=f(u), v=f(v), ca=f(d / det), cb=f(-b / det), cc=f(a / det),
        depth=f(rng.uniform(1.0, 10.0, n)), radius=f(cutoff * np.sqrt(lam1)),
        ex=f(ex), ey=f(ey), qmax=f(cutoff * cutoff), red=f(rgb[:, 0]),
        green=f(rgb[:, 1]), blue=f(rgb[:, 2]), opacity=f(opacity),
        valid=torch.as_tensor(valid, device=dev))
    return proj, torch.as_tensor(labels, device=dev)
