"""K-means clustering on gaussian features.

Counterpart of ``gsplat_tpu.cluster.kmeans`` (a re-architecture of the
reference's 3D_clustering/k_means.py): one distance product and argmin per
iteration assign every point, and the centroid update is a one-hot product
with the empty-cluster-keeps-its-centroid rule (py:124-128). Defaults k=10,
tol=1e-4, max_iter=10 (py:46, 202, 210). Features are concat(xyz, f_dc)
(py:109), or xyz alone, the ``k_means_kd_tree`` variant (py:46-103).

The initial centroids are the rows ``np.random.default_rng(seed).choice``
picks, sorted, so the port starts where the JAX package does. Distances and
sums are f32 products at full precision, as JAX's ``Precision.HIGHEST``:
on the card, TF32 must be off for them (checked, not set). The one-hot
product sums in a fixed order where ``index_add_`` on the card would not.
With ``mesh=`` the points are split over the mesh's shards (padded with
the first point, as ``gsplat_tpu/cluster/kmeans.py:106-150`` pads them);
each iteration adds the shards' centroid sums and counts in shard order and
across processes (an all-reduce), and JAX's loop and stop rule run on the
result.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from gsplat_tpu_torch.parallel.mesh import (Mesh, all_gather_shards,
                                            all_reduce_sum, on_device)
from gsplat_tpu_torch.scene import GaussianScene, color_to_dc

# Reference cluster palette (k_means.py:8, /255).
COLORS = np.array([
    [252, 199, 55], [242, 107, 15], [231, 56, 121], [126, 24, 145],
    [247, 44, 91], [255, 116, 139], [167, 212, 119], [228, 241, 172],
], dtype=np.float32) / 255.0


class KMeansResult(NamedTuple):
    labels: torch.Tensor     # [N] i32
    centroids: torch.Tensor  # [k, F]
    iterations: int
    shift: float             # final centroid shift norm


def check_f32_matmul(device: torch.device) -> None:
    """Raise unless f32 products on ``device`` run at full precision: TF32
    would move points across cluster boundaries and neighbours across the
    k-th distance."""
    if device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "clustering needs full-precision f32 products on the card: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def scene_features(scene: GaussianScene, with_color: bool = True
                   ) -> torch.Tensor:
    """concat(xyz, f_dc) features (k_means.py:109) or xyz only (py:46-103)."""
    if not with_color:
        return scene.means
    return torch.cat([scene.means, scene.sh[:, 0, :]], dim=1)


def assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """argmin_j ||x_i - c_j||^2 via one product (the first minimum wins)."""
    d = ((x * x).sum(dim=1, keepdim=True) - 2.0 * (x @ c.T)
         + (c * c).sum(dim=1)[None, :])
    return torch.argmin(d, dim=1).to(torch.int32)


def _partial_sums(x: torch.Tensor, labels: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each cluster's sum of points and count, from a one-hot product."""
    oh = torch.nn.functional.one_hot(labels.long(), k).to(x.dtype)  # [n, k]
    return oh.T @ x, oh.sum(dim=0)


def _new_centroids(sums, counts, c) -> Tuple[torch.Tensor, torch.Tensor]:
    new_c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp_min(counts[:, None], 1.0), c)
    return new_c, torch.linalg.vector_norm(new_c - c)


def update(x: torch.Tensor, labels: torch.Tensor, c: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new centroids, shift norm): the mean of each cluster's points from
    a one-hot product; an empty cluster keeps its centroid."""
    return _new_centroids(*_partial_sums(x, labels, c.shape[0]), c)


def _kmeans_loop(features: torch.Tensor, c: torch.Tensor, k: int,
                 max_iter: int, tol: float, mesh: Mesh) -> KMeansResult:
    """JAX's loop and stop rule over the mesh's shards (module docstring):
    ``features`` whole on every process, ``c`` the initial centroids. One
    shard on the features' device is the single-device k-means."""
    n = features.shape[0]
    pad = -n % mesh.size
    x = (torch.cat([features, features[:1].expand(pad, -1)]) if pad
         else features)
    ns = x.shape[0] // mesh.size
    xs = [x[s * ns:(s + 1) * ns].to(dev)
          for s, dev in zip(mesh.local, mesh.devices)]
    c = c.to(mesh.home)
    # the loop condition of the JAX while_loop, compared in f32
    it, shift, tol32 = 0, float("inf"), np.float32(tol)
    while it < max_iter and np.float32(shift) >= tol32:
        parts = []
        for x_s, dev in zip(xs, mesh.devices):
            with on_device(dev):
                part = _partial_sums(x_s, assign(x_s, c.to(dev)), k)
            parts.append([t.to(mesh.home) for t in part])
        sums, counts = parts[0]
        for s_p, c_p in parts[1:]:
            sums, counts = sums + s_p, counts + c_p
        c, s = _new_centroids(all_reduce_sum(sums, mesh),
                              all_reduce_sum(counts, mesh), c)
        shift = float(s)
        it += 1
    labels = []
    for x_s, dev in zip(xs, mesh.devices):
        with on_device(dev):
            labels.append(assign(x_s, c.to(dev)))
    labels = torch.cat(all_gather_shards(labels, mesh))[:n]
    return KMeansResult(labels.to(features.device), c.to(features.device),
                        it, shift)


def kmeans(
    features: torch.Tensor,
    k: int = 10,
    *,
    max_iter: int = 10,
    tol: float = 1e-4,
    seed: int = 0,
    mesh=None,
    init_centroids=None,
) -> KMeansResult:
    """Cluster [N, F] features on their device; with ``mesh`` over its
    shards (module docstring), the result on the features' device."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a gsplat_tpu_torch.parallel.mesh.Mesh")
    check_f32_matmul(features.device)
    if mesh is not None:
        for dev in mesh.devices:
            check_f32_matmul(dev)
    n = features.shape[0]
    if init_centroids is None:
        # random distinct points as initial centroids (k_means.py:111)
        idx = np.random.default_rng(seed).choice(n, size=k, replace=False)
        c = features[torch.as_tensor(np.sort(idx), device=features.device)]
    else:
        c = torch.as_tensor(np.asarray(init_centroids, np.float32),
                            device=features.device)
    if mesh is None:
        mesh = Mesh((1, 1), (features.device,))
    return _kmeans_loop(features, c, k, max_iter, tol, mesh)


def recolor_scene(scene: GaussianScene, labels: torch.Tensor,
                  palette: np.ndarray = COLORS) -> GaussianScene:
    """Bake cluster colors into the DC band (k_means.py:140-149)."""
    labels = torch.as_tensor(labels, device=scene.device)
    pal = torch.as_tensor(np.asarray(palette, np.float32), device=scene.device)
    sh = scene.sh.clone()
    sh[:, 0, :] = color_to_dc(pal[labels.long() % pal.shape[0]])
    return dataclasses.replace(scene, sh=sh, labels=labels.to(torch.int32))


def cluster_scene(
    scene: GaussianScene,
    k: int = 10,
    *,
    with_color: bool = True,
    max_iter: int = 10,
    tol: float = 1e-4,
    seed: int = 0,
    mesh=None,
    recolor: bool = True,
) -> Tuple[GaussianScene, KMeansResult]:
    """k_means.py CLI semantics: cluster, label, optionally recolor."""
    res = kmeans(scene_features(scene, with_color), k, max_iter=max_iter,
                 tol=tol, seed=seed, mesh=mesh)
    out = (recolor_scene(scene, res.labels) if recolor
           else dataclasses.replace(scene, labels=res.labels))
    return out, res
