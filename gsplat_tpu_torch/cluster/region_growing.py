"""Region-growing segmentation on gaussian point clouds.

Counterpart of ``gsplat_tpu.cluster.region_growing`` (a re-architecture of
the reference's 3D_clustering/region_growing.py): the batched geometry runs
on the scene's device in row blocks, as in the JAX package, which bounds
memory at [block, N] distances: kNN search by a distance product and
``torch.topk`` (self included), PCA normals by a batched ``torch.linalg.eigh``
of [block, 3, 3] covariances, and residuals. The BFS growth (py:166-226) is
sequential host Python by design, a copy of the JAX package's.

Defaults mirror the reference __main__ (py:272-278): normals_k=2000,
neighbors_k=10, residual threshold 0.1, angle threshold 0.05 rad. The f32
products run at full precision (TF32 off, checked as in ``kmeans``). An
eigenvector's sign is arbitrary; the inward flip fixes it except where
n . (p - centroid) is about 0.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from gsplat_tpu_torch.cluster.kmeans import check_f32_matmul
from gsplat_tpu_torch.scene import GaussianScene, color_to_dc


class Geometry(NamedTuple):
    normals: torch.Tensor     # [N, 3] unit, inward-flipped
    residuals: torch.Tensor   # [N]
    neighbors: torch.Tensor   # [N, k_nbr] i32


def knn_indices(points: torch.Tensor, k: int, block: int = 1024
                ) -> torch.Tensor:
    """[N, k] nearest-neighbour indices (self included), nearest first,
    from blocked distances."""
    check_f32_matmul(points.device)
    n = points.shape[0]
    sq = (points * points).sum(dim=1)
    out = torch.empty((n, k), dtype=torch.int32, device=points.device)
    for i in range(0, n, block):
        chunk = points[i:i + block]
        d = ((chunk * chunk).sum(dim=1)[:, None]
             - 2.0 * (chunk @ points.T) + sq[None, :])
        out[i:i + block] = torch.topk(-d, k, dim=1).indices.to(torch.int32)
    return out


def pca_normals(points: torch.Tensor, nbrs: torch.Tensor, k: int,
                block: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point PCA over k neighbours -> (normals [N, 3], residuals [N]).

    normal = eigenvector of the smallest eigenvalue of the neighbour
    covariance (region_growing.py:96-113); residual = |n . (p - centroid)|
    (py:149-162); inward flip when dot(n, p - global_centroid) > 0
    (py:115-120)."""
    check_f32_matmul(points.device)
    n = points.shape[0]
    centroid = points.mean(dim=0)
    normals = torch.empty((n, 3), dtype=points.dtype, device=points.device)
    resid = torch.empty((n,), dtype=points.dtype, device=points.device)
    for i in range(0, n, block):
        nb = nbrs[i:i + block, :k].long()
        p = points[i:i + block]
        nbp = points[nb]                                  # [block, k, 3]
        mu = nbp.mean(dim=1, keepdim=True)
        d = nbp - mu
        cov = torch.einsum("bki,bkj->bij", d, d) / k
        _, vecs = torch.linalg.eigh(cov)                  # ascending
        nrm = vecs[:, :, 0]                               # smallest -> normal
        flip = (nrm * (p - centroid)).sum(dim=1) > 0
        nrm = torch.where(flip[:, None], -nrm, nrm)
        nrm = nrm / torch.clamp_min(
            torch.linalg.vector_norm(nrm, dim=1, keepdim=True), 1e-12)
        normals[i:i + block] = nrm
        resid[i:i + block] = (nrm * (p - mu[:, 0, :])).sum(dim=1).abs()
    return normals, resid


def compute_geometry(
    points,
    *,
    normals_k: int = 2000,
    neighbors_k: int = 10,
) -> Geometry:
    """Batched normals/residuals/adjacency for region growing, on the
    device of ``points`` (a tensor; an array goes to the CPU)."""
    pts = torch.as_tensor(points, dtype=torch.float32)
    n = pts.shape[0]
    k_n = min(normals_k, n)
    k_b = min(neighbors_k, n)
    nbrs_n = knn_indices(pts, k_n)
    normals, resid = pca_normals(pts, nbrs_n, k_n)
    nbrs_b = nbrs_n[:, :k_b] if k_b <= k_n else knn_indices(pts, k_b)
    return Geometry(normals=normals, residuals=resid, neighbors=nbrs_b)


def grow_regions(
    geometry: Geometry,
    *,
    residual_threshold: float = 0.1,
    angle_threshold: float = 0.05,
    min_region_size: int = 1,
) -> np.ndarray:
    """Smoothness-constrained BFS growth (region_growing.py:166-226), on the
    host. Returns [N] region labels, ordered by descending region size
    (largest region = 0)."""
    normals = geometry.normals.cpu().numpy()
    resid = geometry.residuals.cpu().numpy()
    nbrs = geometry.neighbors.cpu().numpy()
    n = normals.shape[0]
    cos_thr = np.cos(angle_threshold)

    available = np.ones(n, dtype=bool)
    order = np.argsort(resid, kind="stable")
    regions: List[np.ndarray] = []
    ptr = 0
    while True:
        while ptr < n and not available[order[ptr]]:
            ptr += 1
        if ptr >= n:
            break
        seed = order[ptr]
        available[seed] = False
        frontier = [seed]
        members = [seed]
        while frontier:
            cur = frontier.pop()
            cand = nbrs[cur]
            cand = cand[available[cand]]
            if cand.size == 0:
                continue
            ok = np.abs(normals[cand] @ normals[seed]) > cos_thr
            accepted = cand[ok]
            for j in accepted:
                if available[j]:
                    available[j] = False
                    members.append(j)
                    if resid[j] < residual_threshold:
                        frontier.append(j)
        regions.append(np.array(members))

    regions.sort(key=len, reverse=True)
    labels = np.full(n, -1, dtype=np.int32)
    nxt = 0
    for reg in regions:
        if len(reg) >= min_region_size:
            labels[reg] = nxt
            nxt += 1
    return labels


def segment_scene(
    scene: GaussianScene,
    *,
    normals_k: int = 2000,
    neighbors_k: int = 10,
    residual_threshold: float = 0.1,
    angle_threshold: float = 0.05,
    recolor: bool = True,
    seed: int = 0,
) -> Tuple[GaussianScene, Geometry]:
    """Full region-growing pipeline on the scene's device; optional random
    recolor per region (region_growing.py:229-245)."""
    geo = compute_geometry(scene.means, normals_k=normals_k,
                           neighbors_k=neighbors_k)
    labels = grow_regions(geo, residual_threshold=residual_threshold,
                          angle_threshold=angle_threshold)
    out = dataclasses.replace(
        scene, labels=torch.as_tensor(labels, device=scene.device))
    if recolor:
        rng = np.random.default_rng(seed)
        n_reg = int(labels.max()) + 1
        palette = rng.uniform(0.0, 1.0, size=(max(n_reg, 1), 3))
        rgb = palette[np.clip(labels, 0, None)]
        sh = scene.sh.cpu().numpy().copy()
        sh[:, 0, :] = color_to_dc(rgb)
        out = dataclasses.replace(out, sh=torch.as_tensor(
            sh, dtype=scene.sh.dtype, device=scene.device))
    return out, geo
