"""Majority-vote label assignment over camera views.

Counterpart of ``gsplat_tpu.label.vote``, the re-architecture of the
reference's serial double loop (deep_learning_segmentation.py:241-308, pure
Python over cameras x gaussians) as a loop over views with every gaussian
projected at once.

Semantics parity with the reference:
- center projection ``u = fx x/z + W/2`` with z > 0 cull and bounds check
  (py:43-82);
- seg-map lookup scales pixel coords to the map resolution with clamping
  (py:269-286);
- votes count raw seg-map values INCLUDING -1 background (py:288-295);
- final label = argmax of votes, ``-1`` for never-visible gaussians
  (py:297-308). Vote classes are stored shifted by +1 so ``-1`` is bin 0.

The JAX package looks the seg maps up with a one-hot matmul on the TPU's
matrix unit and chunks gaussians and batches views to bound that buffer;
the port keeps the result and drops the workaround: the lookup is a direct
gather ``seg[v, ys, xs]`` and the [N, num_classes + 1] int32 histogram takes
one ``index_add_`` per view (integer adds, exact in any order). No [V, N, C]
or [N, SW] one-hot exists. The vote is plain torch on both devices; the
occlusion-aware path's visibility render runs kernel B5 once per view.

With ``mesh=`` (``parallel/mesh.py``), as ``gsplat_tpu/label/vote.py:196-230``
and ``:238-320`` shard them: the vote splits the views over ``host`` and
the gaussians over ``chip`` (views padded with zero-size cameras, which
see nothing) and sums the histograms over ``host``, within a process and
by an all-reduce across processes; integer counts, so the votes are
exact. The visibility pass splits the views over every shard, each shard
rendering its views of the whole scene (kernel B5).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gsplat_tpu_torch.config import DEFAULT, UNLABELED
from gsplat_tpu_torch.io.cameras import Camera
from gsplat_tpu_torch.parallel.mesh import (Mesh, all_gather_shards,
                                            all_reduce_sum, on_device)
from gsplat_tpu_torch.render.api import _render_vis_impl
from gsplat_tpu_torch.render.projection import CameraParams
from gsplat_tpu_torch.scene import DeviceLike, GaussianScene, resolve_device
from gsplat_tpu_torch.utils.profiling import span


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a gsplat_tpu_torch.parallel.mesh.Mesh")


def project_centers(
    means: torch.Tensor,             # [N, 3]
    rot: torch.Tensor,               # [V, 3, 3]
    pos: torch.Tensor,               # [V, 3]
    fx: torch.Tensor, fy: torch.Tensor,          # [V]
    width: torch.Tensor, height: torch.Tensor,   # [V]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched center projection. Returns (u [V,N], v [V,N], visible [V,N]).

    Written out elementwise in f32 (as ``render/projection.py`` is), so no
    matrix product and no TF32 setting can touch it."""
    mx, my, mz = means[None, :, 0], means[None, :, 1], means[None, :, 2]
    t = -(rot[:, :, 0] * pos[:, 0, None] + rot[:, :, 1] * pos[:, 1, None]
          + rot[:, :, 2] * pos[:, 2, None])                         # [V, 3]

    def cam_axis(i):
        return (rot[:, i, 0, None] * mx + rot[:, i, 1, None] * my
                + rot[:, i, 2, None] * mz + t[:, i, None])

    pcx, pcy, z = cam_axis(0), cam_axis(1), cam_axis(2)
    vis = z > 0.0
    zs = torch.where(vis, z, torch.ones_like(z))
    w, h = width[:, None], height[:, None]
    u = fx[:, None] * pcx / zs + w / 2.0
    v = fy[:, None] * pcy / zs + h / 2.0
    vis = vis & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    return u, v, vis


def camera_batch(cameras: Sequence[Camera]) -> Dict[str, np.ndarray]:
    """Stack camera parameters into f32 arrays."""
    return dict(
        rot=np.stack([c.rotation for c in cameras]).astype(np.float32),
        pos=np.stack([c.position for c in cameras]).astype(np.float32),
        fx=np.array([c.fx for c in cameras], np.float32),
        fy=np.array([c.fy for c in cameras], np.float32),
        width=np.array([c.width for c in cameras], np.float32),
        height=np.array([c.height for c in cameras], np.float32),
    )


def _camera_tensors(cameras: Sequence[Camera], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(a).to(device)
            for k, a in camera_batch(cameras).items()}


def seg_lookup_coords(u: torch.Tensor, v: torch.Tensor, width: torch.Tensor,
                      height: torch.Tensor, sw: int, sh: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel coords [V, N] -> seg-map coords (reference py:269-286): the f32
    ratio ``sw / max(w, 1)`` first, then the product, truncation toward
    zero and the clamp, as the JAX package rounds them. (``int / tensor``
    would take torch's reciprocal-times path and round differently.)"""
    def ratio(size, extent):
        num = torch.full_like(extent, float(size))
        return (num / torch.clamp_min(extent, 1.0))[:, None]

    rx, ry = ratio(sw, width), ratio(sh, height)
    xs = torch.clamp((u * rx).to(torch.int32), 0, sw - 1)
    ys = torch.clamp((v * ry).to(torch.int32), 0, sh - 1)
    return xs, ys


def _vote_histogram(means: torch.Tensor, cams: Dict[str, torch.Tensor],
                    seg_maps: torch.Tensor, num_classes: int,
                    vis: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Vote histogram [N, num_classes + 1] int32 over a stack of views.

    seg_maps: [V, SH, SW] int32 (uniform resolution; resize upstream). Bin 0
    counts label -1; bin k counts label k - 1; values past the bins clamp
    into the end bins, as in the JAX package. ``vis`` [V, N] bool, if given,
    masks which gaussians may vote in each view (occlusion-aware path)."""
    n = means.shape[0]
    nbins = num_classes + 1
    sh, sw = seg_maps.shape[1], seg_maps.shape[2]
    votes = torch.zeros(n * nbins, dtype=torch.int32, device=means.device)
    gbase = torch.arange(n, dtype=torch.int64, device=means.device) * nbins
    for i in range(seg_maps.shape[0]):
        one = {k: c[i:i + 1] for k, c in cams.items()}
        u, v, visible = project_centers(means, one["rot"], one["pos"],
                                        one["fx"], one["fy"], one["width"],
                                        one["height"])
        xs, ys = seg_lookup_coords(u, v, one["width"], one["height"], sw, sh)
        visible = visible[0] if vis is None else visible[0] & vis[i]
        g = visible.nonzero()[:, 0]
        lab = seg_maps[i][ys[0, g].long(), xs[0, g].long()]
        bins = torch.clamp(lab + 1, 0, num_classes).long()
        votes.index_add_(0, gbase[g] + bins,
                         torch.ones_like(g, dtype=torch.int32))
    return votes.view(n, nbins)


def _vote_sharded(means: torch.Tensor, cams: Dict[str, np.ndarray],
                  seg_maps: np.ndarray, num_classes: int, mesh: Mesh,
                  vis: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`_vote_histogram` with views over the mesh's ``host`` axis and
    gaussians over ``chip``, summed over ``host`` (module docstring); the
    [N, C + 1] votes on ``mesh.home``."""
    n_host, n_chip = mesh.dims
    n, v = means.shape[0], seg_maps.shape[0]
    ng, nv = -(-n // n_chip), -(-v // n_host)
    means = torch.cat([means, means.new_zeros(ng * n_chip - n, 3)])
    if vis is not None:
        vis = torch.cat([vis, vis.new_zeros(v, ng * n_chip - n)], dim=1)
    pad = nv * n_host - v
    if pad:
        seg_maps = np.concatenate(
            [seg_maps, np.full((pad,) + seg_maps.shape[1:], -1, np.int32)])
        cams = {k: np.concatenate([a, np.repeat(a[-1:], pad, 0)])
                for k, a in cams.items()}
        cams["width"][v:] = 0.0
        cams["height"][v:] = 0.0
        if vis is not None:
            vis = torch.cat([vis, vis.new_zeros(pad, vis.shape[1])])
    votes = torch.zeros(ng * n_chip, num_classes + 1, dtype=torch.int32,
                        device=mesh.home)
    for s, dev in zip(mesh.local, mesh.devices):
        h, c = divmod(s, n_chip)
        views, rows = slice(h * nv, (h + 1) * nv), slice(c * ng, (c + 1) * ng)
        with on_device(dev):
            part = _vote_histogram(
                means[rows].to(dev),
                {k: torch.from_numpy(a[views]).to(dev)
                 for k, a in cams.items()},
                _seg_tensor(seg_maps[views], dev), num_classes,
                vis=None if vis is None else vis[views, rows].to(dev))
        votes[rows] += part.to(mesh.home)
    return all_reduce_sum(votes, mesh)[:n]


def votes_to_labels(votes: torch.Tensor) -> torch.Tensor:
    """argmax over the histogram (the first maximum wins); never-visible ->
    UNLABELED (-1)."""
    seen = votes.sum(dim=1) > 0
    return torch.where(seen, votes.argmax(dim=1).to(torch.int32) - 1,
                       torch.full_like(seen, UNLABELED, dtype=torch.int32))


def _seg_tensor(seg_maps, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(seg_maps, np.int32), device=device)


def _upload_and_vote(means: torch.Tensor, cameras: Sequence[Camera],
                     seg_maps, num_classes: int, device: torch.device,
                     vis: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`_vote_histogram` over ``cameras`` and the host's ``seg_maps``,
    uploaded to ``device`` in a span of their own. The uploads die with the
    call, before the labels' reduction, a job's peak of device memory."""
    with span("gsplat.upload"):
        cams = _camera_tensors(cameras, device)
        seg = _seg_tensor(seg_maps, device)
    with span("gsplat.vote"):
        return _vote_histogram(means, cams, seg, num_classes, vis=vis)


def assign_labels(
    scene: GaussianScene,
    cameras: Sequence[Camera],
    seg_maps: np.ndarray,        # [V, SH, SW] int32
    *,
    num_classes: int = 151,
    mesh=None,
    return_votes: bool = False,
    initial_votes=None,
    device: DeviceLike = None,
):
    """Majority-vote labels [N] i32 for every gaussian, on ``device`` (the
    card unless the caller names another).

    ``initial_votes`` resumes a partial sweep: pass the saved [N, C + 1]
    histogram and only the remaining cameras/seg_maps. With ``mesh`` the
    vote is sharded (module docstring); the labels are the same."""
    _check_mesh(mesh)
    device = resolve_device(device)
    with span("gsplat.label"):
        if mesh is None:
            votes = _upload_and_vote(scene.means.to(device), cameras,
                                     seg_maps, num_classes, device)
        else:
            with span("gsplat.vote"):
                votes = _vote_sharded(scene.means.to(mesh.home),
                                      camera_batch(cameras),
                                      np.asarray(seg_maps, np.int32),
                                      num_classes, mesh).to(device)
        with span("gsplat.vote"):
            if initial_votes is not None:
                votes = votes + torch.as_tensor(
                    np.asarray(initial_votes), device=device).to(votes.dtype)
            labels = votes_to_labels(votes)
    if return_votes:
        return labels, votes
    return labels


def _visibility_group(scene: GaussianScene, cameras: Sequence[Camera],
                      thr: float, cfg, vis: torch.Tensor, idxs) -> None:
    """The visibility of one resolution group (shared width/height) into
    rows ``idxs`` of ``vis`` [V, N]: one visibility render (kernel B5) per
    view. The [V, N] rows are the blend's too, so that every launch of a
    job lies in a stage."""
    w, h = cameras[0].width, cameras[0].height
    with span("gsplat.blend"):
        bg = torch.zeros(3, device=scene.device)
    rows = []
    for cam in cameras:
        out = _render_vis_impl(scene, CameraParams.from_camera(
            cam, scene.device), bg, width=w, height=h, cfg=cfg,
            with_labels=False)
        with span("gsplat.blend"):
            rows.append(out["gaussian_weight"] >= thr)
    with span("gsplat.blend"):
        rows = torch.stack(rows)    # the list goes before the scatter
        vis[torch.tensor(idxs, device=vis.device)] = rows


def visibility_masks(
    scene: GaussianScene,
    cameras: Sequence[Camera],
    *,
    visibility_threshold: float = 0.05,
    cfg=None,
    mesh=None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """[V, N] bool on ``device``: gaussian g visibly contributes to view v
    (its max per-pixel blend weight through the tile pipeline >= the
    threshold).

    Views are grouped by (width, height), as in the JAX package, and each
    group's views are rendered in turn. With ``mesh`` the views are split
    over every shard (padded with the last view), each rendering its views
    of the whole scene, and gathered."""
    _check_mesh(mesh)
    cfg = cfg or DEFAULT
    device = resolve_device(device)
    with span("gsplat.visibility"):
        if mesh is not None:
            per = -(-len(cameras) // mesh.size)
            padded = list(cameras) + [cameras[-1]] * (per * mesh.size
                                                      - len(cameras))
            rows = []
            for s, dev in zip(mesh.local, mesh.devices):
                with on_device(dev):
                    rows.append(visibility_masks(
                        scene, padded[s * per:(s + 1) * per],
                        visibility_threshold=visibility_threshold, cfg=cfg,
                        device=dev))
            vis = torch.cat(all_gather_shards(rows, mesh))[:len(cameras)]
            return vis.to(device)
        scene = scene.to(device)
        groups: Dict[Tuple[int, int], list] = {}
        for i, c in enumerate(cameras):
            groups.setdefault((c.width, c.height), []).append(i)
        with span("gsplat.blend"):
            vis = torch.zeros(len(cameras), scene.num_gaussians,
                              dtype=torch.bool, device=device)
        for idxs in groups.values():
            _visibility_group(scene, [cameras[i] for i in idxs],
                              visibility_threshold, cfg, vis, idxs)
        return vis


def assign_labels_visible(
    scene: GaussianScene,
    cameras: Sequence[Camera],
    seg_maps: np.ndarray,
    *,
    num_classes: int = 151,
    visibility_threshold: float = 0.05,
    return_votes: bool = False,
    cfg=None,
    mesh=None,
    device: DeviceLike = None,
):
    """Occlusion-aware majority vote (capability beyond the reference).

    The reference's center-projection vote lets OCCLUDED gaussians vote with
    the occluder's pixel label. Here each view is rendered through the tile
    pipeline (kernel B5) and a gaussian only votes when its max per-pixel
    blend weight reaches ``visibility_threshold``, i.e. when it visibly
    contributes to that view. The vote itself is :func:`assign_labels`'
    histogram with the per-view visibility as an extra mask. With ``mesh``
    both the visibility pass and the vote are sharded (module
    docstring)."""
    _check_mesh(mesh)
    device = resolve_device(device)
    with span("gsplat.label"):
        if mesh is not None:
            vis = visibility_masks(scene, cameras,
                                   visibility_threshold=visibility_threshold,
                                   cfg=cfg, mesh=mesh, device=mesh.home)
            with span("gsplat.vote"):
                votes = _vote_sharded(scene.means.to(mesh.home),
                                      camera_batch(cameras),
                                      np.asarray(seg_maps, np.int32),
                                      num_classes, mesh, vis=vis).to(device)
                labels = votes_to_labels(votes)
        else:
            scene = scene.to(device)
            vis = visibility_masks(scene, cameras,
                                   visibility_threshold=visibility_threshold,
                                   cfg=cfg, device=device)
            votes = _upload_and_vote(scene.means, cameras, seg_maps,
                                     num_classes, device, vis=vis)
            with span("gsplat.vote"):
                labels = votes_to_labels(votes)
    if return_votes:
        return labels, votes
    return labels


def label_statistics(labels, id2label: Optional[Dict[int, str]] = None
                     ) -> List[str]:
    """Per-label count/percentage lines (deep_learning_segmentation.py:363-371)."""
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    labels = np.asarray(labels)
    lines = []
    for lab, cnt in zip(*np.unique(labels, return_counts=True)):
        name = (id2label or {}).get(int(lab), str(int(lab)))
        lines.append(
            f"label {int(lab)} ({name}): {int(cnt)} gaussians "
            f"({100.0 * cnt / len(labels):.2f}%)")
    return lines
