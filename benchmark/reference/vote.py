"""Occlusion-aware majority vote in plain PyTorch.

A gaussian is visible in a view when its largest blend weight over the
pixels of its tiles, composited with no early stop, reaches
``visibility_threshold``. A visible gaussian votes with the seg map's class
under its centre: u = fx x / z + W / 2 with (x, y, z) = R m + t, t = -R p,
written out per axis; it must lie in front (z > 0) and inside the frame,
and the map is read at (trunc(u sw / W), trunc(v sh / H)) clamped to the
map. Classes count shifted by one so -1 (unlabeled) is bin 0; the label is
the first largest bin minus one, -1 for a gaussian that never voted.
"""

from __future__ import annotations

import torch

from benchmark.reference import render
from benchmark.reference.render import F32, Precision


@torch.no_grad()
def visibility(params: dict, cam: render.Cam, raster: dict, chunk: int,
               threshold: float, prec: Precision = F32) -> torch.Tensor:
    """([N] bool visibility of one view, the blend's pair counts, the
    view's stream)."""
    proj = render.project(params, cam, raster, prec)
    stream = render.bin_tiles(proj, cam.width, cam.height, raster["tile"])
    out = render.blend(proj.table, stream, cam.width, cam.height, raster,
                       chunk=chunk, eps=0.0, gauss_max=True, prec=prec)
    return out.gauss_weight >= threshold, out.pairs, stream


@torch.no_grad()
def labels(means: torch.Tensor, cams, seg: torch.Tensor, vis: torch.Tensor,
           num_classes: int) -> torch.Tensor:
    """[N] i64 labels from ``vis`` [V, N] and seg maps ``seg`` [V, SH, SW]."""
    n = means.shape[0]
    bins = num_classes + 1
    votes = torch.zeros(n * bins, dtype=torch.int64, device=means.device)
    sh_, sw_ = seg.shape[1], seg.shape[2]
    for i, cam in enumerate(cams):
        r = cam.rot
        t = -(r[:, 0] * cam.pos[0] + r[:, 1] * cam.pos[1]
              + r[:, 2] * cam.pos[2])
        axis = [r[a, 0] * means[:, 0] + r[a, 1] * means[:, 1]
                + r[a, 2] * means[:, 2] + t[a] for a in range(3)]
        z = axis[2]
        front = z > 0.0
        zs = torch.where(front, z, torch.ones_like(z))
        w = torch.tensor(float(cam.width), device=means.device)
        h = torch.tensor(float(cam.height), device=means.device)
        u = torch.tensor(cam.fx, device=means.device) * axis[0] / zs + w / 2.0
        v = torch.tensor(cam.fy, device=means.device) * axis[1] / zs + h / 2.0
        ok = front & (u >= 0) & (u < w) & (v >= 0) & (v < h) & vis[i]
        rx = torch.full_like(w, float(sw_)) / torch.clamp_min(w, 1.0)
        ry = torch.full_like(h, float(sh_)) / torch.clamp_min(h, 1.0)
        xs = torch.clamp((u * rx).to(torch.int32), 0, sw_ - 1).long()
        ys = torch.clamp((v * ry).to(torch.int32), 0, sh_ - 1).long()
        g = ok.nonzero()[:, 0]
        cls = torch.clamp(seg[i][ys[g], xs[g]].long() + 1, 0, num_classes)
        votes.index_add_(0, g * bins + cls, torch.ones_like(g))
    votes = votes.view(n, bins)
    seen = votes.sum(1) > 0
    never = torch.full_like(seen, -1, dtype=torch.int64)
    return torch.where(seen, votes.argmax(1) - 1, never)
