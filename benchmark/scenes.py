"""The benchmark's generator: scenes, camera rigs, seg maps, viewer poses
and edits, all from ``--seed`` and the configuration and traffic files,
made on the run's device in a few large calls.

Every random draw of a run comes from a ``torch.Generator`` on the device
seeded from (seed, purpose), so the scene does not depend on the traffic
and a subset of views (the reference's) is built from the same draws as
the whole set. A view's seg map is a function of its own small draws
(:func:`seg_maps`), so the reference rebuilds any view without the
others.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

SH_C0 = 0.28209479177387814
_PURPOSES = {"scene": 1, "seg": 4, "poses": 5, "edits": 6, "check": 7}


def generator(seed: int, purpose: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 16 + _PURPOSES[purpose]) % (2 ** 63))
    return g


def scene(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's synthetic capture: ``ball_share`` of the
    gaussians uniform in a ball (the captured object), the rest uniform in
    the volume of a shell (the unbounded background); per-axis log-scales
    normal around each part's median, clipped at its maximum; uniform
    opacity logits; DC colour uniform, higher SH bands normal; labels
    uniform."""
    geo = cfg["geometry"]
    n = cfg["gaussians"]
    k = (cfg["sh_degree"] + 1) ** 2
    g = generator(seed, "scene", device)
    f32 = dict(device=device, dtype=torch.float32)
    nb = int(round(n * geo["ball_share"]))
    d = torch.randn(n, 3, generator=g, **f32)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    u = torch.rand(n, generator=g, **f32)
    r_in, r_out = geo["shell_radii"]
    radius = torch.cat([geo["ball_radius"] * u[:nb] ** (1.0 / 3.0),
                        (r_in ** 3 + u[nb:] * (r_out ** 3 - r_in ** 3))
                        ** (1.0 / 3.0)])
    means = d * radius[:, None]
    med = torch.cat([torch.full((nb,), geo["ball_scale_median"], **f32),
                     torch.full((n - nb,), geo["shell_scale_median"], **f32)])
    top = torch.cat([torch.full((nb,), geo["ball_scale_max"], **f32),
                     torch.full((n - nb,), geo["shell_scale_max"], **f32)])
    log_scales = torch.minimum(
        torch.log(med)[:, None]
        + geo["scale_sigma_ln"] * torch.randn(n, 3, generator=g, **f32),
        torch.log(top)[:, None])
    quats = torch.randn(n, 4, generator=g, **f32)
    lo, hi = geo["opacity_logit_range"]
    opacities = lo + (hi - lo) * torch.rand(n, generator=g, **f32)
    sh = torch.empty(n, k, 3, **f32)
    sh[:, 0] = (torch.rand(n, 3, generator=g, **f32) - 0.5) / SH_C0
    sh[:, 1:] = geo["sh_rest_sigma"] * torch.randn(n, k - 1, 3, generator=g,
                                                    **f32)
    labels = torch.randint(0, cfg["labels"], (n,), generator=g,
                           device=device, dtype=torch.int32)
    return dict(means=means, log_scales=log_scales, quats=quats,
                opacities=opacities, sh=sh, labels=labels)


class View(NamedTuple):
    """A pinhole camera: world-to-camera rows (right, down, forward)."""

    rot: np.ndarray   # [3, 3] f64
    pos: np.ndarray   # [3] f64
    fx: float
    fy: float
    width: int
    height: int


def look_at(eye, target, width: int, height: int, fov_x_deg: float) -> View:
    """Camera at ``eye`` looking at ``target``, image y down (up is -y)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    fx = 0.5 * width / np.tan(np.radians(fov_x_deg) / 2)
    return View(np.stack([right, down, fwd]), eye, fx, fx, width, height)


def ring(cfg: dict) -> List[View]:
    """The configuration's views on a ring about the origin: radius
    ``radius``, height ``height_amp`` sin(``height_waves`` theta)."""
    rig = cfg["rig"]
    out = []
    for i in range(cfg["views"]):
        a = 2 * math.pi * i / cfg["views"]
        eye = (rig["radius"] * math.cos(a),
               rig["height_amp"] * math.sin(rig["height_waves"] * a),
               rig["radius"] * math.sin(a))
        out.append(look_at(eye, (0.0, 0.0, 0.0), cfg["width"],
                           cfg["height"], rig["fov_x_deg"]))
    return out


def seg_draws(cfg: dict, traffic: dict, seed: int, device):
    """Per view: region centres [V, R, 2] in [0, 1), each region's class
    (Zipf(``zipf``) over ``num_classes``, rank r has class r) and whether it
    is unlabeled (share ``unlabeled_share``)."""
    s = traffic["seg"]
    g = generator(seed, "seg", device)
    v, r = cfg["views"], s["regions"]
    centres = torch.rand(v, r, 2, generator=g, device=device)
    ranks = torch.arange(1, s["num_classes"] + 1, device=device,
                         dtype=torch.float64)
    p = ranks ** -s["zipf"]
    cls = torch.multinomial((p / p.sum()).float().expand(v, -1).contiguous(),
                            r, replacement=True, generator=g)
    off = torch.rand(v, r, generator=g, device=device) < s["unlabeled_share"]
    return centres, torch.where(off, -1, cls).to(torch.int32)


def seg_maps(cfg: dict, draws, views) -> torch.Tensor:
    """[len(views), H, W] i32: the Voronoi partition of each view's region
    centres (nearest centre in pixel units, the lowest index on a tie),
    each region its class."""
    centres, cls = draws
    h, w = cfg["height"], cfg["width"]
    dev = centres.device
    yy, xx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    out = torch.empty(len(views), h, w, dtype=torch.int32, device=dev)
    for j, v in enumerate(views):
        cx = centres[v, :, 0] * w
        cy = centres[v, :, 1] * h
        d2 = (xx[..., None] - cx) ** 2 + (yy[..., None] - cy) ** 2
        out[j] = cls[v][d2.argmin(-1)]
    return out


def poses(traffic: dict, seed: int) -> List[tuple]:
    """The viewer's loop of (theta, phi, radius), from a seeded start."""
    p = traffic["poses"]
    n = p["count"]
    start = int(torch.randint(0, n, (1,), generator=generator(
        seed, "poses", "cpu")))
    out = []
    for i in range(n):
        a = 2 * math.pi * ((start + i) % n) / n
        out.append((a, p["phi_amp"] * math.sin(p["phi_waves"] * a),
                    p["radius"]))
    return out


def edits(cfg: dict, traffic: dict, seed: int) -> dict:
    """Four distinct labels from the seed: displaced, hidden, recoloured,
    selected."""
    e = traffic["edits"]
    lab = torch.randperm(cfg["labels"], generator=generator(
        seed, "edits", "cpu"))[:4].tolist()
    return dict(displace={lab[0]: tuple(e["offset"])}, hide=[lab[1]],
                recolor={lab[2]: tuple(e["colour"])}, selected=lab[3],
                selection_mode=True)


def sample(count: int, k: int, seed: int) -> List[int]:
    """``k`` distinct indices below ``count`` drawn from the seed (the
    views or frames a check compares)."""
    return sorted(torch.randperm(count, generator=generator(
        seed, "check", "cpu"))[:k].tolist())
