"""Dense compositing (no tiles): the differentiable small-scene oracle.

Counterpart of ``gsplat_tpu.render.blend_xla``. It evaluates every (pixel,
gaussian) pair, O(H*W*N) memory, so it is for small scenes and tests only,
the autograd twin the tiled kernels are held against. Front-to-back
compositing is an exclusive cumulative product over the depth-sorted
gaussian axis: C_p = sum_i [prod_{j<i}(1 - a_j)] a_i c_i. The JAX package
runs this path as plain XLA, outside any Pallas kernel, so here it is plain
torch; autograd derives its gradient. The one matrix product, ``w @ col``,
runs in full f32 on the card as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False, PyTorch's default.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gsplat_tpu_torch.config import UNLABELED, RasterConfig
from gsplat_tpu_torch.render.projection import Projected


def pixel_alphas(
    means2d: torch.Tensor,   # [N, 2]
    conic: torch.Tensor,     # [N, 3]
    opacity: torch.Tensor,   # [N]
    valid: torch.Tensor,     # [N] bool
    px: torch.Tensor,        # [P] pixel-centre x
    py: torch.Tensor,        # [P] pixel-centre y
    cfg: RasterConfig,
) -> torch.Tensor:
    """[P, N] per-pixel alphas with the alpha_min / alpha_max semantics."""
    dx = px[:, None] - means2d[None, :, 0]
    dy = py[:, None] - means2d[None, :, 1]
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    q = a[None] * dx * dx + 2 * b[None] * dx * dy + c[None] * dy * dy
    alpha = opacity[None, :] * torch.exp(-0.5 * q)
    alpha = torch.clamp_max(alpha, cfg.alpha_max)
    keep = (alpha >= cfg.alpha_min) & valid[None, :]
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def blend_dense(
    proj: Projected,
    order: torch.Tensor,     # [N] depth-sorted indices
    width: int,
    height: int,
    cfg: RasterConfig,
    labels: Optional[torch.Tensor] = None,
    background: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Composite the gaussians in ``order`` at every pixel: ``image``,
    ``alpha``, ``transmittance`` and, with ``labels``, ``label_map`` (the
    label of each pixel's largest weight, the first of equal ones;
    ``UNLABELED`` where no weight is above 0)."""
    dev = proj.u.device
    px = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(py, px, indexing="ij")   # [H, W]
    pxf, pyf = gx.reshape(-1), gy.reshape(-1)

    m2d = torch.stack([proj.u, proj.v], dim=-1)[order]
    con = torch.stack([proj.ca, proj.cb, proj.cc], dim=-1)[order]
    opa = proj.opacity[order]
    col = torch.stack([proj.red, proj.green, proj.blue], dim=-1)[order]
    val = proj.valid[order]

    alpha = pixel_alphas(m2d, con, opa, val, pxf, pyf, cfg)   # [P, N]
    t_incl = torch.cumprod(1.0 - alpha, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]],
                       dim=1)
    w = t_excl * alpha                                        # [P, N]
    img = w @ col                                             # [P, 3]
    t_final = t_incl[:, -1]

    if background is None:
        background = torch.tensor(cfg.background, dtype=torch.float32,
                                  device=dev)
    img = img + t_final[:, None] * background[None, :]

    out = dict(
        image=img.reshape(height, width, 3),
        alpha=(1.0 - t_final).reshape(height, width),
        transmittance=t_final.reshape(height, width),
    )
    if labels is not None:
        lab = labels[order]
        best = torch.argmax(w, dim=1)
        hit = torch.gather(w, 1, best[:, None])[:, 0] > 0
        label_map = torch.where(hit, lab[best],
                                torch.full_like(lab[best], UNLABELED))
        out["label_map"] = label_map.reshape(height, width)
    return out
