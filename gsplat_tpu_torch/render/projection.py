"""Differentiable gaussian projection (plain torch; autograd derives the VJP).

Counterpart of ``gsplat_tpu.render.projection``: quat -> rotation -> Sigma3,
camera transform, perspective Jacobian, Sigma2 = (J W) Sigma3 (J W)^T + blur,
conic, opacity-aware cutoff, culling mask. It keeps the JAX package's
elementwise structure-of-arrays form (every field [N], no [N, 3, 3] matmul),
so no matrix product and therefore no TF32 rounding can enter on the card.
Semantics are those of the NumPy oracle ``gsplat_tpu/ref/rasterizer.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gsplat_tpu_torch.config import RasterConfig
from gsplat_tpu_torch.io.cameras import Camera
from gsplat_tpu_torch.render.sh import eval_sh_soa
from gsplat_tpu_torch.scene import DeviceLike, GaussianScene, resolve_device


class CameraParams(NamedTuple):
    """Camera parameters as f32 tensors on the render device."""

    rot: torch.Tensor    # [3, 3] world-to-camera rotation
    pos: torch.Tensor    # [3] camera center (world)
    fx: torch.Tensor     # scalar
    fy: torch.Tensor     # scalar

    @classmethod
    def from_camera(cls, cam: Camera, device: DeviceLike = None
                    ) -> "CameraParams":
        device = resolve_device(device)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        return cls(rot=f32(cam.rotation), pos=f32(cam.position),
                   fx=f32(cam.fx), fy=f32(cam.fy))


class Projected(NamedTuple):
    """Projection outputs, structure-of-arrays: every field is [N]."""

    u: torch.Tensor        # pixel x
    v: torch.Tensor        # pixel y
    ca: torch.Tensor       # conic a (inverse 2D covariance)
    cb: torch.Tensor       # conic b
    cc: torch.Tensor       # conic c
    depth: torch.Tensor    # camera-space z
    radius: torch.Tensor   # cutoff-sigma pixel radius (isotropic bound)
    ex: torch.Tensor       # cutoff-ellipse half-extent along x
    ey: torch.Tensor       # cutoff-ellipse half-extent along y
    qmax: torch.Tensor     # Mahalanobis^2 at the alpha_min cutoff
    red: torch.Tensor      # SH-evaluated color (>= 0)
    green: torch.Tensor
    blue: torch.Tensor
    opacity: torch.Tensor  # sigmoid-activated
    valid: torch.Tensor    # bool


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """[N, 4] (w, x, y, z) -> [N, 3, 3]."""
    q = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


# PyTorch's CPU kernels compute the last (numel % 32) elements of a tensor
# with scalar code, whose exp, log and sigmoid can round differently from
# the vector code's; so a gaussian's value would depend on its position in
# the tensor, and a shard of a scene (parallel/render_sharded.py) would not
# project as the whole scene does. _lanes puts every element on the vector
# path. CUDA kernels compute every element alike.
_CPU_LANES = 32


def _lanes(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` elementwise, each element computed by the same code
    whatever its position (module note above)."""
    n = x.numel()
    if x.device.type != "cpu" or n % _CPU_LANES == 0:
        return fn(x)
    flat = torch.cat([x.reshape(-1), x.new_zeros(-n % _CPU_LANES)])
    return fn(flat)[:n].reshape(x.shape)


def _sigma3_entries(log_scales: torch.Tensor, quats: torch.Tensor):
    """Unique entries of Sigma3 = R diag(exp(2s)) R^T as six [N] tensors
    (s00, s01, s02, s11, s12, s22), all elementwise."""
    q = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    e = _lanes(torch.exp, 2.0 * log_scales)
    e0, e1, e2 = e[..., 0], e[..., 1], e[..., 2]
    s00 = r00 * e0 * r00 + r01 * e1 * r01 + r02 * e2 * r02
    s01 = r00 * e0 * r10 + r01 * e1 * r11 + r02 * e2 * r12
    s02 = r00 * e0 * r20 + r01 * e1 * r21 + r02 * e2 * r22
    s11 = r10 * e0 * r10 + r11 * e1 * r11 + r12 * e2 * r12
    s12 = r10 * e0 * r20 + r11 * e1 * r21 + r12 * e2 * r22
    s22 = r20 * e0 * r20 + r21 * e1 * r21 + r22 * e2 * r22
    return s00, s01, s02, s11, s12, s22


def project(
    scene: GaussianScene,
    cam: CameraParams,
    width: int,
    height: int,
    cfg: RasterConfig = RasterConfig(),
    *,
    z_near: float = 0.2,
    z_far: float = 200.0,
    sh_degree: int | None = None,
) -> Projected:
    """Project all gaussians into one camera (differentiable)."""
    means = scene.means
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    R = cam.rot
    # -R @ pos written out elementwise: a 3-vector, and no matmul precision
    # setting can touch it
    trans = -(R[:, 0] * cam.pos[0] + R[:, 1] * cam.pos[1]
              + R[:, 2] * cam.pos[2])
    pcx = R[0, 0] * mx + R[0, 1] * my + R[0, 2] * mz + trans[0]
    pcy = R[1, 0] * mx + R[1, 1] * my + R[1, 2] * mz + trans[1]
    z = R[2, 0] * mx + R[2, 1] * my + R[2, 2] * mz + trans[2]
    valid = (z > z_near) & (z < z_far)
    zs = torch.where(valid, z, torch.ones_like(z))

    u = cam.fx * pcx / zs + width / 2.0
    v = cam.fy * pcy / zs + height / 2.0

    s00, s01, s02, s11, s12, s22 = _sigma3_entries(
        scene.log_scales, scene.quats)
    # T = J @ R_wc, with J the 2x3 perspective Jacobian; rows built directly
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    f0 = cam.fx * inv_z
    g0 = cam.fx * pcx * inv_z2
    f1 = cam.fy * inv_z
    g1 = cam.fy * pcy * inv_z2
    t00 = f0 * R[0, 0] - g0 * R[2, 0]
    t01 = f0 * R[0, 1] - g0 * R[2, 1]
    t02 = f0 * R[0, 2] - g0 * R[2, 2]
    t10 = f1 * R[1, 0] - g1 * R[2, 0]
    t11 = f1 * R[1, 1] - g1 * R[2, 1]
    t12 = f1 * R[1, 2] - g1 * R[2, 2]
    st00 = s00 * t00 + s01 * t01 + s02 * t02
    st01 = s01 * t00 + s11 * t01 + s12 * t02
    st02 = s02 * t00 + s12 * t01 + s22 * t02
    st10 = s00 * t10 + s01 * t11 + s02 * t12
    st11 = s01 * t10 + s11 * t11 + s12 * t12
    st12 = s02 * t10 + s12 * t11 + s22 * t12
    a = t00 * st00 + t01 * st01 + t02 * st02 + cfg.cov2d_blur
    b = t10 * st00 + t11 * st01 + t12 * st02
    c = t10 * st10 + t11 * st11 + t12 * st12 + cfg.cov2d_blur
    det = a * c - b * b
    valid = valid & (det > 0)
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    ca, cb, cc = c * inv_det, -b * inv_det, a * inv_det

    opacity = _lanes(torch.sigmoid, scene.opacities)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det_safe, 0.0))
    # Opacity-aware cutoff: alpha >= alpha_min is impossible beyond
    # sqrt(2 ln(opacity/alpha_min)) sigmas; opacity < alpha_min culls.
    cutoff = torch.sqrt(2.0 * _lanes(torch.log, torch.clamp_min(
        opacity / cfg.alpha_min, 1.0)))
    cutoff = torch.clamp_max(cutoff, cfg.sigma_cutoff)
    radius = cutoff * torch.sqrt(torch.clamp_min(lam1, 0.0))
    # per-axis half-extents of the cutoff ellipse {q <= cutoff^2}
    ex = cutoff * torch.sqrt(torch.clamp_min(a, 0.0))
    ey = cutoff * torch.sqrt(torch.clamp_min(c, 0.0))
    qmax = cutoff * cutoff
    valid = valid & (opacity >= cfg.alpha_min)

    valid = valid & (u + ex > 0) & (u - ex < width)
    valid = valid & (v + ey > 0) & (v - ey < height)

    red, green, blue = eval_sh_soa(
        scene.sh, mx - cam.pos[0], my - cam.pos[1], mz - cam.pos[2],
        degree=sh_degree)

    return Projected(u=u, v=v, ca=ca, cb=cb, cc=cc, depth=z, radius=radius,
                     ex=ex, ey=ey, qmax=qmax, red=red, green=green,
                     blue=blue, opacity=opacity, valid=valid)


def tile_grid(width: int, height: int, tile_size: int) -> Tuple[int, int]:
    """(tiles_x, tiles_y) for an image."""
    return (-(-width // tile_size), -(-height // tile_size))
