"""Gaussian projection: the plain differentiable torch code, and two CUDA
kernels, its forward and its backward.

Counterpart of ``gsplat_tpu.render.projection``: quat -> rotation -> Sigma3,
camera transform, perspective Jacobian, Sigma2 = (J W) Sigma3 (J W)^T + blur,
conic, opacity-aware cutoff, culling mask, SH colour. :func:`_project_plain`
keeps the JAX package's elementwise structure-of-arrays form (every field
[N], no [N, 3, 3] matmul), so no matrix product and therefore no TF32
rounding can enter on the card; autograd derives its VJP. Semantics are
those of the NumPy oracle ``gsplat_tpu/ref/rasterizer.py``.

:func:`project` chooses from what its inputs show. CUDA tensors take one
launch of ``csrc/project.cu``, equal to the plain code bit for bit; where
the call records a gradient of the scene's fields, that launch is the
forward of an ``autograd.Function`` whose backward is one launch of
``csrc/project_bwd.cu`` (:func:`project_bwd`), the analytic VJP that
:func:`_project_vjp_plain` writes out in plain torch and that the kernel
equals bit for bit. CPU tensors, and calls where a camera tensor requires
grad (the kernels compute no camera gradient), take the plain code and
autograd.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.config import RasterConfig
from gsplat_tpu_torch.io.cameras import Camera
from gsplat_tpu_torch.render.sh import (SH_C0, SH_C1, SH_C2, SH_C3, _sh_sum,
                                        _unit, eval_sh_soa)
from gsplat_tpu_torch.scene import (DeviceLike, GaussianScene, SceneParams,
                                   resolve_device)
from gsplat_tpu_torch.utils.profiling import span


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


def _rotation_scales(log_scales: torch.Tensor, quats: torch.Tensor):
    """The unit quaternion's four [N] components (w, x, y, z) and the
    quaternion's norm [N, 1]; R = quat_to_rotmat's nine entries, row-major;
    and exp(2 s)'s three: what Sigma3 is made of, all elementwise."""
    norm = torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    q = quats / norm
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
    return ((w, x, y, z), norm, (r00, r01, r02, r10, r11, r12, r20, r21, r22),
            (e[..., 0], e[..., 1], e[..., 2]))


def _sigma3_entries(rq, e):
    """Unique entries of Sigma3 = R diag(e) R^T as six [N] tensors
    (s00, s01, s02, s11, s12, s22), from :func:`_rotation_scales`' R and
    e."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rq
    e0, e1, e2 = e
    s00 = r00 * e0 * r00 + r01 * e1 * r01 + r02 * e2 * r02
    s01 = r00 * e0 * r10 + r01 * e1 * r11 + r02 * e2 * r12
    s02 = r00 * e0 * r20 + r01 * e1 * r21 + r02 * e2 * r22
    s11 = r10 * e0 * r10 + r11 * e1 * r11 + r12 * e2 * r12
    s12 = r10 * e0 * r20 + r11 * e1 * r21 + r12 * e2 * r22
    s22 = r20 * e0 * r20 + r21 * e1 * r21 + r22 * e2 * r22
    return s00, s01, s02, s11, s12, s22


class _Geometry(NamedTuple):
    """What :func:`_geometry` computes of one projection, every tensor [N]
    (``norm`` [N, 1]): the camera-space mean, the depth range, the pixel
    position, Sigma3's parts (:func:`_rotation_scales`) and entries, the
    perspective Jacobian's rows T = J R (``t``: t00, t01, t02, t10, t11,
    t12) and Sigma3 T^T's columns (``st``, in the same order), and Sigma2 =
    [[a, b], [b, c]] with its determinant."""

    mx: torch.Tensor
    my: torch.Tensor
    mz: torch.Tensor
    pcx: torch.Tensor
    pcy: torch.Tensor
    z: torch.Tensor
    in_depth: torch.Tensor   # bool: z_near < z < z_far
    zs: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    quat: tuple
    norm: torch.Tensor
    rq: tuple
    e: tuple
    s: tuple
    inv_z: torch.Tensor
    inv_z2: torch.Tensor
    f0: torch.Tensor
    g0: torch.Tensor
    f1: torch.Tensor
    g1: torch.Tensor
    t: tuple
    st: tuple
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    det: torch.Tensor
    det_safe: torch.Tensor
    inv_det: torch.Tensor


def _geometry(scene: GaussianScene, cam: CameraParams, width: int,
              height: int, cfg: RasterConfig, *, z_near: float,
              z_far: float) -> _Geometry:
    """The first half of :func:`_project_plain`: the projection up to
    Sigma2's inverse determinant (differentiable), the values the backward
    recomputes."""
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
    in_depth = (z > z_near) & (z < z_far)
    zs = torch.where(in_depth, z, torch.ones_like(z))

    u = cam.fx * pcx / zs + width / 2.0
    v = cam.fy * pcy / zs + height / 2.0

    quat, norm, rq, e = _rotation_scales(scene.log_scales, scene.quats)
    s00, s01, s02, s11, s12, s22 = s = _sigma3_entries(rq, e)
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
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    return _Geometry(
        mx=mx, my=my, mz=mz, pcx=pcx, pcy=pcy, z=z, in_depth=in_depth, zs=zs,
        u=u, v=v, quat=quat, norm=norm, rq=rq, e=e, s=s, inv_z=inv_z,
        inv_z2=inv_z2, f0=f0, g0=g0, f1=f1, g1=g1,
        t=(t00, t01, t02, t10, t11, t12),
        st=(st00, st01, st02, st10, st11, st12), a=a, b=b, c=c, det=det,
        det_safe=det_safe, inv_det=inv_det)


def _project_plain(scene: GaussianScene, cam: CameraParams, width: int,
                   height: int, cfg: RasterConfig, *, z_near: float,
                   z_far: float, sh_degree: int | None) -> Projected:
    """Plain PyTorch version of :func:`project` (differentiable)."""
    geo = _geometry(scene, cam, width, height, cfg, z_near=z_near,
                    z_far=z_far)
    a, b, c, det_safe, inv_det = (geo.a, geo.b, geo.c, geo.det_safe,
                                  geo.inv_det)
    u, v = geo.u, geo.v
    valid = geo.in_depth & (geo.det > 0)
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
        scene.sh, geo.mx - cam.pos[0], geo.my - cam.pos[1],
        geo.mz - cam.pos[2], degree=sh_degree)

    return Projected(u=u, v=v, ca=ca, cb=cb, cc=cc, depth=geo.z,
                     radius=radius, ex=ex, ey=ey, qmax=qmax, red=red,
                     green=green, blue=blue, opacity=opacity, valid=valid)


def _records_grad(scene: GaussianScene, cam: CameraParams) -> bool:
    """Whether autograd records through a projection of these inputs."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (scene.means, scene.log_scales, scene.quats,
                                  scene.opacities, scene.sh, *cam))


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies where the projection's kernels run: the grad rule
    of :func:`project` reads it (the wrappers take the plain versions for
    CPU tensors)."""
    return t.device.type == "cuda"


def _sh_bands(k: int, sh_degree: int | None) -> int:
    """SH bands past the DC term that :func:`eval_sh_soa` evaluates."""
    if sh_degree is not None:
        k = min(k, (sh_degree + 1) ** 2)
    return sum(k > b for b in (1, 4, 9))


# project's differentiable outputs, in the order its backward takes their
# gradients
GRAD_FIELDS = ("u", "v", "ca", "cb", "cc", "depth", "red", "green", "blue",
               "opacity")

# the SH basis' derivative constants (render/sh.py's times a small
# integer): the f32 of the double product, as csrc/project_bwd.cu takes them
_D2_2M2, _D2_2P4 = -2.0 * SH_C2[2], 4.0 * SH_C2[2]
_D2_4P2, _D2_4M2 = 2.0 * SH_C2[4], -2.0 * SH_C2[4]
_D3_0P6, _D3_0P3 = 6.0 * SH_C3[0], 3.0 * SH_C3[0]
_D3_2M2, _D3_2P8 = -2.0 * SH_C3[2], 8.0 * SH_C3[2]
_D3_3M6, _D3_3P3 = -6.0 * SH_C3[3], 3.0 * SH_C3[3]
_D3_4M2, _D3_4P8 = -2.0 * SH_C3[4], 8.0 * SH_C3[4]
_D3_5P2, _D3_5M2 = 2.0 * SH_C3[5], -2.0 * SH_C3[5]
_D3_6P3, _D3_6M6 = 3.0 * SH_C3[6], -6.0 * SH_C3[6]


@torch.no_grad()
def _project_vjp_plain(scene, cam: CameraParams, cfg: RasterConfig, grads,
                       *, z_near: float, z_far: float,
                       sh_degree: int | None) -> SceneParams:
    """Plain PyTorch version of :func:`project_bwd`: the analytic VJP of
    :func:`_project_plain` (its differentiable outputs, ``GRAD_FIELDS``)
    with respect to the scene's five float fields, one elementwise
    operation for each of ``csrc/project_bwd.cu``'s, in its order.

    ``scene`` has the five fields; ``grads`` holds an [N] tensor (any
    stride) or None (zeros) for each of ``GRAD_FIELDS``. The forward values
    are recomputed by :func:`_geometry` and ``render/sh.py``. Where
    PyTorch's derivative picks a branch, so does this: the colour's
    ``clamp_min`` passes where c + 0.5 >= 0, the depth range's and the
    determinant's ``where`` where they hold, the view direction's 1e-12
    floor cuts its normalisation's term. Gaussians whose ten gradients are
    all 0 get zero rows; SH bands past ``sh_degree`` get zeros."""
    geo = _geometry(scene, cam, 0, 0, cfg, z_near=z_near, z_far=z_far)
    zero = torch.zeros_like(geo.z)
    gu, gv, gca, gcb, gcc, gdepth, gr, gg, gb, gop = (
        zero if g is None else g for g in grads)
    live = zero.bool()
    for g in (gu, gv, gca, gcb, gcc, gdepth, gr, gg, gb, gop):
        live = live | (g != 0)
    a, b, c, inv_det = geo.a, geo.b, geo.c, geo.inv_det

    # conic = (c, -b, a) / det_safe
    g_inv = (gca * c - gcb * b) + gcc * a
    g_det = torch.where(geo.det > 0, -(g_inv * (inv_det * inv_det)), 0.0)
    g_a = gcc * inv_det + g_det * c
    g_b = -(gcb * inv_det) - 2.0 * (g_det * b)
    g_c = gca * inv_det + g_det * a

    # Sigma2 = T Sigma3 T^T: Sigma3's gradient as the symmetric
    # gS = T^T [[g_a, g_b / 2], [g_b / 2, g_c]] T
    hb = 0.5 * g_b
    t0, t1, st0, st1 = geo.t[:3], geo.t[3:], geo.st[:3], geo.st[3:]
    w0 = [g_a * t0[k] + hb * t1[k] for k in range(3)]
    w1 = [hb * t0[k] + g_c * t1[k] for k in range(3)]
    g_t0 = [2.0 * (g_a * st0[k]) + g_b * st1[k] for k in range(3)]
    g_t1 = [2.0 * (g_c * st1[k]) + g_b * st0[k] for k in range(3)]
    gS = [[None] * 3 for _ in range(3)]
    for j in range(3):
        for k in range(j, 3):
            gS[j][k] = gS[k][j] = t0[j] * w0[k] + t1[j] * w1[k]

    # Sigma3 = R_q E R_q^T: P = gS R_q, g_Rq = 2 P E, g_e = diag(R_q^T P)
    R, e = geo.rq, geo.e
    gR = [None] * 9
    g_ls = []
    for k in range(3):
        P = [(gS[j][0] * R[k] + gS[j][1] * R[3 + k]) + gS[j][2] * R[6 + k]
             for j in range(3)]
        for j in range(3):
            gR[3 * j + k] = 2.0 * (P[j] * e[k])
        g_e = (R[k] * P[0] + R[3 + k] * P[1]) + R[6 + k] * P[2]
        g_ls.append(2.0 * (g_e * e[k]))

    # R_q from the unit quaternion, then its normalisation
    qw, qx, qy, qz = geo.quat
    gqw = 2.0 * ((qz * (gR[3] - gR[1]) + qy * (gR[2] - gR[6]))
                 + qx * (gR[7] - gR[5]))
    gqx = 2.0 * (((qy * (gR[1] + gR[3]) + qz * (gR[2] + gR[6]))
                  + qw * (gR[7] - gR[5])) - 2.0 * (qx * (gR[4] + gR[8])))
    gqy = 2.0 * (((qx * (gR[1] + gR[3]) + qz * (gR[5] + gR[7]))
                  + qw * (gR[2] - gR[6])) - 2.0 * (qy * (gR[0] + gR[8])))
    gqz = 2.0 * (((qx * (gR[2] + gR[6]) + qy * (gR[5] + gR[7]))
                  + qw * (gR[3] - gR[1])) - 2.0 * (qz * (gR[0] + gR[4])))
    dot = ((gqw * qw + gqx * qx) + gqy * qy) + gqz * qz
    norm = geo.norm[:, 0]
    g_q = [(gq - dot * q) / norm
           for gq, q in zip((gqw, gqx, gqy, gqz), geo.quat)]

    # T = J R: its rows from f0 = fx / zs, g0 = fx pcx / zs^2 (and f1, g1)
    r = cam.rot
    g_f0 = (g_t0[0] * r[0, 0] + g_t0[1] * r[0, 1]) + g_t0[2] * r[0, 2]
    g_g0 = -((g_t0[0] * r[2, 0] + g_t0[1] * r[2, 1]) + g_t0[2] * r[2, 2])
    g_f1 = (g_t1[0] * r[1, 0] + g_t1[1] * r[1, 1]) + g_t1[2] * r[1, 2]
    g_g1 = -((g_t1[0] * r[2, 0] + g_t1[1] * r[2, 1]) + g_t1[2] * r[2, 2])
    g_pcx = gu * geo.f0 + g_g0 * (cam.fx * geo.inv_z2)
    g_pcy = gv * geo.f1 + g_g1 * (cam.fy * geo.inv_z2)
    g_zs = -((gu * geo.g0 + gv * geo.g1)
             + ((g_f0 * geo.f0 + g_f1 * geo.f1)
                + 2.0 * (g_g0 * geo.g0 + g_g1 * geo.g1)) * geo.inv_z)
    g_z = torch.where(geo.in_depth, g_zs, 0.0) + gdepth

    # the colour: clamp_min(c + 0.5, 0) passes where c + 0.5 >= 0
    sh = scene.sh
    keval = (1, 4, 9, 16)[_sh_bands(sh.shape[1], sh_degree)]
    x, y, z, nrm, inv_n = _unit(geo.mx - cam.pos[0], geo.my - cam.pos[1],
                                geo.mz - cam.pos[2])
    gcol = [torch.where(_sh_sum(sh, x, y, z, keval, ch) >= 0, g, 0.0)
            for ch, g in enumerate((gr, gg, gb))]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    basis = [SH_C0, -(SH_C1 * y), SH_C1 * z, -(SH_C1 * x),
             SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy),
             SH_C2[3] * xz, SH_C2[4] * (xx - yy),
             SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
             SH_C3[2] * y * (4 * zz - xx - yy),
             SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
             SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
             SH_C3[6] * x * (xx - 3 * yy)]

    # the direction's gradient: sum_k (sum_ch gcol sh[k, ch]) d basis_k
    vk = [None] + [(gcol[0] * sh[:, k, 0] + gcol[1] * sh[:, k, 1])
                   + gcol[2] * sh[:, k, 2] for k in range(1, keval)]
    gx = gy = gz = zero
    if keval > 1:
        gx, gy, gz = -SH_C1 * vk[3], -SH_C1 * vk[1], SH_C1 * vk[2]
    if keval > 4:
        gx = gx + (SH_C2[0] * y) * vk[4]
        gy = gy + (SH_C2[0] * x) * vk[4]
        gy = gy + (SH_C2[1] * z) * vk[5]
        gz = gz + (SH_C2[1] * y) * vk[5]
        gx = gx + (_D2_2M2 * x) * vk[6]
        gy = gy + (_D2_2M2 * y) * vk[6]
        gz = gz + (_D2_2P4 * z) * vk[6]
        gx = gx + (SH_C2[3] * z) * vk[7]
        gz = gz + (SH_C2[3] * x) * vk[7]
        gx = gx + (_D2_4P2 * x) * vk[8]
        gy = gy + (_D2_4M2 * y) * vk[8]
    if keval > 9:
        gx = gx + (_D3_0P6 * xy) * vk[9]
        gy = gy + (_D3_0P3 * (xx - yy)) * vk[9]
        gx = gx + (SH_C3[1] * yz) * vk[10]
        gy = gy + (SH_C3[1] * xz) * vk[10]
        gz = gz + (SH_C3[1] * xy) * vk[10]
        gx = gx + (_D3_2M2 * xy) * vk[11]
        gy = gy + (SH_C3[2] * (4 * zz - xx - 3 * yy)) * vk[11]
        gz = gz + (_D3_2P8 * yz) * vk[11]
        gx = gx + (_D3_3M6 * xz) * vk[12]
        gy = gy + (_D3_3M6 * yz) * vk[12]
        gz = gz + (_D3_3P3 * (2 * zz - xx - yy)) * vk[12]
        gx = gx + (SH_C3[4] * (4 * zz - 3 * xx - yy)) * vk[13]
        gy = gy + (_D3_4M2 * xy) * vk[13]
        gz = gz + (_D3_4P8 * xz) * vk[13]
        gx = gx + (_D3_5P2 * xz) * vk[14]
        gy = gy + (_D3_5M2 * yz) * vk[14]
        gz = gz + (SH_C3[5] * (xx - yy)) * vk[14]
        gx = gx + (_D3_6P3 * (xx - yy)) * vk[15]
        gy = gy + (_D3_6M6 * xy) * vk[15]
    # x = dx / max(|d|, 1e-12): below the floor only the direct term
    dd = (gx * x + gy * y) + gz * z
    above = nrm >= 1e-12
    g_dir = [torch.where(above, gd - dd * d, gd) * inv_n
             for gd, d in ((gx, x), (gy, y), (gz, z))]

    # the camera-space mean is R m + t; the direction is m - pos
    g_mean = [((r[0, k] * g_pcx + r[1, k] * g_pcy) + r[2, k] * g_z)
              + g_dir[k] for k in range(3)]

    # opacity = sigmoid(logit)
    op = _lanes(torch.sigmoid, scene.opacities)
    g_o = gop * (op * (1.0 - op))

    k_all = sh.shape[1]
    g_sh = torch.stack([
        torch.stack([gcol[ch] * basis[k] for ch in range(3)], -1)
        if k < keval else torch.zeros(len(zero), 3, dtype=zero.dtype,
                                      device=zero.device)
        for k in range(k_all)], 1)
    keep = lambda t: torch.where(live.view(-1, *([1] * (t.dim() - 1))), t,
                                 0.0)
    return SceneParams(keep(torch.stack(g_mean, 1)),
                       keep(torch.stack(g_ls, 1)), keep(torch.stack(g_q, 1)),
                       keep(g_o), keep(g_sh))


def _check_inputs(scene, cam: CameraParams) -> None:
    """The inputs the kernels take: contiguous f32 scene fields and camera
    tensors of :func:`project`'s shapes, on one device."""
    means, sh = scene.means, scene.sh
    n = means.shape[0]
    shapes = ((means, (n, 3)), (scene.log_scales, (n, 3)),
              (scene.quats, (n, 4)), (scene.opacities, (n,)),
              (cam.rot, (3, 3)), (cam.pos, (3,)), (cam.fx, ()),
              (cam.fy, ()))
    tensors = [t for t, _ in shapes] + [sh]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("project takes f32 scene and camera tensors")
    if any(t.shape != shape for t, shape in shapes) or not (
            sh.dim() == 3 and sh.shape[0] == n and sh.shape[2] == 3
            and sh.shape[1] in (1, 4, 9, 16)):
        raise ValueError("project takes means, log_scales [N, 3], quats "
                         "[N, 4], opacities [N], sh [N, K, 3] with K in "
                         "(1, 4, 9, 16), rot [3, 3], pos [3], fx, fy []")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("project takes contiguous tensors")
    if any(t.device != means.device for t in tensors):
        raise ValueError("project takes tensors on one device")
    if means.device.type not in ("cpu", "cuda"):
        raise ValueError(f"project: no kernel for {means.device}")
    if n >= 2 ** 31:
        raise ValueError("project takes fewer than 2^31 gaussians")


class _Static(NamedTuple):
    """:func:`project`'s arguments that are not tensors."""

    width: int
    height: int
    cfg: RasterConfig
    z_near: float
    z_far: float
    sh_degree: int | None


def _project_fields(scene, cam: CameraParams, st: _Static) -> Projected:
    """The projection of checked inputs without a gradient: the plain code
    for CPU tensors, one launch of ``csrc/project.cu`` for CUDA tensors."""
    kw = dict(z_near=st.z_near, z_far=st.z_far, sh_degree=st.sh_degree)
    if scene.means.device.type == "cpu":
        return _project_plain(scene, cam, st.width, st.height, st.cfg, **kw)
    means, sh = scene.means, scene.sh
    n = means.shape[0]
    out = torch.empty(len(Projected._fields) - 1, n, device=means.device)
    valid = torch.empty(n, dtype=torch.bool, device=means.device)
    if n > 0:
        fn = _kernels.function("project")
        cfg = st.cfg
        # opacity / alpha_min on the card is opacity * f32(1 / alpha_min),
        # the reciprocal taken in double: the kernel takes it as an argument
        err = fn(means.data_ptr(), scene.log_scales.data_ptr(),
                 scene.quats.data_ptr(), scene.opacities.data_ptr(),
                 sh.data_ptr(), n, sh.shape[1],
                 _sh_bands(sh.shape[1], st.sh_degree),
                 *(t.data_ptr() for t in cam), st.width, st.height,
                 st.z_near, st.z_far, cfg.cov2d_blur, cfg.alpha_min,
                 1.0 / cfg.alpha_min, cfg.sigma_cutoff, out.data_ptr(),
                 valid.data_ptr(), _kernels.stream(means.device))
        project.launches += 1
        _kernels.check("project", err)
    return Projected(*out.unbind(0), valid=valid)


class _ProjectFunction(torch.autograd.Function):
    """:func:`project` with a gradient for the scene's five fields: forward
    :func:`_project_fields` (one launch of ``csrc/project.cu`` on the card),
    backward :func:`project_bwd` (one launch of ``csrc/project_bwd.cu``,
    span ``gsplat.project_bwd``, on autograd's thread). Only the inputs are
    saved; the backward recomputes the rest. ``radius``, ``ex``, ``ey``,
    ``qmax`` and ``valid`` are not differentiable; a gradient autograd does
    not materialise reaches the kernel as a null pointer."""

    @staticmethod
    def forward(ctx, means, log_scales, quats, opacities, sh, rot, pos, fx,
                fy, st: _Static):
        out = _project_fields(
            SceneParams(means, log_scales, quats, opacities, sh),
            CameraParams(rot, pos, fx, fy), st)
        ctx.st = st
        ctx.save_for_backward(means, log_scales, quats, opacities, sh, rot,
                              pos, fx, fy)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(out.radius, out.ex, out.ey, out.qmax,
                                    out.valid)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        st = ctx.st
        by_name = dict(zip(Projected._fields, grads))
        with span("gsplat.project_bwd"):
            g = project_bwd(SceneParams(*saved[:5]), CameraParams(*saved[5:]),
                            [by_name[f] for f in GRAD_FIELDS], st.cfg,
                            z_near=st.z_near, z_far=st.z_far,
                            sh_degree=st.sh_degree)
        return (*(gi if need else None
                  for gi, need in zip(g, ctx.needs_input_grad)),
                None, None, None, None, None)


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
    """Project all gaussians into one camera.

    The rule follows the inputs. Where autograd records (grad mode on and
    any of the scene's five float fields or the camera's tensors requiring
    grad) and the tensors are on the CPU or a camera tensor requires grad,
    this is the plain differentiable code, :func:`_project_plain`, whose
    VJP autograd derives (the kernels compute no camera gradient). Otherwise
    the inputs must be contiguous f32: means and log-scales [N, 3],
    quaternions [N, 4], opacities [N], SH [N, K, 3] with K in 1, 4, 9, 16,
    the camera's rotation [3, 3], position [3] and focal lengths [], all on
    one device. CUDA tensors take one launch of ``csrc/project.cu`` (one
    thread a gaussian, its rows staged through shared memory with 16-byte
    loads; bound by bytes), whose fields are rows of one [14, N] array and
    equal the plain code's bit for bit; CPU tensors without a gradient the
    plain code. Where the CUDA call records a gradient it is one
    ``torch.autograd.Function`` (:class:`_ProjectFunction`): ``u``, ``v``,
    ``ca``, ``cb``, ``cc``, ``depth``, ``red``, ``green``, ``blue`` and
    ``opacity`` are differentiable, and the backward is one launch of
    ``csrc/project_bwd.cu`` (:func:`project_bwd`); ``radius``, ``ex``,
    ``ey``, ``qmax`` (whose derivative is infinite where the cutoff is 0)
    and ``valid`` are not. Replaces XLA glue, not a Pallas kernel."""
    grad = _records_grad(scene, cam)
    if grad and (not _on_card(scene.means)
                 or any(t.requires_grad for t in cam)):
        return _project_plain(scene, cam, width, height, cfg, z_near=z_near,
                              z_far=z_far, sh_degree=sh_degree)
    _check_inputs(scene, cam)
    st = _Static(width, height, cfg, z_near, z_far, sh_degree)
    if not grad:
        return _project_fields(scene, cam, st)
    return Projected(*_ProjectFunction.apply(
        scene.means, scene.log_scales, scene.quats, scene.opacities,
        scene.sh, *cam, st))


project.launches = 0


def project_bwd(scene, cam: CameraParams, grads,
                cfg: RasterConfig = RasterConfig(), *, z_near: float = 0.2,
                z_far: float = 200.0, sh_degree: int | None = None
                ) -> SceneParams:
    """The gradients of the scene's five float fields from those of
    :func:`project`'s differentiable outputs: ``grads`` holds, for each of
    ``GRAD_FIELDS``, an f32 [N] tensor of any stride on the inputs' device,
    or None for zeros. The inputs as :func:`project` takes them (``scene``
    needs the five fields only). CPU tensors take the plain version
    :func:`_project_vjp_plain`; CUDA tensors one launch of
    ``csrc/project_bwd.cu``, equal to it bit for bit, with no copy of the
    strided gradients. Returns contiguous [N, 3], [N, 3], [N, 4], [N] and
    [N, K, 3] tensors."""
    _check_inputs(scene, cam)
    means, sh = scene.means, scene.sh
    n = means.shape[0]
    if len(grads) != len(GRAD_FIELDS) or any(
            g is not None and (g.dtype != torch.float32 or g.shape != (n,)
                               or g.device != means.device) for g in grads):
        raise ValueError("project_bwd takes an f32 [N] gradient or None for "
                         f"each of {GRAD_FIELDS} on the inputs' device")
    kw = dict(z_near=z_near, z_far=z_far, sh_degree=sh_degree)
    if means.device.type == "cpu":
        return _project_vjp_plain(scene, cam, cfg, grads, **kw)
    out = SceneParams(*(torch.empty(t.shape, device=means.device)
                        for t in (means, scene.log_scales, scene.quats,
                                  scene.opacities, sh)))
    if n > 0:
        fn = _kernels.function("project_bwd")
        ptrs = (ctypes.c_void_p * len(grads))(
            *(None if g is None else g.data_ptr() for g in grads))
        strides = (ctypes.c_longlong * len(grads))(
            *(0 if g is None else g.stride(0) for g in grads))
        err = fn(means.data_ptr(), scene.log_scales.data_ptr(),
                 scene.quats.data_ptr(), scene.opacities.data_ptr(),
                 sh.data_ptr(), n, sh.shape[1],
                 _sh_bands(sh.shape[1], sh_degree),
                 *(t.data_ptr() for t in cam), z_near, z_far,
                 cfg.cov2d_blur, ptrs, strides,
                 *(t.data_ptr() for t in out), _kernels.stream(means.device))
        project_bwd.launches += 1
        _kernels.check("project_bwd", err)
    return out


project_bwd.launches = 0


def tile_grid(width: int, height: int, tile_size: int) -> Tuple[int, int]:
    """(tiles_x, tiles_y) for an image."""
    return (-(-width // tile_size), -(-height // tile_size))
