"""Spherical-harmonics color evaluation (torch, differentiable, degrees 0-3).

Counterpart of ``gsplat_tpu.render.sh`` with the same constants (the standard
real-SH basis) and the same operation order, so the two agree to f32 rounding.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int | None = None
            ) -> torch.Tensor:
    """sh [N, K, 3], dirs [N, 3] unit vectors -> [N, 3] colors >= 0."""
    k = sh.shape[1]
    if degree is not None:
        k = min(k, (degree + 1) ** 2)
    c = SH_C0 * sh[:, 0]
    if k > 1:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        c = c - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    if k > 4:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        c = (c + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
             + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
             + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if k > 9:
        c = (c + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
             + SH_C3[1] * xy * z * sh[:, 10]
             + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
             + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
             + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
             + SH_C3[5] * z * (xx - yy) * sh[:, 14]
             + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp_min(c + 0.5, 0.0)


def _unit(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor):
    """(x, y, z, length, 1 / max(length, 1e-12)) of the view directions
    ``dx/dy/dz`` [N]: the unit direction with a 1e-12 floor on its length."""
    nrm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    inv_n = 1.0 / torch.clamp_min(nrm, 1e-12)
    return dx * inv_n, dy * inv_n, dz * inv_n, nrm, inv_n


def _sh_sum(sh: torch.Tensor, x, y, z, k: int, ch: int) -> torch.Tensor:
    """Channel ``ch``'s SH sum over the first ``k`` coefficients plus 0.5,
    before :func:`eval_sh_soa` clamps it at 0."""
    c = SH_C0 * sh[:, 0, ch]
    if k > 1:
        c = (c - SH_C1 * y * sh[:, 1, ch] + SH_C1 * z * sh[:, 2, ch]
             - SH_C1 * x * sh[:, 3, ch])
    if k > 4:
        xx, yy, zz = x * x, y * y, z * z
        c = (c + SH_C2[0] * (x * y) * sh[:, 4, ch]
             + SH_C2[1] * (y * z) * sh[:, 5, ch]
             + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6, ch]
             + SH_C2[3] * (x * z) * sh[:, 7, ch]
             + SH_C2[4] * (xx - yy) * sh[:, 8, ch])
    if k > 9:
        c = (c + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9, ch]
             + SH_C3[1] * (x * y) * z * sh[:, 10, ch]
             + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11, ch]
             + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12, ch]
             + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13, ch]
             + SH_C3[5] * z * (xx - yy) * sh[:, 14, ch]
             + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15, ch])
    return c + 0.5


def eval_sh_soa(sh: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                dz: torch.Tensor, degree: int | None = None):
    """Structure-of-arrays form of :func:`eval_sh` used by the projection.

    ``sh`` [N, K, 3]; ``dx/dy/dz`` [N] UNnormalized view directions
    (normalized here with a 1e-12 floor). Returns three [N] color tensors."""
    k = sh.shape[1]
    if degree is not None:
        k = min(k, (degree + 1) ** 2)
    x, y, z, _, _ = _unit(dx, dy, dz)
    return tuple(torch.clamp_min(_sh_sum(sh, x, y, z, k, ch), 0.0)
                 for ch in range(3))
