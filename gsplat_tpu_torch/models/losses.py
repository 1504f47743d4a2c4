"""Photometric losses and image metrics (torch, differentiable).

Counterpart of ``gsplat_tpu.models.losses``: the standard 3DGS objective
(1-lam)*L1 + lam*(1 - SSIM) with lam = 0.2, PSNR, and SSIM with the classic
11x11 Gaussian window, sigma=1.5, as two separable passes with SAME (zero)
padding and the border renormalisation by the blurred-ones mass.

The blur is 11 shifted f32 multiply-adds per axis, not a convolution: a
float32 ``conv2d`` goes through cuDNN in TF32 on the card by default
(``torch.backends.cudnn.allow_tf32``), which keeps about three decimal
digits, while the CPU rounds in f32. Written out, the blur rounds the same
way on both devices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def l1_loss(image: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(image - target))


def l2_loss(image: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.mean((image - target) ** 2)


def psnr(image: torch.Tensor, target: torch.Tensor, max_val: float = 1.0
         ) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB."""
    mse = torch.mean((image - target) ** 2)
    return 10.0 * torch.log10(max_val * max_val / torch.clamp_min(mse, 1e-12))


@functools.lru_cache(maxsize=8)
def _gauss_window(size: int, sigma: float) -> tuple:
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    w = np.exp(-0.5 * (x / sigma) ** 2)
    return tuple(float(v) for v in (w / np.sum(w)).astype(np.float32))


def _blur(img: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [H, W, C] (SAME zero padding): along H,
    then along W, each a sum of ``size`` shifted products in f32."""
    w = _gauss_window(size, sigma)
    h, wd, _ = img.shape
    half = (size - 1) // 2
    x = F.pad(img, (0, 0, 0, 0, half, size - 1 - half))
    acc = w[0] * x[0:h]
    for k in range(1, size):
        acc = acc + w[k] * x[k:k + h]
    x = F.pad(acc, (0, 0, half, size - 1 - half))
    out = w[0] * x[:, 0:wd]
    for k in range(1, size):
        out = out + w[k] * x[:, k:k + wd]
    return out


def ssim(image: torch.Tensor, target: torch.Tensor, *, window: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over an [H, W, C] image pair (values in [0, 1]).

    Border windows are renormalised by the blurred-ones mass (SAME-padded
    zeros otherwise attenuate border means and can drive the local variance
    estimate negative)."""
    m = _blur(torch.ones_like(image[..., :1]), window, sigma)
    mu_x = _blur(image, window, sigma) / m
    mu_y = _blur(target, window, sigma) / m
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x2 = torch.clamp_min(_blur(image * image, window, sigma) / m - mu_x2,
                             0.0)
    sig_y2 = torch.clamp_min(
        _blur(target * target, window, sigma) / m - mu_y2, 0.0)
    sig_xy = _blur(image * target, window, sigma) / m - mu_xy
    num = (2.0 * mu_xy + _C1) * (2.0 * sig_xy + _C2)
    den = (mu_x2 + mu_y2 + _C1) * (sig_x2 + sig_y2 + _C2)
    return torch.mean(num / den)


def dssim_l1_loss(image: torch.Tensor, target: torch.Tensor,
                  lam: float = 0.2) -> torch.Tensor:
    """The standard 3DGS objective: (1-lam)*L1 + lam*(1 - SSIM)."""
    return (1.0 - lam) * l1_loss(image, target) + lam * (
        1.0 - ssim(image, target))
