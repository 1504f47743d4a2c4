"""One training step of 3D Gaussian Splatting in plain PyTorch: the render
of one view, the photometric loss, the gradient of the loss with respect to
every gaussian's 59 floats, and one Adam update (Kerbl et al. 2023, with
the loss, rates and Adam constants of the configuration's ``fit`` group).

- Render: :mod:`benchmark.reference.render`'s projection, binning and
  compositing; the image is the composite plus T times the background.
- Loss: (1 - lambda) L1 + lambda (1 - SSIM). SSIM is the mean over pixels
  and channels of ((2 mu_x mu_y + C1)(2 s_xy + C2)) / ((mu_x^2 + mu_y^2 +
  C1)(s_x^2 + s_y^2 + C2)), each local moment a separable gaussian blur
  (``window`` taps of ``sigma``) with zero padding divided by the blur of
  ones, the variances clamped at 0. A blur is a product with a banded
  matrix, taken through :class:`render.Precision`.
- Gradient, in blocks so that memory stays bounded at a real frame's size:
  the loss and its gradient with respect to the image over the whole image;
  then, a block of tiles at a time, the same compositing with autograd,
  whose gradient is that of the block's pixels, summed into the gradient
  of the projected table; then the projection's own gradient over every
  gaussian.
- Adam: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, and p += -lr
  scale m^ / (sqrt(v^) + eps) with m^ = m / (1 - b1^t), v^ = v / (1 -
  b2^t), t the update's count from 1; the constants and the bias
  corrections in f32, the configuration's precision.

It imports nothing of the program under test, nor JAX or ``gsplat_tpu``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from benchmark.reference import render
from benchmark.reference.render import F32, Precision

FIELDS = ("means", "log_scales", "quats", "opacities", "sh")
# (tile, batch) pairs a block of the gradient holds at once: each keeps
# about a dozen [1024, 64] f32 tensors for autograd, ~3 MB
BLOCK_PAIRS = 2048


class Step(NamedTuple):
    image: torch.Tensor               # [H, W, 3]
    loss: float
    grads: Dict[str, torch.Tensor]    # by field, the parameters' shapes
    params: Dict[str, torch.Tensor]   # after the update


def _blur_matrix(n: int, window: int, sigma: float, device) -> torch.Tensor:
    """[n, n] f32: row i holds the normalised gaussian taps at columns
    i - window // 2 .. i + window // 2 (zero padding: taps past the edge
    fall away)."""
    x = np.arange(window, dtype=np.float64) - (window - 1) / 2.0
    w = np.exp(-0.5 * (x / sigma) ** 2)
    w = torch.tensor(w / w.sum(), dtype=torch.float32, device=device)
    half = (window - 1) // 2
    i = torch.arange(n, device=device)
    d = i[None, :] - i[:, None] + half
    inside = (d >= 0) & (d < window)
    return torch.where(inside, w[d.clamp(0, window - 1)],
                       torch.zeros((), device=device))


def _blur(x: torch.Tensor, gh: torch.Tensor, gw: torch.Tensor,
          prec: Precision) -> torch.Tensor:
    """[H, W, C] blurred along H, then along W."""
    h, w, c = x.shape
    y = prec.mm(gh, x.reshape(h, w * c)).reshape(h, w, c)
    y = prec.mm(gw, y.permute(1, 0, 2).reshape(w, h * c))
    return y.reshape(w, h, c).permute(1, 0, 2)


def ssim(img: torch.Tensor, target: torch.Tensor, ssim_cfg: dict,
         prec: Precision = F32) -> torch.Tensor:
    h, w, _ = img.shape
    gh = _blur_matrix(h, ssim_cfg["window"], ssim_cfg["sigma"], img.device)
    gw = _blur_matrix(w, ssim_cfg["window"], ssim_cfg["sigma"], img.device)
    blur = lambda x: _blur(x, gh, gw, prec)
    mass = blur(torch.ones_like(img[..., :1]))
    mx, my = blur(img) / mass, blur(target) / mass
    sx = torch.clamp_min(blur(img * img) / mass - mx * mx, 0.0)
    sy = torch.clamp_min(blur(target * target) / mass - my * my, 0.0)
    sxy = blur(img * target) / mass - mx * my
    c1, c2 = ssim_cfg["c1"], ssim_cfg["c2"]
    return torch.mean((2 * mx * my + c1) * (2 * sxy + c2)
                      / ((mx * mx + my * my + c1) * (sx + sy + c2)))


def loss_fn(img: torch.Tensor, target: torch.Tensor, fit: dict,
            prec: Precision = F32) -> torch.Tensor:
    lam = fit["lambda_dssim"]
    return ((1 - lam) * torch.mean(torch.abs(img - target))
            + lam * (1 - ssim(img, target, fit["ssim"], prec)))


def _to_tiles(x: torch.Tensor, stream: render.Stream) -> torch.Tensor:
    """[H, W, C] -> [T, P, C], zero past the image (the inverse of
    ``render._to_image``)."""
    ts, tx, ty = stream.tile, stream.tiles_x, stream.tiles_y
    h, w, c = x.shape
    pad = x.new_zeros(ty * ts, tx * ts, c)
    pad[:h, :w] = x
    return pad.reshape(ty, ts, tx, ts, c).permute(0, 2, 1, 3, 4).reshape(
        tx * ty, ts * ts, c)


def composite(table: torch.Tensor, stream: render.Stream,
              tiles: torch.Tensor, raster: dict, prec: Precision = F32):
    """(rgb [A, P, 3], T [A, P], batches run [A]) of ``tiles`` [A], with
    ``render.blend``'s batches and stop rule; differentiable in ``table``
    where it requires grad."""
    dev = table.device
    chunk, eps = raster["chunk"], raster["early_stop_eps"]
    n, npx = tiles.numel(), stream.tile ** 2
    px, py = render._pixels(stream, dev, table.dtype)
    x0, y0 = render._origins(stream, tiles, table.dtype)
    trans = torch.ones(n, npx, device=dev, dtype=table.dtype)
    rgb = torch.zeros(n, npx, 3, device=dev, dtype=table.dtype)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    ran = torch.zeros(n, dtype=torch.long, device=dev)
    count = stream.count[tiles]
    start = stream.start[tiles]
    k_ar = torch.arange(chunk, device=dev)
    nb = -(-int(count.max()) // chunk) if n else 0
    for k in range(nb):
        alive &= trans.detach().amax(dim=1) >= eps
        act = (alive & (count > k * chunk)).nonzero()[:, 0]
        if act.numel() == 0:
            break
        ran[act] += 1
        pos = start[act, None] + k * chunk + k_ar
        mask = (k * chunk + k_ar) < count[act, None]
        g = torch.where(mask, stream.gauss[torch.where(mask, pos, 0)], 0)
        dc, t1, _, _, _, _ = render._batch(table[g], mask, trans[act],
                                           x0[act], y0[act], px, py, raster,
                                           prec)
        rgb = rgb.index_put((act,), rgb[act] + dc)
        trans = trans.index_put((act,), t1)
    return rgb, trans, ran


def _blocks(ran: torch.Tensor):
    """Tiles in blocks of at most BLOCK_PAIRS (tile, batch) pairs (a tile
    with more is a block alone), in order of batches run."""
    order = torch.argsort(ran, descending=True, stable=True).tolist()
    runs = ran.tolist()
    block, pairs = [], 0
    for t in order:
        if runs[t] == 0:
            break
        if block and pairs + runs[t] > BLOCK_PAIRS:
            yield block
            block, pairs = [], 0
        block.append(t)
        pairs += runs[t]
    if block:
        yield block


def step(params: Dict[str, torch.Tensor], mu: Dict[str, torch.Tensor],
         nu: Dict[str, torch.Tensor], count: int, cam: render.Cam,
         target: torch.Tensor, background: torch.Tensor, fit: dict,
         raster: dict, prec: Precision = F32) -> Step:
    """One step from the state (``params``, Adam's ``mu``, ``nu`` and
    ``count`` of updates made) on the view ``cam`` against ``target``."""
    dev = target.device
    leaves = {f: params[f].detach().clone().requires_grad_(True)
              for f in FIELDS}
    proj = render.project(leaves, cam, raster, prec)
    stream = render.bin_tiles(proj, cam.width, cam.height, raster["tile"])
    table = proj.table.detach().requires_grad_(True)
    all_tiles = torch.arange(stream.tiles_x * stream.tiles_y, device=dev)
    with torch.no_grad():
        rgb, trans, ran = composite(table, stream, all_tiles, raster, prec)
        to_img = lambda x: render._to_image(x, stream, cam.width, cam.height)
        image = to_img(rgb) + to_img(trans[..., None]) * background
    img = image.clone().requires_grad_(True)
    loss = loss_fn(img, target, fit, prec)
    (g_img,) = torch.autograd.grad(loss, img)
    g_rgb = _to_tiles(g_img, stream)
    g_trans = _to_tiles((g_img * background).sum(-1, keepdim=True),
                        stream)[..., 0]
    del rgb, trans
    for block in _blocks(ran):
        tiles = torch.tensor(block, device=dev)
        b_rgb, b_trans, _ = composite(table, stream, tiles, raster, prec)
        torch.autograd.backward([b_rgb, b_trans],
                                [g_rgb[tiles], g_trans[tiles]])
        del b_rgb, b_trans
    g_table = table.grad if table.grad is not None else torch.zeros_like(
        table)
    grads = dict(zip(FIELDS, torch.autograd.grad(
        proj.table, [leaves[f] for f in FIELDS], g_table)))
    del proj, table, leaves
    return Step(image, float(loss.detach()), grads,
                adam(params, grads, mu, nu, count, fit))


@torch.no_grad()
def adam(params, grads, mu, nu, count: int, fit: dict):
    """The parameters after one Adam update (module docstring)."""
    a = fit["adam"]
    t = np.float32(count + 1)
    bc1 = float(np.float32(1) - np.float32(a["b1"]) ** t)
    bc2 = float(np.float32(1) - np.float32(a["b2"]) ** t)
    lr = float(np.float32(fit["lr"]))
    new = {}
    for f in FIELDS:
        g = grads[f]
        m = (1 - a["b1"]) * g + a["b1"] * mu[f]
        v = (1 - a["b2"]) * (g * g) + a["b2"] * nu[f]
        u = (m / bc1) / (torch.sqrt(v / bc2) + a["eps"])
        new[f] = params[f] + -lr * (u * fit["lr_scales"][f])
    return new


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in f64 (0 where both are 0)."""
    d = float(torch.linalg.vector_norm((got.double() - want.double())))
    w = float(torch.linalg.vector_norm(want.double()))
    return d / w if w > 0 else (0.0 if d == 0 else math.inf)
