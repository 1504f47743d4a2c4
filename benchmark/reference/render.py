"""Projection, binning and blending of 3D Gaussian Splatting in plain
PyTorch (Kerbl et al. 2023, with the rasterizer semantics the configuration
states in ``benchmark/configs``' ``raster`` group).

- Projection: Sigma3 = R S S^T R^T, Sigma2 = J W Sigma3 W^T J^T + blur I,
  conic = Sigma2^-1, opacity = sigmoid(logit), colour from SH (degree 0-3)
  plus 0.5 clamped at 0. A gaussian is culled outside (z_near, z_far), with
  a singular Sigma2, below ``alpha_min`` opacity, or when its cutoff
  ellipse (``sqrt(2 ln(opacity / alpha_min))`` sigmas, at most
  ``sigma_cutoff``) misses the frame.
- Binning: the tiles of each gaussian's cutoff-ellipse bbox whose
  rectangle holds a point inside the ellipse; in each tile the instances
  run in order of (quantized depth, gaussian index), the depth quantized by
  dropping the low ``max(bit_length(tiles) + 1, 10)`` bits of its f32
  pattern.
- Blending: per pixel centre, alpha = min(alpha_max, opacity exp(-q / 2)),
  cut to 0 below alpha_min; w = T alpha, C += w c, T *= 1 - alpha; the
  label is that of the first maximum of w. A tile stops before each batch
  of ``chunk`` instances once its largest T is below ``early_stop_eps``.

The blend walks every tile's stream a batch at a time, all tiles together,
so memory stays at one batch of every tile.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

UNLABELED = -1
# columns of the per-gaussian table the blend gathers
U, V, CA, CB, CC, OP, R, G, B, EX, EY, QM = range(12)


def no_tf32() -> None:
    """Matrix products and convolutions in full f32 (the configuration's
    precision): PyTorch lets them run in TF32 on the card otherwise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest even), as a
    tensor core rounds a product's operands; the gradient passes through."""
    d = x.detach().contiguous()
    b = d.view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -8192
    return x + (b.view(torch.float32) - d)


class Precision(NamedTuple):
    name: str = "f32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            a, b = to_tf32(a), to_tf32(b)
        return torch.matmul(a, b)


F32 = Precision("f32")
TF32 = Precision("tf32")


class Cam(NamedTuple):
    rot: torch.Tensor   # [3, 3] world-to-camera rows (right, down, forward)
    pos: torch.Tensor   # [3] centre
    fx: float
    fy: float
    width: int
    height: int


class Proj(NamedTuple):
    table: torch.Tensor   # [N, 12] columns U..QM
    depth: torch.Tensor   # [N] camera z
    valid: torch.Tensor   # [N] bool


def quat_rot(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def sh_basis(d: torch.Tensor, k: int) -> torch.Tensor:
    """[N, k] real SH basis at unit directions ``d`` [N, 3] (k in 1, 4, 9,
    16)."""
    x, y, z = d.unbind(-1)
    cols = [torch.full_like(x, SH_C0)]
    if k > 1:
        cols += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if k > 4:
        xx, yy, zz = x * x, y * y, z * z
        cols += [SH_C2[0] * x * y, SH_C2[1] * y * z,
                 SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
                 SH_C2[4] * (xx - yy)]
    if k > 9:
        cols += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                 SH_C3[2] * y * (4 * zz - xx - yy),
                 SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                 SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                 SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(cols, -1)


def project(params: Dict[str, torch.Tensor], cam: Cam, raster: dict,
            prec: Precision = F32) -> Proj:
    """Differentiable projection of every gaussian into ``cam``."""
    means = params["means"]
    pc = prec.mm(means - cam.pos, cam.rot.t())
    x, y, z = pc.unbind(-1)
    valid = (z > raster["z_near"]) & (z < raster["z_far"])
    zs = torch.where(valid, z, torch.ones_like(z))
    u = cam.fx * x / zs + cam.width / 2.0
    v = cam.fy * y / zs + cam.height / 2.0
    m = quat_rot(params["quats"]) * torch.exp(params["log_scales"])[:, None, :]
    sigma = prec.mm(m, m.transpose(1, 2))
    zero = torch.zeros_like(zs)
    jac = torch.stack([
        torch.stack([cam.fx / zs, zero, -cam.fx * x / (zs * zs)], -1),
        torch.stack([zero, cam.fy / zs, -cam.fy * y / (zs * zs)], -1)], -2)
    t = prec.mm(jac, cam.rot)
    cov = prec.mm(prec.mm(t, sigma), t.transpose(1, 2))
    a = cov[:, 0, 0] + raster["cov2d_blur"]
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + raster["cov2d_blur"]
    det = a * c - b * b
    valid = valid & (det > 0)
    det = torch.where(det > 0, det, torch.ones_like(det))
    op = torch.sigmoid(params["opacities"])
    amin = raster["alpha_min"]
    cutoff = torch.clamp_max(torch.sqrt(2.0 * torch.log(
        torch.clamp_min(op / amin, 1.0))), raster["sigma_cutoff"])
    ex = cutoff * torch.sqrt(torch.clamp_min(a, 0.0))
    ey = cutoff * torch.sqrt(torch.clamp_min(c, 0.0))
    valid = valid & (op >= amin)
    valid = valid & (u + ex > 0) & (u - ex < cam.width)
    valid = valid & (v + ey > 0) & (v - ey < cam.height)
    sh = params["sh"]
    d = means - cam.pos
    d = d / torch.clamp_min(torch.linalg.vector_norm(d, dim=-1,
                                                     keepdim=True), 1e-12)
    rgb = prec.mm(sh_basis(d, sh.shape[1])[:, None, :], sh)[:, 0, :]
    rgb = torch.clamp_min(rgb + 0.5, 0.0)
    table = torch.stack([u, v, c / det, -b / det, a / det, op, rgb[:, 0],
                         rgb[:, 1], rgb[:, 2], ex, ey, cutoff * cutoff], 1)
    return Proj(table, z, valid)


class Stream(NamedTuple):
    """Each tile's instances in compositing order."""

    gauss: torch.Tensor   # [I] i64 gaussian of each instance
    start: torch.Tensor   # [T] i64 first instance of each tile
    count: torch.Tensor   # [T] i64 instances of each tile
    slots: int            # bbox tile slots before the rectangle test
    bbox_count: torch.Tensor  # [N] i64 bbox slots of each gaussian
    tiles_x: int
    tiles_y: int
    tile: int


def _rect_min_q(mx, my, ca, cb, cc, rx0, ry0, ts: float):
    """Least q(p) = ca dx^2 + 2 cb dx dy + cc dy^2 over the rectangle
    [rx0, rx0 + ts] x [ry0, ry0 + ts]: 0 with the mean inside, else the
    least of the four edges' closed-form minima (q is convex)."""
    x0 = rx0 - mx
    x1 = x0 + ts
    y0 = ry0 - my
    y1 = y0 + ts
    inside = (x0 <= 0) & (0 <= x1) & (y0 <= 0) & (0 <= y1)
    ca_s, cc_s = torch.clamp_min(ca, 1e-12), torch.clamp_min(cc, 1e-12)

    def edge_x(e):
        ys = torch.clamp(-cb * e / cc_s, y0, y1)
        return (ca * e + 2.0 * cb * ys) * e + cc * ys * ys

    def edge_y(e):
        xs = torch.clamp(-cb * e / ca_s, x0, x1)
        return (cc * e + 2.0 * cb * xs) * e + ca * xs * xs

    m = torch.minimum(torch.minimum(edge_x(x0), edge_x(x1)),
                      torch.minimum(edge_y(y0), edge_y(y1)))
    return torch.where(inside, torch.zeros_like(m), m)


def depth_shift(num_tiles: int) -> int:
    return max(num_tiles.bit_length() + 1, 10)


@torch.no_grad()
def bin_tiles(proj: Proj, width: int, height: int, tile: int) -> Stream:
    """Each tile's instances, in compositing order (module docstring)."""
    t = proj.table.detach()
    ts = float(tile)
    tx, ty = -(-width // tile), -(-height // tile)
    u, v, ex, ey = t[:, U], t[:, V], t[:, EX], t[:, EY]
    x0 = torch.clamp(torch.floor((u - ex) / ts), 0, tx).long()
    x1 = torch.clamp(torch.ceil((u + ex) / ts), 0, tx).long()
    y0 = torch.clamp(torch.floor((v - ey) / ts), 0, ty).long()
    y1 = torch.clamp(torch.ceil((v + ey) / ts), 0, ty).long()
    bw = torch.clamp_min(x1 - x0, 0)
    cnt = torch.where(proj.valid, bw * torch.clamp_min(y1 - y0, 0),
                      torch.zeros_like(bw))
    slots = int(cnt.sum())
    n = cnt.shape[0]
    g = torch.repeat_interleave(torch.arange(n, device=t.device), cnt,
                                output_size=slots)
    off = torch.cumsum(cnt, 0) - cnt
    local = torch.arange(slots, device=t.device) - off[g]
    row = y0[g] + local // bw[g]
    col = x0[g] + local % bw[g]
    minq = _rect_min_q(u[g], v[g], t[g, CA], t[g, CB], t[g, CC],
                       (col * tile).float(), (row * tile).float(), ts)
    keep = minq <= t[g, QM]
    g, tid = g[keep], (row * tx + col)[keep]
    del row, col, local, minq, keep
    depth = proj.depth.detach().float()
    bits = torch.where(proj.valid, depth, torch.ones_like(depth)).contiguous()
    qd = (bits.view(torch.int32) >> depth_shift(tx * ty)).long()
    _, order = torch.sort((tid << 32) | qd[g], stable=True)
    count = torch.bincount(tid, minlength=tx * ty)
    return Stream(g[order], torch.cumsum(count, 0) - count, count, slots,
                  cnt, tx, ty, tile)


class Blend(NamedTuple):
    rgb: torch.Tensor          # [H, W, 3] without background
    trans: torch.Tensor        # [H, W]
    label: Optional[torch.Tensor]       # [H, W] i64, UNLABELED if none
    gauss_weight: Optional[torch.Tensor]  # [N] max weight over its tiles
    pairs: tuple               # (evaluated, tested, live) instance-pixel


def _pixels(stream: Stream, device, dtype=torch.float32):
    ts = stream.tile
    p = torch.arange(ts * ts, device=device)
    return (p % ts).to(dtype) + 0.5, (p // ts).to(dtype) + 0.5


def _origins(stream: Stream, tiles: torch.Tensor, dtype=torch.float32):
    ts = stream.tile
    return ((tiles % stream.tiles_x) * ts).to(dtype), \
        ((tiles // stream.tiles_x) * ts).to(dtype)


def _batch(rows: torch.Tensor, mask: torch.Tensor, trans: torch.Tensor,
           x0: torch.Tensor, y0: torch.Tensor, px: torch.Tensor,
           py: torch.Tensor, raster: dict, prec: Precision):
    """Composite one batch: ``rows`` [A, K, >= 9] gathered table rows.
    Returns (dC [A, P, 3], T after [A, P], w [A, P, K], alpha, dx, dy)."""
    mx = (rows[:, :, U] - x0[:, None])[:, None, :]
    my = (rows[:, :, V] - y0[:, None])[:, None, :]
    dx = px[None, :, None] - mx
    dy = py[None, :, None] - my
    ca = rows[:, None, :, CA]
    cb = rows[:, None, :, CB]
    cc = rows[:, None, :, CC]
    q = (ca * dx + (2.0 * cb) * dy) * dx + cc * dy * dy
    alpha = torch.clamp_max(rows[:, None, :, OP] * torch.exp(-0.5 * q),
                            raster["alpha_max"])
    keep = (alpha >= raster["alpha_min"]) & mask[:, None, :]
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    cp = torch.cumprod(1.0 - alpha, dim=2)
    excl = torch.cat([torch.ones_like(cp[:, :, :1]), cp[:, :, :-1]], 2)
    w = alpha * (trans[:, :, None] * excl)
    dc = prec.mm(w, rows[:, :, R:B + 1])
    return dc, trans * cp[:, :, -1], w, keep, dx, dy


def _to_image(x: torch.Tensor, stream: Stream, width: int, height: int):
    """[T, P, C] tile pixels -> [H, W, C]."""
    ts, tx, ty = stream.tile, stream.tiles_x, stream.tiles_y
    c = x.shape[-1]
    img = x.reshape(ty, tx, ts, ts, c).permute(0, 2, 1, 3, 4)
    return img.reshape(ty * ts, tx * ts, c)[:height, :width]


@torch.no_grad()
def blend(table: torch.Tensor, stream: Stream, width: int, height: int,
          raster: dict, *, chunk: int, eps: float,
          labels: Optional[torch.Tensor] = None, gauss_max: bool = False,
          prec: Precision = F32) -> Blend:
    """Composite every tile (module docstring). ``labels`` [N] gives the
    label map; ``gauss_max`` each gaussian's largest weight over all pixels
    of its tiles (those past the image's edge included). ``pairs`` counts the instance-pixel
    pairs of the batches that ran, those inside the instance's cutoff box or
    past the cut, and those past the cut."""
    dev = table.device
    table = table.detach()
    nt = stream.tiles_x * stream.tiles_y
    npx = stream.tile ** 2
    px, py = _pixels(stream, dev, table.dtype)
    dt = dict(device=dev, dtype=table.dtype)
    trans = torch.ones(nt, npx, **dt)
    rgb = torch.zeros(nt, npx, 3, **dt)
    best = torch.zeros(nt, npx, **dt) if labels is not None else None
    lab = (torch.full((nt, npx), UNLABELED, dtype=torch.long, device=dev)
           if labels is not None else None)
    gmax = torch.zeros(table.shape[0], **dt) if gauss_max else None
    alive = torch.ones(nt, dtype=torch.bool, device=dev)
    counts = torch.zeros(3, dtype=torch.long, device=dev)
    k_ar = torch.arange(chunk, device=dev)
    nb = -(-int(stream.count.max()) // chunk) if nt else 0
    for k in range(nb):
        alive &= trans.amax(dim=1) >= eps
        tiles = (alive & (stream.count > k * chunk)).nonzero()[:, 0]
        if tiles.numel() == 0:
            break
        pos = stream.start[tiles, None] + k * chunk + k_ar
        mask = (k * chunk + k_ar) < stream.count[tiles, None]
        g = torch.where(mask, stream.gauss[torch.where(mask, pos, 0)], 0)
        rows = table[g]
        x0, y0 = _origins(stream, tiles, table.dtype)
        t0 = trans[tiles]
        dc, t1, w, keep, dx, dy = _batch(rows, mask, t0, x0, y0, px, py,
                                         raster, prec)
        rgb[tiles] += dc
        trans[tiles] = t1
        if labels is not None:
            wmax, arg = w.max(dim=2)
            better = wmax > best[tiles]
            best[tiles] = torch.where(better, wmax, best[tiles])
            lab[tiles] = torch.where(
                better, labels[torch.gather(g, 1, arg)], lab[tiles])
        if gauss_max:
            gmax.scatter_reduce_(0, g[mask], w.amax(dim=1)[mask], "amax")
        box = ((dx.abs() <= rows[:, None, :, EX])
               & (dy.abs() <= rows[:, None, :, EY]) & mask[:, None, :])
        counts += torch.stack([mask.sum() * npx, (box | keep).sum(),
                               keep.sum()])
    img = lambda x: _to_image(x, stream, width, height)
    return Blend(img(rgb), img(trans[:, :, None])[..., 0],
                 img(lab[:, :, None])[..., 0] if labels is not None else None,
                 gmax, tuple(int(c) for c in counts))
