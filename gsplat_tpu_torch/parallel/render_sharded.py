"""Sharded rendering: gaussians over the mesh's shards, each shard's tiles a
2D-interleaved lattice of the image, an overlap-culled exchange of the
projected gaussians between them.

Counterpart of ``gsplat_tpu.parallel.render_sharded``, in four stages so
that one process can run several shards (``shard_map`` runs them as one
program in the JAX package):

1. each local shard projects its gaussians and packs them into the
   [n, 16] exchange table (``COMPACT_COLS``);
2. the exchange: each destination receives the rows of every source whose
   bbox touches one of its tiles (``_overlap_mask``; ``exchange="a2a"``),
   or every row (``exchange="all_gather"``), in the source's order, with
   exact split sizes. Between shards of one process it is a tensor copy;
   across processes one ``all_to_all_single`` inside an autograd
   ``Function`` whose backward is the same exchange with the splits
   swapped (JAX's transposed ``all_to_all``, ``render_sharded.py:216-237``).
   Rows arrive ordered by (source shard, position): shards are contiguous
   slices, so that is the gaussians' global order, and each tile's stable
   sort gives it the single-device sequence;
3. each local shard bins and blends its lattice (kernels B4, B1; B2 and the
   fold backward) into its [ty_l * ts, tx_l * ts] block, the
   tiles' pixels at their global positions;
4. every process gathers the D blocks and interleaves them into the image
   (:func:`interleave_tiles`), so the loss (SSIM's window crosses tiles)
   is computed whole and identical on every rank. The gather's backward
   takes the process's own blocks' slice of the incoming gradient: every
   rank computed the same loss, so summing over ranks (as
   ``torch.distributed.nn.functional.all_gather`` does) would scale the
   gradients by the rank count.

Shards are sized from exact counts, the exchange too: budgets and
``exchange_capacity`` are accepted and ignored, and ``num_dropped`` is 0.
Where the local and the global lattice have the same depth shift (every
grid of up to 511 tiles), the image, transmittance and label map equal the
single-device ``render`` bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from gsplat_tpu_torch.config import Config
from gsplat_tpu_torch.parallel.mesh import Mesh, ShardedScene, on_device
from gsplat_tpu_torch.render.api import (BlendSettings, blend_scene_tiles,
                                         pack_table)
from gsplat_tpu_torch.render.projection import (CameraParams, Projected,
                                                project, tile_grid)
from gsplat_tpu_torch.render.tiles import (Lattice, _tile_bbox, bin_tiles,
                                           count_instances,
                                           count_instances_tight)
from gsplat_tpu_torch.scene import DeviceLike, GaussianScene, resolve_device

# u v ca cb cc depth radius ex ey qmax r g b opacity valid label
COMPACT_COLS = 16


def _pack_compact(proj: Projected, labels: torch.Tensor) -> torch.Tensor:
    """[n, 16] exchange rows. Depth, radius, extents and cutoff only bin
    (as in the single-device render), so they carry no gradient: their
    derivatives are infinite where the cutoff is 0, and a zero cotangent
    times them would be NaN."""
    nd = lambda t: t.detach()
    return torch.stack([
        proj.u, proj.v, proj.ca, proj.cb, proj.cc, nd(proj.depth),
        nd(proj.radius), nd(proj.ex), nd(proj.ey), nd(proj.qmax), proj.red,
        proj.green, proj.blue, proj.opacity, proj.valid.to(torch.float32),
        labels.to(torch.float32)], dim=1)


def _unpack_compact(c: torch.Tensor) -> Projected:
    cols = c.t().contiguous()   # each field a contiguous [n], as B4 takes
    return Projected(*cols[:14], valid=cols[14] > 0.5)


def factor_grid(num_devices: int, tiles_x: int, tiles_y: int
                ) -> Tuple[int, int]:
    """The (Dy, Dx) factorization of the shards with the least tile-padding
    waste, (ceil(ty/Dy)*Dy/ty) * (ceil(tx/Dx)*Dx/tx), ties to the squarest
    grid."""
    best, best_key = (num_devices, 1), (float("inf"), 0)
    for dy in range(1, num_devices + 1):
        if num_devices % dy:
            continue
        dx = num_devices // dy
        wy = (-(-tiles_y // dy) * dy) / max(tiles_y, 1)
        wx = (-(-tiles_x // dx) * dx) / max(tiles_x, 1)
        key = (round(wy * wx, 6), -min(dy, dx))
        if key < best_key:
            best, best_key = (dy, dx), key
    return best


def grid_layout(width: int, height: int, tile_size: int, num_devices: int):
    """(Dy, Dx, tiles_x_local, tiles_y_local) of the interleaved lattice:
    the local counts are the padded global counts over the grid."""
    tiles_x, tiles_y = tile_grid(width, height, tile_size)
    dy, dx = factor_grid(num_devices, tiles_x, tiles_y)
    return dy, dx, -(-tiles_x // dx), -(-tiles_y // dy)


def band_layout(width: int, height: int, tile_size: int, num_devices: int):
    """Row-band view of the grid (Dx forced to 1): (tiles_x, tiles_y_pad,
    band_ty, band_h)."""
    tiles_x, tiles_y = tile_grid(width, height, tile_size)
    tiles_y_pad = -(-tiles_y // num_devices) * num_devices
    band_ty = tiles_y_pad // num_devices
    return tiles_x, tiles_y_pad, band_ty, band_ty * tile_size


def interleave_tiles(stacked: torch.Tensor, dy: int, dx: int, tx_l: int,
                     ty_l: int, tile_size: int, width: int,
                     height: int) -> torch.Tensor:
    """The image in global pixel order from the shards' blocks stacked
    along rows ([D * ty_l * ts, tx_l * ts, ...]): shard (py, px) renders
    local tile (ly, lx) = global tile (py + ly * Dy, px + lx * Dx). Crops to
    (height, width)."""
    ts = tile_size
    rest = tuple(stacked.shape[2:])
    x = stacked.reshape((dy, dx, ty_l, ts, tx_l, ts) + rest)
    x = x.permute((2, 0, 3, 4, 1, 5) + tuple(6 + i for i in range(len(rest))))
    x = x.reshape((ty_l * dy * ts, tx_l * dx * ts) + rest)
    return x[:height, :width]


def _lattice(shard: int, dy: int, dx: int) -> Lattice:
    return Lattice(dy, shard // dx, dx, shard % dx)


def _overlap_mask(proj: Projected, py: int, px: int, dy: int, dx: int,
                  ty_l: int, tx_l: int, tile_size: float) -> torch.Tensor:
    """[n] bool: does the gaussian's bbox touch a tile of shard (py, px)?
    The same bbox the shard's binning enumerates (``tiles._tile_bbox``
    under its lattice), so a row is sent exactly where it has a slot."""
    _, _, _, cnt = _tile_bbox(proj.u, proj.v, proj.ex, proj.ey, proj.valid,
                              tile_size, tx_l, ty_l, Lattice(dy, py, dx, px))
    return cnt > 0


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` with exact splits; backward sends the
    gradient rows back with the splits swapped."""

    @staticmethod
    def forward(ctx, send, send_splits, recv_splits):
        ctx.splits = (send_splits, recv_splits)
        recv = send.new_empty((sum(recv_splits),) + tuple(send.shape[1:]))
        dist.all_to_all_single(recv, send.contiguous(), recv_splits,
                               send_splits)
        return recv

    @staticmethod
    def backward(ctx, grad):
        send_splits, recv_splits = ctx.splits
        out = grad.new_empty((sum(send_splits),) + tuple(grad.shape[1:]))
        dist.all_to_all_single(out, grad.contiguous(), send_splits,
                               recv_splits)
        return out, None, None


def _exchange(pieces: List[List[torch.Tensor]], mesh: Mesh
              ) -> List[torch.Tensor]:
    """Rows for each local destination from ``pieces[k][e]``, the rows
    local source k sends shard e: ordered by (source shard, position)."""
    local = list(mesh.local)
    if not mesh.distributed:
        return [torch.cat([p[e].to(dev) for p in pieces])
                for e, dev in zip(local, mesh.devices)]
    comm = mesh.home
    counts = torch.tensor([[r.shape[0] for r in p] for p in pieces],
                          dtype=torch.int64, device=comm)
    parts = [torch.empty_like(counts) for _ in range(mesh.world)]
    dist.all_gather(parts, counts)
    c = torch.cat(parts).tolist()          # c[source shard][destination]
    send = torch.cat([p[e].to(comm) for q in range(mesh.world)
                      for e in mesh.shards_of(q) for p in pieces])
    send_splits = [sum(c[s][e] for e in mesh.shards_of(q) for s in local)
                   for q in range(mesh.world)]
    order = [(p, e, s) for p in range(mesh.world) for e in local
             for s in mesh.shards_of(p)]
    recv_splits = [sum(c[s][e] for (p, e, s) in order if p == q)
                   for q in range(mesh.world)]
    recv = _AllToAll.apply(send, send_splits, recv_splits)
    blocks = dict(zip(order, recv.split([c[s][e] for (_, e, s) in order])))
    return [torch.cat([blocks[(p, e, s)] for p in range(mesh.world)
                       for s in mesh.shards_of(p)]).to(dev)
            for e, dev in zip(local, mesh.devices)]


class _GatherBlocks(torch.autograd.Function):
    """[D, ...] every shard's block on ``mesh.home`` from this process's
    blocks; backward hands each block its own slice of the gradient (the
    loss is replicated, so no sum over processes)."""

    @staticmethod
    def forward(ctx, mesh, *blocks):
        ctx.mesh = mesh
        ctx.devices = [b.device for b in blocks]
        local = torch.stack([b.to(mesh.home) for b in blocks])
        if not mesh.distributed:
            return local
        parts = [torch.empty_like(local) for _ in range(mesh.world)]
        dist.all_gather(parts, local.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        mine = grad[ctx.mesh.local.start:ctx.mesh.local.stop]
        return (None, *(g.to(dev) for g, dev in zip(mine.unbind(0),
                                                     ctx.devices)))


def exchanged_rows(scene: ShardedScene, cam: CameraParams, mesh: Mesh, *,
                   width: int, height: int, cfg: Config,
                   exchange: str = "a2a"):
    """Stages 1 and 2 of :func:`render_sharded`: each local shard's
    received [m, 16] exchange rows, and the layout (Dy, Dx, tx_l, ty_l)."""
    if exchange not in ("a2a", "all_gather"):
        raise ValueError(f"unknown exchange {exchange!r}")
    if not isinstance(scene, ShardedScene) or scene.mesh != mesh:
        raise ValueError("render_sharded takes a scene sharded over its mesh "
                         "(parallel.mesh.shard_scene)")
    rc = cfg.raster
    ts = rc.tile_size
    d = mesh.size
    dy, dx, tx_l, ty_l = grid_layout(width, height, ts, d)
    # 1. project and pack each local shard; the rows it sends each shard
    pieces = []
    for sc, dev in zip(scene, mesh.devices):
        with on_device(dev):
            camd = CameraParams(*(t.to(dev) for t in cam))
            proj = project(sc, camd, width, height, rc,
                           z_near=cfg.camera.z_near, z_far=cfg.camera.z_far)
            compact = _pack_compact(proj, sc.labels)
            if exchange == "all_gather":
                pieces.append([compact] * d)
            else:
                pieces.append([compact[_overlap_mask(
                    proj, e // dx, e % dx, dy, dx, ty_l, tx_l, float(ts))]
                    for e in range(d)])
    # 2. the exchange
    return _exchange(pieces, mesh), (dy, dx, tx_l, ty_l)


def shard_binning(rows: torch.Tensor, shard: int, layout, cfg: Config):
    """(table, binning, blend settings) of shard ``shard``'s lattice from
    its received exchange rows (stage 3 of :func:`render_sharded`, before
    the blend)."""
    dy, dx, tx_l, ty_l = layout
    ts = cfg.raster.tile_size
    lat = _lattice(shard, dy, dx)
    projf = _unpack_compact(rows)
    binning = bin_tiles(projf, tiles_x=tx_l, tiles_y=ty_l, tile_size=ts,
                        **lat._asdict())
    ptab = pack_table(projf, rows[:, 15].to(torch.int32))
    return ptab, binning, BlendSettings.from_config(
        cfg, tx_l, ty_l, tx_l * ts, ty_l * ts, lattice=lat)


def render_sharded(
    scene: ShardedScene,
    cam: CameraParams,
    mesh: Mesh,
    *,
    width: int,
    height: int,
    cfg: Config,
    budget_per_device: Optional[int] = None,
    background=None,
    interpret: Optional[bool] = None,
    with_labels: bool = False,
    kernel_budget_per_device: Optional[int] = None,
    num_windows_per_device: Optional[int] = None,
    with_dropped: bool = False,
    exchange: str = "a2a",
    exchange_capacity: Optional[int] = None,
):
    """Render a sharded scene (:func:`parallel.mesh.shard_scene`) over the
    mesh. Returns the [height, width, 3] image in global pixel order on
    ``mesh.home``; with ``with_labels`` a dict with ``image``,
    ``transmittance``, ``alpha``, ``best_weight`` and ``label_map``; with
    ``with_dropped`` (and not ``with_labels``) ``(image, num_dropped)``,
    ``num_dropped`` always 0. Differentiable in the scene's tensors.

    ``exchange="a2a"`` sends each destination only the rows overlapping its
    tile lattice; ``"all_gather"`` sends every row everywhere. The budget
    arguments, ``exchange_capacity`` and ``interpret`` are accepted and
    ignored: the port sizes every buffer from exact counts."""
    del (budget_per_device, kernel_budget_per_device, num_windows_per_device,
         exchange_capacity, interpret)
    home = mesh.home
    if background is None:
        background = cfg.raster.background
    bg = torch.as_tensor(background, dtype=torch.float32, device=home)
    received, layout = exchanged_rows(scene, cam, mesh, width=width,
                                      height=height, cfg=cfg,
                                      exchange=exchange)
    dy, dx, tx_l, ty_l = layout
    ts = cfg.raster.tile_size
    # 3. bin and blend each local shard's lattice
    outs = []
    for e, rows, dev in zip(mesh.local, received, mesh.devices):
        with on_device(dev):
            ptab, binning, settings = shard_binning(rows, e, layout, cfg)
            outs.append(blend_scene_tiles(ptab, binning, settings,
                                          with_labels))

    # 4. every shard's block, interleaved into the image
    def assemble(blocks):
        full = _GatherBlocks.apply(mesh, *blocks)
        return interleave_tiles(full.reshape((-1,) + tuple(full.shape[2:])),
                                dy, dx, tx_l, ty_l, ts, width, height)

    trans = assemble([o.transmittance for o in outs])
    image = assemble([o.rgb for o in outs]) + trans[..., None] * bg
    if not with_labels:
        if with_dropped:
            return image, torch.zeros((), dtype=torch.int32, device=home)
        return image
    return dict(image=image, transmittance=trans, alpha=1.0 - trans,
                best_weight=assemble([o.best_weight for o in outs]),
                label_map=assemble([o.label for o in outs]))


@torch.no_grad()
def measure_budgets_sharded(
    scene: GaussianScene,
    cam: CameraParams,
    *,
    width: int,
    height: int,
    cfg: Config,
    num_devices: int,
    device: DeviceLike = None,
):
    """(bbox instances, tight instances, tiles, exchange rows) of the
    busiest of ``num_devices`` shards under the interleaved lattice, on
    ``device`` (the card by default): the exact counts, where the JAX
    package buckets them into static budgets (``render/api.py``'s
    ``measure_budgets`` convention). The exchange count is the most rows a
    (source shard, destination) pair sends, on the scene padded as
    ``shard_scene`` pads it. ``render_sharded`` accepts and ignores all
    four."""
    device = resolve_device(device)
    scene = scene.to(device)
    cam = CameraParams(*(t.to(device) for t in cam))
    rc = cfg.raster
    ts = rc.tile_size
    d = num_devices
    dy, dx, tx_l, ty_l = grid_layout(width, height, ts, d)
    proj = project(scene, cam, width, height, rc, z_near=cfg.camera.z_near,
                   z_far=cfg.camera.z_far)
    kw = dict(tiles_x=tx_l, tiles_y=ty_l, tile_size=ts)
    lats = [_lattice(e, dy, dx)._asdict() for e in range(d)]
    cnt = max(count_instances(proj, **kw, **lat) for lat in lats)
    tight = max(count_instances_tight(proj, **kw, **lat) for lat in lats)
    n = proj.u.shape[0]
    n_shard = -(-n // d)
    cap = 0
    for e in range(d):
        m = _overlap_mask(proj, e // dx, e % dx, dy, dx, ty_l, tx_l,
                          float(ts))
        m = torch.cat([m, m.new_zeros(n_shard * d - n)])
        cap = max(cap, int(m.reshape(d, n_shard).sum(1).max()))
    return cnt, tight, tx_l * ty_l, cap


def make_sharded_render_fn(
    mesh: Mesh,
    *,
    width: int,
    height: int,
    cfg: Config,
    budget_per_device: Optional[int] = None,
    interpret: Optional[bool] = None,
    with_labels: bool = False,
    kernel_budget_per_device: Optional[int] = None,
    num_windows_per_device: Optional[int] = None,
    exchange: str = "a2a",
    exchange_capacity: Optional[int] = None,
    with_dropped: bool = False,
):
    """(scene, cam, background) -> :func:`render_sharded`'s output, over
    the fixed configuration (the JAX package's jitted closure; the port
    runs eagerly)."""

    def fn(scene: ShardedScene, cam: CameraParams, background):
        return render_sharded(
            scene, cam, mesh, width=width, height=height, cfg=cfg,
            budget_per_device=budget_per_device, background=background,
            interpret=interpret, with_labels=with_labels,
            kernel_budget_per_device=kernel_budget_per_device,
            num_windows_per_device=num_windows_per_device,
            exchange=exchange, exchange_capacity=exchange_capacity,
            with_dropped=with_dropped)

    return fn
