"""Tile binning: the depth-ordered instance stream of every image tile.

Counterpart of ``gsplat_tpu.render.tiles``. An *instance* is a (gaussian,
tile) pair. Candidate tiles come from the bbox of the per-axis cutoff-ellipse
extents (``_tile_bbox``); each pair is kept only if the exact minimum of the
conic quadratic over the tile rectangle is <= the gaussian's cutoff ``qmax``
(``_rect_min_q``). Kernel B4 (:func:`enum_keys`) writes one packed sort key
``tile << db | qdepth`` per bbox slot, the sentinel tile ``num_tiles`` for a
filtered pair. One stable sort orders the keys; since enumeration is
gaussian-major, depth ties break by gaussian index, which is the oracle's
canonical (quantized depth, index) order (ref/rasterizer.py:188-196).

The JAX package needs static shapes and so builds 8-aligned windows under an
instance budget; the port sizes its buffers from the exact count instead, so
it has no windows and never drops an instance.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.render.projection import Projected


class BBoxes(NamedTuple):
    """Per-gaussian candidate-tile bboxes and their enumeration offsets."""

    x0: torch.Tensor       # [N] i32 first tile column
    y0: torch.Tensor       # [N] i32 first tile row
    bw: torch.Tensor       # [N] i32 bbox width in tiles
    cnt: torch.Tensor      # [N] i32 bbox tile count (0 if culled)
    offsets: torch.Tensor  # [N] i32 exclusive prefix sum of cnt
    total: int             # number of enumeration slots


class TileBinning(NamedTuple):
    """The sorted instance stream and each tile's range of it.

    Enumeration is gaussian-major, so gaussian g owns the consecutive
    enumeration slots ``[enum_start[g], enum_start[g] + enum_cnt[g])``; the
    backward fold sums each gaussian's gradient rows over that range."""

    inst_gauss: torch.Tensor   # [B] i32 gaussian index per sorted slot
    je_sorted: torch.Tensor    # [B] i32 enumeration slot per sorted slot
    tile_bounds: torch.Tensor  # [T + 1] i32: tile t owns [b[t], b[t+1])
    enum_start: torch.Tensor   # [N] i32 first enumeration slot per gaussian
    enum_cnt: torch.Tensor     # [N] i32 bbox slot count per gaussian
    num_instances: torch.Tensor  # scalar i32 tight (kept) instance count
    num_slots: int             # bbox enumeration slots
    num_dropped: torch.Tensor  # scalar i32, always 0 (exact sizing)


def depth_shift(num_tiles: int) -> int:
    """Right shift of the positive-f32 depth bit pattern that forms the
    quantized depth key; floored at 10 so every grid up to 512 tiles shares
    one canonical quantization and compositing order."""
    return max(num_tiles.bit_length() + 1, 10)


def depth_qkeys(depth: torch.Tensor, valid: torch.Tensor,
                num_tiles: int) -> torch.Tensor:
    """[N] i32 canonical quantized depth keys (non-negative): positive-f32
    bit patterns are monotone in the value, so the truncated bits order by
    depth."""
    bits = torch.where(valid, depth, torch.ones_like(depth)).view(torch.int32)
    return bits >> depth_shift(num_tiles)


def _tile_bbox(u, v, ex, ey, valid, ts: float, tiles_x: int, tiles_y: int):
    """Per-gaussian candidate-tile bbox (x0, y0, bw, cnt), i32 each. The
    divisions by ``ts`` stay divisions (not products with 1/ts) so the tile
    spans round as in the JAX package; the clip happens in f32 before the
    integer conversion, which is the saturating conversion's result."""
    gx0 = torch.clamp(torch.floor((u - ex) / ts), 0, tiles_x).to(torch.int32)
    gx1 = torch.clamp(torch.ceil((u + ex) / ts), 0, tiles_x).to(torch.int32)
    gy0 = torch.clamp(torch.floor((v - ey) / ts), 0, tiles_y).to(torch.int32)
    gy1 = torch.clamp(torch.ceil((v + ey) / ts), 0, tiles_y).to(torch.int32)
    bw = torch.clamp_min(gx1 - gx0, 0)
    bh = torch.clamp_min(gy1 - gy0, 0)
    cnt = torch.where(valid, bw * bh, torch.zeros_like(bw))
    return gx0, gy0, bw, cnt


def _rect_min_q(mx, my, ca, cb, cc, rx0, ry0, ts: float):
    """Exact min of the conic quadratic q(p) = a dx^2 + 2b dxdy + c dy^2 over
    the tile rectangle [rx0, rx0+ts] x [ry0, ry0+ts] (convex: either the mean
    is inside, or the minimum lies on one of the four edges, where the 1-D
    restriction minimizes in closed form). Same operation order as the JAX
    version and the CUDA kernel, one rounding per operation."""
    x0 = rx0 - mx
    x1 = x0 + ts
    y0 = ry0 - my
    y1 = y0 + ts
    inside = (x0 <= 0.0) & (0.0 <= x1) & (y0 <= 0.0) & (0.0 <= y1)
    ca_s = torch.clamp_min(ca, 1e-12)
    cc_s = torch.clamp_min(cc, 1e-12)

    def q_edge_x(ex):
        ys = torch.clamp(-cb * ex / cc_s, y0, y1)
        return (ca * ex + 2.0 * cb * ys) * ex + cc * ys * ys

    def q_edge_y(ey):
        xs = torch.clamp(-cb * ey / ca_s, x0, x1)
        return (cc * ey + 2.0 * cb * xs) * ey + ca * xs * xs

    mq = torch.minimum(torch.minimum(q_edge_x(x0), q_edge_x(x1)),
                       torch.minimum(q_edge_y(y0), q_edge_y(y1)))
    return torch.where(inside, torch.zeros_like(mq), mq)


def tile_bboxes(proj: Projected, *, tiles_x: int, tiles_y: int,
                tile_size: int) -> BBoxes:
    """Bboxes plus enumeration offsets; one host sync for the total."""
    x0, y0, bw, cnt = _tile_bbox(proj.u, proj.v, proj.ex, proj.ey,
                                 proj.valid, float(tile_size), tiles_x,
                                 tiles_y)
    incl = torch.cumsum(cnt, 0, dtype=torch.int32)
    total = int(incl[-1]) if incl.numel() else 0
    return BBoxes(x0, y0, bw, cnt, incl - cnt, total)


def count_instances(proj: Projected, *, tiles_x: int, tiles_y: int,
                    tile_size: int) -> int:
    """Bbox instance count: an upper bound on the tight count."""
    _, _, _, cnt = _tile_bbox(proj.u, proj.v, proj.ex, proj.ey, proj.valid,
                              float(tile_size), tiles_x, tiles_y)
    return int(cnt.sum())


def _enum_keys_plain(proj: Projected, qd: torch.Tensor, bb: BBoxes, *,
                     tiles_x: int, num_tiles: int, tile_size: int, db: int):
    """Plain PyTorch version of kernel B4: the same keys, vectorized over
    slots (slot -> gaussian by repeat_interleave, row-major bbox decode)."""
    dev = proj.u.device
    n = proj.u.shape[0]
    g = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=dev), bb.cnt.long(),
        output_size=bb.total)
    gl = g.long()
    local = torch.arange(bb.total, dtype=torch.int32, device=dev) - bb.offsets[gl]
    w = bb.bw[gl]
    trow = bb.y0[gl] + torch.div(local, w, rounding_mode="floor")
    tcol = bb.x0[gl] + torch.remainder(local, w)
    ts = float(tile_size)
    min_q = _rect_min_q(proj.u[gl], proj.v[gl], proj.ca[gl], proj.cb[gl],
                        proj.cc[gl], tcol.to(torch.float32) * ts,
                        trow.to(torch.float32) * ts, ts)
    tile = torch.where(min_q <= proj.qmax[gl], trow * tiles_x + tcol,
                       torch.full_like(trow, num_tiles))
    return (tile << db) | qd[gl], g


def enum_keys(proj: Projected, qd: torch.Tensor, bb: BBoxes, *,
              tiles_x: int, num_tiles: int, tile_size: int, db: int):
    """Kernel B4 wrapper: ([B] i32 packed keys, [B] i32 gaussian index) for
    the B = ``bb.total`` bbox slots in enumeration (gaussian-major, bbox
    row-major) order.

    Replaces ``gsplat_tpu/render/tiles.py::_enum_key_kernel``. On the card it
    launches ``csrc/enum_keys.cu`` (one thread per gaussian; bound by bytes,
    and at render sizes by its launch); CPU tensors take the plain version.
    The keep-set equals the plain version's bit for bit."""
    fields = (proj.u, proj.v, proj.ca, proj.cb, proj.cc, proj.qmax)
    ints = (bb.x0, bb.y0, bb.bw, bb.cnt, bb.offsets, qd)
    n = proj.u.shape[0]
    for t in fields + ints:
        if t.shape != (n,) or not t.is_contiguous():
            raise ValueError("enum_keys takes contiguous [N] tensors")
        if t.device != proj.u.device:
            raise ValueError("enum_keys inputs lie on different devices")
    if any(t.dtype != torch.float32 for t in fields) or any(
            t.dtype != torch.int32 for t in ints):
        raise TypeError("enum_keys takes f32 projection fields and i32 bboxes")
    if proj.u.device.type == "cpu":
        return _enum_keys_plain(proj, qd, bb, tiles_x=tiles_x,
                                num_tiles=num_tiles, tile_size=tile_size,
                                db=db)
    if proj.u.device.type != "cuda":
        raise ValueError(f"enum_keys: no kernel for {proj.u.device}")
    keys = torch.empty(bb.total, dtype=torch.int32, device=proj.u.device)
    gauss = torch.empty_like(keys)
    if bb.total == 0:
        return keys, gauss
    fn = _kernels.function("enum_keys")
    err = fn(*(t.data_ptr() for t in fields + ints), n, tiles_x, num_tiles,
             float(tile_size), db, keys.data_ptr(), gauss.data_ptr(),
             _kernels.stream(proj.u.device))
    enum_keys.launches += 1
    _kernels.check("enum_keys", err)
    return keys, gauss


enum_keys.launches = 0


def bin_tiles(proj: Projected, *, tiles_x: int, tiles_y: int,
              tile_size: int) -> TileBinning:
    """Sorted instance stream and per-tile ranges (replaces the JAX
    package's ``bin_windows``). Enumeration runs in original gaussian order;
    depth ordering rides the quantized-depth bits of the packed key, so there
    is no per-gaussian depth sort."""
    num_tiles = tiles_x * tiles_y
    db = 32 - depth_shift(num_tiles)   # depth bits in the packed key
    qd = depth_qkeys(proj.depth, proj.valid, num_tiles)
    bb = tile_bboxes(proj, tiles_x=tiles_x, tiles_y=tiles_y,
                     tile_size=tile_size)
    keys, gauss = enum_keys(proj, qd, bb, tiles_x=tiles_x,
                            num_tiles=num_tiles, tile_size=tile_size, db=db)
    keys, perm = torch.sort(keys, stable=True)
    bounds = torch.arange(num_tiles + 1, dtype=torch.int32,
                          device=keys.device) << db
    tile_bounds = torch.searchsorted(keys, bounds, out_int32=True)
    return TileBinning(
        inst_gauss=gauss[perm], je_sorted=perm.to(torch.int32),
        tile_bounds=tile_bounds, enum_start=bb.offsets, enum_cnt=bb.cnt,
        num_instances=tile_bounds[-1], num_slots=bb.total,
        num_dropped=torch.zeros((), dtype=torch.int32, device=keys.device))


def count_instances_tight(proj: Projected, *, tiles_x: int, tiles_y: int,
                          tile_size: int, budget=None) -> int:
    """Exact tight instance count (enumeration and filter, no sort).
    ``budget`` is accepted for the JAX signature; the port needs none."""
    del budget
    num_tiles = tiles_x * tiles_y
    db = 32 - depth_shift(num_tiles)
    qd = depth_qkeys(proj.depth, proj.valid, num_tiles)
    bb = tile_bboxes(proj, tiles_x=tiles_x, tiles_y=tiles_y,
                     tile_size=tile_size)
    keys, _ = enum_keys(proj, qd, bb, tiles_x=tiles_x, num_tiles=num_tiles,
                        tile_size=tile_size, db=db)
    return int((keys < (num_tiles << db)).sum())
