"""Tile blend: front-to-back alpha compositing of the sorted instance stream,
with the optional best-weight label channel (kernel B1), its backward
(kernel B2), the row prefix sum of the gradient fold (kernel B3) and the
visibility blend of the occlusion-aware vote (kernel B5: B1 with no early
stop, plus each instance's max blend weight).

Counterpart of ``gsplat_tpu.render.blend_pallas``. The JAX package walks
8-aligned windows of a materialised [B, 128] parameter array and writes
[T, 8, P] tile rows that ``tiles_to_image`` reshapes; the port's kernels
gather each batch's parameters straight from the [N, 16] per-gaussian table
and read and write image layout, so neither the window array nor
``tiles_to_image`` exists here.

Semantics (the oracle's, ref/rasterizer.py): alpha = min(alpha_max,
opacity * exp(-q/2)), cut to 0 below alpha_min; w = T * alpha; C += w * c;
T *= 1 - alpha; the label takes the first (front-most) maximum of w. Early
stop: a batch of ``chunk`` instances is skipped only when the whole tile's
max T is below ``early_eps``. The backward walks the same batches front to
back with the suffix-sum trick of ``_bwd_win_kernel``: with the per-pixel
seed D = C.dC + T_final.dT and the inclusive prefix p of w (c.dC), the
suffix is S = D - p and dalpha = T (c.dC) - S / (1 - alpha).

B1, B5 and B2 pass over the instance-pixel pairs that certainly fail the
alpha cut (``csrc/blend_cull.cuh``); :func:`_cull_q_cut` and
:func:`_cull_rect_skip` mirror that test in plain PyTorch for the tests.

B1 and B2 take the sharded render's interleaved tile lattice
(``render/tiles.py::Lattice``): local tile (i, j) of the shard's
[tiles_y * ts, tiles_x * ts] image blends the pixels of global tile
(row_phase + i * row_stride, col_phase + j * col_stride). At the default
lattice they blend the single-device grid.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.config import UNLABELED
from gsplat_tpu_torch.render.tiles import FULL, Lattice

# Columns of the [N, 16] per-gaussian parameter table (render/api.py
# pack_table). P_GID carries the gaussian index as f32 (exact for N < 2^24).
(P_MX, P_MY, P_CA, P_CB, P_CC, P_OP, P_R, P_G, P_B, P_VALID, P_LABEL,
 P_GID) = range(12)
PARAM_ROWS = 16

# the kernel keeps at most 4 pixels per thread in registers, 256 threads
MAX_TILE_PIXELS = 1024
# the early-stop batch sizes the blend wrappers take (B1 and B2 stage 64
# instances at a time whatever the chunk)
MAX_CHUNK = 1024

# Margins of the skip test of B5 and B2 (csrc/blend_cull.cuh, where the
# reasons are): on the cut's q, relative to 1 + |ln op| + |ln alpha_min|; on
# a rectangle's least q, relative to the terms' magnitude; on the conic's
# determinant, relative to ca * cc.
CULL_CUT_MARGIN = 1e-4
CULL_RECT_MARGIN = 1e-5
CULL_DET_MARGIN = 1e-5


def _cull_q_cut(op: torch.Tensor, alpha_min: float) -> torch.Tensor:
    """Plain mirror of ``blend_cull.cuh::q_cut``, the C code's f32
    operations in its order: the q beyond which ``op * exp(-q / 2)`` is
    certainly below ``alpha_min``. Used by the tests."""
    lop = torch.log(op)
    lam = torch.log(torch.tensor(alpha_min, dtype=torch.float32,
                                 device=op.device))
    qc = 2.0 * (lop - lam)
    return qc + CULL_CUT_MARGIN * (1.0 + lop.abs() + lam.abs())


def _cull_rect_skip(mx, my, ca, cb, cc, thr, cx0, cx1, cy0, cy1
                    ) -> torch.Tensor:
    """Plain mirror of ``blend_cull.cuh::rect_skips``: True where no pixel
    centre of the rectangle [cx0, cx1] x [cy0, cy1] (tile-local, as the
    kernels' px, py) can pass the cut of an instance with tile-local mean
    (mx, my), conic (ca, cb, cc) and ``thr`` = :func:`_cull_q_cut`. f32
    tensors that broadcast; ``fmax``/``fmin`` as C's. Used by the tests."""
    fmax, fmin = torch.fmax, torch.fmin
    acc = ca * cc
    definite = (ca > 0.0) & (acc - cb * cb > CULL_DET_MARGIN * acc)
    x0, x1 = cx0 - mx, cx1 - mx
    y0, y1 = cy0 - my, cy1 - my
    inside = (x0 <= 0.0) & (0.0 <= x1) & (y0 <= 0.0) & (0.0 <= y1)
    ncb = -cb
    cb2 = 2.0 * cb
    clip = lambda x, lo, hi: fmin(fmax(x, lo), hi)

    def edge_x(ex):
        ys = clip(ncb * ex / cc, y0, y1)
        return (ca * ex + cb2 * ys) * ex + cc * ys * ys

    def edge_y(ey):
        xs = clip(ncb * ey / ca, x0, x1)
        return (cc * ey + cb2 * xs) * ey + ca * xs * xs

    m = fmin(fmin(edge_x(x0), edge_x(x1)), fmin(edge_y(y0), edge_y(y1)))
    m = torch.where(inside, torch.zeros_like(m), m)
    ax = fmax(x0.abs(), x1.abs())
    ay = fmax(y0.abs(), y1.abs())
    mag = (ca * ax + 2.0 * cb.abs() * ay) * ax + cc * ay * ay
    return definite & (m - CULL_RECT_MARGIN * mag > thr)


class BlendOutput(NamedTuple):
    rgb: torch.Tensor                    # [H, W, 3] f32, no background
    transmittance: torch.Tensor          # [H, W] f32
    best_weight: Optional[torch.Tensor]  # [H, W] f32 (with labels)
    label: Optional[torch.Tensor]        # [H, W] i32, UNLABELED if none


def _tiles_to_image(x: torch.Tensor, tiles_x: int, tiles_y: int,
                    tile_size: int, width: int, height: int) -> torch.Tensor:
    """[T, C, P] tile rows -> [H, W, C] image (crop padding)."""
    c = x.shape[1]
    img = x.reshape(tiles_y, tiles_x, c, tile_size, tile_size)
    img = img.permute(0, 3, 1, 4, 2).reshape(
        tiles_y * tile_size, tiles_x * tile_size, c)
    return img[:height, :width]


def _check_stream(name, ptab, inst_gauss, tile_bounds, *, tiles_x, tiles_y,
                  tile_size, width, height, chunk) -> None:
    """Raise on what the blend kernels do not take."""
    if ptab.dtype != torch.float32 or ptab.dim() != 2 or \
            ptab.shape[1] != PARAM_ROWS:
        raise ValueError(f"{name} takes an f32 [N, 16] table")
    if inst_gauss.dtype != torch.int32 or inst_gauss.dim() != 1:
        raise ValueError(f"{name} takes i32 [B] gaussian indices")
    if tile_bounds.dtype != torch.int32 or \
            tile_bounds.shape != (tiles_x * tiles_y + 1,):
        raise ValueError(f"{name} takes i32 [T + 1] tile bounds")
    if not (ptab.is_contiguous() and inst_gauss.is_contiguous()
            and tile_bounds.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if inst_gauss.device != ptab.device or tile_bounds.device != ptab.device:
        raise ValueError(f"{name} inputs lie on different devices")
    if tile_size * tile_size > MAX_TILE_PIXELS or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"{name} needs tile_size^2 <= {MAX_TILE_PIXELS} "
                         f"and 1 <= chunk <= {MAX_CHUNK}")
    if width > tiles_x * tile_size or height > tiles_y * tile_size:
        raise ValueError("the tile grid does not cover the image")


def _tile_origins(tiles_x: int, tiles_y: int, tile_size: int,
                  lattice: Lattice, device):
    """[T] f32 pixel origins (x, y) of each local tile's global tile."""
    tid = torch.arange(tiles_x * tiles_y, device=device)
    row_stride, row_phase, col_stride, col_phase = lattice
    x0 = (col_phase + (tid % tiles_x) * col_stride) * tile_size
    y0 = (row_phase + (tid // tiles_x) * row_stride) * tile_size
    return x0.to(torch.float32), y0.to(torch.float32)


def _blend_tiles_fwd_plain(ptab, inst_gauss, tile_bounds, *, tiles_x,
                           tiles_y, tile_size, width, height, chunk,
                           alpha_min, alpha_max, early_eps, with_labels,
                           lattice: Lattice = FULL) -> BlendOutput:
    """Plain PyTorch version of kernel B1's one-block walk: one step per
    stream position, vectorized over tiles and pixels, in the kernel's
    operation order (each tile composites its l-th instance at step l), so
    on the card the two agree bit for bit wherever exp does."""
    out, _ = _blend_plain(ptab, inst_gauss, tile_bounds, tiles_x=tiles_x,
                          tiles_y=tiles_y, tile_size=tile_size, width=width,
                          height=height, chunk=chunk, alpha_min=alpha_min,
                          alpha_max=alpha_max, early_eps=early_eps,
                          with_labels=with_labels, inst_max=False,
                          lattice=lattice)
    return out


class _Composite(NamedTuple):
    """The per-pixel state of the plain walks, [V, ...] tile rows."""
    trans: torch.Tensor    # [V, P] f32
    rgb: torch.Tensor      # [V, 3, P] f32
    best_w: torch.Tensor   # [V, P] f32
    label: torch.Tensor    # [V, P] i32


def _fresh_composite(rows: int, npix: int, device) -> _Composite:
    return _Composite(
        torch.ones(rows, npix, device=device),
        torch.zeros(rows, 3, npix, device=device),
        torch.zeros(rows, npix, device=device),
        torch.full((rows, npix), UNLABELED, dtype=torch.int32,
                   device=device))


def _walk_plain(ptab, inst_gauss, start, cnt, x0f, y0f, state: _Composite,
                *, tile_size, chunk, alpha_min, alpha_max, early_eps,
                with_labels, inst_max):
    """B1's walk of V ranges ``[start, start + cnt)`` of the stream ([V]
    i64), each over the pixels of a tile with origin (``x0f``, ``y0f``),
    from ``state``: one step per stream position, a batch of ``chunk`` run
    only while its range's max T is at least ``early_eps``. Returns the
    state, the instances each walk took before it stopped ([V] i64, ``cnt``
    where it reached its range's end), and with ``inst_max`` each instance's
    max blend weight, [B] f32 (0 for those not walked)."""
    dev = ptab.device
    trans, rgb, best_w, label = state
    steps = int(cnt.max()) if cnt.numel() else 0
    pid = torch.arange(tile_size * tile_size, device=dev)
    px = ((pid % tile_size).to(torch.float32) + 0.5)[None, :]
    py = ((pid // tile_size).to(torch.float32) + 0.5)[None, :]
    alive = torch.ones(cnt.shape[0], dtype=torch.bool, device=dev)
    walked = cnt.clone()
    last = max(inst_gauss.shape[0] - 1, 0)
    inst_w = (torch.zeros(inst_gauss.shape[0], device=dev) if inst_max
              else None)
    for step in range(steps):
        if step % chunk == 0:
            stop = alive & ~(trans.amax(dim=1) >= early_eps) & (step < cnt)
            walked = torch.where(stop, step, walked)
            alive = alive & ~stop
        run = alive & (step < cnt)
        live = run[:, None]
        g = inst_gauss[torch.clamp(start + step, max=last)].long()
        row = ptab[g]                                          # [V, 16]
        mx = (row[:, P_MX] - x0f)[:, None]
        my = (row[:, P_MY] - y0f)[:, None]
        dx = px - mx
        dy = py - my
        q = ((row[:, P_CA, None] * dx + (2.0 * row[:, P_CB, None]) * dy) * dx
             + row[:, P_CC, None] * dy * dy)
        alpha = torch.clamp_max(row[:, P_OP, None] * torch.exp(-0.5 * q),
                                alpha_max)
        alpha = torch.where((alpha >= alpha_min) & live, alpha,
                            torch.zeros_like(alpha))
        w = trans * alpha
        rgb = rgb + w[:, None, :] * row[:, P_R:P_B + 1, None]
        if with_labels:
            better = w > best_w
            best_w = torch.where(better, w, best_w)
            lab = torch.round(row[:, P_LABEL]).to(torch.int32)[:, None]
            label = torch.where(better, lab, label)
        if inst_max:
            inst_w[(start + step)[run]] = w.amax(dim=1)[run]
        trans = trans * (1.0 - alpha)
    return _Composite(trans, rgb, best_w, label), walked, inst_w


def _composite_image(c: _Composite, *, tiles_x, tiles_y, tile_size, width,
                     height, with_labels) -> BlendOutput:
    to_img = lambda x: _tiles_to_image(x, tiles_x, tiles_y, tile_size,
                                       width, height)
    return BlendOutput(
        rgb=to_img(c.rgb).contiguous(),
        transmittance=to_img(c.trans[:, None])[..., 0],
        best_weight=to_img(c.best_w[:, None])[..., 0] if with_labels else None,
        label=to_img(c.label[:, None])[..., 0] if with_labels else None)


def _blend_plain(ptab, inst_gauss, tile_bounds, *, tiles_x, tiles_y,
                 tile_size, width, height, chunk, alpha_min, alpha_max,
                 early_eps, with_labels, inst_max, lattice: Lattice = FULL):
    """The forward recurrence of B1 and B5, one walk a tile. With
    ``inst_max`` it also returns each instance's max blend weight over all
    pixels of its tile (those past the image edge included), [B] f32, 0
    past the last tile."""
    num_tiles = tiles_x * tiles_y
    x0f, y0f = _tile_origins(tiles_x, tiles_y, tile_size, lattice,
                             ptab.device)
    state, _, inst_w = _walk_plain(
        ptab, inst_gauss, tile_bounds[:-1].long(),
        (tile_bounds[1:] - tile_bounds[:-1]).long(), x0f, y0f,
        _fresh_composite(num_tiles, tile_size * tile_size, ptab.device),
        tile_size=tile_size, chunk=chunk, alpha_min=alpha_min,
        alpha_max=alpha_max, early_eps=early_eps, with_labels=with_labels,
        inst_max=inst_max)
    return _composite_image(state, tiles_x=tiles_x, tiles_y=tiles_y,
                            tile_size=tile_size, width=width, height=height,
                            with_labels=with_labels), inst_w


# The split of B1's long tiles (csrc/blend_fwd.cu): a segment is never
# shorter than this many instances. A one-block walk this short takes about
# a tenth of a millisecond on the card, less than a frame gains from
# spreading it; the card tests' frames (tiles of at most ~650 instances)
# stay one block a tile.
SPLIT_MIN = 1024
# A tile is split when it is longer than SPLIT_ABOVE even shares of the
# stream over the card's resident blocks, into segments of an even share
# over SPLIT_PER_BLOCK. A split tile walks the segments past its stop and
# walks one again, so it pays only where one tile's walk is far longer than
# the others': the limb tiles of a dense scene seen from afar (B1 10-13 ->
# ~2 ms on m360-overview frames). On frames whose tiles are within about
# twice an even share (chip_smoke's 2M frame, an m360 rig view) any split
# made B1 slower, by up to 1.8x (PERF.md).
SPLIT_ABOVE = 2
SPLIT_PER_BLOCK = 4


def split_lengths(num_instances: int, chunk: int, resident_blocks: int
                  ) -> tuple[int, int]:
    """(split_above, seg_len) of B1's split walk: with S the even share of
    the stream's ``num_instances`` over the card's ``resident_blocks``, a
    tile longer than ``split_above`` = SPLIT_ABOVE S is cut into segments
    of ``seg_len`` = S / SPLIT_PER_BLOCK instances, each at least
    :data:`SPLIT_MIN` and rounded up to a multiple of ``chunk``, so that
    every cut is a batch boundary of the one-block walk."""
    share = -(-num_instances // max(resident_blocks, 1))
    up = lambda n: -(-max(n, SPLIT_MIN) // chunk) * chunk
    seg_len = up(-(-share // SPLIT_PER_BLOCK))
    return max(up(SPLIT_ABOVE * share), seg_len), seg_len


def _split_plan(tile_bounds: torch.Tensor, seg_len: int, split_above: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(tile, segment) [S] i64 of each block of B1's split launch that has
    a segment to walk, in the kernel's order: block t takes the first
    segment, or the whole range, of tile t; then come the segments after
    the first of each tile longer than ``split_above``, tile by tile.
    Segment k of such a tile is its instances [start + k seg_len, start +
    (k + 1) seg_len), cut at the tile's end."""
    cnt = (tile_bounds[1:] - tile_bounds[:-1]).long()
    num_tiles = cnt.shape[0]
    more = torch.where(cnt > split_above, (cnt - 1) // seg_len, 0)
    tid = torch.arange(num_tiles, device=cnt.device)
    later = torch.repeat_interleave(tid, more)
    first = torch.repeat_interleave(torch.cumsum(more, 0) - more, more)
    seg = torch.arange(later.shape[0], device=cnt.device) - first + 1
    return torch.cat([tid, later]), torch.cat([torch.zeros_like(tid), seg])


def _blend_tiles_fwd_split_plain(ptab, inst_gauss, tile_bounds, *, seg_len,
                                 split_above, tiles_x, tiles_y, tile_size,
                                 width, height, chunk, alpha_min, alpha_max,
                                 early_eps, with_labels,
                                 lattice: Lattice = FULL) -> BlendOutput:
    """Plain PyTorch version of kernel B1's split walk (``seg_len`` > 0, a
    multiple of ``chunk``, of the tiles longer than ``split_above`` >=
    ``seg_len``), in the kernel's order: every segment of
    :func:`_split_plan` walked from T = 1 with its own early stop, then
    each tile's partials merged front to back; at each segment boundary the
    one-block walk's stop test on the composite so far; C += T C_k, T *= T_k
    and the best weight T best_k where it beats the best so far, when
    segment k ran to its end and the tile max of the product is at least
    ``early_eps``; else segment k walked again from the composite so far.
    A tile no longer than ``split_above`` is one walk, bit for bit
    :func:`_blend_tiles_fwd_plain`'s. (The kernel's later segments also quit
    once the first has published the tile's stop; the merge then never
    reads them, so the result is the same.)"""
    dev = ptab.device
    npix = tile_size * tile_size
    start = tile_bounds[:-1].long()
    cnt = (tile_bounds[1:] - tile_bounds[:-1]).long()
    x0f, y0f = _tile_origins(tiles_x, tiles_y, tile_size, lattice, dev)
    tile, seg = _split_plan(tile_bounds, seg_len, split_above)
    nseg = torch.where(cnt > split_above, (cnt - 1) // seg_len + 1, 1)
    # block of segment k >= 1 of tile t: T + P(t) + k - 1; of segment 0: t
    later_first = cnt.shape[0] + torch.cumsum(nseg - 1, 0) - (nseg - 1)
    seg_start = start[tile] + seg * seg_len
    seg_cnt = torch.where(nseg[tile] == 1, cnt[tile],
                          torch.clamp(cnt[tile] - seg * seg_len,
                                      max=seg_len))
    wkw = dict(tile_size=tile_size, chunk=chunk, alpha_min=alpha_min,
               alpha_max=alpha_max, early_eps=early_eps,
               with_labels=with_labels, inst_max=False)
    parts, walked, _ = _walk_plain(
        ptab, inst_gauss, seg_start, seg_cnt, x0f[tile], y0f[tile],
        _fresh_composite(tile.shape[0], npix, dev), **wkw)
    ran = walked == seg_cnt
    tid = torch.arange(cnt.shape[0], device=dev)
    state = _Composite(*(x[tid] for x in parts))
    stopped = torch.zeros(cnt.shape[0], dtype=torch.bool, device=dev)
    for k in range(1, int(nseg.max()) if cnt.numel() else 1):
        go = (nseg > k) & ~stopped
        stopped = stopped | (go & ~(state.trans.amax(dim=1) >= early_eps))
        go = go & ~stopped
        slot = torch.where(go, later_first + k - 1, 0)
        t_k, c_k, bw_k, lab_k = (x[slot] for x in parts)
        trans = state.trans * t_k
        rgb = state.rgb + state.trans[:, None, :] * c_k
        bw = state.trans * bw_k
        better = bw > state.best_w
        cand = _Composite(trans, rgb, torch.where(better, bw, state.best_w),
                          torch.where(better, lab_k, state.label))
        take = go & ran[slot] & (trans.amax(dim=1) >= early_eps)
        state = _Composite(*(torch.where(
            take.view(-1, *[1] * (new.dim() - 1)), new, old)
            for new, old in zip(cand, state)))
        again = torch.nonzero(go & ~take)[:, 0]
        if again.numel():
            b0 = start[again] + k * seg_len
            n = torch.where(nseg[again] == k + 1, cnt[again] - k * seg_len,
                            seg_len)
            redone, _, _ = _walk_plain(
                ptab, inst_gauss, b0, n, x0f[again], y0f[again],
                _Composite(*(x[again] for x in state)), **wkw)
            state = _Composite(*(x.index_copy(0, again, y)
                                 for x, y in zip(state, redone)))
    return _composite_image(state, tiles_x=tiles_x, tiles_y=tiles_y,
                            tile_size=tile_size, width=width, height=height,
                            with_labels=with_labels)


# per device: the resident blocks of B1's split kernel (SMs x blocks an SM)
_RESIDENT_BLOCKS: dict = {}
# the split's words of a tile and a segment's planes (csrc/blend_fwd.cu
# kTileWords, kPartPlanes)
SPLIT_TILE_WORDS = 3
SPLIT_PART_PLANES = 5


def _resident_blocks(dev: torch.device) -> int:
    if dev not in _RESIDENT_BLOCKS:
        _RESIDENT_BLOCKS[dev] = (
            torch.cuda.get_device_properties(dev).multi_processor_count
            * _kernels.occupancy("blend_fwd")["blocks_per_sm"])
    return _RESIDENT_BLOCKS[dev]


def _split_scratch(dev: torch.device, num_tiles: int, slots: int,
                   npix: int) -> list:
    """B1's scratch on ``dev`` for a split launch of ``num_tiles`` tiles
    and ``slots`` blocks of ``npix`` pixels, kept between calls, each buffer
    grown (by a quarter more than asked) when a call needs more: the
    per-tile words, zero between launches (the merging block resets its
    tile's; a grown buffer starts at zero), the segments' f32 planes, and
    their i32 labels and ends. A CUDA graph holds the buffers it captured:
    replay it only while no larger call has grown them."""
    need = (SPLIT_TILE_WORDS * num_tiles, slots * SPLIT_PART_PLANES * npix,
            slots * (npix + 1))
    have = blend_tiles_fwd.scratch.setdefault(dev, [None] * 3)
    made = (lambda n: torch.zeros(n, dtype=torch.int32, device=dev),
            lambda n: torch.empty(n, device=dev),
            lambda n: torch.empty(n, dtype=torch.int32, device=dev))
    for i, (n, make) in enumerate(zip(need, made)):
        if have[i] is None or have[i].numel() < n:
            have[i] = make(n + n // 4)
    return list(have)


def _split_stats(dev: torch.device) -> torch.Tensor:
    stats = blend_tiles_fwd.splits
    if dev not in stats:
        stats[dev] = torch.zeros(3, dtype=torch.int64, device=dev)
    return stats[dev]


def split_counts(device) -> dict:
    """Tiles that B1 split, the segments they ran in and the segments the
    merge walked again, summed over every launch on ``device`` so far.
    Reads the card: call it after a frame, never on its path."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"tiles": 0, "segments": 0, "walked_again": 0}
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    tiles, segments, again = _split_stats(dev).tolist()
    return {"tiles": tiles, "segments": segments, "walked_again": again}


def split_launch(total: int, num_tiles: int, chunk: int,
                 dev: torch.device, replayed: bool,
                 frame_instances: Optional[int] = None
                 ) -> tuple[int, int, int]:
    """(seg_len, split_above, extra) of B1's launch on the card over a
    stream of ``total`` instances, the tiles of a frame whose whole stream
    holds ``frame_instances`` (by default ``total``): (0, 0, 0), one block a
    tile, where the walk is ``replayed`` by B2 or no tile can be longer
    than the ``split_above`` that :func:`split_lengths` gives the frame;
    else the lengths and the blocks after the first segments (the grid is
    ``num_tiles + extra``)."""
    if replayed or not num_tiles:
        return 0, 0, 0
    split_above, seg_len = split_lengths(
        total if frame_instances is None else frame_instances, chunk,
        _resident_blocks(dev))
    if total <= split_above:
        return 0, 0, 0
    return seg_len, split_above, -(-total // seg_len)


def blend_tiles_fwd(ptab: torch.Tensor, inst_gauss: torch.Tensor,
                    tile_bounds: torch.Tensor, *, tiles_x: int, tiles_y: int,
                    tile_size: int, width: int, height: int, chunk: int,
                    alpha_min: float, alpha_max: float, early_eps: float,
                    with_labels: bool, lattice: Lattice = FULL,
                    frame_instances: Optional[int] = None) -> BlendOutput:
    """Kernel B1 wrapper: composite every tile's range
    ``inst_gauss[tile_bounds[t]:tile_bounds[t+1]]`` of the depth-sorted
    stream, reading parameters from the [N, 16] table ``ptab``; local tile
    t of ``lattice`` (module docstring).

    Replaces ``gsplat_tpu/render/blend_pallas.py::_fwd_win_kernel``. On the
    card it launches ``csrc/blend_fwd.cu`` once: 256-thread blocks that
    walk a tile's range in batches of ``chunk`` instances, each staged in
    sub-batches of 64; a warp passes over an instance that misses its 32x4
    strip, and a pixel tests q before the exp (``csrc/blend_cull.cuh``:
    conservative with a stated margin, so T, RGB, the best weight and the
    label are those of the unculled walk). Where ``ptab`` records a
    gradient, kernel B2 will replay the walk's T and stop decisions bit for
    bit, so each tile is one block's walk. Elsewhere a tile longer than
    the ``split_above`` of :func:`split_lengths` (twice the stream's even
    share over the card's resident blocks) is cut on batch boundaries into
    segments that blocks of the same launch walk, and its last block to
    finish merges them front to back with the one-block walk's early stop
    (:func:`_blend_tiles_fwd_split_plain`; only the merge's products are
    associated differently); a shorter tile is still one block's walk, bit
    for bit. The lengths come from the stream of the whole frame whose
    tiles the launch walks, ``frame_instances`` instances, by default this
    stream's: a shard of the sharded render passes its frame's, so that
    each tile is cut as ``render`` cuts it. :func:`split_counts` reads what
    was split. CPU tensors take the one-block walk's plain version."""
    _check_stream("blend_tiles_fwd", ptab, inst_gauss, tile_bounds,
                  tiles_x=tiles_x, tiles_y=tiles_y, tile_size=tile_size,
                  width=width, height=height, chunk=chunk)
    dev = ptab.device
    num_tiles = tiles_x * tiles_y
    kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_size=tile_size,
              width=width, height=height, chunk=chunk, alpha_min=alpha_min,
              alpha_max=alpha_max, early_eps=early_eps,
              with_labels=with_labels, lattice=lattice)
    if dev.type == "cpu":
        return _blend_tiles_fwd_plain(ptab, inst_gauss, tile_bounds, **kw)
    if dev.type != "cuda":
        raise ValueError(f"blend_tiles_fwd: no kernel for {dev}")
    rgb = torch.empty(height, width, 3, device=dev)
    trans = torch.empty(height, width, device=dev)
    best_w = torch.empty(height, width, device=dev) if with_labels else None
    label = (torch.empty(height, width, dtype=torch.int32, device=dev)
             if with_labels else None)
    seg_len, split_above, extra = split_launch(
        inst_gauss.shape[0], num_tiles, chunk, dev, ptab.requires_grad,
        frame_instances)
    scratch = [None] * 4
    if seg_len:
        scratch = _split_scratch(dev, num_tiles, extra + num_tiles,
                                 tile_size * tile_size)
        scratch.append(_split_stats(dev))
    fn = _kernels.function("blend_fwd")
    err = fn(ptab.data_ptr(), inst_gauss.data_ptr(), tile_bounds.data_ptr(),
             num_tiles, tiles_x, tile_size, width, height, chunk, *lattice,
             alpha_min, alpha_max, early_eps, int(with_labels), seg_len,
             split_above, extra, *(t.data_ptr() if t is not None else None
                      for t in scratch),
             rgb.data_ptr(), trans.data_ptr(),
             best_w.data_ptr() if with_labels else None,
             label.data_ptr() if with_labels else None, _kernels.stream(dev))
    blend_tiles_fwd.launches += 1
    _kernels.check("blend_fwd", err)
    return BlendOutput(rgb, trans, best_w, label)


blend_tiles_fwd.launches = 0
# per device: the split's scratch (_split_scratch) and its counter of tiles
# split, segments and segments walked again (split_counts)
blend_tiles_fwd.scratch = {}
blend_tiles_fwd.splits = {}


def _blend_tiles_vis_plain(ptab, inst_gauss, tile_bounds, *, tiles_x,
                           tiles_y, tile_size, width, height, chunk,
                           alpha_min, alpha_max, with_labels):
    """Plain PyTorch version of kernel B5: B1's plain recurrence with no
    early stop, plus each instance's max blend weight over its tile."""
    return _blend_plain(ptab, inst_gauss, tile_bounds, tiles_x=tiles_x,
                        tiles_y=tiles_y, tile_size=tile_size, width=width,
                        height=height, chunk=chunk, alpha_min=alpha_min,
                        alpha_max=alpha_max, early_eps=0.0,
                        with_labels=with_labels, inst_max=True)


def blend_tiles_vis(ptab: torch.Tensor, inst_gauss: torch.Tensor,
                    tile_bounds: torch.Tensor, *, tiles_x: int, tiles_y: int,
                    tile_size: int, width: int, height: int, chunk: int,
                    alpha_min: float, alpha_max: float, with_labels: bool
                    ) -> tuple[BlendOutput, torch.Tensor]:
    """Kernel B5 wrapper: B1's blend of the sorted stream with no early
    stop, and each instance's max blend weight ``w = T * alpha`` over all
    tile_size^2 pixels of its tile, [B] f32 in sorted-stream order (0 for
    filtered slots past the last tile). Not differentiable.

    Replaces ``gsplat_tpu/render/blend_pallas.py::_fwd_win_vis_kernel``. On
    the card it launches ``csrc/blend_vis.cu``: one 256-thread block per
    16x16 sub-tile (four per 32-px tile), each walking its tile's whole
    range in batches of 256 instances; an instance whose cut ellipse misses
    the sub-tile is dropped before its colour is gathered, a warp passes over
    one that misses its 16x2 strip, and a pixel tests q before the exp
    (``csrc/blend_cull.cuh``: conservative with a stated margin, so the
    outputs equal the plain version's). Each block's per-instance max goes
    to the row with an atomic max on the f32 bits. What still bounds it on
    the card: each sub-tile block stages and tests its whole tile's range,
    so the busiest tile sets the time. B5 has no early stop, so ``chunk``
    does not reach the kernel. CPU tensors take the plain version."""
    _check_stream("blend_tiles_vis", ptab, inst_gauss, tile_bounds,
                  tiles_x=tiles_x, tiles_y=tiles_y, tile_size=tile_size,
                  width=width, height=height, chunk=chunk)
    dev = ptab.device
    kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_size=tile_size,
              width=width, height=height, chunk=chunk, alpha_min=alpha_min,
              alpha_max=alpha_max, with_labels=with_labels)
    if dev.type == "cpu":
        return _blend_tiles_vis_plain(ptab, inst_gauss, tile_bounds, **kw)
    if dev.type != "cuda":
        raise ValueError(f"blend_tiles_vis: no kernel for {dev}")
    if ptab.data_ptr() % 16:
        raise ValueError("blend_tiles_vis takes a 16-byte aligned table")
    total = inst_gauss.shape[0]
    rgb = torch.empty(height, width, 3, device=dev)
    trans = torch.empty(height, width, device=dev)
    best_w = torch.empty(height, width, device=dev) if with_labels else None
    label = (torch.empty(height, width, dtype=torch.int32, device=dev)
             if with_labels else None)
    inst_w = torch.empty(total, device=dev)
    fn = _kernels.function("blend_vis")
    err = fn(ptab.data_ptr(), inst_gauss.data_ptr(), tile_bounds.data_ptr(),
             tiles_x * tiles_y, tiles_x, tile_size, width, height,
             alpha_min, alpha_max, int(with_labels), rgb.data_ptr(),
             trans.data_ptr(), best_w.data_ptr() if with_labels else None,
             label.data_ptr() if with_labels else None, inst_w.data_ptr(),
             total, _kernels.stream(dev))
    blend_tiles_vis.launches += 1
    _kernels.check("blend_vis", err)
    return BlendOutput(rgb, trans, best_w, label), inst_w


blend_tiles_vis.launches = 0


def _image_to_tiles(img: torch.Tensor, tiles_x: int, tiles_y: int,
                    tile_size: int) -> torch.Tensor:
    """[H, W, C] image -> [T, C, P] tile rows, zero outside the image (the
    inverse of :func:`_tiles_to_image`)."""
    h, w, c = img.shape
    pad = img.new_zeros(tiles_y * tile_size, tiles_x * tile_size, c)
    pad[:h, :w] = img
    pad = pad.reshape(tiles_y, tile_size, tiles_x, tile_size, c)
    return pad.permute(0, 2, 4, 1, 3).reshape(tiles_x * tiles_y, c,
                                              tile_size * tile_size)


def _blend_tiles_bwd_plain(ptab, inst_gauss, tile_bounds, rgb, trans, drgb,
                           dtrans, *, tiles_x, tiles_y, tile_size, width,
                           height, chunk, alpha_min, alpha_max, early_eps,
                           lattice: Lattice = FULL) -> torch.Tensor:
    """Plain PyTorch version of kernel B2: the kernel's recurrence, one step
    per stream position, vectorized over tiles and pixels (like
    :func:`_blend_tiles_fwd_plain`, not autograd through it). T and the
    prefix are formed with the kernel's operations in its order; only the
    sums over a tile's pixels are associated differently."""
    del width, height
    dev = ptab.device
    num_tiles = tiles_x * tiles_y
    npix = tile_size * tile_size
    start = tile_bounds[:-1].long()
    cnt = (tile_bounds[1:] - tile_bounds[:-1]).long()
    steps = int(cnt.max()) if num_tiles else 0
    pid = torch.arange(npix, device=dev)
    px = ((pid % tile_size).to(torch.float32) + 0.5)[None, :]
    py = ((pid // tile_size).to(torch.float32) + 0.5)[None, :]
    x0f, y0f = _tile_origins(tiles_x, tiles_y, tile_size, lattice, dev)
    to_tiles = lambda x: _image_to_tiles(x, tiles_x, tiles_y, tile_size)
    c_t, dc_t = to_tiles(rgb), to_tiles(drgb)                # [T, 3, P]
    t_fin = to_tiles(trans[..., None])[:, 0]
    dt_fin = to_tiles(dtrans[..., None])[:, 0]
    dr, dg, db = dc_t[:, 0], dc_t[:, 1], dc_t[:, 2]
    seed = (c_t[:, 0] * dr + c_t[:, 1] * dg + c_t[:, 2] * db
            + t_fin * dt_fin)
    t_run = torch.ones(num_tiles, npix, device=dev)
    prefix = torch.zeros(num_tiles, npix, device=dev)
    drows = torch.zeros(inst_gauss.shape[0], PARAM_ROWS, device=dev)
    alive = torch.ones(num_tiles, dtype=torch.bool, device=dev)
    last = max(inst_gauss.shape[0] - 1, 0)
    zero = torch.zeros(num_tiles, device=dev)
    for step in range(steps):
        if step % chunk == 0:
            alive = alive & (t_run.amax(dim=1) >= early_eps)
        run = alive & (step < cnt)
        g = inst_gauss[torch.clamp(start + step, max=last)].long()
        row = ptab[g]                                          # [T, 16]
        ca, cb, cc, op = (row[:, P_CA], row[:, P_CB], row[:, P_CC],
                          row[:, P_OP])
        dx = px - (row[:, P_MX] - x0f)[:, None]
        dy = py - (row[:, P_MY] - y0f)[:, None]
        q = ((ca[:, None] * dx + (2.0 * cb)[:, None] * dy) * dx
             + cc[:, None] * dy * dy)
        raw = op[:, None] * torch.exp(-0.5 * q)
        alpha = torch.clamp_max(raw, alpha_max)
        live = (alpha >= alpha_min) & run[:, None]
        alpha = torch.where(live, alpha, torch.zeros_like(alpha))
        w = t_run * alpha
        cgrad = (row[:, P_R, None] * dr + row[:, P_G, None] * dg
                 + row[:, P_B, None] * db)
        contrib = w * cgrad
        prefix = prefix + contrib
        one_m = 1.0 - alpha
        dq = torch.where(live & (raw < alpha_max),
                         -0.5 * (contrib - (seed - prefix) * (alpha / one_m)),
                         torch.zeros_like(alpha))
        t1 = dq * dx
        t2 = dq * dy
        cx, cy = t1.sum(1), t2.sum(1)
        vals = torch.stack(
            [-2.0 * ca * cx - 2.0 * cb * cy, -2.0 * cc * cy - 2.0 * cb * cx,
             (t1 * dx).sum(1), 2.0 * (t1 * dy).sum(1), (t2 * dy).sum(1),
             -2.0 * dq.sum(1) / torch.clamp_min(op, 1e-20),
             (w * dr).sum(1), (w * dg).sum(1), (w * db).sum(1)]
            + [zero] * (PARAM_ROWS - 9), dim=1)
        drows[(start + step)[run]] = vals[run]
        t_run = t_run * one_m
    return drows


def blend_tiles_bwd(ptab: torch.Tensor, inst_gauss: torch.Tensor,
                    tile_bounds: torch.Tensor, rgb: torch.Tensor,
                    transmittance: torch.Tensor, drgb: torch.Tensor,
                    dtrans: torch.Tensor, *, tiles_x: int, tiles_y: int,
                    tile_size: int, width: int, height: int, chunk: int,
                    alpha_min: float, alpha_max: float, early_eps: float,
                    lattice: Lattice = FULL) -> torch.Tensor:
    """Kernel B2 wrapper: per-instance gradient rows [B, 16] in sorted-stream
    order (columns d_mx, d_my, d_ca, d_cb, d_cc, d_op, d_r, d_g, d_b; the
    rest zero) from the forward's ``rgb`` [H, W, 3] (no background) and
    ``transmittance`` [H, W] and their cotangents. Rows of instances that
    early stop skipped, and of filtered slots past the last tile, are zero.
    The lattice is B1's (module docstring).

    Replaces ``gsplat_tpu/render/blend_pallas.py::_bwd_win_kernel``. On the
    card it launches ``csrc/blend_bwd.cu``: one 256-thread block per tile
    (the early stop needs the whole tile's T), B1's batches walked front to
    back in sub-batches of 64; a warp passes over an instance whose cut
    ellipse misses its 32x4 strip and a pixel tests q before the exp
    (``csrc/blend_cull.cuh``: conservative with a stated margin, so T and
    every early-stop decision equal B1's); a live warp sums its 9 partials
    with a 12-shuffle halving butterfly, and the warps' sums are added in a
    fixed order. What still bounds it on the card: one block per tile, so
    the busiest tile sets the time. CPU tensors take the plain
    version."""
    _check_stream("blend_tiles_bwd", ptab, inst_gauss, tile_bounds,
                  tiles_x=tiles_x, tiles_y=tiles_y, tile_size=tile_size,
                  width=width, height=height, chunk=chunk)
    dev = ptab.device
    for t, shape in ((rgb, (height, width, 3)), (drgb, (height, width, 3)),
                     (transmittance, (height, width)),
                     (dtrans, (height, width))):
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"blend_tiles_bwd takes f32 image tensors of "
                             f"shape {shape}")
        if not t.is_contiguous() or t.device != dev:
            raise ValueError("blend_tiles_bwd takes contiguous image tensors "
                             "on the table's device")
    kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_size=tile_size,
              width=width, height=height, chunk=chunk, alpha_min=alpha_min,
              alpha_max=alpha_max, early_eps=early_eps, lattice=lattice)
    if dev.type == "cpu":
        return _blend_tiles_bwd_plain(ptab, inst_gauss, tile_bounds, rgb,
                                      transmittance, drgb, dtrans, **kw)
    if dev.type != "cuda":
        raise ValueError(f"blend_tiles_bwd: no kernel for {dev}")
    total = inst_gauss.shape[0]
    num_tiles = tiles_x * tiles_y
    if num_tiles == 0:
        return torch.zeros(total, PARAM_ROWS, device=dev)
    drows = torch.empty(total, PARAM_ROWS, device=dev)
    fn = _kernels.function("blend_bwd")
    err = fn(ptab.data_ptr(), inst_gauss.data_ptr(), tile_bounds.data_ptr(),
             num_tiles, tiles_x, tile_size, width, height, chunk, *lattice,
             alpha_min, alpha_max, early_eps, rgb.data_ptr(),
             transmittance.data_ptr(), drgb.data_ptr(), dtrans.data_ptr(),
             total, drows.data_ptr(), _kernels.stream(dev))
    blend_tiles_bwd.launches += 1
    _kernels.check("blend_bwd", err)
    return drows


blend_tiles_bwd.launches = 0

# rows a tile and tiles a group of csrc/cumsum_rows.cu (kBlockRows, kGroup);
# they size its scratch
CUMSUM_BLOCK_ROWS = 512
CUMSUM_GROUP = 64


def cumsum_scratch_bytes(rows: int) -> int:
    """Bytes of B3's scratch for ``rows`` rows (``csrc/cumsum_rows.cu``'s
    ``scratch_bytes``): f64 column aggregates of each 512-row tile and of
    each group of 64 tiles, then the u32 tile counter."""
    nblk = -(-rows // CUMSUM_BLOCK_ROWS)
    ngroups = -(-nblk // CUMSUM_GROUP)
    return (nblk + ngroups) * PARAM_ROWS * 8 + 4


def _cumsum_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B3."""
    return torch.cumsum(x, 0)


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Kernel B3 wrapper: inclusive prefix sum of an f32 [B, 16] array along
    its rows (one fill of the kernel's scratch, then one launch).

    Replaces ``gsplat_tpu/render/blend_pallas.py::_cumsum_rows_kernel``. On
    the card it launches ``csrc/cumsum_rows.cu``: a single-pass scan that
    reads and writes the array once (bound by bytes), each 512-row tile
    offset by a look-back of fixed order over published tile and group
    aggregates, so the output is the same bit for bit from call to call;
    CPU tensors take the plain version."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != PARAM_ROWS:
        raise ValueError("cumsum_rows takes an f32 [B, 16] array")
    if not x.is_contiguous():
        raise ValueError("cumsum_rows takes a contiguous array")
    if x.device.type == "cpu":
        return _cumsum_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"cumsum_rows: no kernel for {x.device}")
    rows = x.shape[0]
    if rows >= 2 ** 31 or x.data_ptr() % 16:
        raise ValueError("cumsum_rows takes fewer than 2^31 rows, 16-byte "
                         "aligned")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    nbytes = cumsum_scratch_bytes(rows)
    scratch = torch.empty(-(-nbytes // 8), dtype=torch.float64,
                          device=x.device)
    fn = _kernels.function("cumsum_rows")
    err = fn(x.data_ptr(), rows, scratch.data_ptr(), nbytes, out.data_ptr(),
             _kernels.stream(x.device))
    cumsum_rows.launches += 1
    _kernels.check("cumsum_rows", err)
    return out


cumsum_rows.launches = 0
