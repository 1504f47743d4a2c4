"""Kernel B1's split walk of long tiles, on the CPU: its plan
(``render/blend.py::split_lengths``, ``_split_plan``) and its plain version
``_blend_tiles_fwd_split_plain`` (the order of ``csrc/blend_fwd.cu`` with
``seg_len`` > 0) against the one-block walk ``_blend_tiles_fwd_plain``.

The streams are synthetic: tiles of 10-12k instances whose one-block walk
stops inside the first segment, inside a later one (after a segment whose
own walk ran to its end, and after one whose own walk stopped too), exactly
on a segment boundary, or never, beside a short and an empty tile. The card
holds the kernel to the same one-block walk (``tests/test_torch_kernels.py``).

This file imports neither jax nor ``gsplat_tpu``.
"""

import math

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.render import blend
from gsplat_tpu_torch.render.tiles import FULL, Lattice

torch.set_num_threads(2)

CHUNK = 64
SEG = 1024                 # the segment length of these streams
EPS = 1e-5
ALPHA_MIN = 1 / 255
# the tiles of a stream: (kind, instances)
TILES = (("dense", 10_000), ("faint", 12_000), ("mixed", 10_000),
         ("even", 10_500), ("half", 11_000), ("dense", 900), ("dense", 0))


def _tile_params(rng, kind, n, ts):
    """(mx, my, sigma, opacity) [n] of one tile's instances, tile-local."""
    uni = lambda lo, hi: rng.uniform(lo, hi, n)
    if kind == "dense":        # opaque, wide: stops in a few batches
        return uni(0, ts), uni(0, ts), uni(5, 40), uni(0.2, 0.9)
    if kind == "faint":        # faint and wide: T falls slowly everywhere
        return uni(0, ts), uni(0, ts), uni(20, 80), uni(0.004, 0.006)
    if kind == "mixed":        # faint for 1.5 segments, then dense
        faint = np.arange(n) < 1.5 * SEG
        return (uni(0, ts), uni(0, ts),
                np.where(faint, uni(20, 80), uni(5, 40)),
                np.where(faint, uni(0.004, 0.006), uni(0.2, 0.9)))
    if kind == "even":         # one alpha everywhere: T crosses EPS in the
        # last batch of the second segment, so the walk stops on its end
        a = 1 - math.exp(math.log(EPS) / (2 * SEG - CHUNK // 2))
        return (np.full(n, ts / 2), np.full(n, ts / 2), np.full(n, 1e4),
                np.full(n, a))
    assert kind == "half"      # small splats on the left: never stops
    return uni(0, ts / 2 - 6), uni(0, ts), uni(0.7, 2.0), uni(0.3, 0.99)


def _stream(tile_size, lattice=FULL, seed=0, tiles=TILES):
    """A table, stream and bounds of ``tiles`` (one tile row), means at the
    lattice's global tile origins."""
    rng = np.random.default_rng(seed)
    tx, ty = len(tiles), 1
    x0, y0 = blend._tile_origins(tx, ty, tile_size, lattice, "cpu")
    rows = []
    for t, (kind, n) in enumerate(tiles):
        mx, my, s1, op = _tile_params(rng, kind, n, tile_size)
        s2 = s1 * rng.uniform(0.3, 1.0, n)
        ang = rng.uniform(0, np.pi, n)
        c, s = np.cos(ang), np.sin(ang)
        vx = c * c * s1 ** 2 + s * s * s2 ** 2
        vy = s * s * s1 ** 2 + c * c * s2 ** 2
        vxy = c * s * (s1 ** 2 - s2 ** 2)
        det = vx * vy - vxy ** 2
        tab = np.zeros((n, blend.PARAM_ROWS), np.float32)
        tab[:, blend.P_MX] = mx + float(x0[t])
        tab[:, blend.P_MY] = my + float(y0[t])
        tab[:, blend.P_CA] = vy / det
        tab[:, blend.P_CB] = -vxy / det
        tab[:, blend.P_CC] = vx / det
        tab[:, blend.P_OP] = op
        tab[:, blend.P_R:blend.P_B + 1] = rng.uniform(0, 1, (n, 3))
        tab[:, blend.P_VALID] = 1
        tab[:, blend.P_LABEL] = rng.integers(0, 16, n)
        rows.append(tab)
    tab = torch.from_numpy(np.concatenate(rows))
    # the stream is each tile's instances in order, the table shuffled
    perm = torch.from_numpy(rng.permutation(tab.shape[0]))
    ptab = torch.empty_like(tab)
    ptab[perm] = tab
    counts = [n for _, n in tiles]
    bounds = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                          dtype=torch.int32)
    return ptab, perm.to(torch.int32), bounds, tx, ty


def _one_block_walk(ptab, inst, bounds, kw):
    """The one-block walk's image and the instances each tile walked."""
    ts, lattice = kw["tile_size"], kw["lattice"]
    x0, y0 = blend._tile_origins(kw["tiles_x"], kw["tiles_y"], ts, lattice,
                                 "cpu")
    cnt = (bounds[1:] - bounds[:-1]).long()
    state, walked, _ = blend._walk_plain(
        ptab, inst, bounds[:-1].long(), cnt, x0, y0,
        blend._fresh_composite(cnt.shape[0], ts * ts, "cpu"),
        tile_size=ts, chunk=kw["chunk"], alpha_min=kw["alpha_min"],
        alpha_max=kw["alpha_max"], early_eps=kw["early_eps"],
        with_labels=True, inst_max=False)
    out = blend._composite_image(
        state, tiles_x=kw["tiles_x"], tiles_y=kw["tiles_y"], tile_size=ts,
        width=kw["width"], height=kw["height"], with_labels=True)
    return out, walked, cnt


# (tile size, early stop, lattice, split_above)
SPLIT_CASES = {
    "tile32": (32, EPS, FULL, SEG),
    "tile16": (16, EPS, FULL, SEG),
    "tile24": (24, EPS, FULL, SEG),
    "eps0": (16, 0.0, FULL, SEG),
    "lattice": (16, EPS, Lattice(row_stride=2, row_phase=1, col_stride=3,
                                 col_phase=2), SEG),
    # only the two tiles over 10,500 instances split
    "above": (16, EPS, FULL, 10_500),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_walk_matches_one_block_walk(case):
    """rgb, T and the best weight within 1e-5 of the one-block walk, the
    labels equal; bit for bit on every tile whose walk no merge product
    reached (not split, or stopped by the end of its second segment: the
    merge keeps the first segment's walk and walks the second again from
    it)."""
    ts, eps, lattice, above = SPLIT_CASES[case]
    ptab, inst, bounds, tx, ty = _stream(ts, lattice)
    # the image is the local grid's, cropped inside the last tile
    kw = dict(tiles_x=tx, tiles_y=ty, tile_size=ts, width=tx * ts - 5,
              height=ts - 3, chunk=CHUNK, alpha_min=ALPHA_MIN,
              alpha_max=0.999, early_eps=eps, with_labels=True,
              lattice=lattice)
    ref, walked, cnt = _one_block_walk(ptab, inst, bounds, kw)
    want = blend._blend_tiles_fwd_plain(ptab, inst, bounds, **kw)
    assert all(torch.equal(a, b) for a, b in zip(ref, want))
    got = blend._blend_tiles_fwd_split_plain(ptab, inst, bounds,
                                             seg_len=SEG, split_above=above,
                                             **kw)
    for k in ("rgb", "transmittance", "best_weight"):
        err = (getattr(got, k) - getattr(ref, k)).abs().max().item()
        assert err <= 1e-5, (k, err)
    assert torch.equal(got.label, ref.label)
    for t in range(tx):
        cols = slice(t * ts, min((t + 1) * ts, kw["width"]))
        if cnt[t] <= above or (eps > 0 and walked[t] <= 2 * SEG):
            for a, b in zip(got, ref):
                assert torch.equal(a[:, cols], b[:, cols]), t
    if eps == 0:
        assert torch.equal(walked, cnt)
        return
    # the stops the streams were built to give
    dense, faint, mixed, even, half = walked[:5].tolist()
    assert dense < SEG                              # inside segment 0
    assert 2 * SEG < faint < cnt[1] and faint % SEG   # inside a later one
    assert SEG < mixed < 2 * SEG                    # inside segment 1
    assert even == 2 * SEG                          # on a segment boundary
    assert half == cnt[4]                           # never


def test_split_lengths_are_even_shares_on_batch_boundaries():
    """A straggler is longer than SPLIT_ABOVE even shares of the stream over
    the card's resident blocks; its segments are an even share over
    SPLIT_PER_BLOCK; both at least SPLIT_MIN, on multiples of chunk."""
    above, per = blend.SPLIT_ABOVE, blend.SPLIT_PER_BLOCK
    for total, chunk, blocks in ((4_456_000, 64, 528), (10 ** 7, 64, 528),
                                 (123_457, 48, 132), (5 * 10 ** 7, 1000, 1056),
                                 (1000, 64, 528), (0, 64, 528)):
        split_above, seg = blend.split_lengths(total, chunk, blocks)
        share = -(-total // blocks)
        assert seg % chunk == 0 and split_above % chunk == 0
        assert blend.SPLIT_MIN <= seg <= split_above
        assert seg * per >= share and (seg - chunk) * per < max(
            share, blend.SPLIT_MIN * per)
        assert split_above >= above * share
        assert split_above - chunk < max(above * share, blend.SPLIT_MIN, seg)
    # short streams are not split
    assert blend.split_lengths(1000, 64, 528) == (blend.SPLIT_MIN,
                                                  blend.SPLIT_MIN)


@pytest.mark.parametrize("split_above", [256, 600])
def test_split_plan_cuts_on_segment_multiples_and_leaves_short_tiles_whole(
        split_above):
    seg_len = 256
    counts = [0, 1, 255, 256, 257, 512, 513, 1300, 0, 70, 2049]
    bounds = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                          dtype=torch.int32)
    tile, seg = blend._split_plan(bounds, seg_len, split_above)
    nt = len(counts)
    # block t: the first segment of tile t
    assert tile[:nt].tolist() == list(range(nt))
    assert not seg[:nt].any()
    # then the later segments, tile by tile, in order
    pairs = list(zip(tile[nt:].tolist(), seg[nt:].tolist()))
    assert pairs == sorted(pairs)
    # the kernel's grid bounds them by the stream over the segment length
    assert len(pairs) <= -(-sum(counts) // seg_len)
    for t, n in enumerate(counts):
        ks = sorted(seg[tile == t].tolist())
        assert ks == list(range(len(ks)))
        if n <= split_above:
            assert ks == [0]             # one walk: today's, whole
            continue
        # segment k starts k seg_len in: a batch boundary of every chunk
        # that divides seg_len; the last ends at the tile's end
        starts = [k * seg_len for k in ks]
        ends = starts[1:] + [n]
        assert all(0 < e - s <= seg_len for s, e in zip(starts, ends))


def test_split_launch_takes_its_lengths_from_the_frame(monkeypatch):
    """A launch over part of a frame (a shard's lattice) cuts by the whole
    frame's lengths, its grid bounded by its own stream; one block a tile
    where the table records a gradient, where no tile of the launch's
    stream can pass the frame's split_above, or where there is no tile."""
    dev = torch.device("cuda", 0)
    monkeypatch.setitem(blend._RESIDENT_BLOCKS, dev, 528)
    frame = 4_456_000
    above, seg = blend.split_lengths(frame, CHUNK, 528)
    assert blend.split_launch(frame, 1014, CHUNK, dev, False) == (
        seg, above, -(-frame // seg))
    for part in (frame // 2, frame // 8, above + 1):
        assert blend.split_launch(part, 256, CHUNK, dev, False, frame) == (
            seg, above, -(-part // seg))
        assert blend.split_launch(part, 256, CHUNK, dev, True, frame) == (
            0, 0, 0)
    # by its own stream alone, an eighth of the frame is cut finer
    assert blend.split_launch(frame // 8, 256, CHUNK, dev, False)[0] < seg
    assert blend.split_launch(above, 256, CHUNK, dev, False, frame) == (
        0, 0, 0)
    assert blend.split_launch(frame, 0, CHUNK, dev, False) == (0, 0, 0)
