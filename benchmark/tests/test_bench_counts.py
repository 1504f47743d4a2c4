"""The frozen counts: pair counts of the reference's blend against a frame
counted by hand (a plain double loop), and the least-time rules against
numbers worked out by hand."""

import math

import pytest
import torch

from benchmark import counts
from benchmark.common import frame_counts
from benchmark.reference import render

RASTER = dict(tile=32, chunk=64, alpha_min=1.0 / 255.0, alpha_max=0.999,
              sigma_cutoff=3.33, cov2d_blur=0.3, early_stop_eps=1e-5,
              z_near=0.2, z_far=200.0)


def _one_splat(sigma=2.0, op=0.9, cx=16.0, cy=16.0):
    """A [1, 12] table: an isotropic splat in a 32x32 frame (one tile)."""
    cutoff = math.sqrt(2.0 * math.log(op / RASTER["alpha_min"]))
    t = torch.tensor([[cx, cy, 1 / sigma ** 2, 0.0, 1 / sigma ** 2, op,
                       0.2, 0.4, 0.6, cutoff * sigma, cutoff * sigma,
                       cutoff ** 2]], dtype=torch.float32)
    proj = render.Proj(t, torch.tensor([3.0]), torch.tensor([True]))
    return t, proj, cutoff


def test_pairs_of_one_splat_match_a_hand_count():
    sigma, op = 2.0, 0.9
    t, proj, cutoff = _one_splat(sigma, op)
    stream = render.bin_tiles(proj, 32, 32, 32)
    out = render.blend(t, stream, 32, 32, RASTER, chunk=64, eps=1e-5)
    box = live = 0
    for j in range(32):
        for i in range(32):
            dx, dy = i + 0.5 - 16.0, j + 0.5 - 16.0
            alpha = op * math.exp(-0.5 * (dx * dx + dy * dy) / sigma ** 2)
            inbox = abs(dx) <= cutoff * sigma and abs(dy) <= cutoff * sigma
            ok = alpha >= RASTER["alpha_min"]
            live += ok
            box += inbox or ok
    assert out.pairs == (1024, box, live)
    f = frame_counts(stream, out.pairs, 1, 32, 32)
    assert (f.slots, f.tiles) == (1, 1)


def test_rect_test_drops_a_corner_tile():
    # a splat stretched along (1, -1) near a tile corner: its bbox spans
    # 2x2 tiles (half-extents sqrt(9 / 0.19) = 6.9), its ellipse q <= 9
    # reaches (32, 24) (q = 3.2) but not the bottom-right tile, whose
    # nearest point (32, 32) has q = 60.8
    t = torch.tensor([[28.0, 28.0, 1.0, 0.9, 1.0, 0.9, 0.5, 0.5, 0.5,
                       6.9, 6.9, 9.0]], dtype=torch.float32)
    proj = render.Proj(t, torch.tensor([3.0]), torch.tensor([True]))
    stream = render.bin_tiles(proj, 64, 64, 32)
    assert stream.slots == 4
    assert stream.count.tolist() == [1, 1, 1, 0]


def test_least_times_by_hand():
    f = counts.Frame(gaussians=1000, slots=4000, tiles=100, width=320,
                     height=320, pairs=(10_000_000, 2_000_000, 500_000))
    b1_bytes = 1000 * 64 + 4000 * 4 + 101 * 4 + 320 * 320 * 24
    assert counts.blend_bytes("B1", f) == b1_bytes
    b1_ops = 2_000_000 * 8 + 500_000 * (3 + 6)
    assert counts.blend_least("B1", f) == pytest.approx(max(
        b1_bytes / 3.35e12, b1_ops / 33.5e12, 500_000 / (16 * 132 * 1.98e9)))
    b2_bytes = 1000 * 64 + 4000 * 4 + 101 * 4 + 320 * 320 * 32 + 4000 * 64
    assert counts.blend_bytes("B2", f) == b2_bytes
    assert counts.blend_least("B2", f) == pytest.approx(max(
        b2_bytes / 3.35e12, (2_000_000 * 8 + 500_000 * 27) / 33.5e12))
    assert counts.blend_bytes("B5", f) == b1_bytes + 4000 * 4
    assert counts.frame_bytes(1000, 3, 320, 320) == 1000 * 236 + 320 * 320 * 3
    assert counts.label_bytes(1000, 0) == 1000 * 56 + 1000


def test_published_peaks():
    assert counts.F32_INSTR_PER_S == 33.5e12
    assert counts.EXP_PER_S == pytest.approx(4.18176e12)
    assert counts.HBM_BYTES_PER_S == 3.35e12
