"""The port's CUDA kernels (B4 ``enum_keys``, B1 ``blend_tiles_fwd``, B2
``blend_tiles_bwd``, B3 ``cumsum_rows``, the fold's boundary gathers
``segment_sums``, B5 ``blend_tiles_vis``), their wrappers, the skip test of
B5 and B2 (``csrc/blend_cull.cuh``) through its plain mirror, the vote and
the live viewer's frames on the card against the CPU; the host code the
card's machine runs without Pillow (the PNG reader and resize give the bits
whose digests ``test_torch_train_cli.py`` takes from Pillow), and k-means
and the batched ``torch.linalg.eigh`` of region growing on the card.

This file imports neither jax nor ``gsplat_tpu``, so on a machine with a card
and only PyTorch it runs without the JAX harness of ``conftest.py``:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest

On the CPU the wrappers take their plain PyTorch versions and the card cases
skip; on the card each kernel is held against its plain version.
"""

import hashlib
import struct
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.cluster import kmeans, region_growing
from gsplat_tpu_torch.config import UNLABELED
from gsplat_tpu_torch.interact import viewer
from gsplat_tpu_torch.io import cameras, png, synthetic
from gsplat_tpu_torch.label import vote
from gsplat_tpu_torch.models import trainer
from gsplat_tpu_torch.render import api, blend, projection, tiles

torch.set_num_threads(2)

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(name)


@pytest.fixture
def card():
    return _device("cuda")


def _diagonal_splat(device):
    """One gaussian at pixel (48, 48) of a 128x128 image (4x4 tiles of 32),
    3-sigma long along the diagonal x = y (sigma 20 px) and 3 px across it:
    its 3x3-tile bbox holds two corner tiles, (row 0, col 2) and (row 2,
    col 0), that the ellipse never reaches."""
    f = lambda x: torch.tensor([x], dtype=torch.float32, device=device)
    # Sigma = [[200.5, 199.5], [199.5, 200.5]], det 400 -> conic
    ca, cb, cc = 200.5 / 400, -199.5 / 400, 200.5 / 400
    ex = 3.0 * float(np.sqrt(200.5))
    return projection.Projected(
        u=f(48.0), v=f(48.0), ca=f(ca), cb=f(cb), cc=f(cc), depth=f(2.0),
        radius=f(60.0), ex=f(ex), ey=f(ex), qmax=f(9.0), red=f(1.0),
        green=f(0.5), blue=f(0.25), opacity=f(0.9),
        valid=torch.tensor([True], device=device))


@pytest.mark.parametrize("dev", DEVICES)
def test_enum_keys_filters_unreached_tiles(dev):
    proj = _diagonal_splat(_device(dev))
    tx = ty = 4
    db = 32 - tiles.depth_shift(tx * ty)
    qd = tiles.depth_qkeys(proj.depth, proj.valid, tx * ty)
    bb = tiles.tile_bboxes(proj, tiles_x=tx, tiles_y=ty, tile_size=32)
    assert bb.total == 9
    keys, gauss = tiles.enum_keys(proj, qd, bb, tiles_x=tx,
                                  num_tiles=tx * ty, tile_size=32, db=db)
    sentinel = tx * ty
    # slots in bbox row-major order; rows 0-2, cols 0-2
    want = [0, 1, sentinel, 4, 5, 6, sentinel, 9, 10]
    assert (keys.cpu() >> db).tolist() == want
    assert ((keys.cpu() & ((1 << db) - 1)) == qd.cpu()).all()
    assert gauss.cpu().tolist() == [0] * 9
    b = tiles.bin_tiles(proj, tiles_x=tx, tiles_y=ty, tile_size=32)
    assert int(b.num_instances) == 7 and b.num_slots == 9
    assert tiles.count_instances_tight(proj, tiles_x=tx, tiles_y=ty,
                                       tile_size=32) == 7


@pytest.mark.parametrize("dev", DEVICES)
def test_blend_writes_empty_tiles_and_crops(dev):
    device = _device(dev)
    proj = _diagonal_splat(device)
    ptab = api.pack_table(proj, torch.tensor([3], dtype=torch.int32,
                                             device=device))
    width, height = 100, 70               # 4x3 tiles of 32, cropped
    tx, ty = projection.tile_grid(width, height, 32)
    # only tile 5 (row 1, col 1) holds the gaussian
    bounds = torch.tensor([0] * 6 + [1] * 7, dtype=torch.int32, device=device)
    out = blend.blend_tiles_fwd(
        ptab, torch.zeros(1, dtype=torch.int32, device=device), bounds,
        tiles_x=tx, tiles_y=ty, tile_size=32, width=width, height=height,
        chunk=64, alpha_min=1 / 255, alpha_max=0.999, early_eps=1e-5,
        with_labels=True)
    assert out.rgb.shape == (height, width, 3)
    assert out.transmittance.shape == out.label.shape == (height, width)
    t = out.transmittance.cpu()
    lab = out.label.cpu()
    inside = torch.zeros(height, width, dtype=torch.bool)
    inside[32:64, 32:64] = True
    assert (t[~inside] == 1).all() and (out.rgb.cpu()[~inside] == 0).all()
    assert (lab[~inside] == UNLABELED).all()
    assert (out.best_weight.cpu()[~inside] == 0).all()
    # pixel (47, 47) has its centre half a pixel from the mean along both
    # axes: q = (ca + 2 cb + cc) / 4, alpha = 0.9 exp(-q / 2)
    c = (47, 47)
    q = (200.5 - 2 * 199.5 + 200.5) / 400 / 4
    alpha = 0.9 * np.exp(-0.5 * q)
    assert abs(float(t[c]) - (1 - alpha)) < 1e-6
    np.testing.assert_allclose(out.rgb.cpu()[c].numpy(),
                               alpha * np.array([1.0, 0.5, 0.25]), rtol=1e-6)
    assert int(lab[c]) == 3


def test_wrappers_reject_what_the_kernels_do_not_take():
    proj = _diagonal_splat("cpu")
    qd = tiles.depth_qkeys(proj.depth, proj.valid, 16)
    bb = tiles.tile_bboxes(proj, tiles_x=4, tiles_y=4, tile_size=32)
    kw = dict(tiles_x=4, num_tiles=16, tile_size=32, db=22)
    with pytest.raises(TypeError):
        tiles.enum_keys(proj._replace(u=proj.u.double()), qd, bb, **kw)
    with pytest.raises(ValueError):
        tiles.enum_keys(proj._replace(v=torch.zeros(2)), qd, bb, **kw)
    ptab = api.pack_table(proj, torch.zeros(1, dtype=torch.int32))
    inst = torch.zeros(1, dtype=torch.int32)
    bounds = torch.tensor([0] + [1] * 16, dtype=torch.int32)
    bkw = dict(tiles_x=4, tiles_y=4, tile_size=32, width=128, height=128,
               chunk=64, alpha_min=1 / 255, alpha_max=0.999, early_eps=0.0,
               with_labels=False)
    blend.blend_tiles_fwd(ptab, inst, bounds, **bkw)
    bad = [((ptab[:, :12].contiguous(), inst, bounds), {}),
           ((ptab, inst.long(), bounds), {}),
           ((ptab, inst, bounds[:-1]), {}),
           ((ptab, inst, bounds), {"chunk": 2048}),
           ((ptab, inst, bounds), {"width": 129})]
    for args, over in bad:
        with pytest.raises(ValueError):
            blend.blend_tiles_fwd(*args, **{**bkw, **over})
    with pytest.raises(ValueError):
        blend.blend_tiles_fwd(ptab, inst, torch.tensor(
            [0] + [1] * 4, dtype=torch.int32), **{**bkw, "tiles_x": 2,
                                                 "tiles_y": 2,
                                                 "tile_size": 64,
                                                 "width": 128,
                                                 "height": 128})


def test_vis_wrapper_rejects_what_the_kernel_does_not_take():
    proj = _diagonal_splat("cpu")
    ptab = api.pack_table(proj, torch.zeros(1, dtype=torch.int32))
    inst = torch.zeros(2, dtype=torch.int32)   # one live slot, one filtered
    bounds = torch.tensor([0] * 5 + [1] * 8, dtype=torch.int32)
    kw = dict(tiles_x=4, tiles_y=3, tile_size=32, width=100, height=70,
              chunk=64, alpha_min=1 / 255, alpha_max=0.999, with_labels=True)
    out, inst_w = blend.blend_tiles_vis(ptab, inst, bounds, **kw)
    assert out.rgb.shape == (70, 100, 3) and out.label.shape == (70, 100)
    assert inst_w.shape == (2,) and float(inst_w[1]) == 0.0
    # the instance's max weight lies at the pixel next to its mean
    assert abs(float(inst_w[0]) - float(out.best_weight.max())) < 1e-7
    bad = [((ptab.double(), inst, bounds), {}),
           ((ptab, inst.long(), bounds), {}),
           ((ptab, inst, bounds[:-1]), {}),
           ((ptab, inst, bounds), {"chunk": 0}),
           ((ptab, inst, bounds), {"chunk": 2048}),
           ((ptab, inst, bounds), {"width": 129}),
           ((ptab, inst, bounds), {"tile_size": 64})]
    for args, over in bad:
        with pytest.raises(ValueError):
            blend.blend_tiles_vis(*args, **{**kw, **over})
    with pytest.raises(TypeError):
        blend.blend_tiles_vis(ptab, inst, bounds, **kw, early_eps=1e-5)


def test_backward_wrappers_reject_what_the_kernels_do_not_take():
    proj = _diagonal_splat("cpu")
    ptab = api.pack_table(proj, torch.zeros(1, dtype=torch.int32))
    inst = torch.zeros(1, dtype=torch.int32)
    h, w = 100, 128
    img, t = torch.zeros(h, w, 3), torch.ones(h, w)
    kw = dict(tiles_x=4, tiles_y=4, tile_size=32, width=w, height=h,
              chunk=64, alpha_min=1 / 255, alpha_max=0.999, early_eps=0.0)
    bounds = torch.tensor([0] * 6 + [1] * 11, dtype=torch.int32)
    drows = blend.blend_tiles_bwd(ptab, inst, bounds, img, t, img, t, **kw)
    assert drows.shape == (1, 16)
    bad = [(img[:, :-1], t, img, t), (img, t, img.double(), t),
           (img, t.t().contiguous().t(), img, t), (img, t, img, t[:-1])]
    for args in bad:
        with pytest.raises(ValueError):
            blend.blend_tiles_bwd(ptab, inst, bounds, *args, **kw)
    with pytest.raises(ValueError):
        blend.blend_tiles_bwd(ptab, inst.long(), bounds, img, t, img, t,
                              **kw)
    with pytest.raises(ValueError):
        blend.blend_tiles_bwd(ptab, inst, bounds, img, t, img, t,
                              **{**kw, "chunk": 0})
    x = torch.zeros(10, 16)
    assert torch.equal(blend.cumsum_rows(x), x)
    for bad_x in (torch.zeros(10, 8), x.double(), torch.zeros(16, 10).t()):
        with pytest.raises(ValueError):
            blend.cumsum_rows(bad_x)


def _segment_inputs(device, rows=6):
    cs = torch.arange(rows * 16, dtype=torch.float32,
                      device=device).reshape(rows, 16)
    start = torch.tensor([0, 2, 2, 5], dtype=torch.int32, device=device)
    cnt = torch.tensor([2, 0, 3, 1], dtype=torch.int32, device=device)
    return cs, start, cnt


def _refused_segment_inputs(cs, start, cnt):
    return [(cs.double(), start, cnt), (cs[:, :8].contiguous(), start, cnt),
            (cs[:0], start, cnt), (cs.t().contiguous().t(), start, cnt),
            (cs, start.long(), cnt), (cs, start, cnt.long()),
            (cs, start, cnt[:-1]), (cs, start[::2], cnt[::2]),
            (cs, start[:, None], cnt)]


def test_segment_sums_wrapper_rejects_what_the_kernel_does_not_take():
    cs, start, cnt = _segment_inputs("cpu")
    assert api.segment_sums(cs, start, cnt).shape == (4, 16)
    for args in _refused_segment_inputs(cs, start, cnt):
        with pytest.raises(ValueError):
            api.segment_sums(*args)


# --- the skip test of B5 and B2 (csrc/blend_cull.cuh), through its mirror ---

ALPHA_MIN, ALPHA_MAX = 1 / 255, 0.999
TILE = 32


def _conic(ang, s1, s2, blur):
    """f32 (ca, cb, cc): the inverse of the 2D covariance with sigmas s1
    along angle ``ang`` and s2 across it, plus ``blur`` px^2 on the
    diagonal (numpy arrays)."""
    c, s = np.cos(ang), np.sin(ang)
    a = c * c * s1 ** 2 + s * s * s2 ** 2 + blur
    b = c * s * (s1 ** 2 - s2 ** 2)
    d = s * s * s1 ** 2 + c * c * s2 ** 2 + blur
    det = a * d - b * b
    return [torch.from_numpy(np.asarray(x, np.float32))
            for x in (d / det, -b / det, a / det)]


def _conics(rng, n, thin):
    """[n] conics at random angles: round-ish with the projection's 0.3
    px^2 blur, or thin (5-60 px by 0.05-0.6 px, a third without blur, so
    that ca cc - cb^2 comes near 0)."""
    ang = rng.uniform(0, np.pi, n)
    if thin:
        s1, s2 = rng.uniform(5, 60, n), rng.uniform(0.05, 0.6, n)
        blur = np.where(rng.random(n) < 1 / 3, 0.0, 0.3)
    else:
        s1 = rng.uniform(0.3, 12, n)
        s2, blur = s1 * rng.uniform(0.3, 1.0, n), 0.3
    return _conic(ang, s1, s2, blur)


def _tile_pixels(mx, my, ca, cb, cc, op):
    """q and alpha at every pixel centre of a 32-px tile, [n, 32 (row), 32
    (col)], with the blend kernels' operations (render/blend.py
    _blend_plain)."""
    pc = torch.arange(TILE, dtype=torch.float32) + 0.5
    e = lambda t: t[:, None, None]
    dx = pc[None, None, :] - e(mx)
    dy = pc[None, :, None] - e(my)
    q = (e(ca) * dx + e(2.0 * cb) * dy) * dx + e(cc) * dy * dy
    return q, torch.clamp_max(e(op) * torch.exp(-0.5 * q), ALPHA_MAX)


def _assert_conservative(mx, my, ca, cb, cc, op, c0, c1, r0, r1):
    """No pixel the mirror skips (by rectangle or by its own q) passes the
    cut. Returns (skip, min q over the rectangle, q_cut)."""
    thr = blend._cull_q_cut(op, ALPHA_MIN)
    f = lambda t: t.to(torch.float32) + 0.5
    skip = blend._cull_rect_skip(mx, my, ca, cb, cc, thr, f(c0), f(c1),
                                 f(r0), f(r1))
    q, alpha = _tile_pixels(mx, my, ca, cb, cc, op)
    idx = torch.arange(TILE)
    e = lambda t: t[:, None, None]
    inrect = ((idx[None, None, :] >= e(c0)) & (idx[None, None, :] <= e(c1))
              & (idx[None, :, None] >= e(r0)) & (idx[None, :, None] <= e(r1)))
    passes = alpha >= ALPHA_MIN
    assert not (passes & inrect & e(skip)).any()
    assert not (passes & (q > e(thr))).any()
    qmin = torch.where(inrect, q, torch.full_like(q, float("inf")))
    return skip, qmin.amin(dim=(1, 2)), thr


def _rects(rng, n):
    c0 = rng.integers(0, TILE, n)
    c1 = np.minimum(c0 + rng.integers(0, TILE, n), TILE - 1)
    r0 = rng.integers(0, TILE, n)
    r1 = np.minimum(r0 + rng.integers(0, TILE, n), TILE - 1)
    return c0, c1, r0, r1


CULL_CASES = ["round", "thin", "opacity_near_one", "opacity_near_alpha_min",
              "on_the_cut", "indefinite"]


@pytest.mark.parametrize("case", CULL_CASES)
def test_cull_skips_only_pixels_below_the_cut(case):
    """Seeded random instances and rectangles of a 32-px tile: means on and
    off the rectangle (a quarter inside, the rest up to 48 px outside), the
    conics and opacities of the case. "on_the_cut" (thin conics, so the
    terms of q cancel) sets each opacity so that the rectangle's best pixel
    lies within 1e-6 (relative) of alpha_min, on either side; "indefinite"
    takes conics no projection makes (cb^2 > ca cc, or ca <= 0), which the
    rectangle test must never skip by its edge minima."""
    rng = np.random.default_rng(CULL_CASES.index(case))
    n = 3000
    ca, cb, cc = _conics(rng, n, thin=case in ("thin", "on_the_cut"))
    if case == "indefinite":
        ca, cc = (torch.from_numpy(rng.uniform(-1, 2, n).astype(np.float32))
                  for _ in range(2))
        cb = torch.from_numpy(rng.uniform(-3, 3, n).astype(np.float32))
    c0, c1, r0, r1 = _rects(rng, n)
    inside = rng.random(n) < 0.25
    mx = np.where(inside, rng.uniform(c0, c1 + 1), rng.uniform(-48, 80, n))
    my = np.where(inside, rng.uniform(r0, r1 + 1), rng.uniform(-48, 80, n))
    mx, my = (torch.from_numpy(x.astype(np.float32)) for x in (mx, my))
    c0, c1, r0, r1 = (torch.from_numpy(x) for x in (c0, c1, r0, r1))
    if case == "opacity_near_one":
        op = np.where(rng.random(n) < 0.2, 1.0, rng.uniform(0.99, 1.0, n))
    elif case in ("opacity_near_alpha_min", "indefinite"):
        op = ALPHA_MIN * (1 + np.where(rng.random(n) < 0.5, -1, 1)
                          * 10 ** rng.uniform(-7, -1, n))
    else:
        op = rng.uniform(ALPHA_MIN, 1.0, n)
    op = torch.from_numpy(op.astype(np.float32))
    if case == "on_the_cut":
        _, qmin, _ = _assert_conservative(mx, my, ca, cb, cc, op, c0, c1,
                                          r0, r1)
        keep = qmin < 2 * np.log(255.0) - 0.1   # reachable with op <= 1
        mx, my, ca, cb, cc = (t[keep] for t in (mx, my, ca, cb, cc))
        c0, c1, r0, r1, qmin = (t[keep] for t in (c0, c1, r0, r1, qmin))
        jitter = torch.from_numpy(rng.uniform(-1e-6, 1e-6, int(keep.sum())))
        op = (ALPHA_MIN * torch.exp(0.5 * qmin.double())
              * (1 + jitter)).float()
    skip, qmin, thr = _assert_conservative(mx, my, ca, cb, cc, op, c0, c1,
                                           r0, r1)
    if case == "round":
        # and not idle: every rectangle whose least q clears the cut by 1%
        # is skipped (these conics are all definite)
        clear = qmin > thr * 1.01 + 0.01
        assert clear.sum() > n / 4 and skip[clear].all()


def test_cull_q_cut_is_tight():
    """The per-pixel threshold lies above 2 ln(op / alpha_min) by its
    margin and no more: at most 1e-3 (1 + |ln op| + |ln alpha_min|)."""
    op = torch.from_numpy(np.geomspace(ALPHA_MIN, 1.0, 1000).astype(
        np.float32))
    thr = blend._cull_q_cut(op, ALPHA_MIN).double()
    exact = 2 * (torch.log(op.double()) - np.log(np.float32(ALPHA_MIN)))
    slack = thr - exact
    scale = 1 + torch.log(op.double()).abs() + abs(np.log(ALPHA_MIN))
    assert (slack > 0).all() and (slack <= 1e-3 * scale).all()


@settings(max_examples=300, deadline=None, derandomize=True)
@given(mx=st.floats(-48, 80), my=st.floats(-48, 80),
       angle=st.floats(0, np.pi), s_long=st.floats(0.3, 60),
       ratio=st.floats(1, 1000), blur=st.sampled_from([0.0, 0.3]),
       op=st.floats(ALPHA_MIN * 0.99, 1.0), c0=st.integers(0, TILE - 1),
       w=st.integers(0, TILE - 1), r0=st.integers(0, TILE - 1),
       h=st.integers(0, TILE - 1))
def test_cull_is_conservative_for_any_instance(mx, my, angle, s_long, ratio,
                                               blur, op, c0, w, r0, h):
    ca, cb, cc = _conic(np.array([angle]), np.array([s_long]),
                        np.array([s_long / ratio]), blur)
    t = lambda x: torch.tensor([x], dtype=torch.float32)
    i = lambda x: torch.tensor([x])
    _assert_conservative(t(mx), t(my), ca, cb, cc, t(op), i(c0),
                         i(min(c0 + w, TILE - 1)), i(r0),
                         i(min(r0 + h, TILE - 1)))


def test_kernel_libraries_are_keyed_by_source():
    paths = {name: _kernels.library_path(name) for name in _kernels.SIGNATURES}
    assert len(set(paths.values())) == len(paths)
    for name, path in paths.items():
        assert path.parent == _kernels.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
        assert (_kernels.CSRC / f"{name}.cu").is_file()


# --- on the card: each kernel against its plain version --------------------

def _card_frame(device, tile_size=32, n=20_000, width=800, height=608):
    scene = synthetic.random_scene(n, seed=0, extent=1.5,
                                   scale_range=(0.004, 0.02), num_labels=16,
                                   device=device)
    cam = cameras.look_at_camera((0, 0, -3.0), (0, 0, 0), width=width,
                                 height=height)
    proj = projection.project(
        scene, projection.CameraParams.from_camera(cam, device), width,
        height)
    tx, ty = projection.tile_grid(width, height, tile_size)
    return scene, cam, proj, tx, ty


@pytest.mark.gpu
@pytest.mark.parametrize("tile_size", [32, 16])
def test_enum_keys_kernel_matches_plain(card, tile_size):
    _, _, proj, tx, ty = _card_frame(card, tile_size)
    qd = tiles.depth_qkeys(proj.depth, proj.valid, tx * ty)
    bb = tiles.tile_bboxes(proj, tiles_x=tx, tiles_y=ty, tile_size=tile_size)
    kw = dict(tiles_x=tx, num_tiles=tx * ty, tile_size=tile_size,
              db=32 - tiles.depth_shift(tx * ty))
    before = tiles.enum_keys.launches
    keys, gauss = tiles.enum_keys(proj, qd, bb, **kw)
    pkeys, pgauss = tiles._enum_keys_plain(proj, qd, bb, **kw)
    torch.cuda.synchronize()
    assert tiles.enum_keys.launches == before + 1
    assert bb.total > 0
    assert torch.equal(keys, pkeys) and torch.equal(gauss, pgauss)


def _enum_projection(device, n, seed, *, big, valid_from=None):
    """[n] gaussians of no scene on an 800x608 frame (a tenth of them
    invalid, and all of ``valid_from``'s range when given), means up to 50
    px off the image, sigmas 0.5-6 px, but a share ``big`` of them 40-120 px:
    at 8-px tiles those bboxes hold hundreds to thousands of slots."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, np.pi, n)
    s1 = np.where(rng.random(n) < big, rng.uniform(40, 120, n),
                  rng.uniform(0.5, 6, n))
    s2 = s1 * rng.uniform(0.2, 1.0, n)
    c, s = np.cos(ang), np.sin(ang)
    var_x = c * c * s1 ** 2 + s * s * s2 ** 2 + 0.3
    var_y = s * s * s1 ** 2 + c * c * s2 ** 2 + 0.3
    ca, cb, cc = _conic(ang, s1, s2, 0.3)
    valid = rng.random(n) < 0.9
    if valid_from is not None:
        valid[valid_from] = False
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
    ex, ey = 3.33 * np.sqrt(var_x), 3.33 * np.sqrt(var_y)
    return projection.Projected(
        u=f(rng.uniform(-50, 850, n)), v=f(rng.uniform(-50, 658, n)),
        ca=ca.to(device), cb=cb.to(device), cc=cc.to(device),
        depth=f(rng.uniform(1, 10, n)), radius=f(np.maximum(ex, ey)),
        ex=f(ex), ey=f(ey), qmax=f(np.full(n, 3.33 ** 2)),
        red=f(np.ones(n)), green=f(np.ones(n)), blue=f(np.ones(n)),
        opacity=f(np.ones(n)), valid=torch.from_numpy(valid).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["large_bboxes", "empty_blocks", "no_slot"])
def test_enum_keys_kernel_matches_plain_on_edge_cases(card, case):
    """Bboxes of more than 256 slots; whole blocks of 256 gaussians with no
    slot, at N not a multiple of 256; and no slot at all."""
    n, big, empty = {"large_bboxes": (1000, 0.05, None),
                     "empty_blocks": (2000, 0.01, slice(256, 1024)),
                     "no_slot": (1000, 0.0, slice(None))}[case]
    proj = _enum_projection(card, n, seed=len(case), big=big,
                            valid_from=empty)
    tx, ty = projection.tile_grid(800, 608, 8)
    qd = tiles.depth_qkeys(proj.depth, proj.valid, tx * ty)
    bb = tiles.tile_bboxes(proj, tiles_x=tx, tiles_y=ty, tile_size=8)
    kw = dict(tiles_x=tx, num_tiles=tx * ty, tile_size=8,
              db=32 - tiles.depth_shift(tx * ty))
    before = tiles.enum_keys.launches
    keys, gauss = tiles.enum_keys(proj, qd, bb, **kw)
    pkeys, pgauss = tiles._enum_keys_plain(proj, qd, bb, **kw)
    torch.cuda.synchronize()
    assert torch.equal(keys, pkeys) and torch.equal(gauss, pgauss)
    if case == "no_slot":
        assert bb.total == 0 and tiles.enum_keys.launches == before
        return
    assert tiles.enum_keys.launches == before + 1
    if case == "large_bboxes":
        assert int(bb.cnt.max()) > 256
        # and the filter cut some slots of the long, rotated bboxes
        assert int((keys >> kw["db"] == tx * ty).sum()) > 0
    else:
        assert n % 256 and not bb.cnt[empty].any() and bb.total > 0


@pytest.mark.gpu
def test_graph_ms_replays_the_wrapper(card):
    """profiling.graph_ms captures the wrapper's launches in a CUDA graph
    and replays them: a positive time, and the outputs of a replay equal
    the eager call's."""
    from gsplat_tpu_torch.utils.profiling import graph_ms
    _, _, proj, tx, ty = _card_frame(card)
    qd = tiles.depth_qkeys(proj.depth, proj.valid, tx * ty)
    bb = tiles.tile_bboxes(proj, tiles_x=tx, tiles_y=ty, tile_size=32)
    kw = dict(tiles_x=tx, num_tiles=tx * ty, tile_size=32,
              db=32 - tiles.depth_shift(tx * ty))
    want = tiles.enum_keys(proj, qd, bb, **kw)
    got = []
    ms = graph_ms(lambda: got.append(tiles.enum_keys(proj, qd, bb, **kw)),
                  launches=3, reps=2)
    torch.cuda.synchronize()
    assert ms > 0 and len(got) == 4   # the warm-up call and 3 captured
    for keys, gauss in got:
        assert torch.equal(keys, want[0]) and torch.equal(gauss, want[1])


def _check_fwd(ptab, b, **kw):
    """B1 against its plain version."""
    before = blend.blend_tiles_fwd.launches
    out = blend.blend_tiles_fwd(ptab, b.inst_gauss, b.tile_bounds, **kw)
    ref = blend._blend_tiles_fwd_plain(ptab, b.inst_gauss, b.tile_bounds,
                                       **kw)
    torch.cuda.synchronize()
    assert blend.blend_tiles_fwd.launches == before + 1
    # the kernel repeats the plain version's operations in the same order
    # on every pair the skip test keeps (no FMA contraction, the same expf),
    # so 1e-5 is headroom, not slack
    for k in ("rgb", "transmittance", "best_weight"):
        err = (getattr(out, k) - getattr(ref, k)).abs().max().item()
        assert err <= 1e-5, k
    assert torch.equal(out.label, ref.label)


@pytest.mark.gpu
@pytest.mark.parametrize("eps", [0.0, 1e-5])
@pytest.mark.parametrize("tile_size,chunk", [(32, 64), (16, 128)])
def test_blend_kernel_matches_plain(card, eps, tile_size, chunk):
    scene, cam, proj, tx, ty = _card_frame(card, tile_size)
    b = tiles.bin_tiles(proj, tiles_x=tx, tiles_y=ty, tile_size=tile_size)
    _check_fwd(api.pack_table(proj, scene.labels), b, tiles_x=tx, tiles_y=ty,
               tile_size=tile_size, width=cam.width, height=cam.height,
               chunk=chunk, alpha_min=1 / 255, alpha_max=0.999,
               early_eps=eps, with_labels=True)


@pytest.mark.gpu
def test_render_on_card_matches_cpu(card):
    scene = synthetic.random_scene(2000, seed=21, num_labels=6, device="cpu")
    cam = cameras.look_at_camera((0.2, -0.3, -3.0), (0, 0, 0), width=128,
                                 height=96)
    got = api.render(scene, cam, with_labels=True, device=card)
    want = api.render(scene, cam, with_labels=True, device="cpu")
    # projection runs through the card's and the host's exp/log/sqrt, which
    # may differ by an ulp and move one alpha across the 1/255 cut
    for key in ("image", "transmittance", "best_weight"):
        err = (got[key].cpu() - want[key]).abs()
        assert err.max() <= 5e-3, key
        assert (err <= 1e-5).float().mean() >= 0.999, key
    assert (got["label_map"].cpu() == want["label_map"]).float().mean() >= 0.999


def _thin_stream(device, tile_size, width=200, height=136):
    """synthetic.thin_splats_projection's frame of 3,000 thin, rotated,
    high-opacity splats on the 16-px grid lines, binned: the skip test's
    hardest input. 200x136 is no multiple of 32."""
    proj, labels = synthetic.thin_splats_projection(
        3000, width=width, height=height, seed=7, device=device)
    tx, ty = projection.tile_grid(width, height, tile_size)
    b = tiles.bin_tiles(proj, tiles_x=tx, tiles_y=ty, tile_size=tile_size)
    return tx, ty, b, api.pack_table(proj, labels)


def _check_bwd(card, ptab, b, eps, **kw):
    """B2 against its plain version on B1's outputs and a seeded random
    cotangent."""
    kw = dict(kw, alpha_min=1 / 255, alpha_max=0.999, early_eps=eps)
    fwd = blend.blend_tiles_fwd(ptab, b.inst_gauss, b.tile_bounds, **kw,
                                with_labels=False)
    gen = torch.Generator(device=card).manual_seed(5)
    h, w = kw["height"], kw["width"]
    drgb = torch.randn(h, w, 3, generator=gen, device=card)
    dtrans = torch.randn(h, w, generator=gen, device=card)
    args = (ptab, b.inst_gauss, b.tile_bounds, fwd.rgb, fwd.transmittance,
            drgb, dtrans)
    before = blend.blend_tiles_bwd.launches
    got = blend.blend_tiles_bwd(*args, **kw)
    ref = blend._blend_tiles_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert blend.blend_tiles_bwd.launches == before + 1
    # T and the prefix repeat the plain version's operations; the per-tile
    # sums over pixels are associated differently: 1e-4 of each column's
    # peak. Zero rows (early stop, no live pixel, filtered slots) are exact.
    peak = ref[:, :9].abs().amax(0)
    err = (got[:, :9] - ref[:, :9]).abs().amax(0) / peak
    assert (err <= 1e-4).all(), err
    assert torch.equal((got == 0).all(1), (ref == 0).all(1))
    assert not got[:, 9:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("eps", [0.0, 1e-5])
@pytest.mark.parametrize("tile_size,chunk", [(32, 64), (16, 128)])
@pytest.mark.parametrize("width,height", [(800, 608), (100, 70)])
def test_blend_bwd_kernel_matches_plain(card, eps, tile_size, chunk, width,
                                        height):
    scene, _, proj, tx, ty = _card_frame(card, tile_size, width=width,
                                         height=height)
    b = tiles.bin_tiles(proj, tiles_x=tx, tiles_y=ty, tile_size=tile_size)
    _check_bwd(card, api.pack_table(proj, scene.labels), b, eps, tiles_x=tx,
               tiles_y=ty, tile_size=tile_size, width=width, height=height,
               chunk=chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("eps", [0.0, 1e-5])
@pytest.mark.parametrize("tile_size,chunk", [(32, 64), (16, 128), (24, 64)])
def test_blend_bwd_kernel_matches_plain_on_thin_splats(card, eps, tile_size,
                                                       chunk):
    tx, ty, b, ptab = _thin_stream(card, tile_size)
    _check_bwd(card, ptab, b, eps, tiles_x=tx, tiles_y=ty,
               tile_size=tile_size, width=200, height=136, chunk=chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("eps", [0.0, 1e-5])
@pytest.mark.parametrize("tile_size", [32, 16, 24])
def test_blend_kernel_matches_plain_on_thin_splats(card, eps, tile_size):
    tx, ty, b, ptab = _thin_stream(card, tile_size)
    _check_fwd(ptab, b, tiles_x=tx, tiles_y=ty, tile_size=tile_size,
               width=200, height=136, chunk=64, alpha_min=1 / 255,
               alpha_max=0.999, early_eps=eps, with_labels=True)


@pytest.mark.gpu
@pytest.mark.parametrize("frame", ["random", "thin splats"])
@pytest.mark.parametrize("tile_size", [32, 16, 24])
def test_blend_kernel_at_eps_0_equals_vis_kernel(card, frame, tile_size):
    """B5 is B1 with no early stop, the same operations in the same order:
    at early_eps 0 the two agree bit for bit, and B1 without labels gives
    the same image and T."""
    if frame == "random":
        scene, cam, proj, tx, ty = _card_frame(card, tile_size)
        b = tiles.bin_tiles(proj, tiles_x=tx, tiles_y=ty,
                            tile_size=tile_size)
        ptab, width, height = (api.pack_table(proj, scene.labels),
                               cam.width, cam.height)
    else:
        tx, ty, b, ptab = _thin_stream(card, tile_size)
        width, height = 200, 136
    kw = dict(tiles_x=tx, tiles_y=ty, tile_size=tile_size, width=width,
              height=height, chunk=64, alpha_min=1 / 255, alpha_max=0.999)
    fwd = blend.blend_tiles_fwd(ptab, b.inst_gauss, b.tile_bounds, **kw,
                                early_eps=0.0, with_labels=True)
    bare = blend.blend_tiles_fwd(ptab, b.inst_gauss, b.tile_bounds, **kw,
                                 early_eps=0.0, with_labels=False)
    vis, _ = blend.blend_tiles_vis(ptab, b.inst_gauss, b.tile_bounds, **kw,
                                   with_labels=True)
    torch.cuda.synchronize()
    for k in ("rgb", "transmittance", "best_weight", "label"):
        assert torch.equal(getattr(fwd, k), getattr(vis, k)), k
    assert torch.equal(bare.rgb, fwd.rgb)
    assert torch.equal(bare.transmittance, fwd.transmittance)
    assert (fwd.label != UNLABELED).any()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 511, 512, 513, 100_003, 2_500_096])
def test_cumsum_rows_kernel_matches_float64(card, rows):
    gen = torch.Generator(device=card).manual_seed(rows)
    # a drift of 0.1 per row, as gradient rows have, so the peak prefix is
    # not a random walk's
    x = torch.randn(rows, 16, generator=gen, device=card) + 0.1
    before = blend.cumsum_rows.launches
    got = blend.cumsum_rows(x)
    torch.cuda.synchronize()
    assert blend.cumsum_rows.launches == before + 1
    want = torch.cumsum(x.double(), 0)
    err = (got.double() - want).abs().amax(0) / want.abs().amax(0)
    # each output is an f32 prefix of at most 32 rows plus one f32 rounding
    # of an f64 offset, and one f32 addition of the two
    assert (err <= 1e-6).all(), err


@pytest.mark.gpu
def test_cumsum_rows_kernel_is_the_same_from_call_to_call(card):
    """Three calls at 2.5M rows equal bit for bit, with calls of other
    sizes between them: no call sees an earlier call's flags, and the
    look-back adds in one order whatever order the blocks run in."""
    gen = torch.Generator(device=card).manual_seed(7)
    x = torch.randn(2_500_096, 16, generator=gen, device=card) + 0.1
    small = torch.randn(100_003, 16, generator=gen, device=card)
    first = blend.cumsum_rows(x)
    small_first = blend.cumsum_rows(small)
    second = blend.cumsum_rows(x)
    tiny = blend.cumsum_rows(x[:513])
    third = blend.cumsum_rows(x)
    small_again = blend.cumsum_rows(small)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, third)
    assert torch.equal(small_first, small_again)
    # a prefix of the array: its tiles' look-back is the same
    assert torch.equal(tiny, first[:513])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4, 1000, 300_001])
def test_segment_sums_kernel_matches_plain(card, n):
    """The boundary-gather kernel against its plain version bit for bit:
    the hand-made case, then random counts with a third of the gaussians
    without slots (as the training state's dead and off-screen ones), the
    first at start 0 and the last ending at row B - 1."""
    if n == 4:
        cs, start, cnt = _segment_inputs(card)
    else:
        rng = np.random.default_rng(n)
        counts = rng.poisson(1.5, size=n) * (rng.uniform(size=n) > 0.33)
        counts[0] = counts[-1] = 2
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rows = int(counts.sum())
        cnt = torch.from_numpy(counts.astype(np.int32)).to(card)
        start = torch.from_numpy(starts.astype(np.int32)).to(card)
        cs = torch.cumsum(torch.from_numpy(rng.normal(
            size=(rows, 16)).astype(np.float32)).to(card), 0)
    before = api.segment_sums.launches
    got = api.segment_sums(cs, start, cnt)
    want = api._segment_sums_plain(cs, start, cnt)
    torch.cuda.synchronize()
    assert api.segment_sums.launches == before + 1
    assert torch.equal(got, want)
    assert bool((cnt == 0).any()) and not got[cnt == 0].any()


@pytest.mark.gpu
def test_fold_kernels_reject_what_they_do_not_take(card):
    """On the card the wrappers also refuse rows that are not 16-byte
    aligned (a view one float into a buffer), besides what the CPU test of
    the wrappers refuses."""
    cs, start, cnt = _segment_inputs(card)
    for args in _refused_segment_inputs(cs, start, cnt):
        with pytest.raises(ValueError):
            api.segment_sums(*args)
    buf = torch.zeros(6 * 16 + 1, device=card)
    skewed = buf[1:].view(6, 16)
    assert skewed.data_ptr() % 16
    with pytest.raises(ValueError):
        api.segment_sums(skewed, start, cnt)
    with pytest.raises(ValueError):
        blend.cumsum_rows(skewed)
    for bad in (cs[:, :8].contiguous(), cs.double(), cs.t().contiguous().t()):
        with pytest.raises(ValueError):
            blend.cumsum_rows(bad)
    with pytest.raises(ValueError):
        api.segment_sums(cs, start.cpu(), cnt)


@pytest.mark.gpu
def test_render_gradients_on_card_match_cpu(card):
    scene = synthetic.random_scene(2000, seed=21, num_labels=6, device="cpu")
    cam = cameras.look_at_camera((0.2, -0.3, -3.0), (0, 0, 0), width=128,
                                 height=96)
    target = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(96, 128, 3)).astype(np.float32))
    grads = {}
    before = (blend.blend_tiles_bwd.launches, blend.cumsum_rows.launches,
              api.segment_sums.launches)
    for dev in (card, torch.device("cpu")):
        s = scene.to(dev)
        params = trainer.SceneParams.from_scene(s)
        for p in params:
            p.requires_grad_(True)
        out = api.render(params.to_scene(s.labels), cam, device=dev)
        loss = trainer.l2_loss(out["image"], target.to(dev))
        grads[dev.type] = [g.cpu() for g in torch.autograd.grad(loss, params)]
    assert (blend.blend_tiles_bwd.launches, blend.cumsum_rows.launches,
            api.segment_sums.launches) == tuple(b + 1 for b in before)
    # projection runs through the card's and the host's exp/log/sqrt, which
    # may move one alpha across the 1/255 cut: 1e-3 of each tensor's peak
    for f, g_card, g_cpu in zip(trainer.SceneParams._fields, grads["cuda"],
                                grads["cpu"]):
        assert torch.isfinite(g_card).all(), f
        err = (g_card - g_cpu).abs().max() / g_cpu.abs().max()
        assert err <= 1e-3, (f, float(err))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["l1", "l2", "ssim", "dssim_l1"])
def test_losses_on_card_match_cpu(card, name):
    from gsplat_tpu_torch.models import losses
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(96, 128, 3)).astype(np.float32)
    tgt = np.clip(img + rng.normal(0, 0.1, size=img.shape), 0, 1).astype(
        np.float32)
    fn = {"l1": losses.l1_loss, "l2": losses.l2_loss, "ssim": losses.ssim,
          "dssim_l1": losses.dssim_l1_loss}[name]
    out = {}
    for dev in (card, torch.device("cpu")):
        x = torch.from_numpy(img).to(dev).requires_grad_(True)
        v = fn(x, torch.from_numpy(tgt).to(dev))
        (g,) = torch.autograd.grad(v, x)
        out[dev.type] = (float(v), g.cpu())
    # the blur is shifted f32 products on both devices (no TF32 convolution),
    # so only the order of the mean's sums differs
    (vc, gc), (vh, gh) = out["cuda"], out["cpu"]
    assert abs(vc - vh) <= 1e-5 * max(abs(vh), 1.0)
    assert float((gc - gh).abs().max() / gh.abs().max()) <= 1e-4


def _check_vis(ptab, b, **kw):
    """B5 against its plain version; returns the rows and the tight
    instance count."""
    kw = dict(kw, alpha_min=1 / 255, alpha_max=0.999, with_labels=True)
    before = blend.blend_tiles_vis.launches
    out, inst_w = blend.blend_tiles_vis(ptab, b.inst_gauss, b.tile_bounds,
                                        **kw)
    ref, ref_w = blend._blend_tiles_vis_plain(ptab, b.inst_gauss,
                                              b.tile_bounds, **kw)
    torch.cuda.synchronize()
    assert blend.blend_tiles_vis.launches == before + 1
    # B1's operations in B1's order on every pair the skip test keeps, and
    # max is exact: 1e-5 is headroom
    for k in ("rgb", "transmittance", "best_weight"):
        err = (getattr(out, k) - getattr(ref, k)).abs().max().item()
        assert err <= 1e-5, k
    assert torch.equal(out.label, ref.label)
    assert (inst_w - ref_w).abs().max().item() <= 1e-5
    tight = int(b.num_instances)
    assert tight < inst_w.numel() and not inst_w[tight:].any()
    return inst_w, tight


@pytest.mark.gpu
@pytest.mark.parametrize("tile_size,chunk,width,height", [
    (32, 64, 800, 608), (16, 128, 800, 608), (32, 64, 100, 70),
    (16, 128, 100, 70), (24, 64, 100, 70)])
def test_blend_vis_kernel_matches_plain(card, tile_size, chunk, width,
                                        height):
    scene, cam, proj, tx, ty = _card_frame(card, tile_size, width=width,
                                           height=height)
    b = tiles.bin_tiles(proj, tiles_x=tx, tiles_y=ty, tile_size=tile_size)
    inst_w, tight = _check_vis(api.pack_table(proj, scene.labels), b,
                               tiles_x=tx, tiles_y=ty, tile_size=tile_size,
                               width=width, height=height, chunk=chunk)
    assert (inst_w[:tight] > 0.05).float().mean() > 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("tile_size", [32, 16, 24])
def test_blend_vis_kernel_matches_plain_on_thin_splats(card, tile_size):
    tx, ty, b, ptab = _thin_stream(card, tile_size)
    _check_vis(ptab, b, tiles_x=tx, tiles_y=ty, tile_size=tile_size,
               width=200, height=136, chunk=64)


def _vote_inputs(device):
    scene = synthetic.random_scene(3000, seed=41, extent=1.0,
                                   scale_range=(0.01, 0.04), device=device)
    cams = cameras.orbit_cameras(5, 3.0, height=0.3, width=160,
                                 img_height=120)
    seg = np.random.default_rng(0).integers(-1, 7, size=(5, 60, 80)).astype(
        np.int32)
    return scene, cams, seg


@pytest.mark.gpu
def test_assign_labels_on_card_match_cpu(card):
    scene, cams, seg = _vote_inputs("cpu")
    got, gv = vote.assign_labels(scene, cams, seg, num_classes=151,
                                 return_votes=True, device=card)
    want, wv = vote.assign_labels(scene, cams, seg, num_classes=151,
                                  return_votes=True, device="cpu")
    # +, -, *, / and the truncation round alike on both devices
    assert torch.equal(gv.cpu(), wv) and torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_assign_labels_visible_on_card_match_cpu(card):
    scene, cams, seg = _vote_inputs("cpu")
    before = blend.blend_tiles_vis.launches
    got = vote.assign_labels_visible(scene, cams, seg, num_classes=151,
                                     device=card)
    assert blend.blend_tiles_vis.launches == before + len(cams)
    want = vote.assign_labels_visible(scene, cams, seg, num_classes=151,
                                      device="cpu")
    weights = {dev: torch.stack([
        api.render(scene, c, impl="pallas_vis", device=dev)[
            "gaussian_weight"].cpu() for c in cams]) for dev in (card, "cpu")}
    # projection runs through the card's and the host's exp/log/sqrt, so the
    # weights agree to float rounding and may fall on either side of the
    # threshold only within 1e-5 of it: elsewhere the labels are equal
    assert (weights[card] - weights["cpu"]).abs().max() <= 1e-5
    band = ((weights["cpu"] - 0.05).abs() <= 1e-5).any(0)
    assert band.float().mean() <= 0.01
    assert torch.equal(got.cpu()[~band], want[~band])
    assert (want >= 0).float().mean() > 0.1


# --- the probes (P1, P2) -----------------------------------------------------

def test_probe_libraries_are_keyed_by_source():
    from gsplat_tpu_torch.utils import roofline, scan_probe
    paths = {name: _kernels.library_path(name)
             for name in ("peak_probe", "scan_probe")}
    assert paths["peak_probe"] != paths["scan_probe"]
    for name, path in paths.items():
        assert name in _kernels.SIGNATURES
        assert path.parent == _kernels.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
        assert (_kernels.CSRC / f"{name}.cu").is_file()
    for fn in (roofline.fma_chains, roofline.expf_chains,
               scan_probe.flat_scan_kernel, scan_probe.grouped_scan_kernel):
        assert isinstance(fn.launches, int)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["fma", "expf"])
@pytest.mark.parametrize("iters", [1, 7])
def test_peak_kernels_match_plain(card, which, iters):
    from gsplat_tpu_torch.utils import roofline
    fn = roofline.fma_chains if which == "fma" else roofline.expf_chains
    gen = torch.Generator(device=card).manual_seed(iters)
    x = torch.rand(2048, generator=gen, device=card) + 0.5
    before = fn.launches
    got = fn(x, blocks=132, iters=iters)
    want = roofline._chains_plain(
        x, which, 132, iters, *((roofline.FMA_A, roofline.FMA_B)
                                if which == "fma"
                                else (roofline.EXP_SCALE, 0.0)))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == (132 * 256,)
    # one rounding a step on both sides (the plain FMA rounds once from
    # f64); expf and torch.exp on the card agree to an ulp
    assert ((got / want - 1).abs().max().item()) <= 1e-5


@pytest.mark.gpu
def test_measure_peaks_on_card(card):
    from gsplat_tpu_torch.utils import roofline
    peaks = roofline.measure_peaks(card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert peaks["blocks"] == sms * roofline.BLOCKS_PER_SM
    assert peaks["fma_launch_s"] >= 0.5 * roofline.TARGET_S
    # 128 f32 lanes an SM at no more than 2.1 GHz: a folded chain would
    # read faster than the card can run
    assert 0 < peaks["fma_per_s"] <= 128 * sms * 2.1e9
    assert 0 < peaks["expf_per_s"] < peaks["fma_per_s"]
    # the clock nvidia-smi reads under the chain's load
    assert 0 < peaks["sm_mhz_under_load"] <= 2100
    assert peaks["f32_issue_per_s"] == pytest.approx(
        128 * sms * peaks["sm_mhz_under_load"] * 1e6)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["flat", "grouped"])
@pytest.mark.parametrize("cols", [33, 128, 1000])
def test_scan_kernels_match_plain(card, variant, cols):
    from gsplat_tpu_torch.utils import scan_probe
    x = scan_probe.probe_input(card, cols)
    kernel = scan_probe.KERNELS[variant]

    def launched_once(call):
        before = kernel.launches
        got = call()
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        return got

    for op in ("prod", "sum"):
        got = launched_once(lambda: scan_probe.scan(x, op, variant))
        want = scan_probe._scan_plain(x, op, variant)
        ref = (torch.cumprod if op == "prod" else torch.cumsum)(x.double(), 0)
        # the plain version's combines in the kernel's order
        if variant == "flat":
            assert torch.equal(got, want)
        else:
            assert (got - want).abs().max().item() <= (
                1e-7 if op == "prod" else 1e-5)
        assert (got.double() - ref).abs().max().item() <= (
            1e-5 if op == "prod" else 1e-3)
    want = scan_probe._rounds_plain(x, variant)
    # pass counts below, at and not dividing the kernel's pass slices
    for reps in (1, 7, 64, 1000, 1024):
        got = launched_once(lambda: scan_probe.scan_rounds(x, variant, reps))
        if variant == "flat":
            assert torch.equal(got, want), reps
        else:
            assert (got - want).abs().max().item() <= 1e-6, reps


# ---------------------------------------------------------------------------
# host code of the training CLI and clustering on the card's machine
# ---------------------------------------------------------------------------


def smooth_image(h, w, seed=0):
    """A gradient with noise: the filters a PNG writer picks for it vary by
    row."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(3 * x + 2 * y) % 256, (x * y) % 256,
                    rng.integers(0, 256, size=(h, w))], -1)
    return img.astype(np.uint8)


def filtered_png(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG whose rows cycle through the five filter types."""
    h, w, _ = img.shape
    px = img.astype(np.int64)
    rows = []
    for r in range(h):
        ft = r % 5
        cur = px[r].reshape(-1)
        up = px[r - 1].reshape(-1) if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        ul = np.concatenate([np.zeros(3, np.int64), up[:-3]])
        pred = [np.zeros_like(cur), left, up, (left + up) >> 1,
                png._paeth(left, up, ul)][ft]
        rows.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", header)
            + png._chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + png._chunk(b"IEND", b""))


def png_cases():
    """{name: (PNG bytes, resize (width, height) or None)}."""
    big = np.random.default_rng(7).integers(0, 256, size=(1216, 1600, 3),
                                            dtype=np.uint8)
    return {
        "filters 31x23": (filtered_png(smooth_image(23, 31, seed=4)), None),
        "filters 97x61 to 45x130": (filtered_png(smooth_image(61, 97)),
                                    (45, 130)),
        "1600x1216 to 800x608": (png.encode_png(big), (800, 608)),
    }


# sha256 of the pixels of each case; test_torch_train_cli.py holds them
# equal to Pillow's (12.1.0)
PNG_DIGESTS = {
    "filters 31x23":
        "cc0c2399eb4407c0d7ef3d845ce9b69ed3dff9bf52a74c7244a48431695e316b",
    "filters 97x61 to 45x130":
        "a48535512163ed967af22ab148a72fa304c6e07bde2806a9e1e30490c882fb6f",
    "1600x1216 to 800x608":
        "abd81bd0db334c210cc658435dc531b471a7a0d59ff95fda5d3d13335f5e725d",
}


@pytest.mark.gpu
def test_png_and_resize_bits_on_the_cards_machine(card):
    for name, (data, size) in png_cases().items():
        got = png.decode_png(data)
        if size is not None:
            got = png.resize_rgb(got, *size)
        assert hashlib.sha256(got.tobytes()).hexdigest() == PNG_DIGESTS[name]


@pytest.mark.gpu
def test_kmeans_on_card_matches_cpu(card):
    scene = synthetic.random_scene(20000, seed=4, device="cpu")
    feats = kmeans.scene_features(scene)
    want = kmeans.kmeans(feats, 10, seed=1)
    got = kmeans.kmeans(feats.to(card), 10, seed=1)
    assert got.labels.device.type == "cuda"
    assert (got.labels.cpu() == want.labels).float().mean() >= 0.9999
    assert got.iterations == want.iterations
    # a point that changes cluster moves two centroids by ~1/2000 of its
    # distance; none moved here, so only the sums' order differs
    torch.testing.assert_close(got.centroids.cpu(), want.centroids,
                               rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_batched_eigh_and_normals_on_card_match_cpu(card):
    rng = np.random.default_rng(9)
    q, _ = np.linalg.qr(rng.normal(size=(512, 3, 3)))
    w = np.sort(rng.uniform(0.1, 3.0, size=(512, 3)), axis=1)
    w[:, 1] += 0.5
    w[:, 2] += 1.0          # eigenvalues at least 0.5 apart
    cov = torch.from_numpy((q * w[:, None, :]) @ q.transpose(0, 2, 1)).float()
    w_cpu, v_cpu = torch.linalg.eigh(cov)
    w_card, v_card = torch.linalg.eigh(cov.to(card))
    torch.testing.assert_close(w_card.cpu(), w_cpu, rtol=1e-5, atol=1e-5)
    # eigenvectors up to sign
    dots = (v_card.cpu() * v_cpu).sum(1).abs()
    assert float((dots - 1).abs().max()) <= 1e-4
    pts = synthetic.sphere_scene(3000, radius=1.0, seed=9, scale=0.01,
                                 device="cpu").means
    nbrs = region_growing.knn_indices(pts, 30)
    n_cpu, r_cpu = region_growing.pca_normals(pts, nbrs, 30)
    n_card, r_card = region_growing.pca_normals(pts.to(card), nbrs.to(card),
                                                30)
    assert float((n_card.cpu() - n_cpu).abs().max()) <= 1e-4
    torch.testing.assert_close(r_card.cpu(), r_cpu, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_viewer_frames_on_card_match_cpu(card):
    """The viewer of ``tests/test_viewer.py``'s fixture scene (200
    gaussians, seed 3, 64x48, 4 orbit cameras) on the card against a CPU
    viewer, over HTTP: frames with and without labels, orbit and presets,
    at the render's bar after truncation to uint8 (none more than 2 apart,
    >= 99.9% equal), and the /select payloads equal."""
    import json
    import threading
    from http.client import HTTPConnection
    from http.server import ThreadingHTTPServer

    scene = synthetic.random_scene(200, seed=3, extent=1.0,
                                   scale_range=(0.05, 0.1), num_labels=4,
                                   device="cpu")
    cams = cameras.orbit_cameras(4, 3.0, width=64, img_height=48)
    servers = [viewer.ViewerServer(scene, width=64, height=48, cameras=cams,
                                   device=d) for d in (card, "cpu")]
    assert servers[0].device.type == "cuda"
    httpds = [ThreadingHTTPServer(("127.0.0.1", 0), s.make_handler())
              for s in servers]
    for h in httpds:
        threading.Thread(target=h.serve_forever, daemon=True).start()

    def get(h, path):
        conn = HTTPConnection("127.0.0.1", h.server_address[1], timeout=120)
        try:
            conn.request("GET", path)
            r = conn.getresponse()
            assert r.status == 200
            return r.getheader("Content-Type"), r.read()
        finally:
            conn.close()

    try:
        queries = [f"theta={t}&phi=0.2&r=3&labels={lab}"
                   for t in (0.0, 0.5, 1.7, 3.0) for lab in (0, 1)]
        queries += [f"cam={i}&r=3&labels={lab}" for i in range(4)
                    for lab in (0, 1)]
        equal = total = 0
        for q in queries:
            got, want = (get(h, "/render?" + q) for h in httpds)
            assert got[0] == want[0] == "image/png"
            d = np.abs(png.decode_png(got[1]).astype(np.int32)
                       - png.decode_png(want[1]))
            assert d.max() <= 2, q
            equal += int((d == 0).sum())
            total += d.size
        assert equal / total >= 0.999
        for q in ("x=0.5&y=0.5&theta=0&phi=0&r=3",
                  "x=0.3&y=0.6&theta=0.5&phi=0.2&r=3",
                  "x=0.5&y=0.5&cam=2&r=3", "x=-4&y=-4&theta=0&phi=0&r=3"):
            got, want = (json.loads(get(h, "/select?" + q)[1])
                         for h in httpds)
            assert got == want, q
    finally:
        for h in httpds:
            h.shutdown()
            h.server_close()


# --- the sharded render's interleaved tile lattice (B4, B1, B2) -------------

def _lattice_stream(device, tile_size, dy, dx, py, px, n=20_000):
    """Shard (py, px) of a (dy, dx) lattice on the card frame: its local
    grid, binning and table."""
    from gsplat_tpu_torch.parallel.render_sharded import grid_layout
    scene, cam, proj, _, _ = _card_frame(device, tile_size, n=n)
    _, _, tx_l, ty_l = grid_layout(cam.width, cam.height, tile_size, dy * dx)
    lat = tiles.Lattice(row_stride=dy, row_phase=py, col_stride=dx,
                        col_phase=px)
    b = tiles.bin_tiles(proj, tiles_x=tx_l, tiles_y=ty_l,
                        tile_size=tile_size, **lat._asdict())
    return proj, tx_l, ty_l, lat, b, api.pack_table(proj, scene.labels)


@pytest.mark.gpu
@pytest.mark.parametrize("tile_size", [32, 16])
@pytest.mark.parametrize("dy,dx", [(2, 2), (4, 2), (1, 4), (1, 1)])
def test_lattice_kernels_match_plain(card, dy, dx, tile_size):
    """B4's keys and B1's outputs (with and without labels) equal their
    plain versions bit for bit under the lattice, at every phase; B2 within
    its plain version's bar (the per-tile sums over pixels associate
    differently: 1e-4 of each column's peak, zero rows exact). (1, 1) is
    the single-device grid: the lattice arguments at strides of 1 give the
    calls without them."""
    from gsplat_tpu_torch.parallel.render_sharded import grid_layout
    for e in range(dy * dx):
        proj, tx_l, ty_l, lat, b, ptab = _lattice_stream(
            card, tile_size, dy, dx, e // dx, e % dx)
        nt = tx_l * ty_l
        qd = tiles.depth_qkeys(proj.depth, proj.valid, nt)
        bb = tiles.tile_bboxes(proj, tiles_x=tx_l, tiles_y=ty_l,
                               tile_size=tile_size, lattice=lat)
        kw = dict(tiles_x=tx_l, num_tiles=nt, tile_size=tile_size,
                  db=32 - tiles.depth_shift(nt))
        keys = tiles.enum_keys(proj, qd, bb, **kw, lattice=lat)
        pkeys = tiles._enum_keys_plain(proj, qd, bb, **kw, lattice=lat)
        torch.cuda.synchronize()
        assert bb.total > 0
        assert all(torch.equal(a, p) for a, p in zip(keys, pkeys))
        bkw = dict(tiles_x=tx_l, tiles_y=ty_l, tile_size=tile_size,
                   width=tx_l * tile_size, height=ty_l * tile_size, chunk=64,
                   alpha_min=1 / 255, alpha_max=0.999, early_eps=1e-5,
                   lattice=lat)
        for labels in (True, False):
            out = blend.blend_tiles_fwd(ptab, b.inst_gauss, b.tile_bounds,
                                        **bkw, with_labels=labels)
            ref = blend._blend_tiles_fwd_plain(ptab, b.inst_gauss,
                                               b.tile_bounds, **bkw,
                                               with_labels=labels)
            torch.cuda.synchronize()
            for k in blend.BlendOutput._fields:
                got, want = getattr(out, k), getattr(ref, k)
                assert (got is None) == (want is None), k
                assert got is None or torch.equal(got, want), (e, labels, k)
        _check_bwd(card, ptab, b, 1e-5, **{k: v for k, v in bkw.items()
                                           if k not in ("alpha_min",
                                                        "alpha_max",
                                                        "early_eps")})
        if dy * dx == 1:
            # no lattice argument: the single-device call
            plain = {k: v for k, v in bkw.items() if k != "lattice"}
            a = blend.blend_tiles_fwd(ptab, b.inst_gauss, b.tile_bounds,
                                      **plain, with_labels=True)
            c = blend.blend_tiles_fwd(ptab, b.inst_gauss, b.tile_bounds,
                                      **bkw, with_labels=True)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(a, c))
    assert grid_layout(800, 608, tile_size, 1)[:2] == (1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)])
def test_sharded_render_on_card_bit_equal_to_render(card, shape):
    """D logical shards on the one card: the sharded render's image,
    transmittance, best weight and label map equal ``render``'s."""
    from gsplat_tpu_torch.parallel import mesh as mesh_lib
    from gsplat_tpu_torch.parallel.render_sharded import render_sharded
    scene, cam, _, _, _ = _card_frame(card, n=50_001)
    want = api.render(scene, cam, with_labels=True, device=card)
    mesh = mesh_lib.make_mesh(shape, [card])
    got = render_sharded(mesh_lib.shard_scene(scene, mesh),
                         projection.CameraParams.from_camera(cam, card), mesh,
                         width=cam.width, height=cam.height,
                         cfg=api.DEFAULT, with_labels=True)
    torch.cuda.synchronize()
    for k in ("image", "transmittance", "best_weight", "label_map"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.gpu
def test_nccl_exchange_backward_equals_in_process(card):
    """The exchange across ranks (all_to_all_single over NCCL at a world
    size of 1) and its backward equal the in-process exchange's."""
    import socket

    import torch.distributed as dist

    from gsplat_tpu_torch.parallel import mesh as mesh_lib
    from gsplat_tpu_torch.parallel import render_sharded as rs
    from gsplat_tpu_torch.parallel.bootstrap import initialize_distributed
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    gen = torch.Generator(device=card).manual_seed(3)
    rows = [torch.randn(n, 16, generator=gen, device=card) for n in (7, 5)]
    # source k sends destination e its rows i with i % 3 != e: 4 + 3 rows
    # reach destination 0, 5 + 3 destination 1
    cot = [torch.randn(n, 16, generator=gen, device=card) for n in (7, 8)]

    def run(mesh):
        leaves = [r.clone().requires_grad_(True) for r in rows]
        pieces = [[lv[torch.arange(lv.shape[0], device=card) % 3 != e]
                   for e in range(2)] for lv in leaves]
        out = rs._exchange(pieces, mesh)
        grads = torch.autograd.grad(sum((o * c).sum() for o, c in
                                        zip(out, cot)), leaves)
        return [o.detach() for o in out], grads

    want = run(mesh_lib.make_mesh((1, 2), [card]))
    initialize_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        mesh = mesh_lib.make_mesh((1, 2), [card, card])
        assert mesh.distributed
        got = run(mesh)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert [o.shape[0] for o in got[0]] == [7, 8]
    for a, b in zip(got[0] + list(got[1]), want[0] + list(want[1])):
        assert torch.equal(a, b)
