"""The port's CUDA kernels (B4 ``enum_keys``, B1 ``blend_tiles_fwd``, B2
``blend_tiles_bwd``, B3 ``cumsum_rows``, B5 ``blend_tiles_vis``), their
wrappers, the skip test of B5 and B2 (``csrc/blend_cull.cuh``) through its
plain mirror, and the vote on the card against the CPU.

This file imports neither jax nor ``gsplat_tpu``, so on a machine with a card
and only PyTorch it runs without the JAX harness of ``conftest.py``:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest

On the CPU the wrappers take their plain PyTorch versions and the card cases
skip; on the card each kernel is held against its plain version.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.config import UNLABELED
from gsplat_tpu_torch.io import cameras, synthetic
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


@pytest.mark.gpu
@pytest.mark.parametrize("eps", [0.0, 1e-5])
@pytest.mark.parametrize("tile_size,chunk", [(32, 64), (16, 128)])
def test_blend_kernel_matches_plain(card, eps, tile_size, chunk):
    scene, cam, proj, tx, ty = _card_frame(card, tile_size)
    b = tiles.bin_tiles(proj, tiles_x=tx, tiles_y=ty, tile_size=tile_size)
    ptab = api.pack_table(proj, scene.labels)
    kw = dict(tiles_x=tx, tiles_y=ty, tile_size=tile_size, width=cam.width,
              height=cam.height, chunk=chunk, alpha_min=1 / 255,
              alpha_max=0.999, early_eps=eps, with_labels=True)
    before = blend.blend_tiles_fwd.launches
    out = blend.blend_tiles_fwd(ptab, b.inst_gauss, b.tile_bounds, **kw)
    ref = blend._blend_tiles_fwd_plain(ptab, b.inst_gauss, b.tile_bounds,
                                       **kw)
    torch.cuda.synchronize()
    assert blend.blend_tiles_fwd.launches == before + 1
    # the kernel repeats the plain version's operations in the same order
    # (no FMA contraction, the same expf), so 1e-5 is headroom, not slack
    for k in ("rgb", "transmittance", "best_weight"):
        err = (getattr(out, k) - getattr(ref, k)).abs().max().item()
        assert err <= 1e-5, k
    assert torch.equal(out.label, ref.label)


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
@pytest.mark.parametrize("rows", [1, 511, 512, 513, 100_003])
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
    # an f32 sum chain of rows / 32768 + 112 additions per output
    assert (err <= 1e-6).all(), err


@pytest.mark.gpu
def test_render_gradients_on_card_match_cpu(card):
    scene = synthetic.random_scene(2000, seed=21, num_labels=6, device="cpu")
    cam = cameras.look_at_camera((0.2, -0.3, -3.0), (0, 0, 0), width=128,
                                 height=96)
    target = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(96, 128, 3)).astype(np.float32))
    grads = {}
    before = (blend.blend_tiles_bwd.launches, blend.cumsum_rows.launches)
    for dev in (card, torch.device("cpu")):
        s = scene.to(dev)
        params = trainer.SceneParams.from_scene(s)
        for p in params:
            p.requires_grad_(True)
        out = api.render(params.to_scene(s.labels), cam, device=dev)
        loss = trainer.l2_loss(out["image"], target.to(dev))
        grads[dev.type] = [g.cpu() for g in torch.autograd.grad(loss, params)]
    assert (blend.blend_tiles_bwd.launches,
            blend.cumsum_rows.launches) == (before[0] + 1, before[1] + 1)
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
@pytest.mark.parametrize("cols", [128, 1000])
def test_scan_kernels_match_plain(card, variant, cols):
    from gsplat_tpu_torch.utils import scan_probe
    x = scan_probe.probe_input(card, cols)
    kernel = scan_probe.KERNELS[variant]
    before = kernel.launches
    for op in ("prod", "sum"):
        got = scan_probe.scan(x, op, variant)
        want = scan_probe._scan_plain(x, op, variant)
        ref = (torch.cumprod if op == "prod" else torch.cumsum)(x.double(), 0)
        torch.cuda.synchronize()
        # the plain version's combines in the kernel's order
        assert (got - want).abs().max().item() <= (1e-7 if op == "prod"
                                                   else 1e-5)
        assert (got.double() - ref).abs().max().item() <= (
            1e-5 if op == "prod" else 1e-3)
    for reps in (1, 64):
        got = scan_probe.scan_rounds(x, variant, reps)
        want = scan_probe._rounds_plain(x, variant)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-6
    assert kernel.launches == before + 4
