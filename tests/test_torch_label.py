"""The port's labeling slice against the JAX package, on the CPU.

``render(impl="pallas_vis")`` and kernel B5's plain version, the vote
(``gsplat_tpu_torch.label.vote``), the seg-map sources, IoU, the labeled-PLY
writer and the label CLI in both modes. Every test feeds the same numpy
arrays, made from a seed, to the JAX function (Pallas in interpret mode, as
``tests/test_vote_visible.py`` runs it) and to its counterpart in the port,
whose kernel wrappers take their plain versions on the CPU.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import wall_and_hidden_arrays
from gsplat_tpu import config as jconfig
from gsplat_tpu.cli import label as jcli
from gsplat_tpu.evaluation import iou as jiou
from gsplat_tpu.io import cameras as jcameras
from gsplat_tpu.io import ply as jply
from gsplat_tpu.io import synthetic as jsynthetic
from gsplat_tpu.label import adapters as jadapters
from gsplat_tpu.label import vote as jvote
from gsplat_tpu.render import api as japi
from gsplat_tpu.render import blend_pallas
from gsplat_tpu.render import projection as jprojection
from gsplat_tpu.render import tiles as jtiles
from gsplat_tpu.scene import GaussianScene as JScene
from gsplat_tpu_torch import config as tconfig
from gsplat_tpu_torch.cli import label as tcli
from gsplat_tpu_torch.evaluation import iou as tiou
from gsplat_tpu_torch.io import ply as tply
from gsplat_tpu_torch.label import adapters as tadapters
from gsplat_tpu_torch.label import vote as tvote
from gsplat_tpu_torch.render import api as tapi
from gsplat_tpu_torch.render import blend as tblend
from gsplat_tpu_torch.render import projection as tprojection
from gsplat_tpu_torch.scene import FIELDS, scene_from_numpy

torch.set_num_threads(2)

CPU = "cpu"
# test_torch_render.py's CONFIGS: the default, and tile_size=16, chunk=128
CONFIGS = {"default": (32, 64), "ts16_chunk128": (16, 128)}


def _cfgs(tile_size, chunk):
    return tuple(mod.Config(raster=mod.RasterConfig(tile_size=tile_size),
                            tiles=mod.TileConfig(chunk=chunk))
                 for mod in (jconfig, tconfig))


def _port_scene(jscene):
    s = jscene.to_numpy()
    return scene_from_numpy(**{f: np.asarray(getattr(s, f)) for f in FIELDS},
                            device=CPU)


def _wall_and_hidden():
    """test_vote_visible.py's scene: a near-opaque wall of 64 splats at z=0
    fully occluding one gaussian at z=1 (camera at z=-2 looking to +z)."""
    return JScene.create(*wall_and_hidden_arrays())


def _wall_cam(x=0.0, width=64, height=64):
    return jcameras.look_at_camera((x, 0, -2.0), (0, 0, 0), width=width,
                                   height=height)


# --- 1. the visibility render and B5's plain version ----------------------

@pytest.mark.parametrize("cfg_name,width,height", [
    ("default", 128, 96), ("ts16_chunk128", 128, 96), ("default", 100, 70),
    ("ts16_chunk128", 100, 70)])
def test_render_vis_matches_jax(cfg_name, width, height):
    jcfg, tcfg = _cfgs(*CONFIGS[cfg_name])
    js = jsynthetic.random_scene(2000, seed=21, num_labels=6)
    cam = jcameras.look_at_camera((0.2, -0.3, -3.0), (0, 0, 0), width=width,
                                  height=height)
    bg = np.array([0.3, 0.6, 0.9], np.float32)
    want = japi.render(js, cam, jcfg, background=jnp.asarray(bg),
                       with_labels=True, impl="pallas_vis")
    want = {k: np.asarray(v) for k, v in want.items()}
    got = tapi.render(_port_scene(js), cam, tcfg, background=bg,
                      with_labels=True, impl="pallas_vis", device=CPU)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    assert int(got["num_dropped"]) == 0 == int(want["num_dropped"])
    # the render slice's bar (PERF.md section 2)
    for key in ("image", "alpha", "transmittance", "best_weight"):
        err = np.abs(got[key] - want[key])
        assert err.max() <= 5e-3, key
        assert (err <= 1e-5).mean() >= 0.999, key
    assert (got["label_map"] == want["label_map"]).mean() >= 0.999
    gw = got["gaussian_weight"]
    assert gw.shape == (2000,)
    np.testing.assert_allclose(gw, want["gaussian_weight"], rtol=0,
                               atol=1e-5)
    assert (gw > 0.05).mean() > 0.1   # the frame shows many gaussians


def test_render_vis_has_no_early_stop():
    """B5 composites every instance: its image is the pallas render's at
    early_stop_eps 0, not at the default."""
    js = jsynthetic.random_scene(2000, seed=21, num_labels=6)
    cam = jcameras.look_at_camera((0.2, -0.3, -3.0), (0, 0, 0), width=128,
                                  height=96)
    scene = _port_scene(js)
    vis = tapi.render(scene, cam, with_labels=True, impl="pallas_vis",
                      device=CPU)
    exact = tconfig.Config(raster=tconfig.RasterConfig(early_stop_eps=0.0))
    full = tapi.render(scene, cam, exact, with_labels=True, device=CPU)
    for key in ("image", "transmittance", "best_weight", "label_map"):
        assert torch.equal(vis[key], full[key]), key


@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_vis_frame(request):
    """One JAX window binning at 100x70 (edge tiles cut by the image) and
    blend_windows_vis run on it."""
    ts, chunk = CONFIGS[request.param]
    jcfg, tcfg = _cfgs(ts, chunk)
    js = jsynthetic.random_scene(2000, seed=31, extent=1.2,
                                 scale_range=(0.01, 0.05), num_labels=7)
    cam = jcameras.look_at_camera((0.1, 0.2, -3.0), (0, 0, 0), width=100,
                                  height=70)
    jproj = jprojection.project(js, jprojection.CameraParams.from_camera(cam),
                                cam.width, cam.height, jcfg.raster)
    tx, ty = jprojection.tile_grid(cam.width, cam.height, ts)
    budget = jtiles.bucket_budget(int(jtiles.count_instances(
        jproj, tiles_x=tx, tiles_y=ty, tile_size=ts)), chunk)
    jbin = jtiles.bin_windows(jproj, tiles_x=tx, tiles_y=ty, tile_size=ts,
                              chunk=chunk, budget=budget, interpret=True)
    ptab = japi.pack_table(jproj, js.labels)
    params = japi._window_params(ptab, jbin.inst_gauss, chunk)
    rc = jcfg.raster
    out_tiles, wrows = blend_pallas.blend_windows_vis(
        params, jbin.win_tile, jbin.win_first, jbin.win_start, jbin.win_off,
        jbin.win_len, jbin.win_rcg, chunk=chunk, wpg=1, tile_size=ts,
        tiles_x=tx, num_tiles=tx * ty, alpha_min=rc.alpha_min,
        alpha_max=rc.alpha_max, with_labels=True, interpret=True)
    img = np.asarray(blend_pallas.tiles_to_image(out_tiles, tx, ty, ts,
                                                 cam.width, cam.height))
    wrows = np.asarray(wrows)
    keep = wrows[:, 1] >= 0
    gw = np.zeros(js.num_gaussians, np.float32)
    np.maximum.at(gw, wrows[keep, 1].astype(np.int64), wrows[keep, 0])
    inst = np.asarray(jbin.inst_gauss)
    lists = [[] for _ in range(tx * ty)]
    for t, s, o, n in zip(*(np.asarray(a) for a in (
            jbin.win_tile, jbin.win_start, jbin.win_off, jbin.win_len))):
        lists[t].extend(inst[s + o:s + o + n].tolist())
    return dict(js=js, cam=cam, tcfg=tcfg, jproj=jproj, tx=tx, ty=ty, ts=ts,
                img=img, gw=gw, lists=lists)


def test_blend_vis_plain_matches_jax_kernel(jax_vis_frame):
    f = jax_vis_frame
    rc = f["tcfg"].raster
    inst = np.concatenate([np.asarray(l, np.int32) for l in f["lists"]])
    bounds = np.concatenate([[0], np.cumsum([len(l) for l in f["lists"]])])
    # three filtered slots past the last tile, as bin_tiles leaves them
    inst = np.concatenate([inst, np.zeros(3, np.int32)])
    proj = tprojection.Projected(*(torch.from_numpy(np.array(a))
                                   for a in f["jproj"]))
    ptab = tapi.pack_table(proj, torch.from_numpy(
        np.asarray(f["js"].labels)))
    out, inst_w = tblend.blend_tiles_vis(
        ptab, torch.from_numpy(inst),
        torch.from_numpy(bounds.astype(np.int32)), tiles_x=f["tx"],
        tiles_y=f["ty"], tile_size=f["ts"], width=100, height=70,
        chunk=f["tcfg"].tiles.chunk, alpha_min=rc.alpha_min,
        alpha_max=rc.alpha_max, with_labels=True)
    assert inst_w.shape == (len(inst),)
    assert not inst_w[-3:].any()
    img = f["img"]
    np.testing.assert_allclose(out.rgb.numpy(), img[..., 0:3], atol=1e-5)
    np.testing.assert_allclose(out.transmittance.numpy(), img[..., 3],
                               atol=1e-5)
    np.testing.assert_allclose(out.best_weight.numpy(), img[..., 4],
                               atol=1e-5)
    want_lab = np.where(img[..., 4] > 0, np.round(img[..., 5]), -1)
    np.testing.assert_array_equal(out.label.numpy(), want_lab)
    gw = tapi.gaussian_weights(inst_w, torch.from_numpy(inst),
                               f["js"].num_gaussians).numpy()
    np.testing.assert_allclose(gw, f["gw"], rtol=0, atol=1e-5)
    assert (f["gw"] > 0.05).sum() > 100   # the frame is not empty


# --- 2. visibility ---------------------------------------------------------

def _random_vis_case():
    js = jsynthetic.random_scene(1500, seed=12, extent=1.0,
                                 scale_range=(0.01, 0.05), num_labels=5)
    cams = [jcameras.look_at_camera((0.3, -0.2, -3.0), (0, 0, 0), width=96,
                                    height=64),
            jcameras.look_at_camera((-3.0, 0.1, 0.2), (0, 0, 0), width=96,
                                    height=64)]
    return js, cams


@pytest.mark.parametrize("case", ["wall_mixed", "random"])
def test_visibility_masks_match_jax(case):
    if case == "wall_mixed":
        # test_vote_visible.py:106-115: two resolution groups
        js = _wall_and_hidden()
        cams = [_wall_cam(), _wall_cam(width=96, height=48), _wall_cam(0.1)]
    else:
        js, cams = _random_vis_case()
    thr = 0.05
    want = np.asarray(jvote.visibility_masks(js, cams, cfg=jconfig.Config()))
    scene = _port_scene(js)
    got = tvote.visibility_masks(scene, cams, device=CPU).numpy()
    assert got.shape == want.shape == (len(cams), js.num_gaussians)
    weights = np.stack([tapi.render(scene, c, impl="pallas_vis",
                                    device=CPU)["gaussian_weight"].numpy()
                        for c in cams])
    band = np.abs(weights - thr) <= 1e-5
    assert band.sum() <= 2, band.sum()
    np.testing.assert_array_equal(got[~band], want[~band])
    assert got.any(axis=1).all()
    if case == "wall_mixed":
        assert got[:, :64].any(axis=1).all() and not got[:, 64].any()


# --- 3. the vote ----------------------------------------------------------

@pytest.fixture(scope="module")
def vote_setup():
    """test_vote.py's setup: 120 gaussians, 6 orbit views at 64x48, seg
    maps at half resolution (the scaling path)."""
    js = jsynthetic.random_scene(120, seed=41)
    cams = jcameras.orbit_cameras(6, radius=3.0, width=64, img_height=48)
    seg = np.random.default_rng(0).integers(-1, 5, size=(6, 24, 32)).astype(
        np.int32)
    return js, cams, seg


def _scaled_coords_clear_of_integers(scene, cams, seg):
    """No visible center's seg-map coordinate lies within 1e-4 of an
    integer, so an exact-equality failure cannot come from an ulp of the
    projection."""
    cb = {k: torch.from_numpy(v) for k, v in tvote.camera_batch(cams).items()}
    u, v, vis = tvote.project_centers(scene.means, cb["rot"], cb["pos"],
                                      cb["fx"], cb["fy"], cb["width"],
                                      cb["height"])
    sh, sw = seg.shape[1:]
    for c, size, extent in ((u, sw, cb["width"]), (v, sh, cb["height"])):
        x = (c * (size / extent)[:, None])[vis].double().numpy()
        assert np.abs(x - np.round(x)).min() > 1e-4


@pytest.mark.parametrize("variant", ["six_classes", "initial_votes",
                                     "151_classes"])
def test_assign_labels_matches_jax(vote_setup, variant):
    js, cams, seg = vote_setup
    scene = _port_scene(js)
    _scaled_coords_clear_of_integers(scene, cams, seg)
    nc = 151 if variant == "151_classes" else 6
    kw = {}
    if variant == "initial_votes":
        kw["initial_votes"] = np.random.default_rng(3).integers(
            0, 3, size=(120, nc + 1)).astype(np.int32)
    jl, jv = jvote.assign_labels(js, cams, seg, num_classes=nc,
                                 return_votes=True, **kw)
    tl, tv = tvote.assign_labels(scene, cams, seg, num_classes=nc,
                                 return_votes=True, device=CPU, **kw)
    assert tv.dtype == torch.int32 and tv.shape == (120, nc + 1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (tl.numpy() >= 0).mean() > 0.5
    np.testing.assert_array_equal(
        tvote.votes_to_labels(tv).numpy(),
        np.asarray(jvote.votes_to_labels(jnp.asarray(np.asarray(jv)))))


def test_assign_labels_visible_matches_jax():
    js = _wall_and_hidden()
    cams = [_wall_cam(), _wall_cam(0.1)]
    seg = np.full((2, 64, 64), 3, np.int32)
    want = np.asarray(jvote.assign_labels_visible(js, cams, seg,
                                                  num_classes=5,
                                                  cfg=jconfig.Config()))
    scene = _port_scene(js)
    got, votes = tvote.assign_labels_visible(scene, cams, seg, num_classes=5,
                                             return_votes=True, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    naive = tvote.assign_labels(scene, cams, seg, num_classes=5, device=CPU)
    # the hidden gaussian is labeled through the wall by the center vote
    # and left unlabeled by the occlusion-aware one
    assert int(naive[64]) == 3 and int(got[64]) == -1
    assert (got[:64] == 3).all() and int(votes[64].sum()) == 0


def test_vote_mesh_is_not_ported():
    # a mesh that is not a parallel.mesh.Mesh is refused (the sharded votes
    # are held against these in tests/test_torch_parallel.py)
    scene = _port_scene(_wall_and_hidden())
    seg = np.zeros((1, 8, 8), np.int32)
    for fn in (tvote.assign_labels, tvote.assign_labels_visible):
        with pytest.raises(TypeError, match="Mesh"):
            fn(scene, [_wall_cam()], seg, mesh=object(), device=CPU)


# --- 4. numpy helpers: statistics, seg-map sources, IoU -------------------

def test_label_statistics_match_jax():
    labels = np.random.default_rng(4).integers(-1, 6, size=500).astype(
        np.int32)
    names = {0: "wall", 3: "floor"}
    want = jvote.label_statistics(labels, names)
    assert tvote.label_statistics(labels, names) == want
    assert tvote.label_statistics(torch.from_numpy(labels), names) == want


@pytest.mark.parametrize("shape,size", [((24, 32), (48, 64)),
                                        ((61, 47), (30, 20)),
                                        ((10, 10), (10, 10))])
def test_nearest_resize_matches_jax(shape, size):
    seg = np.random.default_rng(5).integers(-1, 9, size=shape).astype(
        np.int32)
    np.testing.assert_array_equal(tadapters._nearest_resize(seg, *size),
                                  jadapters._nearest_resize(seg, *size))


def test_masks_to_instance_map_and_backends_match_jax():
    rng = np.random.default_rng(6)
    masks = [rng.uniform(size=(20, 30)) < p for p in (0.1, 0.6, 0.3, 0.05)]
    np.testing.assert_array_equal(
        tadapters.masks_to_instance_map(masks, 40, 60),
        jadapters.masks_to_instance_map(masks, 40, 60))
    assert set(tadapters.BACKENDS) == set(jadapters.BACKENDS)
    with pytest.raises(ValueError):
        tadapters.make_backend("nope")


def test_npy_source_matches_jax(tmp_path):
    seg = np.random.default_rng(7).integers(-1, 150, size=(30, 40))
    np.save(tmp_path / "view_007_seg.npy", seg.astype(np.int64))
    got = tadapters.make_backend("npy", directory=str(tmp_path))("view_007")
    want = jadapters.NpySource(str(tmp_path))("view_007")
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        tadapters.NpySource(str(tmp_path))("missing")


def test_iou_functions_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    preds = [rng.uniform(size=(16, 16)) < 0.4 for _ in range(4)]
    gts = [rng.uniform(size=(16, 16)) < 0.4 for _ in range(3)]
    for a, b in zip(preds, gts):
        assert tiou.iou(a, b) == jiou.iou(a, b)
    assert tiou.iou(np.zeros((4, 4)), np.zeros((4, 4))) == 0.0
    assert tiou.best_ious(preds, gts) == jiou.best_ious(preds, gts)
    np.testing.assert_array_equal(tiou.segmentation_map_from_masks(preds),
                                  jiou.segmentation_map_from_masks(preds))
    pred = rng.integers(-1, 4, size=(20, 20))
    gt = rng.integers(-1, 4, size=(20, 20))
    for ignore in ((), (-1,)):
        assert tiou.class_ious(pred, gt, ignore) == jiou.class_ious(
            pred, gt, ignore)
        assert tiou.mean_iou(pred, gt, ignore) == jiou.mean_iou(
            pred, gt, ignore)
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"shapes": [
        {"label": "Lego", "points": [[1, 1], [6, 1], [6, 6], [1, 6]]},
        {"label": "other", "points": [[0, 0], [2, 0], [2, 2]]}]}))
    np.testing.assert_array_equal(
        tiou.labelme_mask(str(ann), "Lego", 8, 9),
        jiou.labelme_mask(str(ann), "Lego", 8, 9))


# --- 5. the labeled PLY and the CLI ----------------------------------------

def test_add_labels_to_ply_matches_jax(tmp_path):
    js = jsynthetic.random_scene(150, seed=9, num_labels=3, sh_degree=1)
    src = str(tmp_path / "src.ply")
    jply.scene_to_ply(src, js)
    labels = np.random.default_rng(10).integers(-1, 20, size=150).astype(
        np.int32)
    tply.add_labels_to_ply(src, str(tmp_path / "port.ply"),
                           torch.from_numpy(labels))
    jply.add_labels_to_ply(src, str(tmp_path / "jax.ply"), labels)
    got = jply.read_ply(str(tmp_path / "port.ply"))["vertex"]
    want = jply.read_ply(str(tmp_path / "jax.ply"))["vertex"]
    assert got.dtype == want.dtype and got.dtype.names[-1] == "label"
    np.testing.assert_array_equal(got["label"], labels)
    for p in want.dtype.names:
        assert got[p].tobytes() == want[p].tobytes(), p
    with pytest.raises(ValueError):
        tply.add_labels_to_ply(src, str(tmp_path / "bad.ply"), labels[:-1])


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """A tiny PLY, a cameras.json of 4 orbit views at 64x48 and npy seg maps
    at half resolution, labelled by x slab so the vote has structure."""
    d = tmp_path_factory.mktemp("label_cli")
    js = jsynthetic.random_scene(400, seed=13, extent=0.8,
                                 scale_range=(0.02, 0.06), num_labels=4)
    jply.scene_to_ply(str(d / "scene.ply"), js)
    cams = jcameras.orbit_cameras(4, 3.0, height=0.5, width=64,
                                  img_height=48)
    jcameras.save_cameras(str(d / "cameras.json"), cams)
    rng = np.random.default_rng(14)
    for cam in cams:
        seg = np.repeat(np.arange(8)[None, :] // 2, 24, axis=0)
        seg = np.repeat(seg, 4, axis=1)[:, :32]
        seg = np.where(rng.uniform(size=seg.shape) < 0.2, -1, seg)
        np.save(d / f"{cam.img_name}_seg.npy", seg.astype(np.int32))
    return d, _port_scene(js), cams


@pytest.mark.parametrize("mode", ["center", "visible"])
def test_label_cli_matches_jax(cli_inputs, mode, capsys):
    d, scene, cams = cli_inputs
    if mode == "visible":
        weights = np.stack([tapi.render(scene, c, impl="pallas_vis",
                                        device=CPU)["gaussian_weight"]
                            .numpy() for c in cams])
        assert not (np.abs(weights - 0.05) <= 1e-5).any()
    args = ["--ply_file", str(d / "scene.ply"), "--camera_file",
            str(d / "cameras.json"), "--input_dir", str(d), "--output_dir",
            str(d), "--model", "npy", "--num_classes", "151", "--mode",
            mode]
    assert jcli.main(args + ["--output_file", f"jax_{mode}.ply"]) == 0
    jax_out = capsys.readouterr().out
    assert tcli.main(args + ["--output_file", f"port_{mode}.ply",
                             "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    want = jply.read_ply(str(d / f"jax_{mode}.ply"))["vertex"]
    got = tply.read_ply(str(d / f"port_{mode}.ply"))["vertex"]
    np.testing.assert_array_equal(got["label"], want["label"])
    assert (got["label"] >= 0).mean() > 0.3
    # the statistics printout too
    stats = lambda out: [l for l in out.splitlines() if l.startswith("label")]
    assert stats(port_out) == stats(jax_out)
    # --sharded (refused before the multi-GPU slice) writes the same labels
    # and prints the same statistics
    assert tcli.main(args + ["--output_file", "x.ply", "--device", "cpu",
                             "--sharded"]) == 0
    assert stats(capsys.readouterr().out) == stats(port_out)
    np.testing.assert_array_equal(
        tply.read_ply(str(d / "x.ply"))["vertex"]["label"], got["label"])
