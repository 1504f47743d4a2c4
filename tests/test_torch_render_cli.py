"""The port's offline render path against the JAX package, on the CPU.

``render(impl="dense")`` (``render/blend_dense.py``) and its gradients, the
budget counts, the edits (``interact/edit.py``), ``.splat`` export and
import, ``load_scene``, the PNG encoder (``io/png.py``), the label
visualisation and the render CLI. Every test feeds the same numpy arrays,
made from a seed, to the JAX function and to its counterpart in the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gsplat_tpu import config as jconfig
from gsplat_tpu.cli import render as jcli
from gsplat_tpu.interact import edit as jedit
from gsplat_tpu.io import cameras as jcameras
from gsplat_tpu.io import ply as jply
from gsplat_tpu.io import splat_format as jsplat
from gsplat_tpu.io import synthetic as jsynthetic
from gsplat_tpu.label import adapters as jadapters
from gsplat_tpu.ref import rasterizer as ref
from gsplat_tpu.render import api as japi
from gsplat_tpu.render import projection as jprojection
from gsplat_tpu.render import tiles as jtiles
from gsplat_tpu.scene import GaussianScene as JScene
from gsplat_tpu.scene import color_to_dc
from gsplat_tpu_torch import config as tconfig
from gsplat_tpu_torch.cli import render as tcli
from gsplat_tpu_torch.interact import edit as tedit
from gsplat_tpu_torch.io import ply as tply
from gsplat_tpu_torch.io import png as tpng
from gsplat_tpu_torch.io import splat_format as tsplat
from gsplat_tpu_torch.label import adapters as tadapters
from gsplat_tpu_torch.render import api as tapi
from gsplat_tpu_torch.scene import (FIELDS, GaussianScene, dc_color,
                                    scene_from_numpy)

torch.set_num_threads(2)

CPU = "cpu"


def _port_scene(jscene):
    s = jscene.to_numpy()
    return scene_from_numpy(**{f: np.asarray(getattr(s, f)) for f in FIELDS},
                            device=CPU)


def _small():
    """conftest's small scene and camera: 200 gaussians, 5 labels, 64x48."""
    return (jsynthetic.random_scene(200, seed=1, num_labels=5),
            jcameras.look_at_camera((0.0, 0.0, -3.0), (0.0, 0.0, 0.0),
                                    width=64, height=48, fov_x_deg=60.0))


# --- 1. the dense path -------------------------------------------------------

@pytest.mark.parametrize("bg", [None, (0.2, 0.4, 0.6)])
def test_dense_render_matches_jax(bg):
    js, cam = _small()
    jbg = None if bg is None else jnp.asarray(bg, jnp.float32)
    want = japi.render(js, cam, jconfig.DEFAULT, impl="dense",
                       with_labels=True, background=jbg)
    got = tapi.render(_port_scene(js), cam, tconfig.DEFAULT, impl="dense",
                      with_labels=True, background=bg, device=CPU)
    assert set(got) == set(want)
    for key in ("image", "alpha", "transmittance"):
        err = np.abs(got[key].numpy() - np.asarray(want[key])).max()
        assert err <= 1e-5, key
    assert (got["label_map"].numpy()
            == np.asarray(want["label_map"])).mean() >= 0.99
    assert int(got["num_dropped"]) == 0 == int(want["num_dropped"])
    if bg is not None:
        # the background identity: C + T bg over the black render
        black = tapi.render(_port_scene(js), cam, impl="dense", device=CPU)
        np.testing.assert_allclose(
            got["image"].numpy(),
            (black["image"] + black["transmittance"][..., None]
             * torch.tensor(bg)).numpy(), atol=1e-6)


def test_dense_render_matches_oracle():
    """tests/test_render_xla.py's bar for the JAX dense path."""
    js, cam = _small()
    out_np = ref.render_np(js, cam)
    got = tapi.render(_port_scene(js), cam, impl="dense", with_labels=True,
                      device=CPU)
    err = np.abs(got["image"].numpy() - out_np["image"])
    assert np.median(err) < 1e-5
    assert err.max() < 5e-3
    np.testing.assert_allclose(got["alpha"].numpy(), out_np["alpha"],
                               atol=5e-3)
    assert (got["label_map"].numpy() != out_np["label_map"]).mean() < 0.01


def test_dense_gradients_match_jax():
    js = jsynthetic.random_scene(50, seed=11)
    _, cam = _small()
    target = np.random.default_rng(2).uniform(size=(48, 64, 3)).astype(
        np.float32)
    fields = ("means", "log_scales", "quats", "opacities", "sh")

    def jloss(*leaves):
        s2 = dataclasses.replace(js, **dict(zip(fields, leaves)))
        out = japi.render(s2, cam, impl="dense")
        return jnp.sum((out["image"] - target) ** 2)

    jgrads = jax.grad(jloss, argnums=tuple(range(5)))(
        *(jnp.asarray(getattr(js, f)) for f in fields))
    ts = _port_scene(js)
    leaves = [getattr(ts, f).clone().requires_grad_(True) for f in fields]
    scene = GaussianScene(*leaves, ts.labels)
    out = tapi.render(scene, cam, impl="dense", device=CPU)
    loss = torch.sum((out["image"] - torch.from_numpy(target)) ** 2)
    tgrads = torch.autograd.grad(loss, leaves)
    for f, g, jg in zip(fields, tgrads, jgrads):
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0, f
        assert np.abs(g.numpy() - jg).max() <= 1e-4 * np.abs(jg).max(), f


def test_dense_refuses_large_scenes():
    js = jsynthetic.random_scene(2000, seed=3)
    cam = jcameras.look_at_camera((0, 0, -3.0), (0, 0, 0), width=800,
                                  height=800)
    with pytest.raises(ValueError, match="small-scene"):
        japi.render(js, cam, impl="dense")
    with pytest.raises(ValueError, match="small-scene"):
        tapi.render(_port_scene(js), cam, impl="dense", device=CPU)


# --- 2. budgets ------------------------------------------------------------

def _jax_counts(js, cam):
    proj = jprojection.project(
        js, jprojection.CameraParams.from_camera(cam), cam.width,
        cam.height, jconfig.DEFAULT.raster)
    tx, ty = jprojection.tile_grid(cam.width, cam.height, 32)
    kw = dict(tiles_x=tx, tiles_y=ty, tile_size=32)
    cnt = int(jtiles.count_instances(proj, **kw))
    tight = int(jtiles.count_instances_tight(
        proj, budget=jtiles.bucket_budget(cnt, 64), **kw))
    return cnt, tight, tx * ty


def test_measure_budgets_are_the_jax_counts():
    js = jsynthetic.random_scene(3000, seed=41, extent=1.0,
                                 scale_range=(0.01, 0.04))
    cams = jcameras.orbit_cameras(4, 3.0, height=0.3, width=160,
                                  img_height=120)
    want = [_jax_counts(js, c) for c in cams]
    ts = _port_scene(js)
    for cam, w in zip(cams, want):
        assert tapi.measure_budgets(ts, cam, device=CPU) == w
    multi = tapi.measure_budgets_multi(ts, cams, device=CPU)
    assert multi == tuple(max(w[i] for w in want) for i in range(3))
    assert multi[0] > multi[1] > 0
    # render takes the tuple and ignores it
    b, kb, nw = multi
    out = tapi.render(ts, cams[0], budget=b, kernel_budget=kb,
                      num_windows=nw, device=CPU)
    assert int(out["num_dropped"]) == 0


# --- 3. edits (tests/test_interact.py, mirrored) --------------------------

def _one_splat(label, pos=(0.0, 0.0, 0.0), color=(1.0, 0, 0)):
    return JScene.create(
        np.array([pos]), np.log(np.full((1, 3), 0.1)),
        np.array([[1.0, 0, 0, 0]]), np.array([6.0]),
        color_to_dc(np.array(color))[None, None, :],
        labels=np.array([label], np.int32))


def _cat(*scenes):
    return JScene(*[np.concatenate([np.asarray(getattr(s, f)) for s in scenes])
                    for f in FIELDS])


def _both_edits(jscene, st):
    """apply_edits of both packages; asserts the port's within 1e-6."""
    want = jedit.apply_edits(jscene, st)
    got = tedit.apply_edits(_port_scene(jscene), st)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    return got


def test_hit_test_picks_front_gaussian():
    scene = _cat(_one_splat(7, (0, 0, 0)), _one_splat(9, (0, 0, 1.0)))
    cam = jcameras.look_at_camera((0, 0, -2.0), (0, 0, 0), width=64,
                                  height=64)
    assert tedit.hit_test(_port_scene(scene), cam, 32.0, 32.0) == 7 == \
        jedit.hit_test(scene, cam, 32.0, 32.0)


def test_hit_test_radius_and_miss():
    scene = _one_splat(3)
    cam = jcameras.look_at_camera((0, 0, -2.0), (0, 0, 0), width=64,
                                  height=64)
    ts = _port_scene(scene)
    assert tedit.hit_test(ts, cam, 32.0, 32.0) == 3
    assert tedit.hit_test(ts, cam, 5.0, 5.0) == tconfig.NO_SELECTION
    assert jedit.hit_test(scene, cam, 5.0, 5.0) == tconfig.NO_SELECTION


def test_hit_test_first_minimum_wins_ties():
    """Two centers at one depth and pixel: the lower index's label, as
    ``jnp.argmin``'s first minimum."""
    scene = _cat(_one_splat(4, (0, 0, 0.5)), _one_splat(6, (0, 0, 0.5)),
                 _one_splat(8, (0.01, 0, 0.5)))
    cam = jcameras.look_at_camera((0, 0, -2.0), (0, 0, 0), width=64,
                                  height=64)
    assert tedit.hit_test(_port_scene(scene), cam, 32.0, 32.0) == 4 == \
        jedit.hit_test(scene, cam, 32.0, 32.0)


def test_displacement_moves_only_label():
    scene = _cat(_one_splat(1, (-0.5, 0, 0)), _one_splat(2, (0.5, 0, 0)))
    out = _both_edits(scene, jedit.EditState().displace(1, (0.0, 0.3, 0.0)))
    m = out.means.numpy()
    np.testing.assert_allclose(m[0], [-0.5, 0.3, 0.0], atol=1e-6)
    np.testing.assert_allclose(m[1], [0.5, 0.0, 0.0], atol=1e-6)


def test_hide_label_removes_from_render():
    scene = _one_splat(5)
    cam = jcameras.look_at_camera((0, 0, -2.0), (0, 0, 0), width=32,
                                  height=32)
    st = jedit.EditState().toggle_visibility(5)
    out = tapi.render(_both_edits(scene, st), cam, device=CPU)
    assert float(out["alpha"].max()) < 1e-3
    st.toggle_visibility(5)
    out2 = tapi.render(_both_edits(scene, st), cam, device=CPU)
    assert float(out2["alpha"].max()) > 0.8


def test_custom_color_mix():
    scene = _one_splat(4, color=(1.0, 0.0, 0.0))
    out = _both_edits(scene, jedit.EditState().set_color(4, (0.0, 0.0, 1.0)))
    np.testing.assert_allclose(dc_color(out.sh.numpy()[0, 0]),
                               [0.4, 0.0, 0.6], atol=1e-6)


def test_selection_highlight():
    scene = _one_splat(4, color=(0.0, 1.0, 0.0))
    st = jedit.EditState()
    st.selection_mode, st.selected_label = True, 4
    out = _both_edits(scene, st)
    np.testing.assert_allclose(dc_color(out.sh.numpy()[0, 0]),
                               [0.5, 0.5, 0.0], atol=1e-6)


def test_edits_on_a_random_scene_match_jax():
    js = jsynthetic.random_scene(500, seed=5, num_labels=6, sh_degree=1)
    st = (jedit.EditState().displace(1, (0.1, -0.2, 0.05), step=0.5)
          .toggle_visibility(3).set_color(2, (0.2, 0.9, 0.1))
          .set_color(5, (1.0, 1.0, 0.0)))
    st.selection_mode, st.selected_label = True, 2
    got = _both_edits(js, st)
    assert (got.opacities[got.labels == 3] == -30.0).all()


def test_session_roundtrip(tmp_path):
    st = (tedit.EditState().displace(3, (0.1, 0, 0)).toggle_visibility(8)
          .set_color(2, (0.5, 0.6, 0.7)))
    st.selected_label = 3
    p = str(tmp_path / "session.json")
    st.save(p)
    back = tedit.EditState.load(p)
    assert back.displacements[3] == (0.1, 0.0, 0.0)
    assert back.hidden[8] is True
    assert back.colors[2] == (0.5, 0.6, 0.7)
    assert back.selected_label == 3
    # the session JSON is the JAX class's, string for string, both ways
    jst = (jedit.EditState().displace(3, (0.1, 0, 0)).toggle_visibility(8)
           .set_color(2, (0.5, 0.6, 0.7)))
    jst.selected_label = 3
    assert st.to_json() == jst.to_json()
    assert jedit.EditState.load(p).to_json() == st.to_json()


def test_delete_labels():
    scene = _cat(_one_splat(1), _one_splat(2), _one_splat(3))
    out = tedit.delete_labels(_port_scene(scene), [2])
    want = jedit.delete_labels(scene, [2])
    assert out.num_gaussians == 2 and out.device == torch.device(CPU)
    assert set(out.labels.tolist()) == {1, 3}
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(want, f)))


# --- 4. .splat, load_scene, PNG ---------------------------------------------

@pytest.mark.parametrize("sort", [True, False])
def test_splat_bytes_equal_jax(sort):
    js = jsynthetic.random_scene(300, seed=71, num_labels=4, sh_degree=2)
    want, wo = jsplat.pack_splat(js, sort_by_importance=sort)
    got, go = tsplat.pack_splat(_port_scene(js), sort_by_importance=sort)
    assert got == want
    np.testing.assert_array_equal(go, wo)
    np.testing.assert_array_equal(tsplat.importance(_port_scene(js)),
                                  jsplat.importance(js))


def test_splat_roundtrip_within_quantization(tmp_path):
    js = jsynthetic.random_scene(200, seed=72, num_labels=3)
    ts = _port_scene(js)
    p, lp = str(tmp_path / "s.splat"), str(tmp_path / "s.labels")
    tsplat.write_splat(p, ts, labels_path=lp)
    jsplat.write_splat(str(tmp_path / "j.splat"), js,
                       labels_path=str(tmp_path / "j.labels"))
    assert open(p, "rb").read() == open(tmp_path / "j.splat", "rb").read()
    assert open(lp, "rb").read() == open(tmp_path / "j.labels", "rb").read()
    data, _ = tsplat.pack_splat(ts, sort_by_importance=False)
    back = tsplat.read_splat(data, device=CPU)
    want = jsplat.read_splat(data)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(want, f)))
    s = ts.to_numpy()
    np.testing.assert_array_equal(back.means.numpy(), s["means"])
    np.testing.assert_allclose(back.log_scales.numpy(), s["log_scales"],
                               atol=1e-5)
    np.testing.assert_allclose(dc_color(back.sh.numpy()[:, 0, :]),
                               np.clip(dc_color(s["sh"][:, 0, :]), 0, 1),
                               atol=1.0 / 255.0 + 1e-6)
    qw = s["quats"] / np.linalg.norm(s["quats"], axis=1, keepdims=True)
    qg = back.quats.numpy() / np.linalg.norm(back.quats.numpy(), axis=1,
                                             keepdims=True)
    assert np.abs(np.abs(np.sum(qw * qg, axis=1)) - 1).max() < 1e-3
    with pytest.raises(ValueError):
        tsplat.read_splat(data[:-1], device=CPU)


def test_load_scene_autodetect(tmp_path):
    js = jsynthetic.random_scene(30, seed=74, num_labels=3)
    ts = _port_scene(js)
    pply, psplat = str(tmp_path / "s.ply"), str(tmp_path / "s.splat")
    tply.scene_to_ply(pply, ts)
    tsplat.write_splat(psplat, ts, sort_by_importance=False)
    a = tply.load_scene(pply, device=CPU)
    b = tply.load_scene(psplat, device=CPU)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(ts, f)), f
    assert torch.equal(b.means, ts.means)
    wb = jply.load_scene(psplat)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(wb, f)))
    raw = open(pply, "rb").read()
    assert torch.equal(tply.load_scene_bytes(raw, device=CPU).means,
                       ts.means)
    assert torch.equal(tply.load_scene_bytes(open(psplat, "rb").read(),
                                             device=CPU).means, ts.means)
    # a PLY whose header lines end in CRLF is still a PLY
    head, body = raw.split(b"end_header\n", 1)
    crlf = tmp_path / "crlf.ply"
    crlf.write_bytes(head.replace(b"\n", b"\r\n") + b"end_header\r\n" + body)
    c = tply.load_scene(str(crlf), device=CPU)
    assert torch.equal(c.means, ts.means) and torch.equal(c.labels, ts.labels)


def test_png_decodes_through_pil(tmp_path):
    rgb = np.random.default_rng(9).integers(0, 256, size=(37, 53, 3)).astype(
        np.uint8)
    p = tmp_path / "x.png"
    tpng.write_png(str(p), rgb)
    with Image.open(p) as im:
        assert im.mode == "RGB" and im.size == (53, 37)
        np.testing.assert_array_equal(np.asarray(im), rgb)
    for bad in (rgb[..., :2], rgb.astype(np.float32), rgb[0]):
        with pytest.raises(ValueError):
            tpng.encode_png(bad)


def test_save_visualization_pixels_equal_jax(tmp_path):
    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, size=(24, 40, 3)).astype(np.uint8)
    seg = rng.integers(-1, 12, size=(24, 40)).astype(np.int32)
    jadapters.save_visualization(str(tmp_path / "j.png"), img, seg,
                                 num_classes=12)
    tadapters.save_visualization(str(tmp_path / "t.png"), img, seg,
                                 num_classes=12)
    with Image.open(tmp_path / "j.png") as a, \
            Image.open(tmp_path / "t.png") as b:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# --- 5. the render CLI ------------------------------------------------------

def test_render_cli_matches_jax(tmp_path, capsys):
    js = jsynthetic.random_scene(1500, seed=21, num_labels=6)
    scene_path = tmp_path / "scene.ply"
    jply.scene_to_ply(str(scene_path), js)
    cams = jcameras.orbit_cameras(3, 3.0, height=0.2, width=96,
                                  img_height=72)
    jcameras.save_cameras(str(tmp_path / "cameras.json"), cams)
    st = (jedit.EditState().toggle_visibility(3)
          .displace(1, (0.05, 0.0, 0.0)).set_color(2, (0.1, 0.2, 0.9)))
    st.save(str(tmp_path / "session.json"))
    args = ["--ply_file", str(scene_path), "--camera_file",
            str(tmp_path / "cameras.json"), "--label_maps", "--session",
            str(tmp_path / "session.json"), "--background", "0.1,0.2,0.3",
            "--views", "0,2"]
    assert jcli.main(args + ["--out_dir", str(tmp_path / "jax")]) == 0
    jax_out = capsys.readouterr().out
    assert tcli.main(args + ["--out_dir", str(tmp_path / "port"),
                             "--device", CPU]) == 0
    port_out = capsys.readouterr().out
    assert port_out.replace("port", "jax") == jax_out
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 2 * 3
    for name in names:
        if name.endswith(".npy"):
            a = np.load(tmp_path / "jax" / name)
            b = np.load(tmp_path / "port" / name)
            assert (a == b).mean() >= 0.999
            assert not (b == 3).any()          # the hidden label is gone
            assert (b >= 0).mean() > 0.3
            continue
        with Image.open(tmp_path / "jax" / name) as a, \
                Image.open(tmp_path / "port" / name) as b:
            a, b = np.asarray(a).astype(int), np.asarray(b).astype(int)
        assert a.shape == b.shape
        assert (np.abs(a - b) <= 1).all(-1).mean() >= 0.999
