"""The PyTorch/CUDA port (``gsplat_tpu_torch``) against the JAX package and
the NumPy oracle, on the CPU.

Every test feeds the same numpy arrays, made from a seed, to the JAX function
and to its counterpart in the port. JAX runs as its own tests run it: on the
CPU, ``render`` and ``bin_windows`` choose Pallas interpret mode. On the CPU
the port's kernel wrappers take their plain PyTorch versions; the tests
marked ``gpu`` hold each CUDA kernel against its plain version and skip
without a card.
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import config as jconfig
from gsplat_tpu.io import cameras as jcameras
from gsplat_tpu.io import ply as jply
from gsplat_tpu.io import synthetic as jsynthetic
from gsplat_tpu.ref import rasterizer as ref
from gsplat_tpu.render import api as japi
from gsplat_tpu.render import projection as jprojection
from gsplat_tpu.render import sh as jsh
from gsplat_tpu.render import tiles as jtiles
from gsplat_tpu_torch import config as tconfig
from gsplat_tpu_torch.io import cameras as tcameras
from gsplat_tpu_torch.io import ply as tply
from gsplat_tpu_torch.io import synthetic as tsynthetic
from gsplat_tpu_torch.render import api as tapi
from gsplat_tpu_torch.render import blend as tblend
from gsplat_tpu_torch.render import projection as tprojection
from gsplat_tpu_torch.render import sh as tsh
from gsplat_tpu_torch.render import tiles as ttiles
from gsplat_tpu_torch.scene import FIELDS, scene_from_numpy

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _cfgs(tile_size, chunk, eps=None):
    """The same configuration in both packages."""
    out = []
    for mod in (jconfig, tconfig):
        raster = mod.RasterConfig(tile_size=tile_size)
        if eps is not None:
            raster = dataclasses.replace(raster, early_stop_eps=eps)
        out.append(mod.Config(raster=raster, tiles=mod.TileConfig(chunk=chunk)))
    return tuple(out)


# the default config, and test_render_pallas.py's tile_size=16, chunk=128
CONFIGS = {"default": (32, 64), "ts16_chunk128": (16, 128)}


def _arrays(jscene):
    s = jscene.to_numpy()
    return {f: np.asarray(getattr(s, f)) for f in FIELDS}


def _port_scene(jscene):
    return scene_from_numpy(**_arrays(jscene), device=CPU)


def _port_proj(jproj):
    return tprojection.Projected(*(torch.from_numpy(np.array(f))
                                   for f in jproj))


# --- 1. import guard -------------------------------------------------------

def _port_modules():
    pkg = REPO / "gsplat_tpu_torch"
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  .replace(".__init__", "") for p in pkg.rglob("*.py"))


def test_port_imports_without_jax():
    mods = _port_modules()
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['gsplat_tpu'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    pattern = re.compile(r"^\s*(import|from)\s+(jax|gsplat_tpu)\b", re.M)
    files = list((REPO / "gsplat_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_kernels.py"]
    for f in files:
        assert not pattern.search(f.read_text()), f


# --- 2. carry-across -------------------------------------------------------

def test_scene_carry_across_bit_exact():
    js = jsynthetic.random_scene(500, seed=5, num_labels=4, sh_degree=2)
    arrays = _arrays(js)
    back = scene_from_numpy(**arrays, device=CPU).to_numpy()
    for f in FIELDS:
        assert back[f].dtype == arrays[f].dtype, f
        assert back[f].tobytes() == arrays[f].tobytes(), f


@pytest.mark.parametrize("make", [
    lambda m, **kw: m.random_scene(300, seed=7, num_labels=5, sh_degree=3,
                                   **kw),
    lambda m, **kw: m.sphere_scene(300, seed=8, noise=0.01, **kw),
    lambda m, **kw: m.grid_scene(4, **kw),
], ids=["random", "sphere", "grid"])
def test_synthetic_scenes_equal_jax(make):
    want = _arrays(make(jsynthetic))
    got = make(tsynthetic, device=CPU).to_numpy()
    for f in FIELDS:
        assert got[f].tobytes() == want[f].tobytes(), f


def test_config_and_cameras_equal_jax():
    assert dataclasses.asdict(tconfig.DEFAULT) == dataclasses.asdict(
        jconfig.DEFAULT)
    for jc, tc in zip(jcameras.orbit_cameras(5, 3.0, height=0.4),
                      tcameras.orbit_cameras(5, 3.0, height=0.4)):
        assert jc.to_json() == tc.to_json()


def test_ply_carries_across_both_ways(tmp_path):
    js = jsynthetic.random_scene(200, seed=9, num_labels=3, sh_degree=1)
    jply.scene_to_ply(str(tmp_path / "jax.ply"), js)
    got = tply.scene_from_ply(str(tmp_path / "jax.ply"), device=CPU)
    tply.scene_to_ply(str(tmp_path / "port.ply"), got)
    back = jply.scene_from_ply(str(tmp_path / "port.ply"), use_native=False)
    want = _arrays(js)
    for f in FIELDS:
        assert got.to_numpy()[f].tobytes() == want[f].tobytes(), f
        assert np.asarray(getattr(back, f)).tobytes() == want[f].tobytes(), f


# --- 3. projection and SH --------------------------------------------------

@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_project_matches_jax(degree):
    js = jsynthetic.random_scene(400, seed=11 + degree, num_labels=3,
                                 sh_degree=degree)
    cam = jcameras.look_at_camera((0.3, -0.2, -3.0), (0, 0, 0), width=96,
                                  height=64)
    want = jprojection.project(js, jprojection.CameraParams.from_camera(cam),
                               cam.width, cam.height)
    got = tprojection.project(
        _port_scene(js), tprojection.CameraParams.from_camera(cam, CPU),
        cam.width, cam.height)
    assert len(got) == 15
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        if name == "valid":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(40 + degree)
    sh = rng.normal(size=(300, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(300, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = jsh.eval_sh(jnp.asarray(sh), jnp.asarray(dirs), degree)
    got = tsh.eval_sh(torch.from_numpy(sh), torch.from_numpy(dirs), degree)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# --- 4./5. binning (B4's plain version) and blend (B1's plain version) -----

@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_frame(request):
    """A JAX frame: projection, window binning and an exact-mode render."""
    ts, chunk = CONFIGS[request.param]
    jcfg, tcfg = _cfgs(ts, chunk, eps=0.0)
    js = jsynthetic.random_scene(2000, seed=31, extent=1.2,
                                 scale_range=(0.01, 0.05), num_labels=7)
    cam = jcameras.look_at_camera((0.1, 0.2, -3.0), (0, 0, 0), width=128,
                                  height=96)
    jproj = jprojection.project(js, jprojection.CameraParams.from_camera(cam),
                                cam.width, cam.height, jcfg.raster)
    tx, ty = jprojection.tile_grid(cam.width, cam.height, ts)
    slots = int(jtiles.count_instances(jproj, tiles_x=tx, tiles_y=ty,
                                       tile_size=ts))
    budget = jtiles.bucket_budget(slots, chunk)
    jbin = jtiles.bin_windows(jproj, tiles_x=tx, tiles_y=ty, tile_size=ts,
                              chunk=chunk, budget=budget)
    assert int(jbin.num_dropped) == 0
    # each tile's ordered gaussian list: its live window rows, in order
    inst = np.asarray(jbin.inst_gauss)
    lists = [[] for _ in range(tx * ty)]
    for t, s, o, n in zip(*(np.asarray(a) for a in (
            jbin.win_tile, jbin.win_start, jbin.win_off, jbin.win_len))):
        lists[t].extend(inst[s + o:s + o + n].tolist())
    jout = japi.render(js, cam, jcfg, with_labels=True)
    return dict(js=js, cam=cam, jcfg=jcfg, tcfg=tcfg, jproj=jproj, tx=tx,
                ty=ty, ts=ts, budget=budget, jbin=jbin, lists=lists,
                jout={k: np.asarray(v) for k, v in jout.items()})


def test_bin_tiles_matches_jax_windows(jax_frame):
    f = jax_frame
    proj = _port_proj(f["jproj"])
    b = ttiles.bin_tiles(proj, tiles_x=f["tx"], tiles_y=f["ty"],
                         tile_size=f["ts"])
    bounds = b.tile_bounds.numpy()
    inst = b.inst_gauss.numpy()
    for t, want in enumerate(f["lists"]):
        assert inst[bounds[t]:bounds[t + 1]].tolist() == want, t
    tight = int(jtiles.count_instances_tight(
        f["jproj"], tiles_x=f["tx"], tiles_y=f["ty"], tile_size=f["ts"],
        budget=f["budget"]))
    assert int(b.num_instances) == tight == int(f["jbin"].num_instances)
    assert ttiles.count_instances_tight(
        proj, tiles_x=f["tx"], tiles_y=f["ty"], tile_size=f["ts"]) == tight
    assert b.num_slots == ttiles.count_instances(
        proj, tiles_x=f["tx"], tiles_y=f["ty"], tile_size=f["ts"])
    # the sorted slot index points back at each instance's enumeration slot
    _, gauss = ttiles.enum_keys(
        proj, ttiles.depth_qkeys(proj.depth, proj.valid, f["tx"] * f["ty"]),
        ttiles.tile_bboxes(proj, tiles_x=f["tx"], tiles_y=f["ty"],
                           tile_size=f["ts"]),
        tiles_x=f["tx"], num_tiles=f["tx"] * f["ty"], tile_size=f["ts"],
        db=32 - ttiles.depth_shift(f["tx"] * f["ty"]))
    np.testing.assert_array_equal(gauss.numpy()[b.je_sorted.numpy()], inst)


def test_blend_plain_matches_jax_kernel(jax_frame):
    f = jax_frame
    rc = f["tcfg"].raster
    inst = np.concatenate([np.asarray(l, np.int32) for l in f["lists"]])
    bounds = np.concatenate([[0], np.cumsum([len(l) for l in f["lists"]])])
    ptab = tapi.pack_table(_port_proj(f["jproj"]),
                           torch.from_numpy(_arrays(f["js"])["labels"]))
    out = tblend.blend_tiles_fwd(
        ptab, torch.from_numpy(inst),
        torch.from_numpy(bounds.astype(np.int32)), tiles_x=f["tx"],
        tiles_y=f["ty"], tile_size=f["ts"], width=f["cam"].width,
        height=f["cam"].height, chunk=f["tcfg"].tiles.chunk,
        alpha_min=rc.alpha_min, alpha_max=rc.alpha_max,
        early_eps=rc.early_stop_eps, with_labels=True)
    jout = f["jout"]
    np.testing.assert_allclose(out.rgb.numpy(), jout["image"], atol=1e-5)
    np.testing.assert_allclose(out.transmittance.numpy(),
                               jout["transmittance"], atol=1e-5)
    np.testing.assert_allclose(out.best_weight.numpy(), jout["best_weight"],
                               atol=1e-5)
    np.testing.assert_array_equal(out.label.numpy(), jout["label_map"])
    assert (jout["alpha"] > 0.5).mean() > 0.2   # the frame is not empty


# --- 6. the whole slice ----------------------------------------------------

@pytest.mark.parametrize("n,width,height", [(300, 70, 45), (2000, 128, 96)])
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_render_matches_jax_and_oracle(cfg_name, n, width, height):
    jcfg, tcfg = _cfgs(*CONFIGS[cfg_name])
    js = jsynthetic.random_scene(n, seed=21, num_labels=6)
    cam = jcameras.look_at_camera((0.2, -0.3, -3.0), (0, 0, 0), width=width,
                                  height=height)
    bg = np.array([0.3, 0.6, 0.9], np.float32)
    got = tapi.render(_port_scene(js), cam, tcfg, background=bg,
                      with_labels=True, device=CPU)
    got = {k: v.numpy() for k, v in got.items()}
    want = japi.render(js, cam, jcfg, background=jnp.asarray(bg),
                       with_labels=True)
    assert got["image"].shape == (height, width, 3)
    assert int(got["num_dropped"]) == 0 == int(want["num_dropped"])
    # an exp ulp between XLA-CPU and torch-CPU can move one alpha across
    # 1/255, hence a max bar and a share of pixels at f32 agreement
    for key in ("image", "alpha", "transmittance", "best_weight"):
        err = np.abs(got[key] - np.asarray(want[key]))
        assert err.max() <= 5e-3, key
        assert (err <= 1e-5).mean() >= 0.999, key
    assert (got["label_map"] == np.asarray(want["label_map"])).mean() >= 0.999
    # the oracle bar of test_render_pallas.py::test_pallas_matches_oracle
    oracle = ref.render_np(js, cam, jcfg.raster, background=bg)
    err = np.abs(got["image"] - oracle["image"])
    assert np.median(err) < 1e-5
    assert err.max() < 5e-3
    assert (got["label_map"] != oracle["label_map"]).mean() < 0.01


# --- 7. no hidden fallback -------------------------------------------------

def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsynthetic.random_scene(10)
    scene = tsynthetic.random_scene(10, device=CPU)
    cam = tcameras.look_at_camera((0, 0, -3.0), (0, 0, 0), width=32,
                                  height=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.render(scene, cam)


@pytest.mark.parametrize("impl", ["dense"])
def test_later_slices_raise(impl):
    """The dense slice is in: ``impl='dense'`` renders a small scene and
    refuses past 2^30 pixel-gaussian pairs, as JAX does; an impl no slice
    brings raises."""
    scene = tsynthetic.random_scene(10, device=CPU)
    cam = tcameras.look_at_camera((0, 0, -3.0), (0, 0, 0), width=32,
                                  height=32)
    out = tapi.render(scene, cam, impl=impl, device=CPU)
    assert out["image"].shape == (32, 32, 3) and int(out["num_dropped"]) == 0
    with pytest.raises(ValueError, match="small-scene test oracle"):
        tapi.render(scene, cam.resized(1 << 15, 1 << 15), impl=impl,
                    device=CPU)
    with pytest.raises(ValueError, match="unknown impl"):
        tapi.render(scene, cam, impl="tpu", device=CPU)
