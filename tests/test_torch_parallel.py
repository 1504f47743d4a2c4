"""The port's multi-device slice (``gsplat_tpu_torch/parallel/``) on the CPU.

The JAX package runs as ``tests/test_sharded.py`` runs it: a (2, 4) mesh
over ``conftest.py``'s 8 virtual CPU devices, Pallas in interpret mode. The
port runs the same numpy inputs over an 8-shard CPU mesh, its kernel
wrappers on their plain versions. Each test states its bar:

- the layout helpers, the lattice bboxes, counts and the exchange's overlap
  mask equal JAX's exactly;
- the sharded render is within PERF.md section 2's bar of JAX's
  ``render_sharded`` (max <= 5e-3, >= 99.9% of pixels <= 1e-5, label maps
  >= 99.9% equal) and bit-equal to the port's own ``render`` at D = 1, 2,
  4 and 8 (image, transmittance, label map, best weight);
- sharded train steps hold the loss bit-equal and the parameters within
  1e-5 of each tensor's peak against the port's single-device step, and
  meet ``test_sharded.py``'s bar against JAX's sharded step (loss rtol
  1e-4; means rtol 1e-3, atol 2e-5);
- the votes, visibility masks and k-means labels over a mesh equal the
  single-device ones exactly (visibility off a 1e-5 band at the threshold)
  and JAX's sharded ones;
- two gloo processes of two shards each run one sharded step whose loss is
  bit-equal on both ranks and to the in-process (2, 2) mesh's;
- the CLIs' mesh flags write what their unsharded runs write, in one
  process and in two gloo processes of two shards each.

``test_sharded.py::test_exchange_capacity_overflow_reports_dropped`` has no
mirror: the port sizes the exchange from exact counts, so nothing is ever
dropped and ``exchange_capacity`` is accepted and ignored.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.cluster import kmeans as jkm
from gsplat_tpu.config import Config as JConfig
from gsplat_tpu.io import cameras as jcameras
from gsplat_tpu.io import synthetic as jsynthetic
from gsplat_tpu.label import vote as jvote
from gsplat_tpu.models import trainer as jtrainer
from gsplat_tpu.parallel import mesh as jmesh_lib
from gsplat_tpu.parallel import render_sharded as jrs
from gsplat_tpu.render import projection as jprojection
from gsplat_tpu.render import tiles as jtiles
from gsplat_tpu.scene import GaussianScene as JScene
from gsplat_tpu_torch.cli import train as ttrain_cli
from gsplat_tpu_torch.cluster import kmeans as tkm
from gsplat_tpu_torch.config import DEFAULT
from gsplat_tpu_torch.io import ply as tply
from gsplat_tpu_torch.io import png as tpng
from gsplat_tpu_torch.io.cameras import look_at_camera, save_cameras
from gsplat_tpu_torch.io.synthetic import random_scene
from gsplat_tpu_torch.label import vote as tvote
from gsplat_tpu_torch.models import densify as tdz
from gsplat_tpu_torch.models import trainer as ttrainer
from gsplat_tpu_torch.parallel import mesh as tmesh
from gsplat_tpu_torch.parallel import render_sharded as trs
from gsplat_tpu_torch.render import tiles as ttiles
from gsplat_tpu_torch.render.api import render
from gsplat_tpu_torch.render.projection import CameraParams, Projected
from gsplat_tpu_torch.scene import FIELDS, scene_from_numpy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
JCFG = JConfig()
W = H = 64
PARAMS = ("means", "log_scales", "quats", "opacities", "sh")


def _port_scene(jscene):
    s = jscene.to_numpy()
    return scene_from_numpy(**{f: np.asarray(getattr(s, f)) for f in FIELDS},
                            device=CPU)


def _mesh(d: int) -> tmesh.Mesh:
    """The port's CPU mesh of d shards, (2, 4) at 8 as the JAX fixture."""
    return tmesh.make_mesh({1: (1, 1), 2: (1, 2), 4: (2, 2),
                            8: (2, 4)}[d], [CPU])


def _camp(cam):
    return CameraParams.from_camera(cam, CPU)


def _peak_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.fixture(scope="module")
def jscene():
    return jsynthetic.random_scene(256, seed=31, num_labels=4)


@pytest.fixture(scope="module")
def camera():
    return jcameras.look_at_camera((0.1, 0.2, -3.0), (0, 0, 0), width=W,
                                   height=H)


@pytest.fixture(scope="module")
def jmesh():
    assert jax.device_count() == 8, "conftest must force 8 cpu devices"
    return jmesh_lib.make_mesh((2, 4))


# --- 1. the lattice: layouts, bboxes, counts, the exchange's mask ----------

def test_layout_helpers_match_jax():
    rng = np.random.default_rng(0)
    for d in (1, 2, 3, 4, 6, 8):
        for w, h, ts in ((64, 64, 32), (800, 608, 32), (40, 24, 4),
                         (1600, 1216, 32), (100, 37, 16)):
            tx, ty = -(-w // ts), -(-h // ts)
            assert trs.factor_grid(d, tx, ty) == jrs.factor_grid(d, tx, ty)
            lay = trs.grid_layout(w, h, ts, d)
            assert lay == jrs.grid_layout(w, h, ts, d)
            assert trs.band_layout(w, h, ts, d) == jrs.band_layout(w, h, ts,
                                                                   d)
            if w > 100:
                continue
            dy, dx, tx_l, ty_l = lay
            for rest in ((), (3,)):
                x = rng.normal(size=(d * ty_l * ts, tx_l * ts) + rest
                               ).astype(np.float32)
                want = np.asarray(jrs.interleave_tiles(
                    jnp.asarray(x), dy, dx, tx_l, ty_l, ts, w, h))
                got = trs.interleave_tiles(torch.from_numpy(x), dy, dx, tx_l,
                                           ty_l, ts, w, h).numpy()
                np.testing.assert_array_equal(got, want)


def test_lattice_bboxes_counts_and_overlap_match_jax(jscene, camera):
    jproj = jprojection.project(jscene, jprojection.CameraParams.from_camera(
        camera), W, H, JCFG.raster)
    tproj = Projected(*(torch.from_numpy(np.asarray(getattr(jproj, f)))
                        for f in Projected._fields))
    ts = JCFG.raster.tile_size
    for d in (2, 4, 8):
        dy, dx, tx_l, ty_l = jrs.grid_layout(W, H, ts, d)
        for e in range(d):
            py, px = e // dx, e % dx
            lat = dict(row_stride=dy, row_phase=py, col_stride=dx,
                       col_phase=px)
            want = jtiles._tile_bbox(jproj.u, jproj.v, jproj.ex, jproj.ey,
                                     jproj.valid, float(ts), tx_l, ty_l,
                                     dy, py, dx, px)
            got = ttiles._tile_bbox(tproj.u, tproj.v, tproj.ex, tproj.ey,
                                    tproj.valid, float(ts), tx_l, ty_l,
                                    ttiles.Lattice(dy, py, dx, px))
            for g, w_ in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
            kw = dict(tiles_x=tx_l, tiles_y=ty_l, tile_size=ts)
            cnt = int(jtiles.count_instances(jproj, **kw, **lat))
            assert ttiles.count_instances(tproj, **kw, **lat) == cnt
            assert ttiles.count_instances_tight(tproj, **kw, **lat) == int(
                jtiles.count_instances_tight(jproj, **kw, budget=max(cnt, 8),
                                             **lat))
            np.testing.assert_array_equal(
                trs._overlap_mask(tproj, py, px, dy, dx, ty_l, tx_l,
                                  float(ts)).numpy(),
                np.asarray(jrs._overlap_mask(jproj, py, px, dy, dx, ty_l,
                                             tx_l, float(ts))))


# --- 2. the sharded render ---------------------------------------------------

def test_render_sharded_matches_jax(jscene, camera, jmesh):
    jsh = jmesh_lib.shard_scene(jscene, jmesh)
    want = jrs.render_sharded(
        jsh, jprojection.CameraParams.from_camera(camera), jmesh, width=W,
        height=H, cfg=JCFG, budget_per_device=4096, interpret=True,
        with_labels=True)
    mesh = _mesh(8)
    got = trs.render_sharded(tmesh.shard_scene(_port_scene(jscene), mesh),
                             _camp(camera), mesh, width=W, height=H,
                             cfg=DEFAULT, with_labels=True)
    for key in ("image", "transmittance"):
        err = np.abs(got[key].numpy() - np.asarray(want[key]))
        assert err.max() <= 5e-3, (key, err.max())
        assert (err <= 1e-5).mean() >= 0.999, key
    assert (got["label_map"].numpy()
            == np.asarray(want["label_map"])).mean() >= 0.999


@pytest.mark.parametrize("exchange", ["a2a", "all_gather"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_render_sharded_bit_equal_to_render(jscene, camera, d, exchange):
    scene = _port_scene(jscene)
    mesh = _mesh(d)
    sharded = tmesh.shard_scene(scene, mesh)
    for labels in (True, False):
        want = render(scene, camera, DEFAULT, with_labels=labels,
                      device=CPU)
        got = trs.render_sharded(sharded, _camp(camera), mesh, width=W,
                                 height=H, cfg=DEFAULT, with_labels=labels,
                                 exchange=exchange)
        if not labels:
            assert torch.equal(got, want["image"])
            continue
        for key in ("image", "transmittance", "alpha", "best_weight",
                    "label_map"):
            assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("d", [4, 8])
def test_render_sharded_padded_scene_bit_equal(camera, d):
    # 250 % 8 != 0: shard_scene pads with invisible gaussians
    scene = random_scene(250, seed=33, num_labels=4, device=CPU)
    mesh = _mesh(d)
    sharded = tmesh.shard_scene(scene, mesh)
    assert sharded.num_gaussians == 256 if d == 8 else 252
    img, nd = trs.render_sharded(sharded, _camp(camera), mesh, width=W,
                                 height=H, cfg=DEFAULT, with_dropped=True)
    assert int(nd) == 0
    assert torch.equal(img, render(scene, camera, DEFAULT,
                                   device=CPU)["image"])


def test_measure_budgets_sharded_counts_exactly(camera):
    scene = random_scene(250, seed=51, num_labels=4, device=CPU)
    ts = DEFAULT.raster.tile_size
    dy, dx, tx_l, ty_l = trs.grid_layout(W, H, ts, 8)
    cnt, tight, tiles, cap = trs.measure_budgets_sharded(
        scene, _camp(camera), width=W, height=H, cfg=DEFAULT,
        num_devices=8, device=CPU)
    assert tiles == tx_l * ty_l
    # the exchange count: the most rows a (source, destination) pair sends
    mesh = _mesh(8)
    sharded = tmesh.shard_scene(scene, mesh)
    pairs = []
    for sc in sharded:
        proj = trs.project(sc, _camp(camera), W, H, DEFAULT.raster)
        pairs += [int(trs._overlap_mask(proj, e // dx, e % dx, dy, dx, ty_l,
                                        tx_l, float(ts)).sum())
                  for e in range(8)]
    assert cap == max(pairs) > 0
    assert cnt >= tight > 0


# --- 3. train steps ----------------------------------------------------------

def _perturbed(jscene, seed, scale):
    rng = np.random.default_rng(seed)
    return dataclasses.replace(jscene, means=jscene.means + scale * rng.normal(
        size=jscene.means.shape).astype(np.float32))


@pytest.mark.parametrize("loss", ["l2", "dssim_l1"])
@pytest.mark.parametrize("d", [2, 8])
def test_sharded_train_step_matches_single_device(camera, d, loss):
    jscene = jsynthetic.random_scene(64, seed=35)
    scene = _port_scene(jscene)
    target = render(scene, camera, DEFAULT, device=CPU)["image"]
    pert = _port_scene(_perturbed(jscene, 0, 0.05))
    bg = torch.zeros(3)
    ref = ttrainer.make_train_step((W, H), DEFAULT, lr=2e-3, loss=loss)
    state, ref_loss, _ = ref(ttrainer.init_state(pert, lr=2e-3), pert.labels,
                             _camp(camera), target, bg)
    mesh = _mesh(d)
    sharded = tmesh.shard_scene(pert, mesh)
    step = ttrainer.make_train_step((W, H), DEFAULT, lr=2e-3, loss=loss,
                                    mesh=mesh)
    sstate, sloss, nd = step(ttrainer.init_state(sharded, lr=2e-3),
                             sharded.labels, _camp(camera), target, bg)
    assert int(nd) == 0 and sstate.step == 1
    assert float(sloss) == float(ref_loss)
    got = tmesh.gather_rows(sstate.params)
    for f, g, w_ in zip(PARAMS, got, state.params):
        assert _peak_err(g[:64], w_) <= 1e-5, f
    for moments in ("mu", "nu"):
        whole = tmesh.gather_rows(getattr(sstate.opt_state, moments))
        for f, g, w_ in zip(PARAMS, whole,
                            getattr(state.opt_state, moments)):
            assert _peak_err(g[:64], w_) <= 1e-5, (moments, f)


def _views(jscene, n):
    cams = [jcameras.look_at_camera((0.1 * i, 0.2, -3.0), (0, 0, 0),
                                    width=W, height=H) for i in range(n)]
    scene = _port_scene(jscene)
    targets = np.stack([render(scene, c, DEFAULT, device=CPU)["image"]
                        .numpy() for c in cams])
    return cams, targets


def test_sharded_steps_match_jax(jmesh):
    """The single-view and the multiview sharded steps against JAX's
    sharded steps on the (2, 4) mesh, and against the port's own
    single-device multiview step."""
    jscene = jsynthetic.random_scene(64, seed=41, num_labels=4)
    cams, targets = _views(jscene, 3)
    pert = _perturbed(jscene, 11, 0.04)
    jcams = jtrainer.stack_cameras(
        [jprojection.CameraParams.from_camera(c) for c in cams])
    tcams = ttrainer.stack_cameras([_camp(c) for c in cams])
    jsh = jmesh_lib.shard_scene(pert, jmesh)
    mesh = _mesh(8)
    tsh = tmesh.shard_scene(_port_scene(pert), mesh)
    bg = np.zeros(3, np.float32)
    for multiview in (False, True):
        build = "make_multiview_train_step" if multiview else \
            "make_train_step"
        jstep = getattr(jtrainer, build)(
            (W, H), JCFG, lr=2e-3, budget=2048, mesh=jmesh,
            budget_per_device=2048, interpret=True)
        tstep = getattr(ttrainer, build)((W, H), DEFAULT, lr=2e-3,
                                         mesh=mesh)
        jc = jcams if multiview else jprojection.CameraParams.from_camera(
            cams[0])
        tc = tcams if multiview else _camp(cams[0])
        tt = torch.from_numpy(targets if multiview else targets[0])
        jstate, jloss, jnd = jstep(jtrainer.init_state(jsh, lr=2e-3),
                                   jsh.labels, jc,
                                   jnp.asarray(tt.numpy()), jnp.asarray(bg))
        tstate, tloss, tnd = tstep(ttrainer.init_state(tsh, lr=2e-3),
                                   tsh.labels, tc, tt, torch.from_numpy(bg))
        assert int(jnd) == 0 == int(tnd)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(
            tmesh.gather_rows(tstate.params).means.numpy(),
            np.asarray(jstate.params.means), rtol=1e-3, atol=2e-5)
        if multiview:
            # the port's single-device multiview step: loss bit-equal
            ref = ttrainer.make_multiview_train_step((W, H), DEFAULT,
                                                     lr=2e-3)
            p = _port_scene(pert)
            rstate, rloss, _ = ref(ttrainer.init_state(p, lr=2e-3),
                                   p.labels, tcams, tt, torch.from_numpy(bg))
            assert float(tloss) == float(rloss)
            for f, g, w_ in zip(PARAMS, tmesh.gather_rows(tstate.params),
                                rstate.params):
                assert _peak_err(g, w_) <= 1e-5, f


def test_sharded_adaptive_densify_matches_single_device(camera):
    """The adaptive step under the mesh, a forced densify with the same
    noise, zero_adam_rows on the sharded written mask and one more step:
    the sharded state equals the single-device port's."""
    jscene = jsynthetic.random_scene(96, seed=3, extent=0.8,
                                     scale_range=(0.02, 0.04))
    base = _port_scene(jscene)
    params0, labels0 = tdz.pad_to_capacity(
        ttrainer.SceneParams.from_scene(base), base.labels, 256)
    scene = params0.to_scene(labels0)
    target = torch.zeros(H, W, 3)
    bg = torch.zeros(3)
    noise = torch.from_numpy(np.random.default_rng(5).normal(
        size=(256, 3)).astype(np.float32))
    mesh = _mesh(8)
    runs = {}
    for tag, m in (("one", None), ("mesh", mesh)):
        sc = scene if m is None else tmesh.shard_scene(scene, m)
        step = ttrainer.make_adaptive_train_step((W, H), DEFAULT, lr=5e-3,
                                                 loss="l2", mesh=m)
        state = ttrainer.init_state(sc, lr=5e-3)
        stats = tdz.DensifyStats.zeros(256, device=CPU)
        labels = sc.labels
        if m is not None:
            stats = tmesh.shard_rows(stats, m)
        for _ in range(2):
            state, stats, loss, _ = step(state, stats, labels, _camp(camera),
                                         target, bg)
        alive = int(tdz.num_alive(state.params))
        hot = tdz.DensifyStats(torch.ones(256), torch.ones(256))
        if m is not None:
            hot = tmesh.shard_rows(hot, m)
        params, labels, stats, written = tdz.densify_and_prune(
            state.params, labels, hot, None, 1.0,
            tdz.DensifyConfig(grad_threshold=1e-6), noise=noise)
        assert int(tdz.num_alive(params)) > alive
        state = ttrainer.TrainState(
            params, ttrainer.zero_adam_rows(state.opt_state, written),
            state.step)
        state, stats, loss, _ = step(state, stats, labels, _camp(camera),
                                     target, bg)
        if m is not None:
            state = state._replace(
                params=tmesh.gather_rows(state.params),
                opt_state=state.opt_state._replace(
                    mu=tmesh.gather_rows(state.opt_state.mu),
                    nu=tmesh.gather_rows(state.opt_state.nu)))
            labels, written = (tmesh.gather_rows(labels),
                               tmesh.gather_rows(written))
            stats = tmesh.gather_rows(stats)
        runs[tag] = (state, labels, written, stats, float(loss))
    one, sh = runs["one"], runs["mesh"]
    assert sh[4] == one[4]
    assert torch.equal(sh[1], one[1]) and torch.equal(sh[2], one[2])
    for f, g, w_ in zip(PARAMS, sh[0].params, one[0].params):
        assert _peak_err(g, w_) <= 1e-5, f
    for g, w_ in zip(sh[3], one[3]):
        assert _peak_err(g, w_) <= 1e-5


# --- 4. votes, visibility, k-means ------------------------------------------

def test_sharded_votes_visibility_and_kmeans_match(jmesh):
    # the wall-and-hidden scene of test_vote_visible.py padded to 68
    # gaussians, which the JAX vote needs divisible by its 4 chips
    from chip_smoke import wall_and_hidden_arrays

    means, log_scales, quats, opac, sh = wall_and_hidden_arrays()
    pad = 3
    jscene = JScene.create(
        means=np.concatenate([means, np.full((pad, 3), 50.0)]),
        log_scales=np.concatenate([log_scales, np.full((pad, 3), -3.0)]),
        quats=np.concatenate([quats, np.tile([[1.0, 0, 0, 0]], (pad, 1))]),
        opacities=np.concatenate([opac, np.full((pad,), -30.0)]),
        sh=np.concatenate([sh, np.zeros((pad, 1, 3))]),
        labels=np.zeros((68,), np.int32))
    scene = _port_scene(jscene)
    cams = [jcameras.look_at_camera((0.1 * i, 0.05 * i, -2.0), (0, 0, 0),
                                    width=64, height=64) for i in range(5)]
    seg = np.random.default_rng(2).integers(-1, 5, (5, 32, 32)).astype(
        np.int32)
    mesh = _mesh(8)
    for fn in ("assign_labels", "assign_labels_visible"):
        one = getattr(tvote, fn)(scene, cams, seg, num_classes=5,
                                 return_votes=True, device=CPU)
        got = getattr(tvote, fn)(scene, cams, seg, num_classes=5,
                                 return_votes=True, mesh=mesh, device=CPU)
        want = getattr(jvote, fn)(jscene, cams, seg, num_classes=5,
                                  mesh=jmesh)
        assert torch.equal(got[1], one[1]) and torch.equal(got[0], one[0])
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    vis = tvote.visibility_masks(scene, cams, mesh=mesh, device=CPU)
    assert torch.equal(vis, tvote.visibility_masks(scene, cams, device=CPU))
    # k-means: 1,000 points (divisible by 8: no padding point) and 1,001
    # (JAX's padding with the first point, counted in the sums, as JAX's)
    for n in (1000, 1001):
        feats = np.random.default_rng(n).normal(size=(n, 6)).astype(
            np.float32)
        one = tkm.kmeans(torch.from_numpy(feats), 5, max_iter=10)
        got = tkm.kmeans(torch.from_numpy(feats), 5, max_iter=10, mesh=mesh)
        want = jkm.kmeans(jnp.asarray(feats), k=5, max_iter=10, mesh=jmesh)
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels))
        assert got.iterations == int(want.iterations)
        if n % 8 == 0:
            assert torch.equal(got.labels, one.labels)


# --- 5. two processes over gloo ----------------------------------------------

_CHILD = r"""
import sys
import torch
torch.set_num_threads(1)
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from gsplat_tpu_torch.parallel.bootstrap import initialize_distributed
initialize_distributed("127.0.0.1:" + port, 2, rank, backend="gloo")
import torch.distributed as dist
from gsplat_tpu_torch.parallel import mesh as mesh_lib
from tests_parallel_case import run_case
mesh = mesh_lib.make_mesh(devices=["cpu", "cpu"])
assert mesh.dims == (2, 2) and list(mesh.local) == [2 * rank, 2 * rank + 1]
loss, params = run_case(mesh)
torch.save({"loss": loss, "params": params}, out)
dist.destroy_process_group()
"""

_CASE = r"""
import torch
from gsplat_tpu_torch.config import DEFAULT
from gsplat_tpu_torch.io.cameras import look_at_camera
from gsplat_tpu_torch.io.synthetic import random_scene
from gsplat_tpu_torch.models import trainer
from gsplat_tpu_torch.parallel import mesh as mesh_lib
from gsplat_tpu_torch.render.projection import CameraParams


def run_case(mesh):
    cam = look_at_camera((0, 0, -3.0), (0, 0, 0), width=64, height=64)
    scene = random_scene(510, seed=0, extent=1.0, scale_range=(0.02, 0.1),
                         device="cpu")
    sharded = mesh_lib.shard_scene(scene, mesh)
    step = trainer.make_train_step((64, 64), DEFAULT, lr=1e-3, mesh=mesh,
                                   loss="dssim_l1")
    state, loss, _ = step(trainer.init_state(sharded, lr=1e-3),
                          sharded.labels,
                          CameraParams.from_camera(cam, "cpu"),
                          torch.full((64, 64, 3), 0.25), torch.zeros(3))
    return float(loss), [list(p) for p in state.params]
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_train_step(tmp_path):
    (tmp_path / "tests_parallel_case.py").write_text(_CASE)
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{tmp_path}",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), str(port),
         str(tmp_path / f"rank{rank}.pt")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp_path))
        for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in (0, 1)]
    # the in-process (2, 2) mesh, four shards in this process
    sys.path.insert(0, str(tmp_path))
    try:
        from tests_parallel_case import run_case
    finally:
        sys.path.remove(str(tmp_path))
    loss, params = run_case(tmesh.make_mesh((2, 2), [CPU]))
    assert ranks[0]["loss"] == ranks[1]["loss"] == loss
    for r, got in enumerate(ranks):
        for k, shard in enumerate(got["params"]):
            for f, g, w_ in zip(PARAMS, shard, params[2 * r + k]):
                assert _peak_err(g, w_) <= 1e-6, (r, k, f)


# --- 6. the CLIs' mesh flags -------------------------------------------------

def _spawn_cli_ranks(tmp_path, base):
    """Two processes of the train CLI, ``--mesh 2x2`` over a gloo group:
    2 CPU shards each. Started here, waited for by the caller."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "gsplat_tpu_torch.cli.train"] + base
        + ["--out", str(tmp_path / "procs.ply"), "--checkpoint_dir",
           str(tmp_path / "ck_procs"), "--mesh", "2x2", "--coordinator",
           f"127.0.0.1:{port}", "--num_processes", "2", "--process_id",
           str(rank)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=str(tmp_path)) for rank in (0, 1)]


def test_train_cli_mesh_matches_unsharded(tmp_path, capsys):
    scene = random_scene(300, seed=12, extent=1.0, scale_range=(0.05, 0.15),
                         num_labels=3, device=CPU)
    cams = [dataclasses.replace(look_at_camera(
        (0.8 * np.sin(a), 0.2, -3.0 * np.cos(a)), (0, 0, 0), width=64,
        height=48), img_name=f"v{i}")
        for i, a in enumerate(np.linspace(-0.4, 0.4, 3))]
    for i, c in enumerate(cams):
        img = render(scene, c, DEFAULT, device=CPU)["image"].numpy()
        tpng.write_png(str(tmp_path / f"v{i}.png"),
                       (np.clip(img, 0, 1) * 255).astype(np.uint8))
    save_cameras(str(tmp_path / "cameras.json"), cams)
    init = dataclasses.replace(scene, means=scene.means + 0.02)
    tply.scene_to_ply(str(tmp_path / "init.ply"), init)
    base = ["--camera_file", str(tmp_path / "cameras.json"), "--image_dir",
            str(tmp_path), "--init_ply", str(tmp_path / "init.ply"),
            "--iters", "7", "--scale", "1.0", "--log_every", "2",
            "--densify_every", "3", "--densify_until", "7",
            "--capacity_factor", "1.1",
            "--checkpoint_every", "4", "--device", "cpu"]
    # the two-process run (--mesh 2x2 --num_processes 2) runs meanwhile
    procs = _spawn_cli_ranks(tmp_path, base)
    try:
        lines, plys = {}, {}
        for tag, extra in (("one", []), ("mesh", ["--mesh", "2x2"])):
            out = tmp_path / f"{tag}.ply"
            assert ttrain_cli.main(base + ["--out", str(out),
                                           "--checkpoint_dir",
                                           str(tmp_path / f"ck_{tag}")]
                                   + extra) == 0
            lines[tag] = capsys.readouterr().out.splitlines()
            plys[tag] = tply.read_ply(str(out))["vertex"]
        assert lines["mesh"][0] == ("mesh: {'host': 2, 'chip': 2} "
                                    "(1 processes)")
        assert lines["mesh"][1:-1] == lines["one"][:-1]
        assert any("densify ->" in line for line in lines["one"])
        # the gathered checkpoint at step 4 resumes sharded, bit for bit
        out = tmp_path / "resumed.ply"
        assert ttrain_cli.main(base + ["--out", str(out), "--checkpoint_dir",
                                       str(tmp_path / "ck_mesh"), "--mesh",
                                       "2x2"]) == 0
        assert "resumed at step 5" in capsys.readouterr().out
        np.testing.assert_array_equal(tply.read_ply(str(out))["vertex"],
                                      plys["mesh"])
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    # both ranks print the in-process mesh's lines; rank 0 writes the PLY
    ranks = [o.splitlines() for o, _ in outs]
    assert ranks[0][0] == "mesh: {'host': 2, 'chip': 2} (2 processes)"
    assert ranks[0][1:-1] == lines["mesh"][1:-1]
    assert ranks[0][-1] == f"wrote {tmp_path / 'procs.ply'}"
    assert ranks[1] == ranks[0][:-1]
    plys["procs"] = tply.read_ply(str(tmp_path / "procs.ply"))["vertex"]
    # PERF.md section 2's training CLI bar: Adam turns the fold's ulps into
    # whole steps on gaussians with few pixels, over the 7 steps
    want = plys["one"]
    for tag in ("mesh", "procs"):
        got = plys[tag]
        assert got.shape == want.shape, tag
        for f in want.dtype.names:
            w_ = want[f].astype(np.float64)
            err = np.abs(got[f] - w_) / (np.abs(w_).max() + 1e-30)
            assert (err <= 1e-4).mean() >= 0.99, (tag, f)


@pytest.mark.parametrize("per,rank,count,local,want", [
    (4, 0, 4, None, [0, 1, 2, 3]),    # --mesh 2x4 over 2 hosts: host 0
    (4, 1, 4, None, [0, 1, 2, 3]),    # host 1, the same local cards
    (2, 1, 4, None, [2, 3]),          # 2 processes of 2 on a 4-card host
    (2, 3, 4, 1, [2, 3]),             # torchrun's LOCAL_RANK decides
    (4, 0, 1, None, [0, 0, 0, 0]),    # 4 logical shards on one card
    (4, 0, 2, None, [0, 0, 1, 1]),
])
def test_process_cards(per, rank, count, local, want):
    """The cards ``mesh_from_args`` gives a process of a group on the card:
    its run of ``per`` local cards, shared in runs when it has fewer."""
    from gsplat_tpu_torch.parallel.bootstrap import process_cards
    got = process_cards(per, rank, count, local)
    assert got == [torch.device("cuda", i) for i in want]


@pytest.mark.parametrize("per,rank,count,local", [
    (3, 0, 2, None), (2, 0, 4, 2), (1, 0, 0, None)])
def test_process_cards_refuses(per, rank, count, local):
    from gsplat_tpu_torch.parallel.bootstrap import process_cards
    with pytest.raises((ValueError, RuntimeError)):
        process_cards(per, rank, count, local)
