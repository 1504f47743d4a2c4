"""The port's two gates against the JAX package's, on the CPU.

``gsplat_tpu_torch/utils/train_quality.py`` against
``scripts/train_quality.py`` and ``gsplat_tpu_torch/utils/verify_parity.py``
against ``scripts/verify_tpu.py``, both scripts imported by path (as
``tests/test_torch_probes.py`` imports its scripts); JAX's Pallas kernels
run in interpret mode, the port's kernel wrappers take their plain
versions. The JAX script's camera ring and held-out split are local to its
``main``: the test runs that ``main`` with its renders, budget measures and
step builder replaced by stubs that record the cameras and stop it before
the fit.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.config import DEFAULT as JDEFAULT
from gsplat_tpu.io.synthetic import random_scene as jrandom_scene
from gsplat_tpu.models import densify as jdensify
from gsplat_tpu.models import losses as jlosses
from gsplat_tpu.models import trainer as jtrainer
from gsplat_tpu.ref.rasterizer import render_np
from gsplat_tpu.render import api as japi
from gsplat_tpu.render.projection import CameraParams as JCameraParams
from gsplat_tpu.render.tiles import bucket_budget
from gsplat_tpu_torch.config import DEFAULT
from gsplat_tpu_torch.models import losses, trainer
from gsplat_tpu_torch.models import densify
from gsplat_tpu_torch.render.api import measure_budgets_multi, render
from gsplat_tpu_torch.render.projection import CameraParams
from gsplat_tpu_torch.scene import FIELDS
from gsplat_tpu_torch.utils import train_quality as tq
from gsplat_tpu_torch.utils import verify_parity as vp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
# the gate at a tiny recipe: 8 views (4 held out), 48x36, a ground truth of
# 400 + 100 gaussians, 100 at init, 10 iterations with a densify at 5
# (densify stops at 0.6 * iters); the JAX steps are followed over 10
# iterations before a densify
TINY = dict(width=48, height=36, views=8, gt_sphere=400, gt_blobs=100,
            init=100, iters=10, densify_every=5)
FOLLOW = 10
LR = 7e-3


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jtq():
    return _script("train_quality")


@pytest.fixture(scope="module")
def jvt():
    return _script("verify_tpu")


class _Stop(Exception):
    pass


def _jax_ring(jtq, monkeypatch, tmp_path, views, width, height):
    """(every camera in ring order, the held-out indices) of the JAX
    script's ``main``: its GT renders are stubbed to record the cameras,
    its budget measure to return small budgets, and its step builder to
    stop it."""
    seen = []

    def fake_render(scene, cam, *args, **kwargs):
        seen.append(cam)
        return dict(image=np.zeros((cam.height, cam.width, 3), np.float32),
                    num_dropped=0)

    def stop(*args, **kwargs):
        raise _Stop

    monkeypatch.setattr(japi, "render", fake_render)
    monkeypatch.setattr(japi, "measure_budgets_multi",
                        lambda *a, **k: (256, 256, 8))
    monkeypatch.setattr(jtrainer, "make_adaptive_multiview_train_step", stop)
    monkeypatch.setattr("sys.argv", [
        "train_quality.py", "--views", str(views), "--width", str(width),
        "--height", str(height), "--workdir", str(tmp_path)])
    with pytest.raises(_Stop):
        jtq.main()
    train = {c["img_name"] for c in json.loads(
        (tmp_path / "cameras_train.json").read_text())}
    return seen, {i for i, c in enumerate(seen) if c.img_name not in train}


@pytest.fixture(scope="module")
def gt_pair():
    """The GT scene of the default recipe and two of its ring's views at the
    tiny recipe's size, rendered by both packages."""
    jtq = _script("train_quality")
    jgt = jtq.make_gt_scene(1500, 400)
    tgt = tq.make_gt_scene(1500, 400, device=CPU)
    cams = tq.orbit_ring(TINY["views"], TINY["width"], TINY["height"])[:2]
    b, kb, nw = japi.measure_budgets_multi(jgt, cams, JDEFAULT)
    jimgs, timgs, dropped = [], [], []
    for c in cams:
        jo = japi.render(jgt, c, JDEFAULT, budget=b, kernel_budget=kb,
                         num_windows=nw)
        to = render(tgt, c, DEFAULT, device=CPU)
        dropped += [int(jo["num_dropped"]), int(to["num_dropped"])]
        jimgs.append(np.asarray(jo["image"]))
        timgs.append(to["image"].numpy())
    return jgt, tgt, jimgs, timgs, dropped


# --- 1. the ground truth, the ring and the held-out views ------------------

def test_gt_scene_equals_jax(gt_pair):
    jgt, tgt = gt_pair[:2]
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tgt, f).numpy(),
                                      np.asarray(getattr(jgt, f)), err_msg=f)


@pytest.mark.parametrize("recipe", [(28, 192, 144), (8, 48, 36)],
                         ids=["default", "tiny"])
def test_ring_and_held_out_equal_jax(jtq, monkeypatch, tmp_path, recipe):
    views, width, height = recipe
    jcams, jhold = _jax_ring(jtq, monkeypatch, tmp_path, views, width,
                             height)
    cams = tq.orbit_ring(views, width, height)
    assert len(cams) == len(jcams) == views
    for c, j in zip(cams, jcams):
        assert c.to_json() == j.to_json()
    assert tq.held_out(views) == jhold and len(jhold) == 4


def test_gt_render_meets_the_image_bar(gt_pair):
    # PERF.md section 2: max <= 5e-3, >= 99.9% of pixels within 1e-5
    *_, jimgs, timgs, dropped = gt_pair
    assert dropped == [0, 0, 0, 0]
    for j, t in zip(jimgs, timgs):
        err = np.abs(t - j).max(axis=-1)
        assert err.max() <= 5e-3 and (err <= 1e-5).mean() >= 0.999
        assert (t.max(axis=-1) > 0.1).mean() > 0.2     # the object is seen


def test_psnr_and_ssim_equal_jax(gt_pair):
    *_, jimgs, timgs, _ = gt_pair
    a, b = np.clip(timgs[0], 0, 1), np.clip(timgs[1], 0, 1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert abs(float(losses.psnr(ta, tb)) - float(jlosses.psnr(ja, jb))) \
        <= 1e-5
    assert abs(float(losses.ssim(ta, tb)) - float(jlosses.ssim(ja, jb))) \
        <= 1e-5


# --- 2. the gate at a tiny recipe ------------------------------------------

# scripts/train_quality.py:293-317
JAX_KEYS = {"metric", "backend", "gt", "fit", "held_out", "mean_psnr_db",
            "mean_ssim", "num_dropped", "wall_s", "target", "reached"}
JAX_FIT_KEYS = {"init_gaussians", "final_gaussians", "iters", "loss", "step",
                "lr", "densify_every", "train_wall_s", "budget_repin_events",
                "final_budgets"}


def test_gate_main_writes_jax_artifact(tmp_path):
    out = tmp_path / "gate.json"
    argv = ["--device", CPU, "--out", str(out), "--workdir",
            str(tmp_path / "work")]
    for k, v in TINY.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    rc = tq.main(argv)
    art = json.loads(out.read_text())
    assert JAX_KEYS <= set(art) and JAX_FIT_KEYS <= set(art["fit"])
    assert rc == (0 if art["reached"] else 2) and art["backend"] == CPU
    assert art["num_dropped"] == 0 and art["fit"]["budget_repin_events"] == []
    assert art["gt"] == dict(num_gaussians=500, views=8, held_out=4,
                             width=48, height=36)
    assert [v["view"] for v in art["held_out"]] == [
        f"view{i:03d}" for i in sorted(tq.held_out(8))]
    # densify every 5 until 0.6 * 10: at 5 alone; the PLY holds the alive
    # set
    events = art["fit"]["densify_events"]
    assert [e["iter"] for e in events] == [5]
    assert events[0]["alive_after"] > events[0]["alive_before"]
    assert art["fit"]["ply_reloaded"]
    pngs = sorted(p.name for p in (tmp_path / "work" / "images").iterdir())
    assert pngs == [f"view{i:03d}.png" for i in range(8)]


def _jax_budgets(scene, cams):
    """scripts/train_quality.py's measure() (1.35x headroom, bucketed) of
    the counts, which the port's measure counts as the JAX package's does
    (tests/test_torch_render.py) and in less time here."""
    bu, kbu, nwu = measure_budgets_multi(scene, cams, DEFAULT, device=CPU)
    return (bucket_budget(int(bu * 1.35), JDEFAULT.tiles.chunk),
            bucket_budget(int(kbu * 1.35), JDEFAULT.tiles.chunk),
            bucket_budget(int(nwu * 1.35), 8))


def test_fit_follows_jax_steps_and_densify():
    w, h, iters = TINY["width"], TINY["height"], TINY["iters"]
    cams = tq.orbit_ring(TINY["views"], w, h)
    hold = tq.held_out(TINY["views"])
    train = [c for i, c in enumerate(cams) if i not in hold]
    gt = tq.make_gt_scene(TINY["gt_sphere"], TINY["gt_blobs"], device=CPU)
    with torch.no_grad():
        targets = np.stack([torch.clamp(render(gt, c, DEFAULT, device=CPU)[
            "image"], 0, 1).numpy() for c in train])
    # the port's start and the JAX script's (scripts/train_quality.py:175-217)
    state, stats, labels = tq.initial_state(TINY["init"], 4.0, LR, iters,
                                            CPU)
    init = jrandom_scene(TINY["init"], seed=5, extent=1.1,
                         scale_range=(0.03, 0.08))
    capacity = labels.shape[0]
    jparams, jlabels = jdensify.pad_to_capacity(
        jtrainer.SceneParams.from_scene(init), jnp.asarray(init.labels),
        capacity)
    for f in trainer.SceneParams._fields:
        np.testing.assert_array_equal(getattr(state.params, f).numpy(),
                                      np.asarray(getattr(jparams, f)))
    sched = dict(lr=LR, lr_final=LR / 20.0, decay_steps=iters)
    jstate = jtrainer.init_state(jparams.to_scene(jlabels), **sched)
    bu, kbu, nwu = _jax_budgets(state.params.to_scene(labels), train)
    jstep = jtrainer.make_adaptive_multiview_train_step(
        (w, h), JDEFAULT, budget=bu, kernel_budget=kbu, num_windows=nwu,
        loss="l2", **sched)
    step = trainer.make_adaptive_multiview_train_step((w, h), DEFAULT,
                                                      loss="l2", **sched)
    jstats = jdensify.DensifyStats.zeros(capacity)
    jcams = jtrainer.stack_cameras([JCameraParams.from_camera(c)
                                    for c in train])
    tcams = trainer.stack_cameras([CameraParams.from_camera(c, CPU)
                                   for c in train])
    jl, tl = [], []
    for _ in range(FOLLOW):
        jstate, jstats, jloss, jnd = jstep(jstate, jstats, jlabels, jcams,
                                           jnp.asarray(targets),
                                           jnp.zeros(3, jnp.float32))
        state, stats, loss, nd = step(state, stats, labels, tcams,
                                      torch.from_numpy(targets),
                                      torch.zeros(3))
        assert int(jnd) == 0 == int(nd)
        jl.append(float(jloss))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    # the first densify, with the JAX script's key and its split noise
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    dcfg = dict(grad_threshold=2e-5)
    jout, _, _, jwritten = jdensify.densify_and_prune(
        jstate.params, jlabels, jstats, sub, 1.3,
        jdensify.DensifyConfig(**dcfg))
    noise = torch.from_numpy(np.array(jax.random.normal(sub, (capacity, 3))))
    out, _, _, written = densify.densify_and_prune(
        state.params, labels, stats, None, tq.SCENE_EXTENT,
        densify.DensifyConfig(**dcfg), noise=noise)
    alive = int(densify.num_alive(out))
    assert alive == int(jdensify.num_alive(jout))
    assert alive > int(densify.num_alive(state.params))


# --- 3. the parity gate ----------------------------------------------------

def test_parity_problem_equals_verify_tpu(jvt):
    jscene, jcam, jtarget = jvt.build_problem()
    scene, cam, target = vp.build_problem()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(scene, f).numpy(),
                                      np.asarray(getattr(jscene, f)))
    assert cam.to_json() == jcam.to_json()
    np.testing.assert_array_equal(target.numpy(), np.asarray(jtarget))
    assert (vp.N, vp.W, vp.H, vp.SEED) == (jvt.N, jvt.W, jvt.H, jvt.SEED)


@pytest.fixture(scope="module")
def parity_stages():
    scene, cam, target = vp.build_problem()
    return (scene, cam, vp.reference_stage(scene, cam, target),
            vp.kernel_stage(scene, cam, target, CPU))


def test_parity_reference_matches_the_oracle(jvt, parity_stages):
    jscene, jcam, _ = jvt.build_problem()
    oracle = render_np(jscene, jcam)
    ref = parity_stages[2]
    assert np.abs(ref["image"] - oracle["image"]).max() <= 1e-4


def test_parity_stages_pass_the_bars_on_the_cpu(parity_stages, tmp_path):
    ref, got = parity_stages[2:]
    report = vp.compare(got, ref)
    assert report["pass"], report
    assert report["label_map_vs_dense_cpu"]["agreement"] == 1.0
    assert set(report["grads_vs_dense_cpu"]) == set(
        trainer.SceneParams._fields)
    # PARITY_TPU.json's tolerances and its per-tensor keys
    want = json.loads((REPO / "PARITY_TPU.json").read_text())
    for k, v in want["tolerances"].items():
        assert report["tolerances"][k] == v
    assert set(report["pixels_vs_dense_cpu"]) == set(
        want["pixels_vs_dense_xla_cpu"])
