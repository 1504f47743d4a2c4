"""The port's twins of ``bench.py`` and ``bench_vote.py``
(``gsplat_tpu_torch/utils/bench.py``, ``utils/bench_vote.py``) on the CPU.

Each twin's ``main`` at a tiny size; the bench step's loss and gradients
against ``jax.value_and_grad`` of ``bench.py``'s loss (``_render_impl`` with
``impl="pallas"`` in interpret mode and ``measure_budgets``' budget, as
``bench.py`` calls it); the vote problem against ``bench_vote.py``'s, bit
for bit, and its labels against JAX's in both modes; ``frame_report`` at a
frame that is not the default one.
"""

import contextlib
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.config import Config as JConfig
from gsplat_tpu.io.cameras import look_at_camera as jlook_at_camera
from gsplat_tpu.io.cameras import orbit_cameras as jorbit_cameras
from gsplat_tpu.io.synthetic import random_scene as jrandom_scene
from gsplat_tpu.label import vote as jvote
from gsplat_tpu.models.trainer import SceneParams as JSceneParams
from gsplat_tpu.render import api as japi
from gsplat_tpu.render.projection import CameraParams as JCameraParams
from gsplat_tpu_torch.label.vote import votes_to_labels
from gsplat_tpu_torch.utils import bench, bench_vote, roofline

torch.set_num_threads(2)

CPU = torch.device("cpu")
FIELDS = ("means", "log_scales", "quats", "opacities", "sh")
BENCH_TINY = ["--num-gaussians", "500", "--width", "48", "--height", "32",
              "--iters", "2", "--repeats", "3", "--device", "cpu"]
VOTE_TINY = ["--num-gaussians", "2000", "--num-views", "6", "--seg-size",
             "32", "--render-size", "64", "--num-classes", "21", "--device",
             "cpu"]
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "value_median",
              "value_spread")
VOTE_KEYS = ("metric", "value", "unit", "vs_baseline")


def _last_line(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


# --- (a) both twins' main at a tiny size -----------------------------------

@pytest.mark.parametrize("extra", [[], ["--forward-only"]],
                         ids=["fwd+bwd", "forward-only"])
def test_bench_main_on_cpu(extra):
    rec = _last_line(bench.main, BENCH_TINY + extra)
    for key in BENCH_KEYS + ("device", "ms_per_frame", "ms_spread",
                             "sol_mpix_per_s", "tight_instances", "pairs",
                             "num_dropped"):
        assert key in rec, key
    assert rec["unit"] == "Mpix/s"
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    assert rec["value"] == rec["value_median"]
    lo, hi = rec["value_spread"]
    assert lo <= rec["value"] <= hi
    ms_lo, ms_hi = rec["ms_spread"]
    assert ms_lo <= rec["ms_per_frame"] <= ms_hi
    assert rec["ms_per_frame"] == pytest.approx(48 * 32 / rec["value"] / 1e3)
    # no device rate on the CPU, hence no SOL
    assert rec["vs_baseline"] is None and rec["sol_mpix_per_s"] is None
    assert "null" in rec["metric"]
    assert ("fwd+bwd" in rec["metric"]) == (not extra)
    assert rec["device"] == "cpu" and rec["num_dropped"] == 0
    p = rec["pairs"]
    assert p["evaluated"] >= p["tested"] >= p["live"] > 0
    assert rec["tight_instances"] > 0


@pytest.mark.parametrize("mode", ["center", "visible"])
def test_bench_vote_main_on_cpu(mode):
    rec = _last_line(bench_vote.main, VOTE_TINY + ["--mode", mode,
                                                   "--cpu-baseline"])
    for key in VOTE_KEYS + ("device", "seconds", "labeled_fraction"):
        assert key in rec, key
    assert rec["unit"] == "G pair-votes/s" and rec["vs_baseline"] is None
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    assert rec["value"] == pytest.approx(2000 * 6 / rec["seconds"] / 1e9)
    assert mode in rec["metric"] and rec["device"] == "cpu"
    assert 0 < rec["labeled_fraction"] <= 1


# --- (b) the bench step against bench.py's loss in JAX ---------------------

def test_bench_step_matches_jax():
    args = bench.parse_args(BENCH_TINY)
    problem = bench.make_problem(args)
    got = bench.step(problem)

    w, h = args.width, args.height
    cfg = JConfig()
    cam = jlook_at_camera((0.0, 0.0, -3.0), (0.0, 0.0, 0.0), width=w,
                          height=h)
    scene = jrandom_scene(args.num_gaussians, seed=0, extent=1.5,
                          scale_range=(0.004, 0.02), num_labels=16)
    budget, kernel_budget, num_windows = japi.measure_budgets(scene, cam,
                                                              cfg)
    camp = JCameraParams.from_camera(cam)
    bg = jnp.zeros(3, jnp.float32)
    target = jnp.zeros((h, w, 3), jnp.float32)

    def loss_fn(params):
        out = japi._render_impl(
            params.to_scene(scene.labels), camp, bg, width=w, height=h,
            cfg=cfg, with_labels=False, impl="pallas", interpret=True,
            budget=budget, kernel_budget=kernel_budget,
            num_windows=num_windows)
        return 0.5 * jnp.sum((out["image"] - target) ** 2), out["num_dropped"]

    (loss, dropped), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        JSceneParams.from_scene(scene))
    assert int(dropped) == int(got["num_dropped"]) == 0
    # bars: the loss within 1e-5 relative; each gradient within 1e-3 of its
    # tensor's peak (PARITY_TPU.json)
    assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-5)
    for f in FIELDS:
        want = np.asarray(getattr(grads, f))
        mine = getattr(got["grads"], f).numpy()
        assert np.isfinite(mine).all(), f
        peak = np.abs(want).max()
        assert peak > 0, f
        assert np.abs(mine - want).max() <= 1e-3 * peak, f


# --- (c) the vote problem and labels against bench_vote.py's ---------------

@pytest.fixture(scope="module")
def vote_problems():
    """(port problem, JAX scene, cameras, seg maps) per mode, built as
    bench_vote.py:50-58 builds them."""
    out = {}
    for mode in ("center", "visible"):
        args = bench_vote.parse_args(VOTE_TINY + ["--mode", mode])
        rng = np.random.default_rng(0)
        scene = jrandom_scene(args.num_gaussians, seed=0, extent=1.0)
        size = args.render_size if mode == "visible" else args.seg_size
        cams = [c.resized(size, size)
                for c in jorbit_cameras(args.num_views, radius=3.0)]
        seg = rng.integers(-1, args.num_classes - 1, size=(
            args.num_views, args.seg_size, args.seg_size)).astype(np.int32)
        out[mode] = (bench_vote.make_problem(args), scene, cams, seg)
    return out


@pytest.mark.parametrize("mode", ["center", "visible"])
def test_vote_problem_is_bench_votes(vote_problems, mode):
    problem, scene, cams, seg = vote_problems[mode]
    for f in FIELDS + ("labels",):
        want = np.asarray(getattr(scene, f))
        got = getattr(problem.scene, f).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), f
    assert len(problem.cameras) == len(cams)
    for a, b in zip(problem.cameras, cams):
        assert (a.width, a.height, a.fx, a.fy) == (b.width, b.height, b.fx,
                                                   b.fy)
        assert np.array_equal(a.rotation, b.rotation)
        assert np.array_equal(a.position, b.position)
    assert problem.seg_maps.dtype == seg.dtype
    assert np.array_equal(problem.seg_maps, seg)
    assert problem.num_classes == 21


def test_vote_labels_equal_jax(vote_problems):
    problem, scene, cams, seg = vote_problems["center"]
    center = bench_vote.run(problem, "center")
    want = np.asarray(jvote.assign_labels(scene, cams, seg, num_classes=21))
    assert center.dtype == np.int32 and np.array_equal(center, want)
    assert (center != -1).any()
    # the numpy loop of --cpu-baseline, its votes taken as votes_to_labels
    # takes them
    votes = bench_vote.cpu_baseline(problem)
    assert np.array_equal(votes_to_labels(torch.from_numpy(votes)).numpy(),
                          center)

    problem, scene, cams, seg = vote_problems["visible"]
    visible = bench_vote.run(problem, "visible")
    want = np.asarray(jvote.assign_labels_visible(scene, cams, seg,
                                                  num_classes=21,
                                                  interpret=True))
    assert np.array_equal(visible, want)
    assert (visible != -1).any() and not np.array_equal(visible, center)


# --- (d) frame_report at another frame -------------------------------------

def test_frame_report_at_a_given_frame():
    peaks = roofline.measure_peaks(CPU)
    rep = roofline.frame_report(peaks, CPU, gaussians=500, width=48,
                                height=32)
    assert rep["frame"]["gaussians"] == 500
    assert (rep["frame"]["width"], rep["frame"]["height"]) == (48, 32)
    counted = roofline.frame_pairs(CPU, gaussians=500, width=48, height=32)
    assert rep["frame"] == counted["frame"]
    assert rep["frame"]["tight_instances"] > 0
    p = rep["pairs"]
    assert tuple(p.values()) == counted["pairs"]
    assert p["evaluated"] >= p["tested"] >= p["live"] > 0
    assert rep["sol_frame_ms"] == pytest.approx(rep["sol_fwd_ms"]
                                                + rep["sol_bwd_ms"])
    assert rep["sol_mpix_per_s"] == pytest.approx(
        48 * 32 / rep["sol_frame_ms"] / 1e3)
    # the bench twin's counts are the report's
    rec = _last_line(bench.main, BENCH_TINY + ["--forward-only"])
    assert rec["tight_instances"] == rep["frame"]["tight_instances"]
    assert rec["pairs"] == p


# --- (e) importable ----------------------------------------------------------

def test_twins_importable():
    assert callable(bench.main) and callable(bench_vote.main)
    assert callable(bench.make_problem) and callable(bench.step)
    assert callable(bench_vote.make_problem) and callable(bench_vote.run)
