"""The training cell (``m360-train``: ``entries/train.py``,
``reference/train.py``, ``metrics/_spans_train.py``) at a size the CPU
runs in seconds, where the program takes its plain versions: the traffic
repeats from its seed, the reference agrees with the program, the result
line carries the cell's metrics, and each fault the cell can have comes
out not correct. On the card, the fold as a difference of prefix sums
(the JAX package's, kernel B3 and the boundary gathers) comes out not
correct at full size (on the CPU ``torch.cumsum``'s in-order prefix hides
it), and every kernel autograd's thread launches in a traced train
step lies in a stage."""

import contextlib
import copy
import os
import time

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.common import Spec
from benchmark.entries import train
from benchmark.metrics import _spans_train
from conftest import ROOT

NAME = "m360-train"


def tiny(**traffic):
    cell = harness.find_cell(
        harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), NAME)
    cfg = copy.deepcopy(cell.cfg)
    cfg.update(gaussians=3000, width=64, height=48, views=6)
    tr = dict(cell.traffic, warm_units=1, trace_units=2, check_within=3,
              check_steps=2)
    tr.update(traffic)
    return cell._replace(cfg=cfg, traffic=tr)


def test_traffic_repeats_from_its_seed(cpu):
    cfg = tiny().cfg
    for seed in (3, 2 ** 31 + 11):
        orders = [train.view_order(cfg, seed, e) for e in range(3)]
        assert orders == [train.view_order(cfg, seed, e) for e in range(3)]
        assert all(sorted(o) == list(range(cfg["views"])) for o in orders)
        assert orders[0] != orders[1]   # reshuffled every epoch
        t = train.targets(cfg, seed, cpu)
        assert t.shape == (6, 48, 64, 3) and 0 <= t.min() and t.max() <= 1
        assert torch.equal(train.targets(cfg, seed, cpu), t)
        assert torch.equal(train.targets(cfg, seed, cpu, [4, 1]), t[[4, 1]])
    assert not torch.equal(train.targets(cfg, 3, cpu),
                           train.targets(cfg, 4, cpu))
    assert train.view_order(cfg, 3, 0) != train.view_order(cfg, 4, 0)


@pytest.mark.parametrize("seed", [20, 2 ** 31 + 3])
def test_reference_agrees_with_the_program(seed, cpu):
    """The CPU path against the reference, and the control against it. At
    64x48 a pixel whose image sits within a rounding of its target flips
    L1's gradient there, which moves a small gaussian's gradient by up to
    a few % of its field's norm (0.028 on one of 20 seeds), so grad_gap's
    bar here is 0.05; the others are those of the full size or tighter,
    and the control exceeds param_gap's by 60x or more."""
    r = calibrate.readings(tiny(), seed, 0.0, cpu)
    got, control = r["program"], r["control"]
    assert got["image_off"] <= 1e-4 and got["loss_off"] <= 1e-4, got
    assert got["grad_gap"] <= 0.05 and got["param_gap"] <= 1e-3, got
    assert got["zero_moved"] == 0.0, got
    assert control["param_gap"] > 0.03, control


def test_result_line(cpu):
    cell = tiny()
    out = harness.run(cell, 2 ** 31 + 7, 0.5, False, cpu, time.time())
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"frame_ms", "setup_s"}
    assert out["metrics"]["frame_ms"]["value"] > 0
    assert set(out["checks"]) == set(cell.limits)
    assert out["failed"] == 0 and out["attempted"] >= 1


@contextlib.contextmanager
def patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _no_ssim():
    from gsplat_tpu_torch.models import losses
    return patched(losses, "dssim_l1_loss", lambda old: (
        lambda img, tgt, lam=0.2: (1.0 - lam) * losses.l1_loss(img, tgt)))


def _no_bias_correction():
    from gsplat_tpu_torch.models import trainer

    def make(old):
        def update(self, grads, state, params):
            # at a count this large b^t is 0 in f32: no correction
            news, st = old(self, grads, state._replace(count=10 ** 9),
                           params)
            return news, st._replace(count=state.count + 1)
        return update
    return patched(trainer.ScaledAdam, "update", make)


def _prefix_difference_fold():
    from gsplat_tpu_torch.render import api, blend

    def make(old):
        def fold(drows, je_sorted, enum_start, enum_cnt):
            cs = blend.cumsum_rows(api.enumeration_rows(drows, je_sorted))
            return api.segment_sums(cs, enum_start, enum_cnt)
        return fold
    return patched(api, "fold_instance_rows", make)


@pytest.mark.parametrize("fault", [_no_ssim, _no_bias_correction])
def test_fault_is_not_correct(fault, cpu):
    with fault():
        out = harness.run(tiny(), 11, 0.3, False, cpu, time.time())
    assert out["correct"] is False, out["checks"]


@pytest.mark.gpu
def test_prefix_difference_fold_is_not_correct_at_full_size(card):
    cell = harness.find_cell(
        harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), NAME)
    with _prefix_difference_fold():
        out = harness.run(cell, 2 ** 31 + 5, 2.0, False, card, time.time())
    assert out["correct"] is False, out["checks"]
    zero = out["checks"]["zero_moved"]
    assert zero["value"] > zero["limit"], out["checks"]


@pytest.mark.gpu
def test_train_step_kernels_launch_inside_stages(card, tmp_path):
    """Every kernel that autograd's device thread launches in a traced
    train step on the card lies in a stage: one open on that thread (B2's
    and the fold's), or else the host thread's ``gsplat.backward``. The
    host thread's own kernels outside every span (the step's gradient
    accumulators and loss total) are what ``unstaged_pct.train`` counts."""
    import json
    from torch.profiler import ProfilerActivity, profile
    from gsplat_tpu_torch.io.cameras import look_at_camera
    from gsplat_tpu_torch.io.synthetic import random_scene
    from gsplat_tpu_torch.models import trainer
    from gsplat_tpu_torch.render.projection import CameraParams
    scene = random_scene(20000, seed=3, num_labels=4, sh_degree=3,
                         scale_range=(0.004, 0.02), device=card)
    cam = CameraParams.from_camera(look_at_camera(
        (0.0, 0.0, -3.0), (0.0, 0.0, 0.0), width=320, height=240), card)
    target = torch.rand(240, 320, 3, device=card)
    bg = torch.zeros(3, device=card)
    step = trainer.make_train_step((320, 240), lr=5e-3, loss="dssim_l1")
    state = trainer.init_state(scene, lr=5e-3)
    state = step(state, scene.labels, cam, target, bg)[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, scene.labels, cam, target, bg)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"], e["name"])
             for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("gsplat.")]
    host = next(t for t, _, _, n in spans if n == "gsplat.backward")
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}

    def stage(tid, ts):
        inner = [(s, n) for t, s, e, n in spans if t == tid and s <= ts <= e]
        return max(inner)[1] if inner else None

    where, others = {}, 0
    for k in (e for e in events if e.get("cat") == "kernel"):
        launch = launches.get(k.get("args", {}).get("correlation"))
        assert launch is not None, k["name"]
        name = (stage(launch["tid"], launch["ts"])
                or stage(host, launch["ts"]))
        if launch["tid"] != host:
            others += 1
            assert name is not None, k["name"]
        where.setdefault(name, set()).add(k["name"])
    assert others > 0                 # autograd's device thread launched
    assert any("blend_bwd_kernel" in n for n in where["gsplat.blend_bwd"])
    assert any("fold_rows_kernel" in n for n in where["gsplat.fold"])
    assert {"gsplat.loss", "gsplat.backward", "gsplat.adam"} <= set(where)


# --- the span helper on a synthetic trace of two threads -----------------

def _ev(name, cat, ts, dur, tid, **args):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, tid=tid,
                args=args)


def test_span_helper_splits_two_threads():
    """A step of 100 us: the host thread's loss (0-20) and backward
    (20-80) and adam (85-95); autograd's thread opens blend_bwd (30-50)
    and fold (55-70). Kernels launched on autograd's thread outside its
    spans go to the host's stage; idle time under autograd's spans to
    theirs."""
    H, A = 1, 2
    ua = "user_annotation"
    events = [_ev("bench_window", ua, 0, 100, H),
              _ev("gsplat.loss", ua, 0, 20, H),
              _ev("gsplat.backward", ua, 20, 60, H),
              _ev("gsplat.adam", ua, 85, 10, H),
              _ev("gsplat.blend_bwd", ua, 30, 20, A),
              _ev("gsplat.fold", ua, 55, 15, A)]
    launches = [(1, 2, H), (2, 25, A), (3, 31, A), (4, 56, A), (5, 86, H),
                (6, 96, H)]
    kernels = [(1, 5, 10), (2, 26, 3), (3, 35, 10), (4, 58, 4), (5, 88, 4),
               (6, 97, 2)]
    for c, ts, tid in launches:
        events.append(_ev("cudaLaunchKernel", "cuda_runtime", ts, 1, tid,
                          correlation=c))
    for c, ts, dur in kernels:
        events.append(_ev(f"k{c}", "kernel", ts, dur, 7, correlation=c))
    sp = _spans_train.split(events)
    assert sp.stages == {"loss", "backward", "blend_bwd", "fold", "adam"}
    assert sp.device_us == {"loss": 10, "backward": 3, "blend_bwd": 10,
                            "fold": 4, "adam": 4}
    # idle: loss 0-5, 15-20; backward 20-26, 29-30, 50-55, 70-80;
    # blend_bwd 30-35, 45-50; fold 55-58, 62-70; adam 85-88, 92-95;
    # unstaged 80-85, 95-97, 99-100 and kernel 6's 2 us
    assert sp.idle_us == {"loss": 10, "backward": 22, "blend_bwd": 10,
                          "fold": 11, "adam": 6}
    assert sp.unstaged_us == 5 + 2 + 1 + 2
    total = (sum(sp.device_us.values()) + sum(sp.idle_us.values())
             + sp.unstaged_us)
    assert total == sp.window_us == 100
