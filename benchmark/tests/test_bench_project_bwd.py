"""The ``project_bwd`` stage of a training step (``metrics/project_bwd_ms.py``,
``metrics/project_bwd_idle_ms.py``): on a synthetic trace of two threads the
readers take the kernels and the idle time under autograd's
``gsplat.project_bwd`` span, and read nothing where no such span was opened
(a program without the projection's backward kernel). On the card, a traced
train step launches the projection's two kernels inside ``gsplat.project``
and ``gsplat.project_bwd``."""

import json
import types

import pytest

from benchmark import harness
from benchmark.metrics import _spans_train, project_bwd_idle_ms, project_bwd_ms


def _ev(name, cat, ts, dur, tid, **args):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, tid=tid,
                args=args)


def _trace(with_span: bool):
    """A step of 100 us: the host thread's backward (10-90); autograd's
    thread opens blend_bwd (20-40) and, with ``with_span``,
    project_bwd (50-70), launching one kernel in each (25-35, 55-60) and
    one outside both (80-85)."""
    H, A = 1, 2
    ua = "user_annotation"
    events = [_ev("bench_window", ua, 0, 100, H),
              _ev("gsplat.backward", ua, 10, 80, H),
              _ev("gsplat.blend_bwd", ua, 20, 20, A)]
    if with_span:
        events.append(_ev("gsplat.project_bwd", ua, 50, 20, A))
    for c, launch, ts, dur in ((1, 21, 25, 10), (2, 51, 55, 5),
                               (3, 79, 80, 5)):
        events.append(_ev("cudaLaunchKernel", "cuda_runtime", launch, 1, A,
                          correlation=c))
        events.append(_ev(f"k{c}", "kernel", ts, dur, 7, correlation=c))
    return events


def test_split_gives_project_bwd_its_kernels_and_idle():
    sp = _spans_train.split(_trace(True))
    assert sp.stages == {"backward", "blend_bwd", "project_bwd"}
    assert sp.device_us == {"blend_bwd": 10, "project_bwd": 5,
                            "backward": 5}
    # idle: blend_bwd 20-25, 35-40; project_bwd 50-55, 60-70; backward
    # 10-20, 40-50, 70-80, 85-90; unstaged 0-10, 90-100
    assert sp.idle_us == {"blend_bwd": 10, "project_bwd": 15,
                          "backward": 35}
    assert sp.unstaged_us == 20


@pytest.mark.parametrize("with_span", [True, False])
def test_readers_read_the_span_or_nothing(monkeypatch, tmp_path, with_span):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _trace(with_span)}))
    monkeypatch.setattr(harness, "TRACE_OUT", path)
    r = types.SimpleNamespace(trace=types.SimpleNamespace(kernels=3),
                              units=5)
    ms, idle = project_bwd_ms.read(r), project_bwd_idle_ms.read(r)
    if with_span:
        assert (ms, idle) == (pytest.approx(5e-3 / 5),
                              pytest.approx(15e-3 / 5))
    else:
        assert (ms, idle) == (None, None)


@pytest.mark.gpu
def test_train_step_launches_projection_kernels_in_their_stages(card,
                                                                tmp_path):
    import torch
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
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}

    def stage(launch):
        inner = [(s, n) for t, s, e, n in spans
                 if t == launch["tid"] and s <= launch["ts"] <= e]
        return max(inner)[1] if inner else None

    where = {}
    for k in (e for e in events if e.get("cat") == "kernel"):
        launch = launches[k["args"]["correlation"]]
        where.setdefault(k["name"], set()).add(stage(launch))
    fwd = [n for n in where if "project_kernel" in n]
    bwd = [n for n in where if "project_bwd_kernel" in n]
    assert fwd and bwd, sorted(where)
    assert all(where[n] == {"gsplat.project"} for n in fwd), where
    assert all(where[n] == {"gsplat.project_bwd"} for n in bwd), where
