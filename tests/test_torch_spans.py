"""The port's stage spans (``utils/profiling.py::span``): never entered
without a profiler; under one, the render's stages (project, bin, pack,
blend) in order, the labeling job's (the visibility renders, the seg maps'
upload, the vote) and the viewer frame's (edits, the render, assembly)
inside their parents, with results equal to an unprofiled call's. On the
card, every kernel of a traced job and frame, those launched through
``ctypes`` from ``csrc/`` included, has a launch with its correlation id
inside a stage.

This file imports neither jax nor ``gsplat_tpu``; on the card:

    python -m pytest tests/test_torch_spans.py -m gpu --noconftest
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsplat_tpu_torch.interact.edit import EditState
from gsplat_tpu_torch.interact.viewer import ViewerServer
from gsplat_tpu_torch.io.cameras import look_at_camera, orbit_cameras
from gsplat_tpu_torch.io.synthetic import random_scene
from gsplat_tpu_torch.label import vote
from gsplat_tpu_torch.render.api import render
from gsplat_tpu_torch.utils import profiling

W, H = 48, 32
RENDER = ["gsplat.project", "gsplat.bin", "gsplat.pack", "gsplat.blend"]
PARENTS = ("gsplat.frame", "gsplat.label", "gsplat.visibility")
CSRC = Path(__file__).resolve().parents[1] / "gsplat_tpu_torch" / "csrc"


def _scene(device="cpu"):
    return random_scene(300, seed=1, num_labels=4, device=device)


def _camera():
    return look_at_camera((0.0, 0.0, -3.0), (0.0, 0.0, 0.0), width=W,
                          height=H)


def _seg(views):
    rng = np.random.default_rng(0)
    return rng.integers(-1, 5, size=(views, H // 2, W // 2)).astype(np.int32)


def _label(scene, views, device="cpu"):
    return vote.assign_labels_visible(
        scene, orbit_cameras(views, 3.0, width=W, img_height=H),
        _seg(views), num_classes=5, device=device)


def _viewer(scene, device="cpu"):
    srv = ViewerServer(scene, width=W, height=H, center=np.zeros(3),
                       device=device)
    srv.edits = EditState(displacements={1: (0.1, 0.0, 0.0)},
                          hidden={2: True}, colors={3: (0.1, 0.8, 0.2)},
                          selected_label=0, selection_mode=True)
    return srv


def _frame(srv):
    return srv.frame_pixels(0.8, 0.3, 3.0, labels=True)


def _spans(prof):
    """(name, start, end) of the ``gsplat.*`` spans, in order of start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("gsplat.")),
                  key=lambda s: (s[1], -s[2]))


def _only(spans, name):
    got = [s for s in spans if s[0] == name]
    assert len(got) == 1, (name, got)
    return got[0]


def _inside(spans, outer):
    return [s for s in spans if outer[1] <= s[1] and s[2] <= outer[2]
            and s is not outer]


def _in_order(spans):
    for a, b in zip(spans, spans[1:]):
        assert a[2] <= b[1], (a, b)


def test_no_span_is_entered_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    scene = _scene()
    render(scene, _camera(), device="cpu")
    _frame(_viewer(scene))
    _label(scene, 3)
    # the patch is the one the spans go through
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="gsplat.project"):
            render(scene, _camera(), device="cpu")


def test_render_stages_in_order():
    scene = _scene()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render(scene, _camera(), device="cpu")
    spans = _spans(prof)
    assert [s[0] for s in spans] == RENDER
    _in_order(spans)


def test_label_job_spans_and_labels():
    scene = _scene()
    plain = _label(scene, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _label(scene, 3)
    assert torch.equal(plain, traced)
    spans = _spans(prof)
    job = _only(spans, "gsplat.label")
    assert len(_inside(spans, job)) == len(spans) - 1
    vis = _only(spans, "gsplat.visibility")
    assert job[1] <= vis[1] and vis[2] <= job[2]
    # each view's render stages, then the threshold's blend; the [V, N]
    # matrix's allocation and the background before the views, its rows
    # after them
    stages = _inside(spans, vis)
    assert [s[0] for s in stages] == (["gsplat.blend"] * 2 + (
        RENDER + ["gsplat.blend"]) * 3 + ["gsplat.blend"])
    _in_order(stages)
    after = [s for s in spans if s[1] >= vis[2]]
    assert [s[0] for s in after] == ["gsplat.upload", "gsplat.vote",
                                     "gsplat.vote"]
    _in_order(after)


def test_frame_spans_and_pixels():
    srv = _viewer(_scene())
    plain = _frame(srv)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _frame(srv)
    assert plain.dtype == np.uint8 and plain.tobytes() == traced.tobytes()
    spans = _spans(prof)
    frame = _only(spans, "gsplat.frame")
    stages = _inside(spans, frame)
    assert [s[0] for s in stages] == (["gsplat.edits"] + RENDER
                                      + ["gsplat.assemble"])
    assert len(stages) == len(spans) - 1
    _in_order(stages)


def _csrc_kernels():
    names = set()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\([^)]*\)\s+)?(\w+)\s*\(",
                                path.read_text()))
    return names


def _kernels_outside_stages(path):
    """Kernel events of the Chrome trace at ``path`` whose launch (the
    CUDA API event of the same correlation id) is missing or lies
    in no ``gsplat.*`` stage of the launching thread; and the names of all
    kernels."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    stages = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("gsplat.")
              and e["name"] not in PARENTS]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    bad = []
    for k in kernels:
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is None or not any(
                tid == launch["tid"] and s <= launch["ts"] <= t
                for tid, s, t in stages):
            bad.append(k["name"])
    return bad, [k["name"] for k in kernels]


@pytest.mark.gpu
def test_card_kernels_launch_inside_stages(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda", 0)
    scene = random_scene(20000, seed=2, num_labels=4, device=card)
    srv = _viewer(scene, card)
    _label(scene, 2, card)
    _frame(srv)
    torch.cuda.synchronize()
    own = _csrc_kernels()
    for name, run in (("label", lambda: _label(scene, 2, card)),
                      ("frame", lambda: _frame(srv))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        path = tmp_path / f"{name}.json"
        prof.export_chrome_trace(str(path))
        bad, names = _kernels_outside_stages(path)
        assert names and not bad, (name, sorted(set(bad)))
        # B4 and the blend (B5 in the job, B1 in the frame), launched
        # through ctypes, are among them
        assert sum(any(o in n for o in own) for n in names) >= 2, name
