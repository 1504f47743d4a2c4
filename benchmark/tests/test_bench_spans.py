"""The stage readers (``metrics/_spans.py``): a synthetic Chrome trace of
two stages under a parent, split into each stage's device and idle time by
the launches' correlation ids and by overlap; a trace of a program without
spans, and the CPU's traced runs, read nothing."""

import json
import os
import time

import pytest

from benchmark import harness, tracing
from benchmark.metrics import _spans
from conftest import tiny_cell

HOST = 11
STAGE_METRICS = ("project_ms", "project_idle_ms", "bin_ms", "bin_idle_ms",
                 "pack_ms", "pack_idle_ms", "blend_ms", "blend_idle_ms",
                 "vote_ms", "vote_idle_ms", "upload_ms", "upload_idle_ms",
                 "edits_ms", "edits_idle_ms", "assemble_ms",
                 "assemble_idle_ms", "unstaged_pct")


def _x(name, cat, ts, dur, tid=HOST, corr=None):
    e = dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=tid)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(spans=True):
    """A window of 1,000 us on the host thread: under the parent
    ``gsplat.label``, ``gsplat.project`` over [100, 400] and
    ``gsplat.blend`` over [400, 800]. Device events: a kernel launched
    under the parent alone [60, 90], one in project [200, 300], one in
    blend [450, 600] overlapped by another of blend's [550, 620], a memcpy
    of blend's [700, 750], and a kernel with no launch [850, 900]. A span
    of another thread does not count."""
    ev = [_x(tracing.WINDOW, "user_annotation", 0, 1000),
          _x("cudaLaunchKernel", "cuda_runtime", 50, 5, corr=1),
          _x("cudaLaunchKernel", "cuda_runtime", 150, 5, corr=2),
          _x("cudaLaunchKernel", "cuda_runtime", 420, 5, corr=3),
          _x("cudaLaunchKernel", "cuda_runtime", 430, 5, corr=4),
          _x("cudaMemcpyAsync", "cuda_runtime", 690, 5, corr=5),
          _x("k0", "kernel", 60, 30, tid=7, corr=1),
          _x("k1", "kernel", 200, 100, tid=7, corr=2),
          _x("k2", "kernel", 450, 150, tid=7, corr=3),
          _x("k3", "kernel", 550, 70, tid=8, corr=4),
          _x("Memcpy HtoD", "gpu_memcpy", 700, 50, tid=7, corr=5),
          _x("k4", "kernel", 850, 50, tid=7, corr=99),
          # the profiler's own annotation of the device's timeline
          _x("gsplat.project", "gpu_user_annotation", 200, 100, tid=7)]
    if spans:
        ev += [_x("gsplat.label", "user_annotation", 0, 1000),
               _x("gsplat.project", "user_annotation", 100, 300),
               _x("gsplat.blend", "user_annotation", 400, 400),
               _x("gsplat.bin", "user_annotation", 0, 1000, tid=HOST + 1)]
    return ev


def test_split_by_stage():
    sp = _spans.split(_trace())
    assert sp.window_us == 1000 and sp.n_device == 6
    assert sp.stages == {"project", "blend"}
    # k3 overlaps k2: its time past k2's end is blend's
    assert sp.device_us == {"project": 100, "blend": 170 + 50}
    # gaps [0,60] [90,200] [300,450] [620,700] [750,850] [900,1000]
    assert sp.idle_us == {"project": 100 + 100, "blend": 50 + 80 + 50}
    assert sp.unstaged_us == 30 + 50 + 60 + 10 + 50 + 100
    total = (sum(sp.device_us.values()) + sum(sp.idle_us.values())
             + sp.unstaged_us)
    assert total == pytest.approx(sp.window_us)


def test_nested_stages_take_the_innermost():
    pieces = _spans._pieces([(0, 10, "a"), (2, 5, "b"), (5, 7, "c"),
                             (12, 14, "d")])
    assert pieces == [(0, 2, "a"), (2, 5, "b"), (5, 7, "c"), (7, 10, "a"),
                      (12, 14, "d")]


class _Trace:
    kernels = [("k", 0.0, 1e-4)]


class _Reading:
    trace = _Trace()
    units = 2


def _write(path, events):
    path.write_text(json.dumps({"traceEvents": events}))


def test_readers_per_unit_and_one_load(tmp_path, monkeypatch):
    path = tmp_path / "trace.json"
    _write(path, _trace())
    monkeypatch.setattr(harness, "TRACE_OUT", path)
    calls = []
    split = _spans.split
    monkeypatch.setattr(_spans, "split",
                        lambda ev: calls.append(1) or split(ev))
    _spans._CACHE.clear()
    r = _Reading()
    got = {m: harness.reader(m + ".label")(r) for m in STAGE_METRICS}
    assert got["project_ms"] == pytest.approx(0.05)
    assert got["project_idle_ms"] == pytest.approx(0.1)
    assert got["blend_ms"] == pytest.approx(0.11)
    assert got["blend_idle_ms"] == pytest.approx(0.09)
    assert got["unstaged_pct"] == pytest.approx(30.0)
    # a stage with no span reads nothing
    assert {m for m, v in got.items() if v is None} == set(
        STAGE_METRICS) - {"project_ms", "project_idle_ms", "blend_ms",
                          "blend_idle_ms", "unstaged_pct"}
    assert len(calls) == 1
    # a new trace at the same path is read again
    _write(path, _trace())
    os.utime(path, ns=(time.time_ns(), time.time_ns() + 10 ** 9))
    harness.reader("blend_ms.frame")(r)
    assert len(calls) == 2


def test_program_without_spans_reads_nothing(tmp_path, monkeypatch):
    path = tmp_path / "trace.json"
    _write(path, _trace(spans=False))
    monkeypatch.setattr(harness, "TRACE_OUT", path)
    _spans._CACHE.clear()
    for m in STAGE_METRICS:
        assert harness.reader(m + ".frame")(_Reading()) is None


@pytest.mark.parametrize("name", ("m360-overview", "tnt-label"))
def test_cpu_traced_run_reads_no_stage(name, cpu):
    cell = tiny_cell(name)
    out = harness.run(cell, 2 ** 31 + 11, 0.5, True, cpu, time.time())
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "breakdown", "device", "checks"]
    assert out["correct"] is True
    stage = {m["name"] for m in cell.per_layer
             if m["name"].split(".")[0] in STAGE_METRICS}
    assert len(stage) == 13
    assert not stage & set(out["metrics"])
