"""The result line: exactly the contract's keys, ``checks`` last, the
cell's metrics by name, and a run on the program's plain CPU path
judged correct (the harness's look for a card is skipped)."""

import time

import pytest

from benchmark import harness
from benchmark.common import Spec
from benchmark.entries import view
from conftest import tiny_cell

CELLS = ("m360-overview", "tnt-label")


@pytest.mark.parametrize("name", CELLS)
def test_measured_run(name, cpu):
    cell = tiny_cell(name)
    out = harness.run(cell, 2 ** 31 + 7, 0.5, False, cpu, time.time())
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert out["metrics"][m["name"]]["unit"] == m["unit"]
        assert out["metrics"][m["name"]]["value"] > 0
    assert set(out["checks"]) == set(cell.limits)
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}


def test_traced_run(cpu):
    cell = tiny_cell("m360-overview")
    out = harness.run(cell, 5, 0.5, True, cpu, time.time())
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "breakdown", "device", "checks"]
    assert out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in cell.per_layer}
    assert set(out["metrics"]) <= names
    # no device ran: only what the host's clock can give is read
    assert "b1_roofline.frame" not in out["metrics"]


def test_traced_frames_are_the_windows_own(cpu):
    # fewer traced frames than the positions the check may sample: those
    # served after the window are not counted among the traced frames
    cell = tiny_cell("m360-overview", trace_units=2, check_within=6,
                     check_frames=2)
    tr = cell.traffic
    for seed in range(8):
        prog = view.Cell(Spec(cell.workload["name"], cell.cfg, tr, seed, cpu))
        prog.warm(tr["warm_units"])
        prog.before_trace()
        for _ in range(tr["trace_units"]):
            prog.unit()
        prog.finish()
        c = prog.trace_counts()
        assert c["n_frames"] == 2 and sorted(c["frames"]) == [0, 1]
        if prog.i > tr["warm_units"] + 2:
            break
    else:
        raise AssertionError("no seed sampled a frame past the window")
