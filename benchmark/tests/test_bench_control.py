"""The control: the reference computed with TF32 products (the precision
below the configuration's) in the program's place must come out not
correct under the cell's limits. On the CPU at a tiny size where the
control's error already shows there (the viewer's frame); on the card at
each cell's own size."""

import pytest

from benchmark import calibrate, harness
from conftest import ROOT, tiny_cell


def _over(cell, control):
    return {k: v for k, v in control.items() if v > cell.limits[k]}


@pytest.mark.parametrize("name", ["m360-overview"])
def test_control_fails_a_limit(name, cpu):
    cell = tiny_cell(name)
    r = calibrate.readings(cell, 3, 0.0, cpu, program=False)
    assert _over(cell, r["control"]), (r["control"], cell.limits)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["m360-overview", "tnt-label"])
def test_control_fails_a_limit_at_full_size(name, card):
    bench = harness.load_json(f"{ROOT}/BENCHMARK.json")
    cell = harness.find_cell(bench, name)
    for seed in (91, 92, 93):
        r = calibrate.readings(cell, seed, 0.0, card, program=False)
        assert _over(cell, r["control"]), (seed, r["control"], cell.limits)
