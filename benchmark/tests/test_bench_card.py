"""On the card: each standing cell runs at its own size, with a short
window, and its check comes out correct."""

import time

import pytest

from benchmark import harness
from conftest import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["m360-overview", "tnt-label"])
def test_cell_is_correct_on_the_card(name, card):
    cell = harness.find_cell(harness.load_json(f"{ROOT}/BENCHMARK.json"),
                             name)
    out = harness.run(cell, 2 ** 31 + 99, 2.0, False, card, time.time())
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
