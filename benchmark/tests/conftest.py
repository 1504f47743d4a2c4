"""Shared by the benchmark's tests: the ``gpu`` marker and cells cut to a
size the CPU runs in seconds (the program then takes its plain versions).

Run from the repository's root: ``python -m pytest benchmark/tests -q``
(CPU), ``python -m pytest benchmark/tests -q -m gpu`` on the card.
"""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "m360-overview": dict(cfg=dict(gaussians=3000, width=64, height=48,
                                   views=6),
                          traffic=dict(warm_units=2, trace_units=8,
                                       check_within=6, check_frames=2)),
    "tnt-label": dict(cfg=dict(gaussians=3000, width=64, height=48,
                               views=4),
                      traffic=dict(warm_units=1, check_views=2)),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips inside the test without one")


def tiny_cell(name: str, **traffic):
    """The cell of ``BENCHMARK.json`` named ``name``, with its configuration
    and traffic cut to ``TINY``'s sizes and ``traffic``'s (its limits as
    they are)."""
    from benchmark import harness
    cell = harness.find_cell(
        harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), name)
    cfg = copy.deepcopy(cell.cfg)
    cfg.update(TINY[name]["cfg"])
    tr = copy.deepcopy(cell.traffic)
    tr.update(TINY[name]["traffic"], **traffic)
    if tr["entry"] == "view":
        tr["poses"]["count"] = 12
    return cell._replace(cfg=cfg, traffic=tr)


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
