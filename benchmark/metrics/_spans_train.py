"""Shared by the training step's stage readers: the traced window split
among the program's stages as :mod:`benchmark.metrics._spans` splits it,
with the spans of every thread.

A training step's backward runs on autograd's device thread while the
window's host thread waits inside ``gsplat.backward``; B2 and the fold open
their spans (``gsplat.blend_bwd``, ``gsplat.fold``) on that thread. Such
spans are read as the host thread's own: they lie inside the host's
``gsplat.backward``, so they nest there, and a device event launched from
autograd's thread goes to the innermost stage open at its launch (one of
theirs, else ``gsplat.backward``), as does the idle time under them. So

    sum over stages of (device + idle) + unstaged = the window.

Where the trace holds no device event, or no span of a stage, a reader
reads nothing.
"""

import json
from pathlib import Path
from typing import Dict, Optional

from benchmark import harness
from benchmark.metrics import _spans
from benchmark.tracing import WINDOW

_CACHE: Dict[tuple, _spans.Split] = {}


def split(events: list) -> _spans.Split:
    """The window of ``events`` (a Chrome trace's) split among the stages
    (module docstring)."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no bench_window annotation")
    host = win[0].get("tid")
    return _spans.split([
        dict(e, tid=host) if (e.get("ph") == "X"
                              and e.get("cat") == "user_annotation"
                              and e.get("name", "").startswith(_spans.PREFIX))
        else e for e in events])


def load(path: Path) -> _spans.Split:
    """:func:`split` of the Chrome trace at ``path``, read once a process
    for each version of the file."""
    key = (str(path), path.stat().st_mtime_ns)
    if key not in _CACHE:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        _CACHE.clear()
        _CACHE[key] = split(events)
    return _CACHE[key]


def _read(r) -> Optional[_spans.Split]:
    if not r.trace.kernels or not r.units or not harness.TRACE_OUT.is_file():
        return None
    sp = load(harness.TRACE_OUT)
    return sp if sp.n_device and sp.stages else None


def device_ms(r, stage: str) -> Optional[float]:
    """Device milliseconds a step launched in ``stage``."""
    sp = _read(r)
    if sp is None or stage not in sp.stages:
        return None
    return 1e-3 * sp.device_us.get(stage, 0.0) / r.units


def idle_ms(r, stage: str) -> Optional[float]:
    """Milliseconds a step in which the device idled in ``stage``."""
    sp = _read(r)
    if sp is None or stage not in sp.stages:
        return None
    return 1e-3 * sp.idle_us.get(stage, 0.0) / r.units
