"""Shared by the stage readers: the traced window split among the
program's stages, the ``gsplat.<stage>`` spans of ``utils.profiling.span``.

The spans are events of the Chrome trace that ``tracing.profile`` wrote to
``harness.TRACE_OUT``, on the clock of its kernel, memcpy and memset
events. A device event belongs to the innermost stage open on the window's
host thread when it was launched: at the CUDA API event of the same
correlation id. The idle time, the window outside the union of the
device events, belongs to the stages open on the host thread during it,
split by overlap. What no stage covers (under a parent span, which only
groups stages, or outside every span) is unstaged, so that

    sum over stages of (device + idle) + unstaged = the window.

Where the trace holds no device event, or no span of a stage (a program
without spans), a reader reads nothing.
"""

import bisect
import json
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

from benchmark import harness
from benchmark.tracing import DEVICE_CATS, WINDOW

PREFIX = "gsplat."
PARENTS = ("gsplat.frame", "gsplat.label", "gsplat.visibility")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Split(NamedTuple):
    window_us: float
    stages: frozenset             # the stages seen, named without PREFIX
    device_us: Dict[str, float]   # by stage
    idle_us: Dict[str, float]
    unstaged_us: float
    n_device: int                 # device events in the window


_CACHE: Dict[tuple, Split] = {}


def _pieces(spans: List[Tuple[float, float, str]]
            ) -> List[Tuple[float, float, str]]:
    """Nested (start, end, name) spans of one thread as disjoint pieces,
    each named by the innermost span over it, in order."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []      # (end, name), innermost last
    cur = float("-inf")

    def close_until(t):
        nonlocal cur
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cur:
                out.append((cur, end, name))
                cur = end

    for s, t, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_until(s)
        if stack and s > cur:
            out.append((cur, s, stack[-1][1]))
        cur = max(cur, s)
        stack.append((min(t, stack[-1][0]) if stack else t, name))
    close_until(float("inf"))
    return out


def split(events: list) -> Split:
    """The window of ``events`` (a Chrome trace's) split among the stages
    (module docstring)."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no bench_window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    host = win[0].get("tid")
    stages, launches, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            s = max(float(e["ts"]), w0)
            t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
            if t > s:
                device.append((s, t, e.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launches[c] = float(e["ts"])
        elif (cat == "user_annotation" and e.get("tid") == host
              and e.get("name", "").startswith(PREFIX)
              and e["name"] not in PARENTS):
            s = float(e["ts"])
            stages.append((s, s + float(e.get("dur", 0.0)),
                           e["name"][len(PREFIX):]))
    pieces = _pieces(stages)
    starts = [p[0] for p in pieces]

    def stage_at(t: Optional[float]) -> Optional[str]:
        if t is None:
            return None
        i = bisect.bisect_right(starts, t) - 1
        return pieces[i][2] if i >= 0 and t <= pieces[i][1] else None

    dev: Dict[str, float] = {}
    idle: Dict[str, float] = {}
    unstaged = 0.0
    gaps = []
    cur = w0
    # time where device events overlap goes to the one that began first
    for s, t, corr in sorted(device, key=lambda d: (d[0], d[1])):
        if s > cur:
            gaps.append((cur, s))
        a = max(s, cur)
        if t > a:
            stage = stage_at(launches.get(corr))
            if stage is None:
                unstaged += t - a
            else:
                dev[stage] = dev.get(stage, 0.0) + (t - a)
            cur = t
    if cur < w1:
        gaps.append((cur, w1))
    j = 0
    for s, t in gaps:
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < t:
            o = min(t, pieces[k][1]) - max(s, pieces[k][0])
            if o > 0:
                name = pieces[k][2]
                idle[name] = idle.get(name, 0.0) + o
                covered += o
            k += 1
        unstaged += (t - s) - covered
    return Split(w1 - w0, frozenset(p[2] for p in stages), dev, idle,
                 unstaged, len(device))


def load(path: Path) -> Split:
    """:func:`split` of the Chrome trace at ``path``, read once a process
    for each version of the file (its path and modification time)."""
    key = (str(path), path.stat().st_mtime_ns)
    if key not in _CACHE:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        _CACHE.clear()
        _CACHE[key] = split(events)
    return _CACHE[key]


def _read(r) -> Optional[Split]:
    if not r.trace.kernels or not r.units or not harness.TRACE_OUT.is_file():
        return None
    sp = load(harness.TRACE_OUT)
    return sp if sp.n_device and sp.stages else None


def device_ms(r, stage: str) -> Optional[float]:
    """Device milliseconds a unit of work in ``stage``."""
    sp = _read(r)
    if sp is None or stage not in sp.stages:
        return None
    return 1e-3 * sp.device_us.get(stage, 0.0) / r.units


def idle_ms(r, stage: str) -> Optional[float]:
    """Milliseconds a unit in which the device idled while the host was in
    ``stage``."""
    sp = _read(r)
    if sp is None or stage not in sp.stages:
        return None
    return 1e-3 * sp.idle_us.get(stage, 0.0) / r.units


def unstaged_pct(r) -> Optional[float]:
    """The share of the window, device and idle time, in no stage."""
    sp = _read(r)
    if sp is None or sp.window_us <= 0:
        return None
    return 100.0 * sp.unstaged_us / sp.window_us
