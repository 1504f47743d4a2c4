"""One ``torch.profiler`` trace of a steady window, reduced to what the
per-layer metrics read.

Only the device's kernel, memcpy and memset events count as device work:
the profiler also draws PyTorch's operator annotations on the device's
timeline (``gpu_user_annotation``), which span an operator's kernels and
the gaps between them, so counting them would call idle time busy. The
window is the host span of the ``bench_window`` annotation; device events
are clipped to it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench_window"
TOP = 10


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]   # (name, start s, seconds)
    device_ops: List[list]    # [name, seconds], the TOP largest sums
    idle_gaps: List[list]     # [host op, seconds], the TOP largest sums


def _union(spans) -> Tuple[float, List[Tuple[float, float]]]:
    """Total length of the union of (start, end) spans, and its pieces."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def reduce(events: list) -> Trace:
    """The window's device busy time, its kernels, and the largest sums of
    device time by operation and of idle time by what the host ran."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no bench_window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    host_tid = win[0].get("tid")
    spans, kernels, by_op = [], [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t <= s:
            continue
        spans.append((s, t))
        name = e.get("name", "?")
        by_op[name] = by_op.get(name, 0.0) + (t - s) * 1e-6
        if e["cat"] == "kernel":
            kernels.append((name, s * 1e-6, (t - s) * 1e-6))
    busy, merged = _union(spans)
    gaps, cursor = [], w0
    for s, t in merged:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, t)
    if cursor < w1:
        gaps.append((cursor, w1))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e.get("name", "?")) for e in events
                   if e.get("ph") == "X" and e.get("tid") == host_tid
                   and e.get("cat") in ("cpu_op", "user_annotation",
                                        "python_function", "cuda_runtime",
                                        "cuda_driver")
                   and e.get("name") != WINDOW), key=lambda x: x[0])
    # sweep: the stack holds the host ops open at the current time, the
    # innermost on top (ops on one thread nest)
    by_gap: Dict[str, float] = {}
    stack: List[Tuple[float, float, str]] = []
    j = 0
    for s, t in gaps:
        mid = 0.5 * (s + t)
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        inner = stack[-1][2] if stack else "(host, outside any op)"
        by_gap[inner] = by_gap.get(inner, 0.0) + (t - s) * 1e-6
    top = lambda d: [[_short(k), v] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:TOP]]
    kernels.sort(key=lambda k: k[1])
    return Trace((w1 - w0) * 1e-6, busy * 1e-6, kernels, top(by_op),
                 top(by_gap))


def profile(fn: Callable[[], None], sync: Callable[[], None],
            out: Path) -> Trace:
    """Run ``fn`` once under the profiler and reduce its trace, which is
    written to ``out`` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile as prof_, \
        record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with prof_(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            sync()
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    return reduce(events)
