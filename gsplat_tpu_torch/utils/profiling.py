"""Profiling and timing harness.

Counterpart of ``gsplat_tpu.utils.profiling``:

- ``device_timer``: steady-state seconds per call of a step. On the card it
  brackets the calls with CUDA events after a warm-up call; on the CPU it
  reads ``time.perf_counter``. PyTorch runs eagerly and a CUDA event waits
  for the device, so neither the JAX version's on-device loop nor its
  one-iteration baseline subtraction is needed.
- ``graph_ms``: the card's milliseconds per call of a short kernel's
  wrapper with the host's launch cost taken out, by replaying a CUDA graph
  of many calls.
- ``span``: a named range of the program (the ``gsplat.*`` stages of the
  render, the vote and the viewer) in a running profiler's trace, on the
  profiler's clock beside the card's kernels; nothing when no profiler
  runs.
- ``trace``: a ``torch.profiler`` trace of the CPU and, where there is a
  card, CUDA activity, written as a Chrome trace with the spans in it.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from pathlib import Path
from typing import Callable, Optional

import torch
from torch.profiler import record_function

TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_trace"
_OFF = contextlib.nullcontext()


def span(name: str):
    """A named range in the profiler's trace; nothing when no profiler runs.

    Entering ``record_function`` costs microseconds even with no profiler,
    so it is entered only while one records (the check costs a tenth of a
    microsecond). The span's parent is the span enclosing it on the same
    thread; the profiler keeps it and writes it with the trace."""
    return (record_function(name) if torch.autograd._profiler_enabled()
            else _OFF)


def fetch_sync(x) -> float:
    """Wait for ``x`` and fetch its first element as a float."""
    return float(torch.as_tensor(x).reshape(-1)[0])


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def device_timer(
    step_fn: Callable,
    args,
    *,
    iters: int = 20,
    perturb: Optional[Callable] = None,
) -> float:
    """Seconds per call of ``step_fn(*args, c)``, the mean of ``iters``
    calls after one warm-up call.

    ``c`` is the loop carry, the previous call's return value (``0.0`` for
    the first); ``perturb(args, c)`` may instead thread it into the inputs.
    The device is that of the first tensor in ``args``."""
    device = _device_of(args)

    def call(c):
        a = perturb(args, c) if perturb else args
        return step_fn(*a, c)

    c = call(0.0)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            c = call(c)
        end.record()
        end.synchronize()
        return max(start.elapsed_time(end) * 1e-3 / iters, 1e-9)
    fetch_sync(c)
    t0 = time.perf_counter()
    for _ in range(iters):
        c = call(c)
    fetch_sync(c)
    return max((time.perf_counter() - t0) / iters, 1e-9)


def graph_ms(fn: Callable, launches: int = 20, reps: int = 10) -> float:
    """Device milliseconds per call of ``fn`` (on the card): ``launches``
    calls captured in one CUDA graph, the graph replayed ``reps`` times
    between CUDA events, the median replay over ``launches``. Events around
    one call of a kernel shorter than its wrapper's host work (checks,
    allocations, the launch) time the host; the replay does not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


@contextlib.contextmanager
def trace(log_dir: str = str(TRACE_DIR)):
    """``torch.profiler`` over the block; yields ``log_dir`` and writes
    ``trace.json`` (open in Perfetto or chrome://tracing) into it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
