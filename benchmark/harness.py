"""One run of one cell: set-up, the measured (or traced) window, the
check, and the result line.

A cell (a workload of ``BENCHMARK.json``) names a configuration and a
traffic mix; the harness reads ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``entry`` names the module of
``entries/`` that drives the program) and ``limits/<workload>.json``, and
a per-layer metric's reader from ``metrics/<name>.py`` or, failing that,
``metrics/<name before the first dot>.py``. A new cell, mix or metric is
new files and entries, with no edit to these.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch

from benchmark import counts, tracing
from benchmark.common import Spec, free, sync
from benchmark.reference import render

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_OUT = ROOT / "build" / "bench_trace" / "trace.json"
BANNED = ("jax", "jaxlib", "flax", "gsplat_tpu")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell(NamedTuple):
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    cfg: dict
    traffic: dict
    limits: Dict[str, float]


def find_cell(bench: dict, name: str) -> Cell:
    """The cell of workload ``name``: its metrics those of ``bench``, its
    limits ``limits/<name>.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; "
                         f"known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(w, e2e, layer, load_json(ROOT / conf["file"]),
                load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                load_json(HERE / "limits" / f"{name}.json"))


def banned_modules(names=None) -> List[str]:
    """The banned top-level names among ``names`` (default: the modules
    loaded), each compared whole: ``gsplat_tpu_torch`` is not
    ``gsplat_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def reader(name: str):
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                f"benchmark_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    return None


class Reading(NamedTuple):
    """What a per-layer metric's reader sees of a traced window."""

    trace: tracing.Trace
    spec: Spec
    units: int          # steps, frames or views in the window
    frames: Dict[int, counts.Frame]   # the reference's count of the work
    #     of each frame it counted, by the frame's place among the window's
    #     frames (a label view is a frame; all of them, or a sample)
    n_frames: int       # frames in the window
    step_least: Optional[float]   # the window's least seconds, whole


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, setup_t0: float) -> dict:
    """One run; the result line as a dict (``correct`` from the check)."""
    render.no_tf32()
    spec = Spec(cell.workload["name"], cell.cfg, cell.traffic, seed, device)
    entry = importlib.import_module(
        f"benchmark.entries.{cell.traffic['entry']}")
    prog = entry.Cell(spec)
    prog.warm(cell.traffic["warm_units"])
    sync(device)
    log(f"set-up done at {time.time() - setup_t0:.3f} s after start")
    if trace:
        prog.before_trace()
        n_units = cell.traffic["trace_units"]
        tr = tracing.profile(lambda: [prog.unit() for _ in range(n_units)],
                             lambda: sync(device), TRACE_OUT)
        attempted = n_units
        work = n_units * prog.work()
    else:
        setup_s = time.time() - setup_t0
        times, work, attempted = [], 0, 0
        t0 = time.perf_counter()
        now = t0
        while now - t0 < seconds:
            prog.unit()
            t1 = time.perf_counter()
            times.append(t1 - now)
            now = t1
            work += prog.work()
            attempted += 1
        window_s = now - t0
        log("unit seconds: " + " ".join(f"{t:.4f}" for t in times[:24]))
    prog.finish()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = banned_modules()
    if found:
        raise SystemExit(f"modules loaded that the port must not use: "
                         f"{found}")
    failed = prog.failed
    log(f"window done: {attempted} units, peak {peak} bytes")
    prog.release()
    t_ref = time.perf_counter()
    answers = prog.answers
    ref = prog.reference(render.F32)
    numbers = prog.compare(answers, ref)
    del ref
    free()
    log(f"reference took {time.perf_counter() - t_ref:.3f} s")
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    correct = failed == 0 and all(v <= cell.limits[k]
                                  for k, v in numbers.items())
    metrics = {}
    if trace:
        t_c = time.perf_counter()
        c = prog.trace_counts()
        log(f"counts took {time.perf_counter() - t_c:.3f} s")
        reading = Reading(tr, spec, work, c["frames"], c["n_frames"],
                          c["step_least"])
        for m in cell.per_layer:
            fn = reader(m["name"])
            value = fn(reading) if fn else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(prog.e2e(window_s, times, work), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    out = dict(correct=bool(correct), attempted=attempted, failed=failed,
               metrics=metrics)
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=1, memory_peak_bytes=int(peak))
    if trace:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.device_ops,
                            "idle_gaps": tr.idle_gaps}
    out["device"] = dev
    out["checks"] = checks
    return out
