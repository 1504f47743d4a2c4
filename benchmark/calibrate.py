"""Readings that set a cell's limits: for each seed, the numbers the check
compares for the program (after a short window at the cell's own load) and
for the control, the reference computed with TF32 products in the
program's place. One JSON line a seed; the benchmark's own runs never run
the control.

    python3 benchmark/calibrate.py --workload tnt-label --seeds 1 2 3 \\
        [--seconds 2] [--control-only]
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402


def readings(cell, seed: int, seconds: float, device, program: bool = True,
             control: bool = True) -> dict:
    """{"program": numbers, "control": numbers} of one seed."""
    from benchmark.common import Spec, free
    from benchmark.reference import render
    render.no_tf32()
    entry = importlib.import_module(
        f"benchmark.entries.{cell.traffic['entry']}")
    prog = entry.Cell(Spec(cell.workload["name"], cell.cfg, cell.traffic,
                           seed, device))
    out = {"seed": seed}
    if program:
        prog.warm(cell.traffic["warm_units"])
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            prog.unit()
        prog.finish()
    else:
        prog.warm(cell.traffic["warm_units"])
        prog.finish()
    prog.release()
    ref = prog.reference(render.F32)
    if program:
        out["program"] = prog.compare(prog.answers, ref)
    if control:
        out["control"] = prog.compare(prog.reference(render.TF32), ref)
    del prog, ref
    free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-only", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(harness.load_json(
        os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.time()
        r = readings(cell, seed, args.seconds, dev,
                     program=not args.control_only)
        r["s"] = time.time() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
