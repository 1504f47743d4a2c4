"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload tnt-label --seed 7 --seconds 20 \\
        --trace 0

From the root of a checkout. With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics from
one profiler trace; both check what the program produced against the
plain reference (``benchmark/reference``) and print each number compared
beside its limit, last on standard error and under ``checks`` in the
result, which is the last line of standard output. Exits non-zero, with no
result, without enough CUDA cards, or if JAX or the JAX package was loaded.
"""

import os
import sys
import time


def _process_start() -> float:
    """Epoch seconds at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T0 = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# every build and kernel cache inside the checkout, at fixed paths; no
# library may load JAX behind the program's back
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.find_cell(bench, args.workload)
    chips = cell.workload["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T0)
    banned = harness.banned_modules()
    if banned:
        print(f"modules loaded that the port must not use: {banned}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
