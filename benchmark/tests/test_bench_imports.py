"""What the benchmark loads: nothing of JAX or the JAX package anywhere,
and nothing of the program in the reference. Each check runs in a fresh
interpreter, top-level module names compared whole."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_HARNESS = r"""
import glob, importlib, importlib.util, json, os, sys
root = sys.argv[1]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location(
    "bench_run", os.path.join(root, "benchmark", "run.py"))
importlib.util.module_from_spec(spec)
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from benchmark import harness, calibrate, counts, scenes, tracing, common
bench = os.path.join(root, "benchmark")
for path in sorted(glob.glob(os.path.join(bench, "entries", "*.py"))):
    importlib.import_module("benchmark.entries." + os.path.basename(path)[:-3])
for path in sorted(glob.glob(os.path.join(bench, "metrics", "*.py"))):
    name = os.path.basename(path)[:-3]
    if not name.startswith("_"):
        assert harness.reader(name) is not None
    else:
        importlib.import_module("benchmark.metrics." + name)
for path in glob.glob(os.path.join(root, "benchmark", "configs", "*.json")) + \
        glob.glob(os.path.join(root, "benchmark", "traffic", "*.json")):
    json.load(open(path))
# what the entries drive
import gsplat_tpu_torch.label.vote
import gsplat_tpu_torch.interact.viewer
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import benchmark.reference.render
import benchmark.reference.frame, benchmark.reference.vote
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, ROOT], check=True,
                         capture_output=True, text=True, env=env, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    names = _top_level(_HARNESS)
    assert "gsplat_tpu_torch" in names and "benchmark" in names
    assert not names & {"jax", "jaxlib", "flax", "gsplat_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = _top_level(_REFERENCE)
    assert "benchmark" in names and "torch" in names
    assert not names & {"gsplat_tpu_torch", "gsplat_tpu", "jax", "jaxlib",
                        "flax"}


def test_banned_names_compare_whole():
    from benchmark import harness
    assert harness.banned_modules(["gsplat_tpu_torch.render.api", "torch",
                                   "jax_like", "flaxen"]) == []
    assert harness.banned_modules(["gsplat_tpu.render", "jaxlib.xla",
                                   "jax", "flax.linen"]) == [
        "flax", "gsplat_tpu", "jax", "jaxlib"]
