"""Device milliseconds a unit of work of every kernel the program does not
build from ``gsplat_tpu_torch/csrc/``: PyTorch's own operators
(projection, SH, sort, losses, autograd, Adam, edits, the vote)."""

import re
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "gsplat_tpu_torch" / "csrc"


def _program_kernels():
    names = set()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\([^)]*\)\s+)?(\w+)\s*\(",
                                path.read_text()))
    return names


def read(r):
    if not r.trace.kernels or not r.units:
        return None
    own = _program_kernels()
    t = sum(k[2] for k in r.trace.kernels
            if not any(name in k[0] for name in own))
    return 1e3 * t / r.units
