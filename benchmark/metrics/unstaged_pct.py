"""Share of the traced window, device and idle time, that no
``gsplat.<stage>`` span covers: what the stage metrics cannot place."""

from benchmark.metrics import _spans


def read(r):
    return _spans.unstaged_pct(r)
