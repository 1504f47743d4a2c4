"""Milliseconds a unit of work (a view or a frame) in which the device idled
while the host was inside the ``gsplat.blend`` span: the blend (B1 and the
background composite; B5, ``gaussian_weights``, the visibility threshold
and the job's [V, N] rows)."""

from benchmark.metrics import _spans


def read(r):
    return _spans.idle_ms(r, "blend")
