"""Milliseconds a unit of work (a view or a frame) in which the device idled
while the host was inside the ``gsplat.pack`` span: the blend kernels'
parameter table (``render/api.py::pack_table``)."""

from benchmark.metrics import _spans


def read(r):
    return _spans.idle_ms(r, "pack")
