"""Milliseconds a unit of work (a view or a frame) in which the device idled
while the host was inside the ``gsplat.bin`` span: the binning
(``render/tiles.py``: bboxes, the instance count read on the host, B4, the
sort, ``searchsorted``)."""

from benchmark.metrics import _spans


def read(r):
    return _spans.idle_ms(r, "bin")
