"""Milliseconds a unit of work (a view or a frame) in which the device idled
while the host was inside the ``gsplat.assemble`` span: the viewer's frame
assembly (``interact/viewer.py::assemble_frame``: the overlay and the copy
to the host)."""

from benchmark.metrics import _spans


def read(r):
    return _spans.idle_ms(r, "assemble")
