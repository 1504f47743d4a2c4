"""Milliseconds a unit of work (a view or a frame) in which the device idled
while the host was inside the ``gsplat.edits`` span: the viewer's edits
(``interact/edit.py::apply_edits``)."""

from benchmark.metrics import _spans


def read(r):
    return _spans.idle_ms(r, "edits")
