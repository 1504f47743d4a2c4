"""Device milliseconds a unit of work (a view or a frame) launched inside the
``gsplat.edits`` span: the viewer's edits
(``interact/edit.py::apply_edits``)."""

from benchmark.metrics import _spans


def read(r):
    return _spans.device_ms(r, "edits")
