"""Device milliseconds a unit of work (a view or a frame) launched inside the
``gsplat.pack`` span: the blend kernels' parameter table
(``render/api.py::pack_table``)."""

from benchmark.metrics import _spans


def read(r):
    return _spans.device_ms(r, "pack")
