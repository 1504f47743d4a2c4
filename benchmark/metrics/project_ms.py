"""Device milliseconds a unit of work (a view or a frame) launched inside the
``gsplat.project`` span: the projection and SH
(``render/api.py::_project_bin_pack``: ``render/projection.py``,
``render/sh.py``)."""

from benchmark.metrics import _spans


def read(r):
    return _spans.device_ms(r, "project")
