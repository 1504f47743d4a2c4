"""Milliseconds a unit of work (a view or a frame) in which the device idled
while the host was inside the ``gsplat.project`` span: the projection and
SH (``render/api.py::_project_bin_pack``: ``render/projection.py``,
``render/sh.py``)."""

from benchmark.metrics import _spans


def read(r):
    return _spans.idle_ms(r, "project")
