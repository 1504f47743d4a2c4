"""Device milliseconds a unit of work (a view or a frame) launched inside the
``gsplat.bin`` span: the binning (``render/tiles.py``: bboxes, the instance
count read on the host, B4, the sort, ``searchsorted``)."""

from benchmark.metrics import _spans


def read(r):
    return _spans.device_ms(r, "bin")
