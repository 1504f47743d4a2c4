"""Device milliseconds a unit of work (a view or a frame) launched inside the
``gsplat.upload`` span: the upload of a job's seg maps and cameras to the
card (``label/vote.py``)."""

from benchmark.metrics import _spans


def read(r):
    return _spans.device_ms(r, "upload")
