"""Milliseconds a unit of work (a view or a frame) in which the device idled
while the host was inside the ``gsplat.upload`` span: the upload of a job's
seg maps and cameras to the card (``label/vote.py``)."""

from benchmark.metrics import _spans


def read(r):
    return _spans.idle_ms(r, "upload")
