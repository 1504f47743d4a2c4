"""Milliseconds a training step in which the device idled while the
``gsplat.adam`` span was open: Adam's update
(``models/trainer.py::ScaledAdam.update``)."""

from benchmark.metrics import _spans_train


def read(r):
    return _spans_train.idle_ms(r, "adam")
