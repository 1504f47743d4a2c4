"""Device milliseconds a training step launched inside the ``gsplat.adam``
span, on whichever thread opened it: Adam's update
(``models/trainer.py::ScaledAdam.update``)."""

from benchmark.metrics import _spans_train


def read(r):
    return _spans_train.device_ms(r, "adam")
