"""Device milliseconds a training step launched inside the ``gsplat.loss``
span, on whichever thread opened it: the photometric loss
(``models/trainer.py::_grads``: ``models/losses.py::dssim_l1_loss``)."""

from benchmark.metrics import _spans_train


def read(r):
    return _spans_train.device_ms(r, "loss")
