"""Milliseconds a training step in which the device idled while the
``gsplat.loss`` span was open: the photometric loss
(``models/trainer.py::_grads``: ``models/losses.py::dssim_l1_loss``)."""

from benchmark.metrics import _spans_train


def read(r):
    return _spans_train.idle_ms(r, "loss")
