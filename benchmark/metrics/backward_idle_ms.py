"""Milliseconds a training step in which the device idled while the
``gsplat.backward`` span was open: ``torch.autograd.grad`` of a step and the
gradients' sum (``models/trainer.py::_grads``): the loss's and the
projection's backward, and all else autograd's thread launches outside B2
and the fold."""

from benchmark.metrics import _spans_train


def read(r):
    return _spans_train.idle_ms(r, "backward")
