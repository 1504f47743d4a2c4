"""Milliseconds a training step in which the device idled while the
``gsplat.project_bwd`` span was open: the projection's backward kernel and
its arguments (``render/projection.py::_ProjectFunction.backward``), on
autograd's thread. A program without the span reads nothing."""

from benchmark.metrics import _spans_train


def read(r):
    return _spans_train.idle_ms(r, "project_bwd")
