"""Device milliseconds a training step launched inside the
``gsplat.project_bwd`` span, on whichever thread opened it: the projection's
backward kernel and its arguments
(``render/projection.py::_ProjectFunction.backward``), on autograd's
thread. A program without the span reads nothing."""

from benchmark.metrics import _spans_train


def read(r):
    return _spans_train.device_ms(r, "project_bwd")
