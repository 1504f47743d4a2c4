"""Milliseconds a training step in which the device idled while the
``gsplat.fold`` span was open: the gradient fold
(``render/api.py::fold_instance_rows``: the rows' move to enumeration order
and ``csrc/fold_rows.cu``), on autograd's thread."""

from benchmark.metrics import _spans_train


def read(r):
    return _spans_train.idle_ms(r, "fold")
