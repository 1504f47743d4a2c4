"""Device milliseconds a training step launched inside the ``gsplat.fold``
span, on whichever thread opened it: the gradient fold
(``render/api.py::fold_instance_rows``: the rows' move to enumeration order
and ``csrc/fold_rows.cu``), on autograd's thread."""

from benchmark.metrics import _spans_train


def read(r):
    return _spans_train.device_ms(r, "fold")
