"""Milliseconds a training step in which the device idled while the
``gsplat.blend_bwd`` span was open: kernel B2 and its arguments
(``render/api.py::BlendSceneTiles.backward``), on autograd's thread."""

from benchmark.metrics import _spans_train


def read(r):
    return _spans_train.idle_ms(r, "blend_bwd")
