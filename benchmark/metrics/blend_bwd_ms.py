"""Device milliseconds a training step launched inside the ``gsplat.blend_bwd``
span, on whichever thread opened it: kernel B2 and its arguments
(``render/api.py::BlendSceneTiles.backward``), on autograd's thread."""

from benchmark.metrics import _spans_train


def read(r):
    return _spans_train.device_ms(r, "blend_bwd")
