"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on
the program's plain CPU path, once for each fault the cell can have. (No
cell runs across chips, so none can leave out an exchange.)"""

import contextlib
import time

import pytest

from benchmark import harness
from conftest import tiny_cell


@contextlib.contextmanager
def patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _frame_altered():
    from gsplat_tpu_torch.interact.viewer import ViewerServer

    def make(old):
        def frame(self, *a, **kw):
            img = old(self, *a, **kw).copy()
            img[:4] = 255 - img[:4]
            return img
        return frame
    return patched(ViewerServer, "frame_pixels", make)


def _half_scene_view():
    from gsplat_tpu_torch.interact import viewer

    def make(old):
        def edits(scene, *a, **kw):
            out = old(scene, *a, **kw)
            op = out.opacities.clone()
            op[1::2] = -30.0
            return out.__class__(out.means, out.log_scales, out.quats, op,
                                 out.sh, out.labels)
        return edits
    return patched(viewer, "apply_edits", make)


def _half_views_label():
    from gsplat_tpu_torch.label import vote

    def make(old):
        def half(means, cams, seg_maps, num_classes, vis=None):
            v = seg_maps.shape[0] // 2
            return old(means, {k: c[:v] for k, c in cams.items()},
                       seg_maps[:v], num_classes,
                       None if vis is None else vis[:v])
        return half
    return patched(vote, "_vote_histogram", make)


def _labels_altered():
    from gsplat_tpu_torch.label import vote

    def make(old):
        def altered(*a, **kw):
            lab = old(*a, **kw).clone()
            lab[::7] += 1
            return lab
        return altered
    return patched(vote, "assign_labels_visible", make)


def _visibility_altered():
    from gsplat_tpu_torch.label import vote

    def make(old):
        def flipped(*a, **kw):
            vis = old(*a, **kw).clone()
            vis[:, ::5] = ~vis[:, ::5]
            return vis
        return flipped
    return patched(vote, "visibility_masks", make)


FAULTS = [
    ("m360-overview", _frame_altered), ("m360-overview", _half_scene_view),
    ("tnt-label", _half_views_label), ("tnt-label", _labels_altered),
    ("tnt-label", _visibility_altered),
]


@pytest.mark.parametrize(
    "name,fault", FAULTS,
    ids=[f"{n}-{f.__name__.strip('_')}" for n, f in FAULTS])
def test_fault_is_not_correct(name, fault, cpu):
    cell = tiny_cell(name)
    with fault():
        out = harness.run(cell, 11, 0.3, False, cpu, time.time())
    assert out["correct"] is False, out["checks"]
