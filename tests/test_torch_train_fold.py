"""The gradient fold (``render/api.py::fold_rows``, ``csrc/fold_rows.cu``)
and the port's train step against a plain reference.

The fold sums each gaussian's own gradient rows in one fixed order. The
JAX package's fold, a difference of two rows of one f32 prefix sum over
all rows (kernel B3 and ``segment_sums`` in the port), carries an ulp of
the running sum into every segment: at a real frame's size the sum
reaches 1e6 and a gaussian whose rows are all 0 came out at +-0.06. On the
CPU the fold is held to float64 segment sums, and the port's CPU train
step (render, loss, the five gradients, Adam) to the benchmark's plain
reference (``benchmark/reference/train.py``: plain PyTorch in f32, nothing
of either package). On the card the kernel is held to its plain version
bit for bit, and the old path is shown to move zero segments that the new
one leaves at 0.

This file imports neither jax nor ``gsplat_tpu``; on the card:

    python -m pytest tests/test_torch_train_fold.py -m gpu --noconftest
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import render as ref_render
from benchmark.reference import train as ref_train
from gsplat_tpu_torch.io.cameras import look_at_camera
from gsplat_tpu_torch.io.synthetic import random_scene
from gsplat_tpu_torch.models import trainer
from gsplat_tpu_torch.render import api, blend
from gsplat_tpu_torch.render.projection import CameraParams

torch.set_num_threads(2)

FIT = json.loads((Path(__file__).resolve().parents[1] / "benchmark"
                  / "configs" / "m360-fit.json").read_text())


def _segments(counts, rng, scale=1.0):
    """(rows [B, 16] f32, start, cnt) of ragged segments of ``counts``;
    a segment of count < 0 holds -count rows, all 0."""
    cnt = np.abs(np.asarray(counts, np.int64))
    start = np.cumsum(cnt) - cnt
    rows = (scale * rng.normal(size=(int(cnt.sum()), 16))).astype(
        np.float32)
    for s, c in zip(start, counts):
        if c < 0:
            rows[s:s - c] = 0.0
    i32 = lambda a: torch.from_numpy(a.astype(np.int32))
    return torch.from_numpy(rows), i32(start), i32(cnt)


def _segment_f64(rows, start, cnt):
    r = rows.double()
    return torch.stack([r[s:s + c].sum(0) if c else torch.zeros(16,
                        dtype=torch.float64)
                        for s, c in zip(start.tolist(), cnt.tolist())])


def _prefix_difference(rows, start, cnt):
    """The JAX package's fold: one prefix sum, two boundary rows."""
    return api._segment_sums_plain(blend._cumsum_rows_plain(rows), start,
                                   cnt)


# --- on the CPU ----------------------------------------------------------

def _after_a_large_sum(rng):
    """One long segment whose rows bring the running sum to ~1e6 in every
    column, then small segments with all-zero ones among them."""
    head = np.full((1, 16), 1.0e6 / 4096, np.float32) + rng.uniform(
        0, 1, size=(4096, 16)).astype(np.float32)
    tail, tail_cnt = [], []
    for k in range(300):
        c = int(rng.integers(1, 9))
        block = rng.normal(scale=0.01, size=(c, 16)).astype(np.float32)
        if k % 3 == 0:
            block[:] = 0.0
        tail.append(block)
        tail_cnt.append(c)
    rows = np.concatenate([head] + tail)
    cnt = np.array([4096] + tail_cnt, np.int64)
    start = np.cumsum(cnt) - cnt
    zero = np.array([False] + [k % 3 == 0 for k in range(300)])
    i32 = lambda a: torch.from_numpy(a.astype(np.int32))
    return torch.from_numpy(rows), i32(start), i32(cnt), zero


def test_fold_sums_each_segment_on_its_own():
    rows, start, cnt, zero = _after_a_large_sum(np.random.default_rng(3))
    want = _segment_f64(rows, start, cnt)
    assert float(want[0].abs().min()) > 1.0e6   # the running sum's size
    before = api.fold_rows.launches
    got = api.fold_rows(rows, start, cnt)
    assert api.fold_rows.launches == before      # no kernel on the CPU
    # each segment within 1e-6 of its own size (its f32 rounding), and the
    # all-zero segments exactly 0
    size = torch.clamp_min(_segment_f64(rows.abs(), start, cnt), 1e-30)
    assert float(((got.double() - want).abs() / size).max()) <= 1e-6
    assert not got[torch.from_numpy(zero)].any()
    # the prefix difference is off by about an ulp of the running sum
    # (2^-4 at 1e6) on the small segments after it
    old = _prefix_difference(rows, start, cnt)
    err = (old[1:].double() - want[1:]).abs().max()
    assert 0.01 <= float(err) <= 0.2, float(err)


CASES = {
    "ragged": [3, 1, 0, 7, 40, 2, 0, 0, 33, 64, 65, 1, 200],
    "empty_first_and_last": [0, 0, 5, 9, 0],
    "all_empty": [0, 0, 0],
    "zero_rows": [4, -6, 1, -40, 3, -1],
    "one_owns_every_row": [0, 5000, 0],
}


@pytest.mark.parametrize("case", list(CASES))
def test_fold_on_ragged_segments(case):
    rng = np.random.default_rng(len(CASES[case]))
    rows, start, cnt = _segments(CASES[case], rng)
    if rows.shape[0] == 0:
        rows = torch.zeros(1, 16)
    got = api.fold_rows(rows, start, cnt)
    want = _segment_f64(rows, start, cnt)
    size = torch.clamp_min(_segment_f64(rows.abs(), start, cnt), 1e-30)
    assert float(((got.double() - want).abs() / size).max()) <= 1e-6
    assert not got[cnt == 0].any()
    zero = torch.tensor([c < 0 for c in CASES[case]])
    assert not got[zero].any()
    # through the blend's fold: the same sums from sorted-stream rows
    perm = torch.randperm(rows.shape[0], generator=torch.Generator()
                          .manual_seed(1)).to(torch.int32)
    sorted_rows = torch.empty_like(rows)
    sorted_rows[torch.arange(rows.shape[0])] = rows[perm.long()]
    assert torch.equal(api.fold_instance_rows(sorted_rows, perm, start, cnt),
                       got)


def test_fold_wrapper_rejects_what_the_kernel_does_not_take():
    rows = torch.zeros(4, 16)
    start = torch.zeros(2, dtype=torch.int32)
    cnt = torch.tensor([4, 0], dtype=torch.int32)
    assert api.fold_rows(rows, start, cnt).shape == (2, 16)
    for args in ((rows.double(), start, cnt), (torch.zeros(4, 8), start, cnt),
                 (rows, start.long(), cnt), (rows, start, cnt[:1]),
                 (torch.zeros(16, 4).t(), start, cnt)):
        with pytest.raises(ValueError):
            api.fold_rows(*args)


# --- the port's CPU train step against the plain reference ----------------

W, H = 64, 48


def _step_inputs(seed):
    scene = random_scene(400, seed=seed, extent=0.8, scale_range=(0.02, 0.1),
                         num_labels=4, sh_degree=3, device="cpu")
    cam = look_at_camera((0.3, -0.4, -3.0), (0.0, 0.0, 0.0), width=W,
                         height=H, fov_x_deg=50.0)
    # targets above every rendered value, so that no pixel sits at L1's
    # kink, where a rounding of the image flips the gradient's sign
    target = torch.from_numpy(np.random.default_rng(seed).uniform(
        1.5, 2.5, size=(H, W, 3)).astype(np.float32))
    return scene, cam, target


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_train_step_matches_plain_reference(seed):
    fit, raster = FIT["fit"], FIT["raster"]
    scene, cam, target = _step_inputs(seed)
    bg = torch.tensor(fit["background"], dtype=torch.float32)
    state = trainer.init_state(scene, lr=fit["lr"])
    step = trainer.make_train_step((W, H), lr=fit["lr"], loss=fit["loss"])
    cams = CameraParams.from_camera(cam, "cpu")
    # two steps, so that the second starts from nonzero moments
    for k in range(2):
        seen = {}
        render_fn, grads_fn = trainer._render_impl, trainer._grads

        def rendered(*a, **kw):
            out = render_fn(*a, **kw)
            seen["image"] = out["image"].detach()
            return out

        def graded(*a, **kw):
            out = grads_fn(*a, **kw)
            seen["grads"] = out[0]
            return out

        trainer._render_impl, trainer._grads = rendered, graded
        try:
            new, loss, _ = step(state, scene.labels, cams, target, bg)
        finally:
            trainer._render_impl, trainer._grads = render_fn, grads_fn
        f = ref_train.FIELDS
        ref = ref_train.step(
            dict(zip(f, state.params)), dict(zip(f, state.opt_state.mu)),
            dict(zip(f, state.opt_state.nu)), state.opt_state.count,
            ref_render.Cam(torch.tensor(cam.rotation, dtype=torch.float32),
                           torch.tensor(cam.position, dtype=torch.float32),
                           float(cam.fx), float(cam.fy), W, H),
            target, bg, fit, raster)
        # the image and loss differ by the blend's association of its sums
        assert ref_train.rel_gap(seen["image"], ref.image) <= 1e-5
        assert abs(float(loss) - ref.loss) <= 1e-5 * ref.loss
        for name, g, p in zip(f, seen["grads"], new.params):
            rg = ref.grads[name]
            assert float(rg.abs().max()) > 0, name
            # an independent derivation of the same gradient in f32
            assert ref_train.rel_gap(g, rg) <= 1e-4, (k, name)
            # gaussians the reference leaves without gradient have none
            zero = (rg == 0).reshape(rg.shape[0], -1).all(1)
            assert not g[zero].any(), (k, name)
            d = p - state.params[f.index(name)]
            rd = ref.params[name] - state.params[f.index(name)]
            assert ref_train.rel_gap(d, rd) <= 1e-3, (k, name)
        state = new


# --- on the card ---------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _fold_on_card(rows, start, cnt, card):
    r, s, c = rows.to(card), start.to(card), cnt.to(card)
    before = api.fold_rows.launches
    first = api.fold_rows(r, s, c)
    assert api.fold_rows.launches == before + 1
    again = api.fold_rows(r, s, c)
    want = api._fold_rows_plain(rows, start, cnt)
    torch.cuda.synchronize()
    assert torch.equal(first.cpu().view(torch.int32),
                       want.view(torch.int32))
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    return first


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_fold_kernel_matches_plain(card, case):
    rows, start, cnt = _segments(CASES[case], np.random.default_rng(7))
    if rows.shape[0] == 0:
        rows = torch.zeros(1, 16)
    _fold_on_card(rows, start, cnt, card)


@pytest.mark.gpu
def test_fold_kernel_matches_plain_at_scale(card):
    rng = np.random.default_rng(11)
    # 1e5 rows of one gaussian among 200k ragged ones (1-40 rows, a tenth
    # empty, a tenth all zero), -0.0 rows among them
    counts = rng.integers(1, 41, size=200_000)
    counts[rng.uniform(size=counts.size) < 0.1] = 0
    z = rng.uniform(size=counts.size) < 0.1
    counts = np.where(z, -counts, counts)
    counts[1000] = 100_000
    rows, start, cnt = _segments(counts, rng)
    rows[::17] = -0.0
    got = _fold_on_card(rows, start, cnt, card)
    assert not got[torch.from_numpy(z).to(card)].any()


@pytest.mark.gpu
def test_old_fold_moves_zero_segments_and_the_new_does_not(card):
    """~2e7 slots whose running sum reaches ~1e6, a tenth of the segments
    all 0: B3 and the boundary gathers give some of them nonzero rows, the
    new fold none."""
    g = torch.Generator(device=card).manual_seed(5)
    n = 2_000_000
    cnt = torch.randint(1, 19, (n,), generator=g, device=card,
                        dtype=torch.int32)
    start = (torch.cumsum(cnt, 0, dtype=torch.int32) - cnt).contiguous()
    b = int(cnt.sum())
    rows = 0.1 * torch.rand(b, 16, generator=g, device=card)
    zero = torch.rand(n, generator=g, device=card) < 0.1
    owner = torch.repeat_interleave(torch.arange(n, device=card),
                                    cnt.long())
    rows[zero[owner]] = 0.0
    assert b > 1.5e7
    old = api.segment_sums(blend.cumsum_rows(rows), start, cnt)
    new = api.fold_rows(rows, start, cnt)
    torch.cuda.synchronize()
    assert int(old[zero].any(1).sum()) > 0
    assert not new[zero].any()
