"""The port's training CLI slice against Pillow and the JAX package, on the
CPU: the PNG reader and Pillow's resize (``io/png.py``), checkpoints
(``utils/checkpoint.py``), the weights carry-across of a training state,
and ``cli/train.py`` against ``gsplat_tpu.cli.train`` (Pallas in interpret
mode, as ``tests/test_train.py`` runs it) and against itself across a
resume. Pillow is 12.1.0 here; ``resize_rgb`` reproduces its
``Resample.c`` arithmetic, so the comparisons are exact.
"""

import filecmp
import hashlib
import io
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from gsplat_tpu.cli import train as jcli
from gsplat_tpu.io import ply as jply
from gsplat_tpu.io import synthetic as jsynthetic
from gsplat_tpu.models import trainer as jtrainer
from gsplat_tpu_torch.cli import train as tcli
from gsplat_tpu_torch.io import png
from gsplat_tpu_torch.io import ply as tply
from gsplat_tpu_torch.io.cameras import orbit_cameras, save_cameras
from gsplat_tpu_torch.io.synthetic import random_scene
from gsplat_tpu_torch.label import vote as tvote
from gsplat_tpu_torch.models import densify as tdensify
from gsplat_tpu_torch.models import trainer as ttrainer
from gsplat_tpu_torch.utils import checkpoint as ckpt
from test_torch_kernels import (PNG_DIGESTS, filtered_png, png_cases,
                                smooth_image)

torch.set_num_threads(2)

CPU = "cpu"


def _pil_png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# ---------------------------------------------------------------------------
# PNG reader and resize: exact against Pillow
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
@pytest.mark.parametrize("optimize", [False, True])
def test_decode_png_equals_pillow(mode, optimize):
    img = Image.fromarray(smooth_image(41, 57))
    img = (img.convert("P", palette=Image.Palette.ADAPTIVE, colors=60)
           if mode == "P" else img.convert(mode))
    data = _pil_png(img, optimize=optimize)
    np.testing.assert_array_equal(png.decode_png(data), _pil_rgb(data))


def test_decode_png_all_five_filters(tmp_path):
    img = smooth_image(23, 31, seed=4)
    data = filtered_png(img)
    p = tmp_path / "f.png"
    p.write_bytes(data)
    got = png.decode_png(str(p))
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, _pil_rgb(data))
    # and the package's own writer
    np.testing.assert_array_equal(png.decode_png(png.encode_png(img)), img)


def _interlaced_png():
    header = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)
    return (png.SIGNATURE + png._chunk(b"IHDR", header)
            + png._chunk(b"IDAT", zlib.compress(b"\0" * 64))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("case", ["interlaced", "16-bit", "bad crc"])
def test_decode_png_refuses(tmp_path, case):
    # an Adam7 file whose data does not fill its seven passes (55 bytes for
    # a 4x4 RGB image); a 16-bit palette, a depth no palette may have
    if case == "interlaced":
        data, what = _interlaced_png(), "55 were expected"
    elif case == "16-bit":
        header = struct.pack(">IIBBBBB", 4, 4, 16, 3, 0, 0, 0)
        data = (png.SIGNATURE + png._chunk(b"IHDR", header)
                + png._chunk(b"PLTE", bytes(6))
                + png._chunk(b"IDAT", zlib.compress(b"\0" * 36))
                + png._chunk(b"IEND", b""))
        what = "bit depth 16 is not allowed"
    else:
        data = bytearray(_pil_png(Image.fromarray(smooth_image(8, 8))))
        data[-20] ^= 1    # a byte of the IDAT chunk
        data, what = bytes(data), "CRC"
    p = tmp_path / f"{case}.png"
    p.write_bytes(data)
    with pytest.raises(ValueError, match=what) as err:
        png.decode_png(str(p))
    assert str(p) in str(err.value)


@pytest.mark.parametrize("src,dst", [
    ((3114, 2075), (778, 518)), ((1600, 1216), (800, 608)),
    ((161, 97), (320, 240)), ((100, 100), (100, 100)), ((37, 53), (16, 16))])
def test_resize_rgb_equals_pillow(src, dst):
    img = np.random.default_rng(sum(src)).integers(
        0, 256, size=(src[1], src[0], 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst))
    np.testing.assert_array_equal(png.resize_rgb(img, *dst), want)


@settings(max_examples=60, deadline=None)
@given(w0=st.integers(1, 48), h0=st.integers(1, 48), w1=st.integers(1, 48),
       h1=st.integers(1, 48), seed=st.integers(0, 2**16))
def test_resize_rgb_equals_pillow_on_small_sizes(w0, h0, w1, h1, seed):
    img = np.random.default_rng(seed).integers(0, 256, size=(h0, w0, 3),
                                               dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((w1, h1)))
    np.testing.assert_array_equal(png.resize_rgb(img, w1, h1), want)


def test_png_digests_are_pillows():
    """The inputs and digests ``test_torch_kernels.py`` checks on the card's
    machine (which has no Pillow) are Pillow's pixels."""
    for name, (data, size) in png_cases().items():
        want = _pil_rgb(data)
        if size is not None:
            want = np.asarray(Image.fromarray(want).resize(size))
        got = png.decode_png(data)
        if size is not None:
            got = png.resize_rgb(got, *size)
        np.testing.assert_array_equal(got, want)
        assert hashlib.sha256(got.tobytes()).hexdigest() == PNG_DIGESTS[name]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _payload(seed=0):
    scene = random_scene(64, seed=seed, num_labels=3, sh_degree=1,
                         device=CPU)
    state = ttrainer.init_state(scene, lr=0.01)
    gen = torch.Generator().manual_seed(seed)
    mu = ttrainer.SceneParams(*(torch.randn(p.shape, generator=gen)
                                for p in state.params))
    state = state._replace(opt_state=state.opt_state._replace(count=7, mu=mu),
                           step=7)
    stats = tdensify.DensifyStats(torch.rand(64, generator=gen),
                                  torch.arange(64, dtype=torch.float32))
    return dict(state=state, labels=scene.labels, stats=stats,
                generator=gen.get_state())


def _assert_same(a, b):
    assert type(a) is type(b)
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    saved = _payload()
    path = str(tmp_path / "ck" / "state")
    ckpt.save_pytree(path, saved)
    _assert_same(ckpt.restore_pytree(path, like=_payload(seed=1)), saved)
    # without a structure: nested dicts of the leaves
    plain = ckpt.restore_pytree(path)
    assert torch.equal(plain["state"]["params"]["means"],
                       saved["state"].params.means)
    assert plain["state"]["opt_state"]["count"] == 7
    # a structure that does not fit raises
    with pytest.raises(ValueError):
        ckpt.restore_pytree(path, like=dict(state=saved["state"]))


def test_checkpoint_save_is_atomic(tmp_path, monkeypatch):
    path = str(tmp_path / "state")
    ckpt.save_pytree(path, {"x": torch.arange(4)})

    def torn(obj, f):
        f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn)
    with pytest.raises(OSError):
        ckpt.save_pytree(path, {"x": torch.arange(8)})
    monkeypatch.undo()
    assert torch.equal(ckpt.restore_pytree(path)["x"], torch.arange(4))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["state"]


def test_vote_checkpoint_resumes_a_split_sweep(tmp_path):
    scene = random_scene(400, seed=3, device=CPU)
    cams = orbit_cameras(6, 3.0, width=64, img_height=48)
    seg = np.random.default_rng(3).integers(-1, 5, size=(6, 24, 32)).astype(
        np.int32)
    whole = tvote.assign_labels(scene, cams, seg, num_classes=6, device=CPU)
    vc = ckpt.VoteCheckpoint(str(tmp_path))
    assert vc.load() == (None, 0)
    _, votes = tvote.assign_labels(scene, cams[:3], seg[:3], num_classes=6,
                                   return_votes=True, device=CPU)
    vc.save(votes, 3)
    saved, nxt = ckpt.VoteCheckpoint(str(tmp_path)).load()
    assert nxt == 3 and isinstance(saved, np.ndarray)
    resumed = tvote.assign_labels(scene, cams[nxt:], seg[nxt:],
                                  num_classes=6, initial_votes=saved,
                                  device=CPU)
    assert torch.equal(resumed, whole)
    assert (whole >= 0).sum() > 50


def test_state_from_numpy_carries_a_jax_state_across():
    js = jsynthetic.random_scene(50, seed=5, sh_degree=1)
    jstate = jtrainer.init_state(js, lr=0.01)
    rng = np.random.default_rng(5)
    adam = jstate.opt_state[0]
    mu = [rng.normal(size=np.shape(a)).astype(np.float32) for a in adam.mu]
    nu = [rng.uniform(size=np.shape(a)).astype(np.float32) for a in adam.nu]
    params = [np.asarray(a) for a in jstate.params]
    t = ttrainer.state_from_numpy(params, mu, nu, 9, device=CPU)
    assert t.step == 9 and t.opt_state.count == 9
    for got, want in zip(list(t.params) + list(t.opt_state.mu)
                         + list(t.opt_state.nu), params + mu + nu):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli_inputs(d, width, height, views=2, seed=3):
    """cameras.json and PIL-written noise targets of ``views`` orbit views."""
    cams = orbit_cameras(views, 3.0, width=width, img_height=height)
    save_cameras(str(d / "cameras.json"), cams)
    (d / "img").mkdir()
    rng = np.random.default_rng(seed)
    for c in cams:
        Image.fromarray(rng.integers(0, 256, size=(height, width, 3),
                                     dtype=np.uint8)).save(
            d / "img" / f"{c.img_name}.png")
    return ["--camera_file", str(d / "cameras.json"), "--image_dir",
            str(d / "img")]


@pytest.mark.parametrize("case", ["plain", "adaptive"])
def test_train_cli_matches_jax(tmp_path, case, capsys):
    """Both CLIs on two views of PIL-written targets: the plain path at
    96x64 with --scale 1.0, and the adaptive path (capacity padding,
    statistics, opacity resets, no densify event: the split noise comes
    from different generators) on 192x128 targets at --scale 0.5. The
    printed lines agree (losses within 1e-4 relative), and every field of
    the output PLYs agrees within 1e-4 of its peak on at least 99% of the
    gaussians. The others are gaussians whose few pixels sit at the alpha
    cut, which an exp ulp moves (PERF.md §2), or whose gradient is
    rounding noise; Adam's step, about lr x sign(g), turns such a change
    into up to a whole step an iteration, so they differ by at most two
    steps an iteration."""
    if case == "plain":
        w, h, scale, extra = 96, 64, 1.0, []
    else:
        w, h, scale, extra = 192, 128, 0.5, [
            "--densify_every", "10", "--opacity_reset_every", "2",
            "--loss", "dssim_l1"]
    iters, lr = 4, 5e-3
    args = _cli_inputs(tmp_path, w, h) + [
        "--num_gaussians", "300", "--iters", str(iters), "--scale",
        str(scale), "--log_every", "1", "--lr", str(lr)] + extra
    assert jcli.main(args + ["--out", str(tmp_path / "jax.ply")]) == 0
    jax_out = capsys.readouterr().out
    assert tcli.main(args + ["--out", str(tmp_path / "port.ply"),
                             "--device", CPU]) == 0
    port_out = capsys.readouterr().out
    lines = lambda out: [l.split(": loss")[0] for l in out.splitlines()
                         if not l.startswith("wrote")]
    assert lines(port_out) == lines(jax_out)
    loss = lambda out: [float(l.split()[-1]) for l in out.splitlines()
                        if ": loss " in l]
    np.testing.assert_allclose(loss(port_out), loss(jax_out), rtol=1e-4)

    want = jply.read_ply(str(tmp_path / "jax.ply"))["vertex"]
    got = tply.read_ply(str(tmp_path / "port.ply"))["vertex"]
    assert got.dtype == want.dtype and len(got) == len(want) == 300
    # each PLY property's Adam step, lr x its field's scale
    sc = ttrainer.LR_SCALES
    steps = {"x": sc["means"], "y": sc["means"], "z": sc["means"],
             "opacity": sc["opacities"]}
    steps.update({f"f_dc_{i}": sc["sh"] for i in range(3)})
    steps.update({f"scale_{i}": sc["log_scales"] for i in range(3)})
    steps.update({f"rot_{i}": sc["quats"] for i in range(4)})
    loose = np.zeros(len(want), bool)
    for f in want.dtype.names:
        err = np.abs(got[f].astype(np.float64) - want[f])
        bar = 1e-4 * max(float(np.abs(want[f]).max()), 1e-30)
        loose |= err > bar
        assert err.max() <= bar + 2 * iters * lr * steps.get(f, 0.0), f
    assert loose.mean() <= 0.01


def test_train_cli_resume_is_exact(tmp_path):
    """An adaptive run with its only save at it = 7, then the same command
    again: it resumes at step 8, densifies at 8 and 10 from the restored
    generator, and writes the same PLY bytes as the uninterrupted run."""
    args = _cli_inputs(tmp_path, 64, 48) + [
        "--num_gaussians", "100", "--scale", "1.0", "--iters", "12",
        "--checkpoint_every", "7", "--densify_every", "2",
        "--densify_until", "12", "--checkpoint_dir", str(tmp_path / "ck"),
        "--log_every", "4", "--device", CPU]
    assert tcli.main(args + ["--out", str(tmp_path / "a.ply")]) == 0
    assert (tmp_path / "ck" / "state").exists()
    saved = ckpt.restore_pytree(str(tmp_path / "ck" / "state"))
    assert saved["state"]["step"] == 8
    assert tcli.main(args + ["--out", str(tmp_path / "b.ply")]) == 0
    assert filecmp.cmp(tmp_path / "a.ply", tmp_path / "b.ply", shallow=False)
    scene = tply.scene_from_ply(str(tmp_path / "a.ply"), device=CPU)
    assert 100 < scene.num_gaussians <= 512


def test_train_cli_resume_prints_its_step(tmp_path, capsys):
    args = _cli_inputs(tmp_path, 48, 32, views=1) + [
        "--num_gaussians", "50", "--scale", "1.0", "--iters", "3",
        "--checkpoint_every", "1", "--checkpoint_dir",
        str(tmp_path / "ck"), "--device", CPU, "--out",
        str(tmp_path / "o.ply")]
    assert tcli.main(args) == 0
    capsys.readouterr()
    assert tcli.main(args) == 0
    assert "resumed at step 3" in capsys.readouterr().out


def test_train_cli_skips_missing_images(tmp_path, capsys):
    args = _cli_inputs(tmp_path, 48, 32) + ["--out", str(tmp_path / "o.ply"),
                                            "--iters", "1", "--device", CPU]
    first = sorted((tmp_path / "img").iterdir())[0]
    first.unlink()
    assert tcli.main(args + ["--num_gaussians", "30"]) == 0
    err = capsys.readouterr().err
    assert f"warning: missing target image {first}" in err
    for p in (tmp_path / "img").iterdir():
        p.unlink()
    assert tcli.main(args) == 1
    assert "no (camera, image) pairs" in capsys.readouterr().err


# the mesh flags run (tests/test_torch_parallel.py); a malformed mesh, or a
# process flag without the other two (and no torchrun environment), raises
@pytest.mark.parametrize("flag", [["--mesh", "2x4x1"],
                                  ["--coordinator", "localhost:1234"],
                                  ["--num_processes", "2"],
                                  ["--process_id", "0"]])
def test_train_cli_refuses_mesh_flags(tmp_path, flag, monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    args = _cli_inputs(tmp_path, 48, 32) + ["--out", str(tmp_path / "o.ply"),
                                            "--device", CPU]
    with pytest.raises(ValueError, match="mesh spec|process group"):
        tcli.main(args + flag)


def test_train_cli_needs_a_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _cli_inputs(tmp_path, 48, 32) + ["--out", str(tmp_path / "o.ply")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(args)
    assert not (tmp_path / "o.ply").exists()


def test_compact_alive_drops_dead_slots():
    scene = random_scene(10, seed=2, num_labels=3, device=CPU)
    params, labels = tdensify.pad_to_capacity(
        ttrainer.SceneParams.from_scene(scene), scene.labels, 16)
    out = tcli._compact_alive(params.to_scene(labels))
    assert out.num_gaussians == 10
    assert torch.equal(out.means, scene.means)
    assert torch.equal(out.labels, scene.labels)
    np.testing.assert_array_equal(
        jnp.asarray(jcli._compact_alive(jsynthetic.random_scene(
            10, seed=2, num_labels=3)).means), scene.means.numpy())
