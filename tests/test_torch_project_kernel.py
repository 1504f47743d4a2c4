"""The projection kernel (``csrc/project.cu``) behind
``render/projection.py::project``: on the card, equal to the plain version
``_project_plain`` bit for bit in every field; on the CPU, the rule that
chooses between the two, the wrapper's argument checks and its launch count.
Its backward kernel is ``tests/test_torch_project_bwd.py``'s.

This file imports neither jax nor ``gsplat_tpu``, so on a machine with a card
and only PyTorch it runs without the JAX harness of ``conftest.py``:

    python -m pytest tests/test_torch_project_kernel.py -m gpu --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.config import RasterConfig
from gsplat_tpu_torch.io.cameras import look_at_camera
from gsplat_tpu_torch.render import projection
from gsplat_tpu_torch.render.projection import CameraParams, Projected
from gsplat_tpu_torch.scene import GaussianScene, scene_from_numpy

torch.set_num_threads(2)

W, H = 160, 120
EYE = (0.25, -0.5, -3.0)
RC = RasterConfig()
FIELDS = Projected._fields[:-1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _camera(device):
    cam = look_at_camera(EYE, (0.1, 0.2, 0.0), width=W, height=H)
    return CameraParams.from_camera(cam, device)


def _scene(n, seed, degree=3, device="cpu") -> GaussianScene:
    """A seeded scene whose gaussians meet every cull of the projection:
    behind the camera and beyond z_far, det <= 0 (long needles just in
    front of the camera, whose f32 determinant cancels), opacity below
    alpha_min, off each edge of the frame, and means on the camera's
    centre (a zero-length view direction); quaternions unnormalised."""
    rng = np.random.default_rng(seed)
    eye = np.asarray(EYE)
    means = eye + rng.uniform(-6.0, 6.0, (n, 3)) * [1.0, 1.0, 2.0]
    log_scales = rng.normal(-3.0, 1.5, (n, 3))
    quats = rng.normal(size=(n, 4)) * rng.uniform(0.05, 20.0, (n, 1))
    opacities = rng.uniform(-9.0, 6.0, n)
    rows = rng.permutation(n)
    far, needle, centre = rows[:n // 20], rows[n // 20:n // 5], rows[-3:]
    means[far, 2] = rng.uniform(150.0, 400.0, far.size)
    means[needle] = eye + rng.uniform(-0.02, 0.02, (needle.size, 3)) + [
        0.0, 0.0, 0.6]
    log_scales[needle] = [6.0, -12.0, -12.0]
    means[centre] = eye
    k = (degree + 1) ** 2
    sh = rng.normal(0.0, 0.6, (n, k, 3))
    return scene_from_numpy(means, log_scales, quats, opacities, sh,
                            device=device)


def _both(scene, cam, sh_degree=None, cfg=RC, z_near=0.2, z_far=200.0):
    kw = dict(z_near=z_near, z_far=z_far, sh_degree=sh_degree)
    return (projection.project(scene, cam, W, H, cfg, **kw),
            projection._project_plain(scene, cam, W, H, cfg, **kw))


def _ulps(a, b):
    """Largest distance in f32 units in the last place between a and b."""
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    # map the sign-magnitude bits onto a monotone integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


def _assert_equal(got, want):
    off = {f: _ulps(getattr(got, f), getattr(want, f)) for f in FIELDS
           if not torch.equal(getattr(got, f).view(torch.int32),
                              getattr(want, f).view(torch.int32))}
    assert not off, f"fields differ from the plain version (ulps): {off}"
    assert torch.equal(got.valid, want.valid)


# -- on the card ----------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("degree,sh_degree,n", [
    (0, None, 1000), (1, None, 1001), (2, None, 999), (3, None, 4099),
    (3, 0, 1000), (3, 1, 1000), (3, 2, 777), (1, 3, 1000), (3, None, 1),
    (3, None, 128 * 3)])
def test_kernel_equals_plain(card, degree, sh_degree, n):
    scene = _scene(n, seed=10 * degree + n, degree=degree, device=card)
    before = projection.project.launches
    got, want = _both(scene, _camera(card), sh_degree)
    assert projection.project.launches == before + 1
    _assert_equal(got, want)


@pytest.mark.gpu
def test_kernel_equals_plain_under_other_settings(card):
    """Another alpha_min (0.0035: the f32 of its double reciprocal, 285.7143,
    is not the f32 reciprocal of its f32, 285.71426, and neither is exact),
    cutoff, blur and depth range."""
    cfg = RasterConfig(alpha_min=0.0035, sigma_cutoff=3.0, cov2d_blur=0.25)
    scene = _scene(2000, seed=8, device=card)
    _assert_equal(*_both(scene, _camera(card), cfg=cfg, z_near=0.5,
                         z_far=120.0))


@pytest.mark.gpu
def test_kernel_equals_plain_on_unaligned_rows(card):
    """A scene sliced at row 1: its means and log-scales rows start off 16
    bytes, so the block takes its 4-byte loads."""
    scene = _scene(3001, seed=5, device=card)
    sliced = GaussianScene(*(t[1:] for t in (
        scene.means, scene.log_scales, scene.quats, scene.opacities,
        scene.sh, scene.labels)))
    assert sliced.means.data_ptr() % 16
    _assert_equal(*_both(sliced, _camera(card)))


@pytest.mark.gpu
def test_kernel_equals_plain_at_main_path_size(card):
    """The benchmark's scene statistics at 300k gaussians, SH degree 3."""
    n = 300_000
    rng = np.random.default_rng(7)
    shell = rng.random(n) < 0.2
    means = rng.normal(size=(n, 3))
    means *= (np.where(shell, rng.uniform(4, 8, n), rng.random(n) ** (1 / 3))
              / np.linalg.norm(means, axis=1))[:, None]
    scene = scene_from_numpy(
        means, np.log(0.004) + 0.5 * rng.normal(size=(n, 3)),
        rng.normal(size=(n, 4)), rng.uniform(-2, 4, n),
        rng.normal(0, 0.3, (n, 16, 3)), device=card)
    cam = CameraParams.from_camera(look_at_camera(
        (2.5, 0.3, 0.4), (0, 0, 0), width=W, height=H), card)
    _assert_equal(*_both(scene, cam))


@pytest.mark.gpu
def test_kernel_takes_no_grad_calls_only(card):
    """Which calls on the card launch the kernel (since the projection got
    its backward kernel, every call but one whose camera requires grad):
    a call that records a gradient of a scene field launches it once, as
    the forward of the autograd.Function; a camera that requires grad
    takes the plain code; a call without grad launches it; an empty scene
    launches nothing."""
    scene = _scene(500, seed=3, device=card)
    cam = _camera(card)
    before = projection.project.launches
    scene.means.requires_grad_(True)
    got = projection.project(scene, cam, W, H, RC)
    assert "_ProjectFunction" in type(got.u.grad_fn).__name__
    assert projection.project.launches == before + 1
    rot = cam.rot.clone().requires_grad_(True)
    got = projection.project(scene, cam._replace(rot=rot), W, H, RC)
    assert got.u.grad_fn is not None
    assert "_ProjectFunction" not in type(got.u.grad_fn).__name__
    assert projection.project.launches == before + 1
    with torch.no_grad():
        got = projection.project(scene, cam, W, H, RC)
    assert projection.project.launches == before + 2
    empty = GaussianScene(*(t[:0] for t in (
        scene.means, scene.log_scales, scene.quats, scene.opacities,
        scene.sh, scene.labels)))
    out = projection.project(empty, cam, W, H, RC)
    assert projection.project.launches == before + 2
    assert out.u.shape == (0,) and out.valid.dtype == torch.bool


# -- on the CPU ----------------------------------------------------------


def test_cases_meet_every_cull():
    """The seeded scene of the card tests meets each cull it is meant to
    (read from the plain version)."""
    scene = _scene(1000, seed=0)
    cam = _camera("cpu")
    with torch.no_grad():
        p = projection._project_plain(scene, cam, W, H, RC, z_near=0.2,
                                      z_far=200.0, sh_degree=None)
    z = p.depth
    in_range = (z > 0.2) & (z < 200.0)
    opaque = p.opacity >= RC.alpha_min
    in_frame = ((p.u + p.ex > 0) & (p.u - p.ex < W)
                & (p.v + p.ey > 0) & (p.v - p.ey < H))
    assert int((z <= 0.2).sum()) > 0 and int((z >= 200.0).sum()) > 0
    assert int((~opaque).sum()) > 0
    assert int((in_range & opaque & in_frame & ~p.valid).sum()) > 0  # det
    for off in (p.u + p.ex <= 0, p.u - p.ex >= W, p.v + p.ey <= 0,
                p.v - p.ey >= H):
        assert int((in_range & off).sum()) > 0
    assert int(p.valid.sum()) > 0
    assert bool(torch.isfinite(p.red).all())   # the zero-length directions


@pytest.mark.parametrize("field", ["means", "log_scales", "quats",
                                   "opacities", "sh", "rot", "fx"])
def test_records_grad_rule(field):
    scene = _scene(10, seed=1, degree=1)
    cam = _camera("cpu")
    assert not projection._records_grad(scene, cam)
    holder = cam if field in CameraParams._fields else scene
    getattr(holder, field).requires_grad_(True)
    assert projection._records_grad(scene, cam)
    with torch.no_grad():
        assert not projection._records_grad(scene, cam)


def _no_kernel(name):
    raise AssertionError(f"kernel {name} fetched on the CPU")


def test_cpu_call_takes_plain(monkeypatch):
    monkeypatch.setattr(_kernels, "function", _no_kernel)
    scene = _scene(300, seed=2)
    before = projection.project.launches
    got, want = _both(scene, _camera("cpu"))
    assert projection.project.launches == before
    _assert_equal(got, want)


def test_grad_call_gives_plain_gradients(monkeypatch):
    monkeypatch.setattr(_kernels, "function", _no_kernel)
    leaves = []

    def run(fn):
        scene = _scene(300, seed=4, degree=2)
        fields = (scene.means, scene.log_scales, scene.quats,
                  scene.opacities, scene.sh)
        for t in fields:
            t.requires_grad_(True)
        out = fn(scene, _camera("cpu"), W, H, RC, z_near=0.2, z_far=200.0,
                 sh_degree=None)
        loss = sum((getattr(out, f) * torch.linspace(0.5, 1.5, 300)).sum()
                   for f in FIELDS)
        leaves.append(torch.autograd.grad(loss, fields))

    before = projection.project.launches
    run(projection.project)
    run(projection._project_plain)
    assert projection.project.launches == before
    for a, b in zip(*leaves):   # NaN where a mean sits on the camera
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# each case: the scene field or camera field it replaces, and the new value
BAD_INPUTS = {
    "f64 means": ("means", lambda s, c: s.means.double()),
    "f64 rot": ("rot", lambda s, c: c.rot.double()),
    "quats [N, 3]": ("quats", lambda s, c: s.quats[:, :3].contiguous()),
    "opacities [N, 1]": ("opacities", lambda s, c: s.opacities[:, None]),
    "sh [N, 5, 3]": ("sh", lambda s, c: torch.zeros(20, 5, 3)),
    "sh [N, 16, 2]": ("sh", lambda s, c: torch.zeros(20, 16, 2)),
    "fx [1]": ("fx", lambda s, c: c.fx[None]),
    "strided means": ("means", lambda s, c: s.means.t().contiguous().t()),
    "strided sh": ("sh", lambda s, c: s.sh.transpose(0, 1).contiguous()
                   .transpose(0, 1)),
}


@pytest.mark.parametrize("case,error", [
    ("f64 means", TypeError), ("f64 rot", TypeError),
    ("quats [N, 3]", ValueError), ("opacities [N, 1]", ValueError),
    ("sh [N, 5, 3]", ValueError), ("sh [N, 16, 2]", ValueError),
    ("fx [1]", ValueError), ("strided means", ValueError),
    ("strided sh", ValueError)])
def test_wrapper_rejects(case, error):
    scene, cam = _scene(20, seed=6), _camera("cpu")
    field, value = BAD_INPUTS[case]
    if field in CameraParams._fields:
        cam = cam._replace(**{field: value(scene, cam)})
    else:
        scene = dataclasses.replace(scene, **{field: value(scene, cam)})
    before = projection.project.launches
    with pytest.raises(error):
        projection.project(scene, cam, W, H, RC)
    assert projection.project.launches == before


@pytest.mark.parametrize("k,sh_degree,bands", [
    (1, None, 0), (4, None, 1), (9, None, 2), (16, None, 3), (16, 0, 0),
    (16, 1, 1), (16, 2, 2), (4, 3, 1), (16, -1, 0)])
def test_sh_bands(k, sh_degree, bands):
    assert projection._sh_bands(k, sh_degree) == bands
