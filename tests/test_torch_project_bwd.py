"""The projection's backward: ``render/projection.py::project_bwd`` (kernel
``csrc/project_bwd.cu``) and its plain version ``_project_vjp_plain``, and
the rule by which ``project`` takes the autograd.Function of the two, which
is the same on both devices.

On the CPU: the plain VJP against float64 autograd through
``_project_plain`` (the scene of ``test_torch_project_kernel.py`` that meets
every cull), exact zeros for gaussians without a gradient and for bands
past ``sh_degree``, and the rule for each input that can require grad, the
Function's halves taking their plain versions. On the card (marker
``gpu``): the kernel equal to the plain VJP bit for bit, the same from run
to run, one launch a backward.

This file imports neither jax nor ``gsplat_tpu``:

    python -m pytest tests/test_torch_project_bwd.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.config import RasterConfig
from gsplat_tpu_torch.io.cameras import look_at_camera
from gsplat_tpu_torch.render import projection
from gsplat_tpu_torch.render.projection import GRAD_FIELDS, CameraParams
from gsplat_tpu_torch.scene import SceneParams, scene_from_numpy
from test_torch_project_kernel import RC, H, W, _camera, _scene, _ulps

torch.set_num_threads(2)

KW = dict(z_near=0.2, z_far=200.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fields(scene, n=None, dtype=torch.float32):
    """The scene's five float fields, cut to the first n rows."""
    return SceneParams(*(t[:n].to(dtype).contiguous() for t in (
        scene.means, scene.log_scales, scene.quats, scene.opacities,
        scene.sh)))


def _grads(n, seed, dead_every=5, device="cpu"):
    """Incoming gradients as autograd hands them over: strided [N] columns
    of one [N, 16] table (as the fold's output reaches ``project`` through
    ``pack_table``'s stack), depth as a gradient of zeros (None), every
    ``dead_every``-th gaussian's row all zero."""
    g = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, 16)).astype(np.float32)).to(device)
    g[::dead_every] = 0.0
    cols = dict(u=0, v=1, ca=2, cb=3, cc=4, opacity=5, red=6, green=7,
                blue=8)
    return [g[:, cols[f]] if f in cols else None for f in GRAD_FIELDS]


def _autograd(fields, cam, grads, sh_degree, dtype):
    """Float ``dtype`` autograd of ``_project_plain``: the five fields'
    gradients of sum_f <output_f, grads_f>."""
    leaves = [t.detach().to(dtype).requires_grad_(True) for t in fields]
    out = projection._project_plain(
        SceneParams(*leaves), CameraParams(*(t.to(dtype) for t in cam)), W,
        H, RC, sh_degree=sh_degree, **KW)
    loss = sum((getattr(out, f) * g.to(dtype)).sum()
               for f, g in zip(GRAD_FIELDS, grads) if g is not None)
    return torch.autograd.grad(loss, leaves)


def _vjp(fields, cam, grads, sh_degree, cfg=RC):
    return projection._project_vjp_plain(fields, cam, cfg, grads,
                                         sh_degree=sh_degree, **KW)


CASES = [(0, None, 1000), (1, None, 1001), (2, None, 999), (3, None, 1000),
         (3, 0, 500), (3, 1, 500), (3, 2, 777), (1, 3, 300), (3, None, 1)]


# -- on the CPU ----------------------------------------------------------


@pytest.mark.parametrize("degree,sh_degree,n", CASES)
def test_vjp_error_within_twice_autograds(degree, sh_degree, n):
    """Each field's error against float64 autograd (L2 over the entries
    both f32 versions and the reference give finite) is no more than twice
    that of f32 autograd; and the VJP is finite wherever autograd's f32
    gradient is (at a mean on the camera's centre autograd gives NaN)."""
    scene = _scene(max(n, 100), seed=10 * degree + n, degree=degree)
    fields, cam = _fields(scene, n), _camera("cpu")
    grads = _grads(n, seed=n)
    ref = _autograd(fields, cam, grads, sh_degree, torch.float64)
    f32 = _autograd(fields, cam, grads, sh_degree, torch.float32)
    got = _vjp(fields, cam, grads, sh_degree)
    for name, r, a, v in zip(SceneParams._fields, ref, f32, got):
        assert not bool((torch.isfinite(a) & ~torch.isfinite(v)).any()), name
        ok = torch.isfinite(r) & torch.isfinite(a) & torch.isfinite(v)
        err_a = float((a.double() - r)[ok].norm())
        err_v = float((v.double() - r)[ok].norm())
        assert err_v <= 2.0 * err_a, (name, err_v, err_a)


@pytest.mark.parametrize("degree,sh_degree", [(3, None), (2, None), (1, None),
                                              (0, None), (3, 1), (3, 2)])
def test_vjp_is_autograds_in_float64(degree, sh_degree):
    """In float64, on well-conditioned gaussians (all in front of the
    camera, none thin), the VJP is autograd's to rounding: every term of
    the chain is there."""
    n = 400
    rng = np.random.default_rng(degree)
    scene = scene_from_numpy(
        rng.normal(size=(n, 3)) * 0.5, np.log(0.05) + 0.3 * rng.normal(
            size=(n, 3)), rng.normal(size=(n, 4)), rng.uniform(-2, 4, n),
        rng.normal(0, 0.3, (n, (degree + 1) ** 2, 3)), device="cpu")
    fields = _fields(scene, dtype=torch.float64)
    cam = CameraParams.from_camera(look_at_camera(
        (2.5, 0.3, 0.4), (0, 0, 0), width=W, height=H), "cpu")
    cam = CameraParams(*(t.double() for t in cam))
    grads = [None if g is None else g.double()
             for g in _grads(n, seed=degree, dead_every=7)]
    ref = _autograd(fields, cam, grads, sh_degree, torch.float64)
    got = _vjp(fields, cam, grads, sh_degree)
    for name, r, v in zip(SceneParams._fields, ref, got):
        assert float((v - r).norm()) <= 1e-12 * float(r.norm()), name


def test_zero_rows_give_exact_zeros():
    """A gaussian whose ten incoming gradients are all 0 gets +0.0 in
    every float of its five rows, whatever its inputs (the cull scene's
    NaN-producing centre means included); no gradient at all gives zeros."""
    scene = _scene(600, seed=9)
    fields, cam = _fields(scene), _camera("cpu")
    for grads, dead in ((_grads(600, seed=9, dead_every=3), slice(0, None, 3)),
                        ([None] * len(GRAD_FIELDS), slice(None))):
        for t in _vjp(fields, cam, grads, None):
            rows = t[dead].reshape(-1)
            assert torch.equal(rows.view(torch.int32),
                               torch.zeros_like(rows).view(torch.int32))


@pytest.mark.parametrize("k,sh_degree", [(16, 0), (16, 1), (16, 2), (4, 0),
                                         (9, 1), (16, -1)])
def test_bands_past_sh_degree_get_zeros(k, sh_degree):
    degree = {4: 1, 9: 2, 16: 3}[k]
    scene = _scene(300, seed=k, degree=degree)
    fields, cam = _fields(scene), _camera("cpu")
    got = _vjp(fields, cam, _grads(300, seed=k), sh_degree)
    keval = (1, 4, 9, 16)[projection._sh_bands(k, sh_degree)]
    assert torch.equal(got.sh[:, keval:].view(torch.int32),
                       torch.zeros_like(got.sh[:, keval:]).view(torch.int32))
    assert bool((got.sh[:, :keval] != 0).any(2).any(0).all())


ON_KERNEL_PATH = {"means", "log_scales", "quats", "opacities", "sh"}


@pytest.mark.parametrize("field", ["means", "log_scales", "quats",
                                   "opacities", "sh", "rot", "fx"])
def test_grad_rule(field):
    """Which code a grad-recording call takes (here on the CPU, where the
    Function's two halves take their plain versions): the Function where
    only scene fields require grad, the plain code where a camera tensor
    does. On the Function, the forward equals ``_project_plain`` and the
    gradients ``_project_vjp_plain``, bit for bit, and the cutoff's fields
    carry no gradient."""
    scene = _scene(200, seed=11, degree=2)
    cam = _camera("cpu")
    holder = cam if field in CameraParams._fields else scene
    getattr(holder, field).requires_grad_(True)
    out = projection.project(scene, cam, W, H, RC, **KW)
    kernel = field in ON_KERNEL_PATH
    assert ("_ProjectFunction" in type(out.u.grad_fn).__name__) == kernel
    with torch.no_grad():
        want = projection._project_plain(scene, cam, W, H, RC,
                                         sh_degree=None, **KW)
    for f in projection.Projected._fields:
        assert torch.equal(getattr(out, f).view(torch.uint8),
                           getattr(want, f).view(torch.uint8)), f
    if not kernel:
        return
    for f in ("radius", "ex", "ey", "qmax", "valid"):
        assert not getattr(out, f).requires_grad, f
    grads = _grads(200, seed=11)
    loss = sum((getattr(out, f) * g).sum()
               for f, g in zip(GRAD_FIELDS, grads) if g is not None)
    (got,) = torch.autograd.grad(loss, [getattr(scene, field)])
    want = getattr(_vjp(_fields(scene), cam, grads, None), field)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_function_takes_unused_outputs_as_none():
    """A loss of u and red alone: the Function's backward gets None for the
    other outputs, and its gradients equal the plain VJP's with those
    gradients None."""
    scene = _scene(150, seed=12, degree=3)
    fields = _fields(scene)
    leaves = SceneParams(*(t.clone().requires_grad_(True) for t in fields))
    cam = _camera("cpu")
    out = projection.project(leaves, cam, W, H, RC, **KW)
    w = torch.linspace(0.5, 1.5, 150)
    got = torch.autograd.grad((out.u * w).sum() + (out.red * w).sum(),
                              leaves)
    grads = [w if f in ("u", "red") else None for f in GRAD_FIELDS]
    for a, b in zip(got, _vjp(fields, cam, grads, None)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("case", ["count", "f64", "shape", "matrix"])
def test_project_bwd_rejects(case):
    scene = _scene(20, seed=6)
    fields, cam = _fields(scene), _camera("cpu")
    grads = _grads(20, seed=6)
    if case == "count":
        grads = grads[:-1]
    elif case == "f64":
        grads[0] = grads[0].double()
    elif case == "shape":
        grads[1] = grads[1][:-1]
    else:
        grads[2] = torch.zeros(20, 2)
    before = projection.project_bwd.launches
    with pytest.raises(ValueError):
        projection.project_bwd(fields, cam, grads, RC, **KW)
    assert projection.project_bwd.launches == before


# -- on the card ----------------------------------------------------------


def _assert_equal(got, want):
    off = {f: _ulps(a, b) for f, a, b in zip(SceneParams._fields, got, want)
           if not torch.equal(a.view(torch.int32), b.view(torch.int32))}
    assert not off, f"fields differ from the plain VJP (ulps): {off}"


def _bwd_both(fields, cam, grads, sh_degree=None, cfg=RC, **kw):
    kw = {**KW, **kw}
    before = projection.project_bwd.launches
    got = projection.project_bwd(fields, cam, grads, cfg,
                                 sh_degree=sh_degree, **kw)
    assert projection.project_bwd.launches == before + 1
    want = projection._project_vjp_plain(fields, cam, cfg, grads,
                                         sh_degree=sh_degree, **kw)
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("degree,sh_degree,n", CASES + [(3, None, 128 * 3)])
def test_kernel_equals_plain_vjp(card, degree, sh_degree, n):
    scene = _scene(max(n, 100), seed=10 * degree + n, degree=degree,
                   device=card)
    _assert_equal(*_bwd_both(_fields(scene, n), _camera(card),
                             _grads(n, seed=n, device=card), sh_degree))


@pytest.mark.gpu
def test_kernel_equals_plain_vjp_under_other_settings(card):
    """Another blur and depth range (and alpha_min and cutoff, which the
    backward does not read); gradients contiguous and depth's too."""
    cfg = RasterConfig(alpha_min=0.0035, sigma_cutoff=3.0, cov2d_blur=0.25)
    fields = _fields(_scene(2000, seed=8, device=card))
    grads = [torch.randn(2000, device=card) for _ in GRAD_FIELDS]
    _assert_equal(*_bwd_both(fields, _camera(card), grads, cfg=cfg,
                             z_near=0.5, z_far=120.0))


@pytest.mark.gpu
def test_kernel_equals_plain_vjp_on_unaligned_rows(card):
    """Inputs sliced at row 1: their rows start off 16 bytes, so the block
    takes its 4-byte loads."""
    scene = _scene(3001, seed=5, device=card)
    fields = SceneParams(*(t[1:] for t in _fields(scene)))
    assert fields.means.data_ptr() % 16
    _assert_equal(*_bwd_both(fields, _camera(card),
                             _grads(3000, seed=5, device=card)))


@pytest.mark.gpu
def test_kernel_equals_plain_vjp_at_main_path_size(card):
    """The benchmark's scene statistics at 3M gaussians of SH degree 3 at
    1237x822, three in four gaussians without a gradient; and a second run
    gives the same bits."""
    n = 3_000_000
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
        (2.5, 0.3, 0.4), (0, 0, 0), width=1237, height=822), card)
    fields = _fields(scene)
    grads = _grads(n, seed=7, device=card)
    keep = torch.rand(n, device=card) < 0.27
    grads = [None if g is None else torch.where(keep, g, 0.0)
             for g in grads]
    got, want = _bwd_both(fields, cam, grads)
    _assert_equal(got, want)
    again = projection.project_bwd(fields, cam, grads, RC, **KW)
    _assert_equal(again, got)


@pytest.mark.gpu
def test_grad_call_launches_each_kernel_once(card):
    """A grad-recording call on the card: one forward launch, and one
    backward launch when autograd runs it; its gradients are the plain
    VJP's of the gradients autograd hands over."""
    scene = _scene(4099, seed=13, device=card)
    fields = _fields(scene)
    leaves = SceneParams(*(t.clone().requires_grad_(True) for t in fields))
    cam = _camera(card)
    before = (projection.project.launches, projection.project_bwd.launches)
    out = projection.project(leaves, cam, W, H, RC, **KW)
    grads = _grads(4099, seed=13, device=card)
    loss = sum((getattr(out, f) * g).sum()
               for f, g in zip(GRAD_FIELDS, grads) if g is not None)
    got = torch.autograd.grad(loss, leaves)
    assert (projection.project.launches, projection.project_bwd.launches
            ) == (before[0] + 1, before[1] + 1)
    _assert_equal(got, projection._project_vjp_plain(
        fields, cam, RC, grads, sh_degree=None, **KW))
