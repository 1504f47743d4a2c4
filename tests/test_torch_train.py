"""The training slice of the PyTorch/CUDA port against the JAX package, on
the CPU.

The same numpy arrays, made from a seed, go to the JAX function and to its
counterpart in the port. JAX runs as its own tests run it on the CPU (Pallas
interpret mode, budgets from ``measure_budgets``); the port runs on
``device="cpu"``, where the blend's autograd Function takes the plain
versions of kernels B1, B2 and B3. Each test states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gsplat_tpu import config as jconfig
from gsplat_tpu.io import cameras as jcameras
from gsplat_tpu.io import synthetic as jsynthetic
from gsplat_tpu.models import densify as jdensify
from gsplat_tpu.models import losses as jlosses
from gsplat_tpu.models import trainer as jtrainer
from gsplat_tpu.render import api as japi
from gsplat_tpu.render import projection as jprojection
from gsplat_tpu.render import tiles as jtiles
from gsplat_tpu_torch import config as tconfig
from gsplat_tpu_torch.models import densify as tdensify
from gsplat_tpu_torch.models import losses as tlosses
from gsplat_tpu_torch.models import trainer as ttrainer
from gsplat_tpu_torch.render import api as tapi
from gsplat_tpu_torch.render import blend as tblend
from gsplat_tpu_torch.render import projection as tprojection
from gsplat_tpu_torch.render import tiles as ttiles
from gsplat_tpu_torch.scene import FIELDS, scene_from_numpy

torch.set_num_threads(2)

CPU = "cpu"
PARAM_FIELDS = ("means", "log_scales", "quats", "opacities", "sh")
# the default config, and test_render_pallas.py's tile_size=16, chunk=128
CONFIGS = {"default": (32, 64), "ts16_chunk128": (16, 128)}
EPS_DEFAULT = tconfig.RasterConfig().early_stop_eps
WIDTH, HEIGHT = 64, 48


def _cfgs(tile_size, chunk, eps=None):
    """The same configuration in both packages."""
    out = []
    for mod in (jconfig, tconfig):
        raster = mod.RasterConfig(tile_size=tile_size)
        if eps is not None:
            raster = dataclasses.replace(raster, early_stop_eps=eps)
        out.append(mod.Config(raster=raster, tiles=mod.TileConfig(chunk=chunk)))
    return tuple(out)


def _arrays(jscene):
    s = jscene.to_numpy()
    return {f: np.asarray(getattr(s, f)) for f in FIELDS}


def _port_scene(jscene, requires_grad=False):
    scene = scene_from_numpy(**_arrays(jscene), device=CPU)
    if requires_grad:
        for f in PARAM_FIELDS:
            getattr(scene, f).requires_grad_(True)
    return scene


def _scene(n=300, seed=31):
    """A dense tiny scene: 300 gaussians that cover a 64x48 view many
    layers deep, so that at tile 16, chunk 128 early stop at eps 1e-5 ends
    some tiles early."""
    return jsynthetic.random_scene(n, seed=seed, extent=1.0,
                                   scale_range=(0.2, 0.4), num_labels=5)


def _camera():
    return jcameras.look_at_camera((0.1, 0.2, -3.0), (0, 0, 0), width=WIDTH,
                                   height=HEIGHT)


def _rel_err(got, want):
    """Max abs error over the max abs of ``want`` (per last-axis column when
    2-D)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    axis = 0 if want.ndim == 2 else None
    return np.abs(got - want).max(axis=axis) / (
        np.abs(want).max(axis=axis) + 1e-30)


def _image_to_tiles(img, tx, ty, ts):
    """[H, W, C] numpy image -> [T, C, P] tile rows (zero outside)."""
    h, w, c = img.shape
    pad = np.zeros((ty * ts, tx * ts, c), img.dtype)
    pad[:h, :w] = img
    return pad.reshape(ty, ts, tx, ts, c).transpose(0, 2, 4, 1, 3).reshape(
        tx * ty, c, ts * ts)


# --- (a) the fold: JAX blend_scene_windows' VJP vs BlendSceneTiles --------

@pytest.fixture(scope="module", params=[(c, e) for c in CONFIGS
                                        for e in (0.0, EPS_DEFAULT)],
                ids=lambda p: f"{p[0]}-eps{p[1]}")
def fold_frame(request):
    """One projected frame carried across, with the JAX VJP of the window
    blend under a seeded random cotangent."""
    cfg_name, eps = request.param
    ts, chunk = CONFIGS[cfg_name]
    jcfg, tcfg = _cfgs(ts, chunk, eps=eps)
    js = _scene()
    cam = _camera()
    rc = jcfg.raster
    jproj = jprojection.project(js, jprojection.CameraParams.from_camera(cam),
                                WIDTH, HEIGHT, rc)
    tx, ty = jprojection.tile_grid(WIDTH, HEIGHT, ts)
    budget = jtiles.bucket_budget(int(jtiles.count_instances(
        jproj, tiles_x=tx, tiles_y=ty, tile_size=ts)), chunk)
    jb = jtiles.bin_windows(jproj, tiles_x=tx, tiles_y=ty, tile_size=ts,
                            chunk=chunk, budget=budget, interpret=True)
    labels = _arrays(js)["labels"]
    jptab = japi.pack_table(jproj, jnp.asarray(labels))
    rng = np.random.default_rng(7)
    drgb = rng.normal(size=(HEIGHT, WIDTH, 3)).astype(np.float32)
    dtrans = rng.normal(size=(HEIGHT, WIDTH)).astype(np.float32)
    g = np.zeros((tx * ty, 8, ts * ts), np.float32)
    g[:, 0:3] = _image_to_tiles(drgb, tx, ty, ts)
    g[:, 3] = _image_to_tiles(dtrans[..., None], tx, ty, ts)[:, 0]

    def blend(pt):
        return japi.blend_scene_windows(
            pt, jb.inst_gauss, jb.win_tile, jb.win_first, jb.win_start,
            jb.win_off, jb.win_len, jb.win_rcg, jb.enum_kernel_row,
            jb.enum_start, jb.enum_cnt, chunk, 1, ts, tx, tx * ty,
            rc.alpha_min, rc.alpha_max, False, True, eps)

    out, vjp = jax.vjp(blend, jptab)
    (dptab,) = vjp(jnp.asarray(g))
    return dict(jproj=jproj, labels=labels, tx=tx, ty=ty, ts=ts,
                chunk=chunk, eps=eps, rc=rc, drgb=drgb, dtrans=dtrans,
                out=np.asarray(out), dptab=np.asarray(dptab))


def _port_proj(jproj):
    return tprojection.Projected(*(torch.from_numpy(np.array(f))
                                   for f in jproj))


def test_fold_matches_jax_vjp(fold_frame):
    f = fold_frame
    proj = _port_proj(f["jproj"])
    b = ttiles.bin_tiles(proj, tiles_x=f["tx"], tiles_y=f["ty"],
                         tile_size=f["ts"])
    assert b.enum_start.shape == b.enum_cnt.shape == proj.u.shape
    ptab = tapi.pack_table(proj, torch.from_numpy(f["labels"]))
    ptab.requires_grad_(True)
    rc = f["rc"]
    settings = tapi.BlendSettings(
        tiles_x=f["tx"], tiles_y=f["ty"], tile_size=f["ts"], width=WIDTH,
        height=HEIGHT, chunk=f["chunk"], alpha_min=rc.alpha_min,
        alpha_max=rc.alpha_max, early_eps=f["eps"])
    out = tapi.blend_scene_tiles(ptab, b, settings)
    torch.autograd.backward(
        [out.rgb, out.transmittance],
        [torch.from_numpy(f["drgb"]), torch.from_numpy(f["dtrans"])])
    got = ptab.grad.numpy()
    want = f["dptab"]
    assert (out.transmittance < 0.5).float().mean() > 0.9
    assert np.abs(want[:, :9]).max(axis=0).min() > 0
    assert not got[:, 9:].any()
    # eps 0: both walk every instance, and differ by association only
    # (cumprod vs sequential T, reduction and cumsum order): 1e-4 of each
    # column's peak (measured ~5e-6). At the default eps the two packages
    # test the tile's max T at points up to 7 instances apart, so an
    # instance composited by one and not the other moves its gaussian's row
    # by O(eps): 1e-3.
    bar = 1e-4 if f["eps"] == 0.0 else 1e-3
    err = _rel_err(got[:, :9], want[:, :9])
    assert err.max() <= bar, err


# --- (b) scene gradients: jax.grad through render vs autograd ------------

@pytest.mark.parametrize("eps", [0.0, EPS_DEFAULT], ids=["eps0", "epsdef"])
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_scene_gradients_match_jax(cfg_name, eps):
    jcfg, tcfg = _cfgs(*CONFIGS[cfg_name], eps=eps)
    js = _scene(seed=41)
    cam = _camera()
    rng = np.random.default_rng(3)
    target = rng.uniform(size=(HEIGHT, WIDTH, 3)).astype(np.float32)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    bu, kb, nw = japi.measure_budgets(js, cam, jcfg)

    def jloss(s):
        out = japi.render(s, cam, jcfg, background=jnp.asarray(bg),
                          budget=bu, kernel_budget=kb, num_windows=nw,
                          interpret=True)
        return 0.5 * jnp.sum((out["image"] - target) ** 2)

    jgrads = jax.grad(jloss, allow_int=True)(js)
    scene = _port_scene(js, requires_grad=True)
    out = tapi.render(scene, cam, tcfg, background=bg, device=CPU)
    loss = 0.5 * torch.sum((out["image"] - torch.from_numpy(target)) ** 2)
    loss.backward()
    # eps 0: 1e-4 of each tensor's peak (PARITY_TPU.json's bar is 1e-3;
    # measured ~3e-6); the default eps adds the O(eps) rows of the fold
    # test: 1e-3
    bar = 1e-4 if eps == 0.0 else 1e-3
    for f in PARAM_FIELDS:
        want = np.asarray(getattr(jgrads, f))
        got = getattr(scene, f).grad.numpy()
        assert np.isfinite(got).all(), f
        assert np.abs(want).max() > 0, f
        err = float(_rel_err(got.ravel(), want.ravel()))
        assert err <= bar, (f, err)


# --- (c) B2's plain version vs autograd through B1's plain version --------

@pytest.mark.parametrize("eps", [0.0, EPS_DEFAULT, 0.05])
def test_blend_bwd_plain_matches_autograd(eps):
    js = _scene(seed=51)
    scene = _port_scene(js)
    cam = _camera()
    ts, chunk = 16, 8
    proj = tprojection.project(
        scene, tprojection.CameraParams.from_camera(cam, CPU), WIDTH,
        HEIGHT, tconfig.RasterConfig(tile_size=ts))
    tx, ty = tprojection.tile_grid(WIDTH, HEIGHT, ts)
    b = ttiles.bin_tiles(proj, tiles_x=tx, tiles_y=ty, tile_size=ts)
    ptab = tapi.pack_table(proj, scene.labels)
    kw = dict(tiles_x=tx, tiles_y=ty, tile_size=ts, width=WIDTH,
              height=HEIGHT, chunk=chunk, alpha_min=1 / 255,
              alpha_max=0.999, early_eps=eps)
    rng = np.random.default_rng(11)
    drgb = torch.from_numpy(rng.normal(size=(HEIGHT, WIDTH, 3))
                            .astype(np.float32))
    dtrans = torch.from_numpy(rng.normal(size=(HEIGHT, WIDTH))
                              .astype(np.float32))
    leaf = ptab.clone().requires_grad_(True)
    out = tblend._blend_tiles_fwd_plain(leaf, b.inst_gauss, b.tile_bounds,
                                        **kw, with_labels=False)
    torch.autograd.backward([out.rgb, out.transmittance], [drgb, dtrans])
    fwd = tblend.blend_tiles_fwd(ptab, b.inst_gauss, b.tile_bounds, **kw,
                                 with_labels=False)
    drows = tblend.blend_tiles_bwd(
        ptab, b.inst_gauss, b.tile_bounds, fwd.rgb,
        fwd.transmittance.contiguous(), drgb, dtrans, **kw)
    got = tapi.fold_instance_rows(drows, b.je_sorted, b.enum_start,
                                  b.enum_cnt)
    want = leaf.grad
    # an independent derivation of the same gradient: they differ by the
    # association of the per-pixel sums only, ~1e-6 of each column's peak
    err = _rel_err(got[:, :9].numpy(), want[:, :9].numpy())
    assert err.max() <= 1e-5, err
    assert not got[:, 9:].any()
    # rows past the tight count (filtered slots) are zero
    tight = int(b.num_instances)
    assert not drows[tight:].any()
    if eps == 0.05:   # early stop skipped instances, whose rows are zero
        assert (~drows[:tight].any(dim=1)).sum() > 0


# --- (d) B3's plain version vs float64 -------------------------------------

@pytest.mark.parametrize("rows", [1, 511, 1500])
def test_cumsum_rows_plain_matches_float64(rows):
    x = np.random.default_rng(rows).normal(
        0.1, 1.0, size=(rows, 16)).astype(np.float32)
    want = np.cumsum(x.astype(np.float64), axis=0)
    before = tblend.cumsum_rows.launches
    got = tblend.cumsum_rows(torch.from_numpy(x)).numpy()
    assert tblend.cumsum_rows.launches == before   # no kernel on the CPU
    # f32 running sums of <= 1500 terms: 1e-6 of the column's peak prefix
    assert (np.abs(got - want).max(0) / np.abs(want).max(0)).max() <= 1e-6
    np.testing.assert_array_equal(tblend._cumsum_rows_plain(
        torch.from_numpy(x)).numpy(), got)


# --- (e) losses and their gradients ---------------------------------------

@pytest.mark.parametrize("name", ["l1", "l2", "psnr", "ssim", "dssim_l1"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(32, 40, 3)).astype(np.float32)
    tgt = np.clip(img + rng.normal(0, 0.1, size=img.shape), 0, 1).astype(
        np.float32)
    jf = {"l1": jlosses.l1_loss, "l2": jlosses.l2_loss, "psnr": jlosses.psnr,
          "ssim": jlosses.ssim, "dssim_l1": jlosses.dssim_l1_loss}[name]
    tf = {"l1": tlosses.l1_loss, "l2": tlosses.l2_loss, "psnr": tlosses.psnr,
          "ssim": tlosses.ssim, "dssim_l1": tlosses.dssim_l1_loss}[name]
    jv, jg = jax.value_and_grad(lambda a: jf(a, jnp.asarray(tgt)))(
        jnp.asarray(img))
    x = torch.from_numpy(img).requires_grad_(True)
    tv = tf(x, torch.from_numpy(tgt))
    tv.backward()
    # f32 sums in another order (the blur: shifted products vs XLA's
    # convolution): 1e-5 relative on the value, 1e-4 of the gradient's peak
    assert abs(float(tv) - float(jv)) <= 1e-5 * max(abs(float(jv)), 1.0)
    assert float(_rel_err(x.grad.numpy(), np.asarray(jg))) <= 1e-4
    if name == "ssim":
        assert float(tlosses.ssim(x.detach(), x.detach())) == pytest.approx(
            1.0, abs=1e-5)
    if name == "l2":
        assert ttrainer.get_loss_fn("l2") is ttrainer.l2_loss


# --- (f) scaled Adam vs optax ----------------------------------------------

def _params_np(n, seed):
    rng = np.random.default_rng(seed)
    shapes = dict(means=(n, 3), log_scales=(n, 3), quats=(n, 4),
                  opacities=(n,), sh=(n, 4, 3))
    return {f: rng.normal(size=shapes[f]).astype(np.float32)
            for f in PARAM_FIELDS}


@pytest.mark.parametrize("decay", [False, True], ids=["const", "decay"])
def test_scaled_adam_matches_optax(decay):
    kw = dict(lr_final=0.002, decay_steps=4) if decay else {}
    p0 = _params_np(50, 1)
    jp = jtrainer.SceneParams(**{f: jnp.asarray(v) for f, v in p0.items()})
    tp = ttrainer.SceneParams(**{f: torch.from_numpy(v.copy())
                                 for f, v in p0.items()})
    jopt = jtrainer.scaled_adam(0.05, **kw)
    topt = ttrainer.scaled_adam(0.05, **kw)
    jst, tst = jopt.init(jp), topt.init(tp)
    for step in range(5):    # step 4 is past decay_steps: the rate holds
        g = _params_np(50, 100 + step)
        jg = jtrainer.SceneParams(**{f: jnp.asarray(v) for f, v in g.items()})
        tg = ttrainer.SceneParams(**{f: torch.from_numpy(v)
                                     for f, v in g.items()})
        upd, jst = jopt.update(jg, jst, jp)
        jp = optax.apply_updates(jp, upd)
        tp, tst = topt.update(tg, tst, tp)
        for f in PARAM_FIELDS:
            # the same f32 operations; pow and sqrt may differ by an ulp
            np.testing.assert_allclose(getattr(tp, f).numpy(),
                                       np.asarray(getattr(jp, f)),
                                       rtol=1e-6, atol=1e-7, err_msg=f)
    assert tst.count == int(jst[0].count) == 5
    np.testing.assert_allclose(tst.mu.sh.numpy(), np.asarray(jst[0].mu.sh),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tst.nu.quats.numpy(),
                               np.asarray(jst[0].nu.quats), rtol=1e-6,
                               atol=1e-9)


# --- (g) zero_adam_rows ----------------------------------------------------

@pytest.mark.parametrize("fields", [None, ("opacities",)])
def test_zero_adam_rows_matches_jax(fields):
    p0 = _params_np(20, 2)
    jp = jtrainer.SceneParams(**{f: jnp.asarray(v) for f, v in p0.items()})
    ones = jax.tree_util.tree_map(
        lambda a: (jnp.ones_like(a) if jnp.issubdtype(a.dtype, jnp.floating)
                   else a), jtrainer.scaled_adam().init(jp))
    mask = np.zeros(20, bool)
    mask[[0, 3, 4, 19]] = True
    jout = jtrainer.zero_adam_rows(ones, jnp.asarray(mask), fields=fields)
    tp = ttrainer.SceneParams(**{f: torch.from_numpy(v)
                                 for f, v in p0.items()})
    tst = ttrainer.scaled_adam().init(tp)
    tst = tst._replace(
        mu=ttrainer.SceneParams(*(torch.ones_like(t) for t in tst.mu)),
        nu=ttrainer.SceneParams(*(torch.ones_like(t) for t in tst.nu)))
    tout = ttrainer.zero_adam_rows(tst, torch.from_numpy(mask),
                                   fields=fields)
    for f in PARAM_FIELDS:
        for mom in ("mu", "nu"):
            want = np.asarray(getattr(getattr(jout[0], mom), f))
            np.testing.assert_array_equal(
                getattr(getattr(tout, mom), f).numpy(), want,
                err_msg=f"{mom}.{f}")
            assert (want == 0).any() == (fields is None or f in fields)


# --- (h) densify, prune and opacity reset ---------------------------------

def test_densify_and_prune_matches_jax():
    js = jsynthetic.random_scene(96, seed=3, extent=1.0,
                                 scale_range=(0.005, 0.05), num_labels=4)
    jparams, jlabels = jdensify.pad_to_capacity(
        jtrainer.SceneParams.from_scene(js), js.labels, 128)
    a = _arrays(js)
    tparams, tlabels = tdensify.pad_to_capacity(
        ttrainer.SceneParams(**{f: torch.from_numpy(a[f])
                                for f in PARAM_FIELDS}),
        torch.from_numpy(a["labels"]), 128)
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(tparams, f).numpy(),
                                      np.asarray(getattr(jparams, f)))
    np.testing.assert_array_equal(tlabels.numpy(), np.asarray(jlabels))
    # prune 6 (transparent) and 2 (oversized); 60 hot candidates for 40 free
    # slots, with ties in the gradient so the stable sorts matter
    rng = np.random.default_rng(9)
    op = np.asarray(jparams.opacities).copy()
    op[:6] = -8.0
    ls = np.asarray(jparams.log_scales).copy()
    ls[6:8] = np.log(0.5)
    accum = np.zeros(128, np.float32)
    accum[10:70] = rng.choice([1e-3, 2e-3, 3e-3], size=60)
    count = np.where(np.arange(128) < 96, 2.0, 0.0).astype(np.float32)
    jparams = jparams._replace(opacities=jnp.asarray(op),
                               log_scales=jnp.asarray(ls))
    tparams = tparams._replace(opacities=torch.from_numpy(op),
                               log_scales=torch.from_numpy(ls))
    cfg = dict(grad_threshold=2e-4, percent_dense=0.02)
    key = jax.random.PRNGKey(4)
    jout, jlab, jstats, jwritten = jdensify.densify_and_prune(
        jparams, jlabels, jdensify.DensifyStats(jnp.asarray(accum),
                                                jnp.asarray(count)),
        key, 1.0, jdensify.DensifyConfig(**cfg))
    noise = np.asarray(jax.random.normal(key, (128, 3)))
    tout, tlab, tstats, twritten = tdensify.densify_and_prune(
        tparams, tlabels, tdensify.DensifyStats(torch.from_numpy(accum),
                                                torch.from_numpy(count)),
        None, 1.0, tdensify.DensifyConfig(**cfg),
        noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(twritten.numpy(), np.asarray(jwritten))
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    assert int(tdensify.num_alive(tout)) == int(jdensify.num_alive(jout))
    # all 40 free slots (32 dead, 8 pruned) take a candidate
    assert int(twritten.sum()) == 40 and not tstats.grad_accum.any()
    # means within 1e-6 (the split offset is a 3x3 product written out
    # elementwise vs an einsum); the rest is copied or shifted by one f32
    np.testing.assert_allclose(tout.means.numpy(), np.asarray(jout.means),
                               atol=1e-6)
    for f in ("log_scales", "quats", "opacities", "sh"):
        np.testing.assert_allclose(getattr(tout, f).numpy(),
                                   np.asarray(getattr(jout, f)), atol=1e-6,
                                   err_msg=f)
    jr, jchanged = jdensify.reset_opacities(jout, value=0.02)
    tr, tchanged = tdensify.reset_opacities(tout, value=0.02)
    np.testing.assert_array_equal(tchanged.numpy(), np.asarray(jchanged))
    np.testing.assert_allclose(tr.opacities.numpy(),
                               np.asarray(jr.opacities), atol=1e-6)


# --- (i) the train steps ---------------------------------------------------

def _train_setup():
    js = _scene(n=200, seed=61)
    cams = [_camera(), jcameras.look_at_camera((0.4, -0.1, -3.0), (0, 0, 0),
                                               width=WIDTH, height=HEIGHT)]
    rng = np.random.default_rng(13)
    targets = rng.uniform(0.2, 0.6, size=(2, HEIGHT, WIDTH, 3)).astype(
        np.float32)
    return js, cams, targets


def _port_grads(js, cams, targets, cfg, loss="l2"):
    """|d loss / d param| of the port's mean loss over views at the initial
    scene."""
    scene = _port_scene(js, requires_grad=True)
    total = 0.0
    for cam, target in zip(cams, targets):
        out = tapi.render(scene, cam, cfg, device=CPU)
        total = total + ttrainer.get_loss_fn(loss)(
            out["image"], torch.from_numpy(target))
    (total / len(cams)).backward()
    return {f: getattr(scene, f).grad.abs().numpy() for f in PARAM_FIELDS}


def _compare_params(tparams, jparams, grads, lr):
    """Parameters where |grad| > 1e-3 of its peak agree within 1% of one
    Adam step (lr x the field's scale; measured <= 0.06%); elsewhere the
    gradient is rounding noise, and Adam's first update, about
    lr * sign(g), flips freely."""
    for f in PARAM_FIELDS:
        got = getattr(tparams, f).detach().numpy()
        want = np.asarray(getattr(jparams, f))
        mask = grads[f] > 1e-3 * grads[f].max()
        assert mask.sum() > 0, f
        err = np.abs(got - want)[mask].max()
        assert err <= 0.01 * lr * ttrainer.LR_SCALES[f], (f, err)


def test_train_step_tracks_jax():
    jcfg, tcfg = _cfgs(32, 64)
    js, cams, targets = _train_setup()
    cam = cams[0]
    lr = 0.01
    bu, kb, nw = japi.measure_budgets(js, cam, jcfg)
    jstep = jtrainer.make_train_step((WIDTH, HEIGHT), jcfg, lr=lr,
                                     lr_final=lr / 10, decay_steps=3,
                                     budget=bu, kernel_budget=kb,
                                     num_windows=nw, interpret=True)
    tstep = ttrainer.make_train_step((WIDTH, HEIGHT), tcfg, lr=lr,
                                     lr_final=lr / 10, decay_steps=3,
                                     budget=bu)
    jstate = jtrainer.init_state(js, lr=lr, lr_final=lr / 10, decay_steps=3)
    tscene = _port_scene(js)
    tstate = ttrainer.init_state(tscene, lr=lr, lr_final=lr / 10,
                                 decay_steps=3)
    jcam = jprojection.CameraParams.from_camera(cam)
    tcam = tprojection.CameraParams.from_camera(cam, CPU)
    bg = np.zeros(3, np.float32)
    jl, tl = [], []
    for _ in range(3):
        jstate, jloss, jnd = jstep(jstate, js.labels, jcam,
                                   jnp.asarray(targets[0]), jnp.asarray(bg))
        tstate, tloss, tnd = tstep(tstate, tscene.labels, tcam,
                                   torch.from_numpy(targets[0]),
                                   torch.from_numpy(bg))
        assert int(jnd) == 0 == int(tnd)
        jl.append(float(jloss))
        tl.append(float(tloss))
    # the loss curve within 1e-4 relative; it falls
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    assert tstate.step == 3 and tstate.opt_state.count == 3
    _compare_params(tstate.params, jstate.params,
                    _port_grads(js, [cam], targets[:1], tcfg), lr)


@pytest.mark.parametrize("kind", ["multiview", "adaptive",
                                  "adaptive_multiview"])
def test_other_train_steps_track_jax(kind):
    jcfg, tcfg = _cfgs(32, 64)
    js, cams, targets = _train_setup()
    lr = 0.01
    multiview = kind.endswith("multiview")
    adaptive = kind.startswith("adaptive")
    name = {"multiview": "make_multiview_train_step",
            "adaptive": "make_adaptive_train_step",
            "adaptive_multiview": "make_adaptive_multiview_train_step"}[kind]
    if multiview:
        bu, kb, nw = japi.measure_budgets_multi(js, cams, jcfg)
        jcams = jtrainer.stack_cameras(
            [jprojection.CameraParams.from_camera(c) for c in cams])
        tcams = ttrainer.stack_cameras(
            [tprojection.CameraParams.from_camera(c, CPU) for c in cams])
        jtgt, ttgt = jnp.asarray(targets), torch.from_numpy(targets)
    else:
        bu, kb, nw = japi.measure_budgets(js, cams[0], jcfg)
        jcams = jprojection.CameraParams.from_camera(cams[0])
        tcams = tprojection.CameraParams.from_camera(cams[0], CPU)
        jtgt, ttgt = jnp.asarray(targets[0]), torch.from_numpy(targets[0])
    loss = "l1" if kind == "adaptive" else "l2"
    jstep = getattr(jtrainer, name)((WIDTH, HEIGHT), jcfg, lr=lr, budget=bu,
                                    kernel_budget=kb, num_windows=nw,
                                    interpret=True, loss=loss)
    tstep = getattr(ttrainer, name)((WIDTH, HEIGHT), tcfg, lr=lr, loss=loss)
    jstate = jtrainer.init_state(js, lr=lr)
    tscene = _port_scene(js)
    tstate = ttrainer.init_state(tscene, lr=lr)
    bg = np.zeros(3, np.float32)
    n = js.num_gaussians
    if adaptive:
        jstate, jstats, jloss, jnd = jstep(
            jstate, jdensify.DensifyStats.zeros(n), js.labels, jcams, jtgt,
            jnp.asarray(bg))
        tstate, tstats, tloss, tnd = tstep(
            tstate, tdensify.DensifyStats.zeros(n, device=CPU),
            tscene.labels, tcams, ttgt, torch.from_numpy(bg))
        # the visible count is |grad| > 0, so a gaussian whose only pixel
        # sits on the alpha_min cut may count in one package alone: <= 1%
        assert (tstats.count.numpy() != np.asarray(jstats.count)).mean() <= 0.01
        assert tstats.count.sum() > 0
        g = np.asarray(jstats.grad_accum)
        assert float(_rel_err(tstats.grad_accum.numpy(), g)) <= 1e-3
    else:
        jstate, jloss, jnd = jstep(jstate, js.labels, jcams, jtgt,
                                   jnp.asarray(bg))
        tstate, tloss, tnd = tstep(tstate, tscene.labels, tcams, ttgt,
                                   torch.from_numpy(bg))
    assert int(jnd) == 0 == int(tnd)
    assert abs(float(tloss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    views = len(cams) if multiview else 1
    _compare_params(tstate.params, jstate.params,
                    _port_grads(js, cams[:views], targets[:views], tcfg,
                                loss), lr)


def test_train_step_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ttrainer.make_train_step((WIDTH, HEIGHT), mesh=object())
