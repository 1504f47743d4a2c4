"""Differentiable splat training: photometric loss + Adam over scene params.

Counterpart of ``gsplat_tpu.models.trainer`` on one device, with the same
names and call signatures, so a test drives both the same way. Gradients
come from torch autograd through the renderer, whose blend and projection
are each one ``torch.autograd.Function``: the blend
(``render/api.py::BlendSceneTiles``) kernel B1 forward, B2 and the fold
(``csrc/fold_rows.cu``) backward on the card; the projection and SH
(``render/projection.py::project``) ``csrc/project.cu`` forward and
``csrc/project_bwd.cu`` backward on the card; their plain versions (and
autograd through the plain projection) on the CPU. A step runs on the
device its state lies on. Under a profiler a step's stages are spans
(``utils/profiling.py::span``): the render's own, then ``gsplat.loss`` (the
photometric loss), ``gsplat.backward`` (``torch.autograd.grad`` and the
gradients' sum, on the calling thread; B2, the fold and the projection's
backward open ``gsplat.blend_bwd``, ``gsplat.fold`` and
``gsplat.project_bwd`` on autograd's thread) and ``gsplat.adam``.

The optimizer is a small hand-written Adam over the five parameter tensors,
step for step the JAX package's ``optax.chain(scale_by_adam(), per-field
LR_SCALES, scale_by_schedule(sched))``: its moments are plain tensors, so
``zero_adam_rows`` is a masked write.

With ``mesh=`` the step builders render through
``parallel/render_sharded.py`` (gaussians over the mesh's shards,
interleaved tiles, the overlap-culled exchange with the gradient's
return), as ``gsplat_tpu/models/trainer.py:183-196`` does. The state is
then sharded (``parallel/mesh.py::Sharded``): ``init_state`` of a
``ShardedScene`` keeps each shard's parameters and Adam moments on its
shard's device, the labels are the scene's ``.labels`` and the densify
statistics ``shard_rows(DensifyStats.zeros(C), mesh)``. Adam works row by
row, so the update needs no collective.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gsplat_tpu_torch.config import Config, DEFAULT
from gsplat_tpu_torch.models import losses
from gsplat_tpu_torch.parallel.mesh import (Mesh, Sharded, ShardedScene,
                                            per_shard)
from gsplat_tpu_torch.parallel.render_sharded import render_sharded
from gsplat_tpu_torch.render.api import _render_impl
from gsplat_tpu_torch.render.projection import CameraParams
from gsplat_tpu_torch.scene import (DeviceLike, GaussianScene, SceneParams,
                                   resolve_device)
from gsplat_tpu_torch.utils.profiling import span

# Standard 3DGS-style per-parameter learning-rate scaling.
LR_SCALES = dict(means=1.0, log_scales=0.05, quats=0.01, opacities=0.5,
                 sh=0.025)

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


class AdamState(NamedTuple):
    """Adam moments per field and the update count (the count both the bias
    correction and the learning-rate schedule read)."""

    count: int
    mu: SceneParams
    nu: SceneParams


class TrainState(NamedTuple):
    params: SceneParams
    opt_state: AdamState
    step: int


class ScaledAdam(NamedTuple):
    """Adam with per-field lr scaling (LR_SCALES) and, with ``lr_final``
    and ``decay_steps``, an exponential decay of the rate from ``lr`` to
    ``lr_final`` over ``decay_steps`` updates."""

    lr: float
    lr_final: Optional[float] = None
    decay_steps: Optional[int] = None

    def init(self, params: SceneParams) -> AdamState:
        """Zero moments (sharded as ``params`` is)."""
        zeros = lambda: per_shard(lambda p: SceneParams(
            *(torch.zeros_like(t) for t in p)), params)
        return AdamState(0, zeros(), zeros())

    def step_size(self, count: int) -> float:
        """The schedule at update ``count`` (0 for the first update, as
        ``optax.scale_by_schedule`` counts), in f32."""
        lr = np.float32(self.lr)
        if self.lr_final is None or not self.decay_steps:
            return float(-lr)
        t = np.clip(np.float32(count) / np.float32(self.decay_steps),
                    np.float32(0.0), np.float32(1.0))
        ratio = np.float32(self.lr_final / self.lr)
        return float(-lr * ratio ** t)

    @torch.no_grad()
    def update(self, grads: SceneParams, state: AdamState,
               params: SceneParams) -> Tuple[SceneParams, AdamState]:
        """(new params, new state) after one update with ``grads``; shard
        by shard when they are sharded (Adam is per row)."""
        count_inc = state.count + 1
        bc1 = float(1 - np.float32(ADAM_B1) ** np.float32(count_inc))
        bc2 = float(1 - np.float32(ADAM_B2) ** np.float32(count_inc))
        step = self.step_size(state.count)

        def rows(params, grads, mu, nu):
            mus, nus, news = [], [], []
            for f, g, m, v, p in zip(SceneParams._fields, grads, mu, nu,
                                     params):
                m = (1 - ADAM_B1) * g + ADAM_B1 * m
                v = (1 - ADAM_B2) * (g * g) + ADAM_B2 * v
                u = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
                news.append(p + step * (u * LR_SCALES[f]))
                mus.append(m)
                nus.append(v)
            return (SceneParams(*news), SceneParams(*mus),
                    SceneParams(*nus))

        with span("gsplat.adam"):
            news, mus, nus = per_shard(rows, params, grads, state.mu,
                                       state.nu)
        return news, AdamState(count_inc, mus, nus)


def scaled_adam(lr: float = 1e-2, *, lr_final: Optional[float] = None,
                decay_steps: Optional[int] = None) -> ScaledAdam:
    """Adam with per-field lr scaling (LR_SCALES); see :class:`ScaledAdam`.
    The schedule is constant without ``lr_final``/``decay_steps``."""
    return ScaledAdam(lr, lr_final, decay_steps)


def init_state(scene: GaussianScene, lr: float = 1e-2,
               lr_final: Optional[float] = None,
               decay_steps: Optional[int] = None) -> TrainState:
    """A fresh state of ``scene``'s parameters, sharded if the scene is (a
    ``ShardedScene``)."""
    params = per_shard(SceneParams.from_scene, scene)
    opt = scaled_adam(lr, lr_final=lr_final, decay_steps=decay_steps)
    return TrainState(params, opt.init(params), 0)


def state_from_numpy(params, m, v, step: int,
                     device: DeviceLike = None) -> TrainState:
    """The weights carry-across of a training state: ``params``, ``m`` and
    ``v`` are the five fields' arrays, in ``SceneParams`` order, of a JAX
    ``TrainState``'s parameters and Adam moments, ``step`` its step; the
    port's ``TrainState`` with the same bits, whose Adam count is ``step``
    (one update a step, as in the JAX package)."""
    device = resolve_device(device)

    def tensors(arrays) -> SceneParams:
        return SceneParams(*(torch.from_numpy(np.array(a, np.float32))
                             .to(device) for a in arrays))

    step = int(step)
    return TrainState(tensors(params), AdamState(step, tensors(m),
                                                 tensors(v)), step)


def zero_adam_rows(opt_state: AdamState, mask: torch.Tensor,
                   fields=None) -> AdamState:
    """Zero the Adam first and second moments at slots where ``mask`` is
    True, for every field or only the named ``fields`` (e.g.
    ``("opacities",)`` after an opacity reset).

    Used after ``densify.densify_and_prune`` / ``densify.reset_opacities``:
    rewritten slots must not inherit the previous occupant's moments. A
    sharded state takes the sharded mask those return."""
    names = SceneParams._fields if fields is None else tuple(fields)

    def z(mask: torch.Tensor, moments: SceneParams) -> SceneParams:
        out = {}
        for f in names:
            t = getattr(moments, f)
            m = mask.reshape((mask.shape[0],) + (1,) * (t.dim() - 1))
            out[f] = torch.where(m, torch.zeros((), device=t.device), t)
        return moments._replace(**out)

    mu, nu = per_shard(lambda m, a, b: (z(m, a), z(m, b)), mask,
                       opt_state.mu, opt_state.nu)
    return opt_state._replace(mu=mu, nu=nu)


def l2_loss(image: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.mean((image - target) ** 2)


def get_loss_fn(name: str):
    """'l2' | 'l1' | 'dssim_l1' (the standard 3DGS objective)."""
    return {"l2": l2_loss, "l1": losses.l1_loss,
            "dssim_l1": losses.dssim_l1_loss}[name]


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a gsplat_tpu_torch.parallel.mesh.Mesh")


def _view(cams: CameraParams, i: int) -> CameraParams:
    return CameraParams(*(getattr(cams, f)[i] for f in CameraParams._fields))


def _grads(params: SceneParams, labels, views, photometric, *, width,
           height, cfg, mesh) -> Tuple[SceneParams, torch.Tensor,
                                       torch.Tensor]:
    """(grads, mean loss, max num_dropped) over ``views``, a list of
    (cam, target, bg). Each view is rendered and differentiated on its own
    and the gradients summed, so one view's graph is alive at a time. With
    ``mesh`` the parameters and labels are sharded and so are the grads;
    the loss is whole on ``mesh.home``, the same on every process."""
    shards = list(params) if mesh is not None else [params]
    labs = list(labels) if mesh is not None else [labels]
    leaves = [SceneParams(*(p.detach().requires_grad_(True) for p in sp))
              for sp in shards]
    scenes = [lv.to_scene(lab) for lv, lab in zip(leaves, labs)]
    flat = [p for lv in leaves for p in lv]
    grads = [torch.zeros_like(p) for p in flat]
    home = flat[0].device
    total = torch.zeros((), device=home)
    dropped = torch.zeros((), dtype=torch.int32, device=home)
    nv = len(views)
    for cam, target, bg in views:
        if mesh is None:
            out = _render_impl(scenes[0], cam, bg, width=width,
                               height=height, cfg=cfg, with_labels=False)
            img, nd = out["image"], out["num_dropped"]
        else:
            img, nd = render_sharded(
                ShardedScene(scenes, mesh), cam, mesh, width=width,
                height=height, cfg=cfg, background=bg, with_dropped=True)
        h = min(img.shape[0], target.shape[0])
        with span("gsplat.loss"):
            loss = photometric(img[:h], target[:h])
        with span("gsplat.backward"):
            gs = torch.autograd.grad(loss / nv, flat)
            for acc, g in zip(grads, gs):
                acc += g
        total = total + loss.detach()
        dropped = torch.maximum(dropped, nd)
    k = len(SceneParams._fields)
    out = [SceneParams(*grads[i * k:(i + 1) * k]) for i in range(len(leaves))]
    return (Sharded(out, mesh) if mesh is not None else out[0],
            total / nv, dropped)


def _make_step(width, height, cfg, lr, lr_final, decay_steps, loss,
               multiview: bool, adaptive: bool, mesh):
    _check_mesh(mesh)
    opt = scaled_adam(lr, lr_final=lr_final, decay_steps=decay_steps)
    photometric = get_loss_fn(loss)

    def views_of(cams, targets, bg):
        if not multiview:
            return [(cams, targets, bg)]
        return [(_view(cams, i), targets[i], bg)
                for i in range(targets.shape[0])]

    def run(state: TrainState, labels, cams, targets, bg):
        grads, loss_v, nd = _grads(state.params, labels,
                                   views_of(cams, targets, bg), photometric,
                                   width=width, height=height, cfg=cfg,
                                   mesh=mesh)
        params, opt_state = opt.update(grads, state.opt_state, state.params)
        return TrainState(params, opt_state, state.step + 1), grads, loss_v, nd

    if adaptive:
        def train_step(state: TrainState, stats, labels, cams, targets, bg):
            state, grads, loss_v, nd = run(state, labels, cams, targets, bg)
            return (state, per_shard(lambda s, g: s.update(g), stats, grads),
                    loss_v, nd)
    else:
        def train_step(state: TrainState, labels, cams, targets, bg):
            state, _, loss_v, nd = run(state, labels, cams, targets, bg)
            return state, loss_v, nd
    return train_step


def make_train_step(
    camera_static: Tuple[int, int],
    cfg: Config = DEFAULT,
    *,
    lr: float = 1e-2,
    lr_final: Optional[float] = None,
    decay_steps: Optional[int] = None,
    budget: Optional[int] = None,
    kernel_budget: Optional[int] = None,
    num_windows: Optional[int] = None,
    mesh=None,
    budget_per_device: Optional[int] = None,
    interpret: Optional[bool] = None,
    loss: str = "l2",
    exchange_capacity: Optional[int] = None,
):
    """Build a train step:
    (state, labels, cam, target, bg) -> (state, loss, num_dropped).

    The budget arguments, ``exchange_capacity`` and ``interpret`` are
    accepted and ignored: the port sizes its buffers from exact counts, so
    ``num_dropped`` is 0. With ``mesh`` the render is the sharded one and
    the state sharded (module docstring); ``cam`` and ``target`` lie on
    ``mesh.home``."""
    del budget, kernel_budget, num_windows, budget_per_device, interpret
    del exchange_capacity
    width, height = camera_static
    return _make_step(width, height, cfg, lr, lr_final, decay_steps, loss,
                      multiview=False, adaptive=False, mesh=mesh)


def make_multiview_train_step(
    camera_static: Tuple[int, int],
    cfg: Config = DEFAULT,
    *,
    lr: float = 1e-2,
    lr_final: Optional[float] = None,
    decay_steps: Optional[int] = None,
    budget: Optional[int] = None,
    kernel_budget: Optional[int] = None,
    num_windows: Optional[int] = None,
    mesh=None,
    budget_per_device: Optional[int] = None,
    interpret: Optional[bool] = None,
    loss: str = "l2",
    exchange_capacity: Optional[int] = None,
):
    """Train step averaging the photometric loss over a batch of views
    (cams: stacked CameraParams [V, ...], targets [V, H, W, 3]):
    (state, labels, cams, targets, bg) -> (state, loss, num_dropped), where
    num_dropped is the max over the views."""
    del budget, kernel_budget, num_windows, budget_per_device, interpret
    del exchange_capacity
    width, height = camera_static
    return _make_step(width, height, cfg, lr, lr_final, decay_steps, loss,
                      multiview=True, adaptive=False, mesh=mesh)


def make_adaptive_multiview_train_step(
    camera_static: Tuple[int, int],
    cfg: Config = DEFAULT,
    *,
    lr: float = 1e-2,
    lr_final: Optional[float] = None,
    decay_steps: Optional[int] = None,
    budget: Optional[int] = None,
    kernel_budget: Optional[int] = None,
    num_windows: Optional[int] = None,
    mesh=None,
    budget_per_device: Optional[int] = None,
    interpret: Optional[bool] = None,
    loss: str = "l2",
    exchange_capacity: Optional[int] = None,
):
    """Multiview batch step that also accumulates adaptive-density
    statistics from the batched gradient:
    (state, stats, labels, cams, targets, bg)
    -> (state, stats, loss, num_dropped)."""
    del budget, kernel_budget, num_windows, budget_per_device, interpret
    del exchange_capacity
    width, height = camera_static
    return _make_step(width, height, cfg, lr, lr_final, decay_steps, loss,
                      multiview=True, adaptive=True, mesh=mesh)


def make_adaptive_train_step(
    camera_static: Tuple[int, int],
    cfg: Config = DEFAULT,
    *,
    lr: float = 1e-2,
    lr_final: Optional[float] = None,
    decay_steps: Optional[int] = None,
    budget: Optional[int] = None,
    kernel_budget: Optional[int] = None,
    num_windows: Optional[int] = None,
    mesh=None,
    budget_per_device: Optional[int] = None,
    interpret: Optional[bool] = None,
    loss: str = "dssim_l1",
    exchange_capacity: Optional[int] = None,
):
    """Single-view step that also accumulates adaptive-density statistics
    (``models/densify.py``): (state, stats, labels, cam, target, bg)
    -> (state, stats, loss, num_dropped). Run ``densify_and_prune`` every K
    steps on the host schedule; the scene lives in fixed-capacity buffers."""
    del budget, kernel_budget, num_windows, budget_per_device, interpret
    del exchange_capacity
    width, height = camera_static
    return _make_step(width, height, cfg, lr, lr_final, decay_steps, loss,
                      multiview=False, adaptive=True, mesh=mesh)


def stack_cameras(cams) -> CameraParams:
    """Stack a list of CameraParams into a view batch."""
    return CameraParams(*(torch.stack([getattr(c, f) for c in cams])
                          for f in CameraParams._fields))
