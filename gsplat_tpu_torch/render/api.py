"""Top-level differentiable renderer: project -> bin -> blend -> image.

Counterpart of ``gsplat_tpu.render.api``: ``render`` keeps the JAX signature
and output keys (``image``, ``alpha``, ``transmittance``, ``num_dropped`` and,
with labels, ``best_weight`` and ``label_map``). It runs on the card unless
the caller names another device; the tensors' device decides whether the
kernels or their plain versions run. The blend is one
``torch.autograd.Function`` on both devices (:class:`BlendSceneTiles`,
the counterpart of ``blend_scene_windows`` and its custom VJP): forward
kernel B1, backward kernel B2 and the gradient fold over kernel B3.
Projection and SH are plain torch, and autograd derives their VJP.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from gsplat_tpu_torch.config import Config, DEFAULT
from gsplat_tpu_torch.io.cameras import Camera
from gsplat_tpu_torch.render import blend
from gsplat_tpu_torch.render.projection import (CameraParams, Projected,
                                                project, tile_grid)
from gsplat_tpu_torch.render.tiles import TileBinning, bin_tiles
from gsplat_tpu_torch.scene import DeviceLike, GaussianScene, resolve_device


def pack_table(proj: Projected, labels: torch.Tensor) -> torch.Tensor:
    """[N, 16] per-gaussian parameter table in original gaussian order
    (columns ``blend.P_*``); the blend kernel gathers its rows at the sorted
    gaussian indices."""
    n = proj.opacity.shape[0]
    dev = proj.opacity.device
    cols = [proj.u, proj.v, proj.ca, proj.cb, proj.cc, proj.opacity,
            proj.red, proj.green, proj.blue,
            torch.ones(n, device=dev),
            labels.to(torch.float32),
            torch.arange(n, dtype=torch.float32, device=dev)]   # P_GID
    cols += [torch.zeros(n, device=dev)] * (blend.PARAM_ROWS - len(cols))
    return torch.stack(cols, dim=1)


class BlendSettings(NamedTuple):
    """The blend kernels' static arguments."""

    tiles_x: int
    tiles_y: int
    tile_size: int
    width: int
    height: int
    chunk: int
    alpha_min: float
    alpha_max: float
    early_eps: float


def enumeration_rows(drows: torch.Tensor, je_sorted: torch.Tensor
                     ) -> torch.Tensor:
    """Gradient rows [B, 16] from sorted-stream order to enumeration order.
    ``je_sorted`` is a permutation of the B slots (filtered slots carry zero
    rows), so this writes every row once."""
    rows = torch.empty_like(drows)
    rows[je_sorted.long()] = drows
    return rows


def segment_sums(cs: torch.Tensor, enum_start: torch.Tensor,
                 enum_cnt: torch.Tensor) -> torch.Tensor:
    """Each gaussian's sum over its enumeration range, from the inclusive
    prefix sum ``cs`` [B, 16]: cs[start + cnt - 1] - cs[start - 1]."""
    b = cs.shape[0]
    start = enum_start.long()
    cnt = enum_cnt.long()
    zero = torch.zeros((), device=cs.device)
    hi = cs[torch.clamp(start + cnt - 1, 0, b - 1)]
    lo = torch.where((start > 0)[:, None], cs[torch.clamp_min(start - 1, 0)],
                     zero)
    return torch.where((cnt > 0)[:, None], hi - lo, zero)


def fold_instance_rows(drows: torch.Tensor, je_sorted: torch.Tensor,
                       enum_start: torch.Tensor, enum_cnt: torch.Tensor
                       ) -> torch.Tensor:
    """Per-instance gradient rows [B, 16] in sorted-stream order -> the
    per-gaussian gradient [N, 16] in original order, without a scatter-add
    (``gsplat_tpu/render/api.py:148-161``): the rows move to enumeration
    order, where each gaussian's instances are consecutive; one prefix sum
    (kernel B3) and two boundary row gathers give each gaussian's segment
    sum. The move and the gathers are plain torch, as they are plain XLA in
    the JAX package."""
    if drows.shape[0] == 0:
        return drows.new_zeros(enum_start.shape[0], drows.shape[1])
    cs = blend.cumsum_rows(enumeration_rows(drows, je_sorted))
    return segment_sums(cs, enum_start, enum_cnt)


class BlendSceneTiles(torch.autograd.Function):
    """Differentiable tile compositing of the [N, 16] table ``ptab``.

    Forward: kernel B1 (``blend.blend_tiles_fwd``), returning (rgb,
    transmittance) and, with labels, (best_weight, label), which are not
    differentiable, as the JAX VJP ignores the label rows. Backward: kernel
    B2 (``blend.blend_tiles_bwd``) then :func:`fold_instance_rows`. Grads
    are materialised (the default), so an output the loss does not use, such
    as T under an RGB-only loss, reaches B2 as zeros."""

    @staticmethod
    def forward(ctx, ptab, inst_gauss, tile_bounds, je_sorted, enum_start,
                enum_cnt, settings: BlendSettings, with_labels: bool):
        out = blend.blend_tiles_fwd(ptab, inst_gauss, tile_bounds,
                                    **settings._asdict(),
                                    with_labels=with_labels)
        ctx.settings = settings
        ctx.save_for_backward(ptab, inst_gauss, tile_bounds, je_sorted,
                              enum_start, enum_cnt, out.rgb,
                              out.transmittance)
        if not with_labels:
            return out.rgb, out.transmittance
        ctx.mark_non_differentiable(out.best_weight, out.label)
        return out.rgb, out.transmittance, out.best_weight, out.label

    @staticmethod
    def backward(ctx, g_rgb, g_trans, *g_labels):
        del g_labels
        (ptab, inst_gauss, tile_bounds, je_sorted, enum_start, enum_cnt, rgb,
         trans) = ctx.saved_tensors
        dptab = None
        if ctx.needs_input_grad[0]:
            drows = blend.blend_tiles_bwd(
                ptab, inst_gauss, tile_bounds, rgb.contiguous(),
                trans.contiguous(), g_rgb.contiguous(), g_trans.contiguous(),
                **ctx.settings._asdict())
            dptab = fold_instance_rows(drows, je_sorted, enum_start,
                                       enum_cnt)
        return dptab, None, None, None, None, None, None, None


def blend_scene_tiles(ptab: torch.Tensor, binning: TileBinning,
                      settings: BlendSettings, with_labels: bool = False
                      ) -> blend.BlendOutput:
    """Differentiable blend of a binned frame (counterpart of
    ``blend_scene_windows``); see :class:`BlendSceneTiles`."""
    outs = BlendSceneTiles.apply(ptab, binning.inst_gauss,
                                 binning.tile_bounds, binning.je_sorted,
                                 binning.enum_start, binning.enum_cnt,
                                 settings, with_labels)
    if with_labels:
        return blend.BlendOutput(*outs)
    return blend.BlendOutput(outs[0], outs[1], None, None)


def _render_impl(scene: GaussianScene, cam: CameraParams,
                 background: torch.Tensor, *, width: int, height: int,
                 cfg: Config, with_labels: bool) -> Dict[str, torch.Tensor]:
    rc = cfg.raster
    proj = project(scene, cam, width, height, rc,
                   z_near=cfg.camera.z_near, z_far=cfg.camera.z_far)
    tiles_x, tiles_y = tile_grid(width, height, rc.tile_size)
    binning = bin_tiles(proj, tiles_x=tiles_x, tiles_y=tiles_y,
                        tile_size=rc.tile_size)
    ptab = pack_table(proj, scene.labels)
    settings = BlendSettings(
        tiles_x=tiles_x, tiles_y=tiles_y, tile_size=rc.tile_size,
        width=width, height=height, chunk=cfg.tiles.chunk,
        alpha_min=rc.alpha_min, alpha_max=rc.alpha_max,
        early_eps=rc.early_stop_eps)
    out = blend_scene_tiles(ptab, binning, settings, with_labels)
    transmit = out.transmittance
    result = dict(image=out.rgb + transmit[..., None] * background,
                  alpha=1.0 - transmit, transmittance=transmit,
                  num_dropped=binning.num_dropped)
    if with_labels:
        result["best_weight"] = out.best_weight
        result["label_map"] = out.label
    return result


def render(
    scene: GaussianScene,
    camera: Camera,
    cfg: Config = DEFAULT,
    *,
    background=None,
    with_labels: bool = False,
    impl: str = "pallas",
    budget: Optional[int] = None,
    kernel_budget: Optional[int] = None,
    num_windows: Optional[int] = None,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Render a scene from a camera on ``device`` (the card by default; the
    scene moves there if it lies elsewhere).

    ``impl='pallas'`` is the tiled kernel path (the name is the JAX one).
    ``budget``, ``kernel_budget`` and ``num_windows`` are accepted and
    ignored: the port sizes its buffers from the exact instance count, so
    ``num_dropped`` is always 0."""
    del budget, kernel_budget, num_windows
    if impl == "dense":
        raise NotImplementedError(
            "impl='dense' (the dense oracle path, render/blend_xla.py) comes "
            "with the port's dense-path slice")
    if impl == "pallas_vis":
        raise NotImplementedError(
            "impl='pallas_vis' (the visibility blend, kernel B5) comes with "
            "the port's labeling slice")
    if impl != "pallas":
        raise ValueError(f"unknown impl {impl!r}")
    device = resolve_device(device)
    scene = scene.to(device)
    if background is None:
        background = cfg.raster.background
    background = torch.as_tensor(background, dtype=torch.float32,
                                 device=device)
    return _render_impl(scene, CameraParams.from_camera(camera, device),
                        background, width=camera.width, height=camera.height,
                        cfg=cfg, with_labels=with_labels)
