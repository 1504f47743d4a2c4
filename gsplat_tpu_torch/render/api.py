"""Top-level differentiable renderer: project -> bin -> blend -> image.

Counterpart of ``gsplat_tpu.render.api``: ``render`` keeps the JAX signature
and output keys (``image``, ``alpha``, ``transmittance``, ``num_dropped`` and,
with labels, ``best_weight`` and ``label_map``). It runs on the card unless
the caller names another device; the tensors' device decides whether the
kernels or their plain versions run. The blend is one
``torch.autograd.Function`` on both devices (:class:`BlendSceneTiles`,
the counterpart of ``blend_scene_windows`` and its custom VJP): forward
kernel B1, backward kernel B2 and the gradient fold of :func:`fold_rows`
(``csrc/fold_rows.cu``). Kernel B3 and the boundary gathers of
:func:`segment_sums`, the JAX package's fold, remain for the probes.
Projection and SH (``render/projection.py::project``) follow the same rule:
where a scene field records a gradient they are one ``autograd.Function`` on
both devices, kernels ``csrc/project.cu`` and ``csrc/project_bwd.cu`` on the
card and their plain versions on the CPU; a camera that requires grad keeps
the plain code and autograd. The blend's settings come from
:meth:`BlendSettings.from_config` alone.
``render(impl="pallas_vis")`` is the labeler's visibility render over kernel
B5 (:func:`_render_vis_impl`); ``render(impl="dense")`` the small-scene
oracle of ``render/blend_dense.py``. :func:`measure_budgets` and
:func:`measure_budgets_multi` keep the JAX names and return exact counts.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.config import Config, DEFAULT
from gsplat_tpu_torch.io.cameras import Camera
from gsplat_tpu_torch.render import blend, blend_dense
from gsplat_tpu_torch.render.projection import (CameraParams, Projected,
                                                project, tile_grid)
from gsplat_tpu_torch.render.tiles import (FULL, Lattice, TileBinning,
                                           bin_tiles,
                                           count_instances,
                                           count_instances_tight,
                                           depth_qkeys)
from gsplat_tpu_torch.scene import DeviceLike, GaussianScene, resolve_device
from gsplat_tpu_torch.utils.profiling import span


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
    """The blend kernels' static arguments. The lattice is the sharded
    render's (``render/tiles.py::Lattice``); the default is the whole
    grid. :meth:`from_config` makes them."""

    tiles_x: int
    tiles_y: int
    tile_size: int
    width: int
    height: int
    chunk: int
    alpha_min: float
    alpha_max: float
    early_eps: float
    lattice: Lattice = FULL

    @classmethod
    def from_config(cls, cfg: Config, tiles_x: int, tiles_y: int, width: int,
                    height: int, lattice: Lattice = FULL) -> "BlendSettings":
        """The settings of a grid of ``tiles_x`` x ``tiles_y`` tiles over
        ``width`` x ``height`` pixels; tile size, chunk, alpha bounds and
        early stop from ``cfg``."""
        rc = cfg.raster
        return cls(tiles_x=tiles_x, tiles_y=tiles_y, tile_size=rc.tile_size,
                   width=width, height=height, chunk=cfg.tiles.chunk,
                   alpha_min=rc.alpha_min, alpha_max=rc.alpha_max,
                   early_eps=rc.early_stop_eps, lattice=lattice)


def enumeration_rows(drows: torch.Tensor, je_sorted: torch.Tensor
                     ) -> torch.Tensor:
    """Gradient rows [B, 16] from sorted-stream order to enumeration order.
    ``je_sorted`` is a permutation of the B slots (filtered slots carry zero
    rows), so this writes every row once."""
    rows = torch.empty_like(drows)
    rows[je_sorted.long()] = drows
    return rows


def _segment_sums_plain(cs: torch.Tensor, enum_start: torch.Tensor,
                        enum_cnt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_sums`: two boundary row
    gathers, as the JAX VJP does them (``gsplat_tpu/render/api.py:156-160``)."""
    b = cs.shape[0]
    start = enum_start.long()
    cnt = enum_cnt.long()
    zero = torch.zeros((), device=cs.device)
    hi = cs[torch.clamp(start + cnt - 1, 0, b - 1)]
    lo = torch.where((start > 0)[:, None], cs[torch.clamp_min(start - 1, 0)],
                     zero)
    return torch.where((cnt > 0)[:, None], hi - lo, zero)


def segment_sums(cs: torch.Tensor, enum_start: torch.Tensor,
                 enum_cnt: torch.Tensor) -> torch.Tensor:
    """Each gaussian's sum over its enumeration range, from the inclusive
    prefix sum ``cs`` [B, 16] f32: cs[start + cnt - 1] - cs[start - 1]
    (cs[-1] read as 0; 0 where cnt is 0), from [N] i32 ``enum_start`` and
    ``enum_cnt``.

    Replaces XLA glue, not a Pallas kernel: the gathers around kernel B3 in
    ``gsplat_tpu/render/api.py:156-160``. On the card it launches
    ``csrc/fold_segments.cu`` (one thread a gaussian's 4-column group,
    16-byte loads and stores; bound by bytes), equal to the plain version
    bit for bit; CPU tensors take the plain version."""
    if (cs.dtype != torch.float32 or cs.dim() != 2
            or cs.shape[1] != blend.PARAM_ROWS or cs.shape[0] == 0):
        raise ValueError("segment_sums takes an f32 [B, 16] prefix sum, "
                         "B >= 1")
    n = enum_start.shape[0]
    for t in (enum_start, enum_cnt):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError("segment_sums takes [N] i32 starts and counts")
        if t.device != cs.device:
            raise ValueError("segment_sums takes tensors on one device")
    if not (cs.is_contiguous() and enum_start.is_contiguous()
            and enum_cnt.is_contiguous()):
        raise ValueError("segment_sums takes contiguous tensors")
    if cs.device.type == "cpu":
        return _segment_sums_plain(cs, enum_start, enum_cnt)
    if cs.device.type != "cuda":
        raise ValueError(f"segment_sums: no kernel for {cs.device}")
    if cs.shape[0] >= 2 ** 31 or 4 * n >= 2 ** 31 or cs.data_ptr() % 16:
        raise ValueError("segment_sums takes fewer than 2^31 rows and 2^29 "
                         "gaussians, 16-byte aligned")
    out = torch.empty(n, blend.PARAM_ROWS, device=cs.device)
    if n == 0:
        return out
    fn = _kernels.function("fold_segments")
    err = fn(cs.data_ptr(), cs.shape[0], enum_start.data_ptr(),
             enum_cnt.data_ptr(), n, out.data_ptr(), _kernels.stream(cs.device))
    segment_sums.launches += 1
    _kernels.check("fold_segments", err)
    return out


segment_sums.launches = 0


# rows a chunk of csrc/fold_rows.cu (kChunk); it sets the order of the sum
FOLD_CHUNK = 32


def _fold_rows_plain(rows: torch.Tensor, enum_start: torch.Tensor,
                     enum_cnt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fold_rows`, in its order: each
    segment cut into chunks of ``FOLD_CHUNK`` rows from its first row, each
    chunk summed left to right from its first row, then the chunks' sums
    left to right from the first. A masked step keeps its sum as it was (a
    ``where``, not an added zero, which would turn -0 into +0)."""
    n = enum_start.shape[0]
    out = rows.new_zeros(n, rows.shape[1])
    cnt = enum_cnt.long()
    nch = (cnt + FOLD_CHUNK - 1) // FOLD_CHUNK
    live = torch.nonzero(nch)[:, 0]
    if live.numel() == 0:
        return out
    nch = nch[live]
    g = torch.repeat_interleave(live, nch)          # chunk -> gaussian
    first = torch.cumsum(nch, 0) - nch              # first chunk of each
    j = torch.arange(g.numel(), device=rows.device) - torch.repeat_interleave(
        first, nch)
    r0 = enum_start.long()[g] + j * FOLD_CHUNK
    length = torch.clamp(cnt[g] - j * FOLD_CHUNK, max=FOLD_CHUNK)
    sums = rows[r0]
    for t in range(1, int(length.max())):
        more = t < length
        sums = torch.where(more[:, None], sums + rows[torch.where(
            more, r0 + t, r0)], sums)
    acc = sums[first]
    for k in range(1, int(nch.max())):
        more = k < nch
        acc = torch.where(more[:, None], acc + sums[torch.where(
            more, first + k, first)], acc)
    out[live] = acc
    return out


def fold_rows(rows: torch.Tensor, enum_start: torch.Tensor,
              enum_cnt: torch.Tensor) -> torch.Tensor:
    """Each gaussian's sum of its own rows [N, 16] f32, from the rows [B,
    16] f32 in enumeration order and [N] i32 ``enum_start`` and
    ``enum_cnt`` (gaussian g owns rows [start, start + cnt)); 0 where cnt is
    0, and exactly 0 where every row is 0. The order of the sum is
    :func:`_fold_rows_plain`'s.

    Replaces XLA glue, not a Pallas kernel: the fold of
    ``gsplat_tpu/render/api.py:148-161``, a difference of two rows of one
    prefix sum (here kernel B3 and :func:`segment_sums`), which carries an
    ulp of the running sum (0.06-0.5 at a real frame's size) into every
    gaussian's row, those with all-zero rows too. On the card it launches
    ``csrc/fold_rows.cu`` (a block per 64 gaussians; their chunks shared by
    the block's quads, each gaussian's chunk sums added in order by its own
    quad; bound by bytes: every row read once, 72 bytes a gaussian), equal
    to the plain version bit for bit and the same from run to run; CPU
    tensors take the plain version."""
    if (rows.dtype != torch.float32 or rows.dim() != 2
            or rows.shape[1] != blend.PARAM_ROWS):
        raise ValueError("fold_rows takes f32 [B, 16] rows")
    n = enum_start.shape[0]
    for t in (enum_start, enum_cnt):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError("fold_rows takes [N] i32 starts and counts")
        if t.device != rows.device:
            raise ValueError("fold_rows takes tensors on one device")
    if not (rows.is_contiguous() and enum_start.is_contiguous()
            and enum_cnt.is_contiguous()):
        raise ValueError("fold_rows takes contiguous tensors")
    if rows.device.type == "cpu":
        return _fold_rows_plain(rows, enum_start, enum_cnt)
    if rows.device.type != "cuda":
        raise ValueError(f"fold_rows: no kernel for {rows.device}")
    if rows.shape[0] >= 2 ** 31 or rows.data_ptr() % 16:
        raise ValueError("fold_rows takes fewer than 2^31 rows, 16-byte "
                         "aligned")
    out = torch.empty(n, blend.PARAM_ROWS, device=rows.device)
    if n == 0:
        return out
    fn = _kernels.function("fold_rows")
    err = fn(rows.data_ptr(), rows.shape[0], enum_start.data_ptr(),
             enum_cnt.data_ptr(), n, out.data_ptr(),
             _kernels.stream(rows.device))
    fold_rows.launches += 1
    _kernels.check("fold_rows", err)
    return out


fold_rows.launches = 0


def fold_instance_rows(drows: torch.Tensor, je_sorted: torch.Tensor,
                       enum_start: torch.Tensor, enum_cnt: torch.Tensor
                       ) -> torch.Tensor:
    """Per-instance gradient rows [B, 16] in sorted-stream order -> the
    per-gaussian gradient [N, 16] in original order, without a scatter-add:
    the rows move to enumeration order, where each gaussian's instances are
    consecutive, and :func:`fold_rows` sums each gaussian's own. The move is
    plain torch, as it is plain XLA in the JAX package
    (``gsplat_tpu/render/api.py:148-161``)."""
    with span("gsplat.fold"):
        if drows.shape[0] == 0:
            return drows.new_zeros(enum_start.shape[0], drows.shape[1])
        return fold_rows(enumeration_rows(drows, je_sorted), enum_start,
                         enum_cnt)


class BlendSceneTiles(torch.autograd.Function):
    """Differentiable tile compositing of the [N, 16] table ``ptab``.

    Forward: kernel B1 (``blend.blend_tiles_fwd``), returning (rgb,
    transmittance) and, with labels, (best_weight, label), which are not
    differentiable, as the JAX VJP ignores the label rows. Backward: kernel
    B2 (``blend.blend_tiles_bwd``, span ``gsplat.blend_bwd``) then
    :func:`fold_instance_rows` (span ``gsplat.fold``); on the card autograd
    runs this on its device thread, where the spans open. Grads
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
            with span("gsplat.blend_bwd"):
                drows = blend.blend_tiles_bwd(
                    ptab, inst_gauss, tile_bounds, rgb.contiguous(),
                    trans.contiguous(), g_rgb.contiguous(),
                    g_trans.contiguous(), **ctx.settings._asdict())
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


def _project_bin_pack(scene: GaussianScene, cam: CameraParams, width: int,
                      height: int, cfg: Config
                      ) -> Tuple[TileBinning, torch.Tensor, BlendSettings]:
    """The stages before the blend, each in its span: the projection (and
    SH), the binning and the blend kernels' parameter table; and the
    blend's settings for the view's grid."""
    rc = cfg.raster
    with span("gsplat.project"):
        proj = project(scene, cam, width, height, rc,
                       z_near=cfg.camera.z_near, z_far=cfg.camera.z_far)
    with span("gsplat.bin"):
        tiles_x, tiles_y = tile_grid(width, height, rc.tile_size)
        binning = bin_tiles(proj, tiles_x=tiles_x, tiles_y=tiles_y,
                            tile_size=rc.tile_size)
    with span("gsplat.pack"):
        ptab = pack_table(proj, scene.labels)
    return binning, ptab, BlendSettings.from_config(cfg, tiles_x, tiles_y,
                                                    width, height)


def _render_impl(scene: GaussianScene, cam: CameraParams,
                 background: torch.Tensor, *, width: int, height: int,
                 cfg: Config, with_labels: bool) -> Dict[str, torch.Tensor]:
    binning, ptab, settings = _project_bin_pack(scene, cam, width, height,
                                                cfg)
    with span("gsplat.blend"):
        out = blend_scene_tiles(ptab, binning, settings, with_labels)
        transmit = out.transmittance
        result = dict(image=out.rgb + transmit[..., None] * background,
                      alpha=1.0 - transmit, transmittance=transmit,
                      num_dropped=binning.num_dropped)
    if with_labels:
        result["best_weight"] = out.best_weight
        result["label_map"] = out.label
    return result


def gaussian_weights(inst_weight: torch.Tensor, inst_gauss: torch.Tensor,
                     num_gaussians: int) -> torch.Tensor:
    """[N] per-gaussian visibility weight: the segment max of kernel B5's
    per-instance rows onto original gaussian order (0 for a gaussian with
    no instance). The JAX package does this max outside its kernel too
    (``gsplat_tpu/render/api.py:282-284``); max is order-free, so the
    scatter is exact in any order."""
    gw = inst_weight.new_zeros(num_gaussians)
    return gw.scatter_reduce_(0, inst_gauss.long(), inst_weight, "amax")


@torch.no_grad()
def _render_vis_impl(scene: GaussianScene, cam: CameraParams,
                     background: torch.Tensor, *, width: int, height: int,
                     cfg: Config, with_labels: bool
                     ) -> Dict[str, torch.Tensor]:
    """Forward render that also returns per-gaussian visibility weights
    (max blend weight over any pixel of the gaussian's tiles), the evidence
    of the occlusion-aware vote. No early stop (kernel B5 has none, as the
    JAX kernel has none). Not differentiable."""
    binning, ptab, settings = _project_bin_pack(scene, cam, width, height,
                                                cfg)
    b5 = settings._asdict()      # B5 has no early stop and no lattice
    del b5["early_eps"], b5["lattice"]
    with span("gsplat.blend"):
        out, inst_w = blend.blend_tiles_vis(
            ptab, binning.inst_gauss, binning.tile_bounds, **b5,
            with_labels=with_labels)
        transmit = out.transmittance
        result = dict(image=out.rgb + transmit[..., None] * background,
                      alpha=1.0 - transmit, transmittance=transmit,
                      gaussian_weight=gaussian_weights(
                          inst_w, binning.inst_gauss, scene.num_gaussians),
                      num_dropped=binning.num_dropped)
    if with_labels:
        result["best_weight"] = out.best_weight
        result["label_map"] = out.label
    return result


def _render_dense_impl(scene: GaussianScene, cam: CameraParams,
                       background: torch.Tensor, *, width: int, height: int,
                       cfg: Config, with_labels: bool
                       ) -> Dict[str, torch.Tensor]:
    """The dense oracle path (``gsplat_tpu/render/api.py:195-207``): the
    gaussians in the canonical compositing order, a stable sort of the
    quantized depth keys of the tiled path's grid, blended densely
    (``blend_dense.blend_dense``). Differentiable by autograd; nothing is
    dropped."""
    rc = cfg.raster
    proj = project(scene, cam, width, height, rc,
                   z_near=cfg.camera.z_near, z_far=cfg.camera.z_far)
    tiles_x, tiles_y = tile_grid(width, height, rc.tile_size)
    order = torch.argsort(depth_qkeys(proj.depth, proj.valid,
                                      tiles_x * tiles_y), stable=True)
    out = blend_dense.blend_dense(
        proj, order, width, height, rc,
        labels=scene.labels if with_labels else None, background=background)
    out["num_dropped"] = torch.zeros((), dtype=torch.int32,
                                     device=background.device)
    return out


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

    ``impl='pallas'`` is the tiled kernel path (the name is the JAX one);
    ``impl='pallas_vis'`` the visibility render of the occlusion-aware vote
    (kernel B5, no early stop), which adds ``gaussian_weight`` [N];
    ``impl='dense'`` the O(H*W*N) plain-torch oracle for small scenes
    (:func:`_render_dense_impl`), which refuses more than 2^30 pairs.
    ``budget``, ``kernel_budget`` and ``num_windows`` are accepted and
    ignored: the port sizes its buffers from the exact instance count, so
    ``num_dropped`` is always 0."""
    del budget, kernel_budget, num_windows
    if impl not in ("pallas", "pallas_vis", "dense"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "dense":
        # the dense oracle materializes [H*W, N] f32 interaction matrices
        size = camera.width * camera.height * scene.num_gaussians
        if size > (1 << 30):
            raise ValueError(
                f"impl='dense' materializes [H*W, N] = "
                f"[{camera.width * camera.height}, {scene.num_gaussians}] "
                f"f32 ({4 * size / 1e9:.0f} GB). The dense path is a "
                "small-scene test oracle; use impl='pallas' (the tiled "
                "kernel path) for scenes this size.")
    device = resolve_device(device)
    scene = scene.to(device)
    if background is None:
        background = cfg.raster.background
    background = torch.as_tensor(background, dtype=torch.float32,
                                 device=device)
    impl_fn = {"pallas": _render_impl, "pallas_vis": _render_vis_impl,
               "dense": _render_dense_impl}[impl]
    return impl_fn(scene, CameraParams.from_camera(camera, device),
                   background, width=camera.width, height=camera.height,
                   cfg=cfg, with_labels=with_labels)


def _view_counts(scene: GaussianScene, cam: CameraParams, width: int,
                 height: int, cfg: Config) -> Tuple[int, int, int]:
    rc = cfg.raster
    tx, ty = tile_grid(width, height, rc.tile_size)
    proj = project(scene, cam, width, height, rc, z_near=cfg.camera.z_near,
                   z_far=cfg.camera.z_far)
    kw = dict(tiles_x=tx, tiles_y=ty, tile_size=rc.tile_size)
    return (count_instances(proj, **kw), count_instances_tight(proj, **kw),
            tx * ty)


@torch.no_grad()
def measure_budgets(scene: GaussianScene, camera: Camera,
                    cfg: Config = DEFAULT, *, device: DeviceLike = None
                    ) -> Tuple[int, int, int]:
    """(instance count, tight instance count, tile count) of one view, on
    ``device`` (the card by default). The JAX package buckets these into the
    static budgets of its windows; the port sizes every buffer from the
    exact count, so it returns the counts themselves (the tile count in
    place of a window count: it has no windows). ``render`` accepts the
    tuple and ignores it."""
    device = resolve_device(device)
    return _view_counts(scene.to(device),
                        CameraParams.from_camera(camera, device),
                        camera.width, camera.height, cfg)


@torch.no_grad()
def measure_budgets_multi(scene: GaussianScene, cameras,
                          cfg: Config = DEFAULT, *, device: DeviceLike = None
                          ) -> Tuple[int, int, int]:
    """:func:`measure_budgets` valid for every camera of ``cameras`` (one
    resolution): the max of each count over the views, taken one view at a
    time, so one projection is live at a time."""
    device = resolve_device(device)
    scene = scene.to(device)
    best = (0, 0, 0)
    for cam in cameras:
        counts = _view_counts(scene, CameraParams.from_camera(cam, device),
                              cam.width, cam.height, cfg)
        best = tuple(max(a, b) for a, b in zip(best, counts))
    return best
