"""Adaptive density control (densify + prune) over fixed-capacity buffers.

Counterpart of ``gsplat_tpu.models.densify``: the scene lives in a fixed-
capacity buffer; "dead" slots carry an opacity logit of ``DEAD_LOGIT``
(sigmoid ~ 0 < alpha_min, so projection culls them). A densify step prunes
transparent or oversized splats, ranks the high-gradient survivors, and
writes clones (small splats) and splits (large ones) into dead slots, the
i-th best candidate into the i-th free slot. Both rankings are stable sorts,
as ``jnp.argsort`` is, so ties (everywhere in the keep mask and among the
-inf priorities) fill the same slots as the JAX package.

The split noise is drawn from a ``torch.Generator`` in place of a JAX key;
``noise`` overrides the draw, so a test can hand both packages the same
numbers.

Sharded buffers (``parallel/mesh.py::Sharded``, the sharded train steps'
state): the JAX package runs ``densify_and_prune`` under GSPMD on them
(``gsplat_tpu/models/trainer.py:406-412``). The port gathers the [C]
buffers, runs the same single-device step on every process (with the same
``noise``, or a generator seeded alike) and keeps each shard's slice, at
the densify cadence; the written mask comes back sharded, for
``trainer.zero_adam_rows``. ``reset_opacities`` works shard by shard.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from gsplat_tpu_torch.config import NO_SELECTION
from gsplat_tpu_torch.models.trainer import SceneParams
from gsplat_tpu_torch.parallel.mesh import on_whole, per_shard, sum_shards
from gsplat_tpu_torch.render.projection import quat_to_rotmat
from gsplat_tpu_torch.scene import DeviceLike, resolve_device

DEAD_LOGIT = -15.0  # sigmoid(-15) ~ 3e-7 << alpha_min: projection culls


class DensifyConfig(NamedTuple):
    grad_threshold: float = 2e-4     # mean accumulated grad norm to densify
    percent_dense: float = 0.01      # split if scale > this * scene_extent
    split_factor: float = 1.6        # scale shrink for split children
    prune_opacity: float = 0.005     # kill below this sigmoid opacity
    prune_scale: float = 0.1         # kill above this * scene_extent
    max_new_fraction: float = 0.5    # cap new splats per step (of capacity)


class DensifyStats(NamedTuple):
    """Accumulated between densify steps (reset after each)."""

    grad_accum: torch.Tensor   # [C] sum of ||dL/dmean|| over steps
    count: torch.Tensor        # [C] number of steps the gaussian was visible

    @classmethod
    def zeros(cls, capacity: int, device: DeviceLike = None
              ) -> "DensifyStats":
        """Zero statistics on ``device`` (the card unless named)."""
        device = resolve_device(device)
        return cls(torch.zeros(capacity, device=device),
                   torch.zeros(capacity, device=device))

    def update(self, grads: SceneParams) -> "DensifyStats":
        g = torch.linalg.vector_norm(grads.means, dim=-1)
        seen = (g > 0.0).to(torch.float32)
        return DensifyStats(self.grad_accum + g, self.count + seen)


def pad_to_capacity(params: SceneParams, labels: torch.Tensor, capacity: int
                    ) -> Tuple[SceneParams, torch.Tensor]:
    """Grow the scene buffers to ``capacity`` with dead slots."""
    n = params.means.shape[0]
    extra = capacity - n
    if extra < 0:
        raise ValueError(f"capacity {capacity} < current {n}")
    if extra == 0:
        return params, labels

    def pad(a, fill):
        return torch.cat([a, torch.full((extra,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=a.device)])

    quats = pad(params.quats, 1.0)
    quats[n:, 1:] = 0.0
    out = SceneParams(
        means=pad(params.means, 0.0),
        log_scales=pad(params.log_scales, 0.0),
        quats=quats,
        opacities=pad(params.opacities, DEAD_LOGIT),
        sh=pad(params.sh, 0.0),
    )
    return out, pad(labels, NO_SELECTION)


def num_alive(params: SceneParams) -> torch.Tensor:
    return sum_shards(per_shard(lambda p: torch.sum(
        (p.opacities > DEAD_LOGIT + 1.0).to(torch.int32)), params))


def _f32_log(x: float) -> float:
    """log of an f32 value in f32, as ``jnp.log`` of a Python float is."""
    return float(torch.log(torch.tensor(x, dtype=torch.float32)))


@torch.no_grad()
def densify_and_prune(
    params: SceneParams,
    labels: torch.Tensor,
    stats: DensifyStats,
    generator: Optional[torch.Generator],
    scene_extent: float,
    cfg: DensifyConfig = DensifyConfig(),
    *,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[SceneParams, torch.Tensor, DensifyStats, torch.Tensor]:
    """One adaptive-density step over the fixed-capacity buffers.

    Prunes transparent/oversized splats, then fills dead slots with clones
    (small, high-grad) and splits (large, high-grad; the child samples the
    parent's gaussian with ``noise`` [C, 3], drawn from ``generator`` when
    not given, and parent and child shrink their scales). Returns
    (params, labels, zeroed stats, rewritten-slot mask); the caller zeroes
    the optimizer moments at the mask (``trainer.zero_adam_rows``)."""
    # sharded buffers are gathered, densified whole and sharded again
    # (module docstring)
    return on_whole(lambda p, lab, st: _densify_whole(
        p, lab, st, generator, scene_extent, cfg, noise), params, labels,
        stats)


def _densify_whole(params, labels, stats, generator, scene_extent, cfg,
                   noise):
    c = params.means.shape[0]
    dev = params.means.device
    opac = torch.sigmoid(params.opacities)
    max_scale = torch.exp(params.log_scales).amax(dim=-1)
    alive = params.opacities > DEAD_LOGIT + 1.0

    # ---- prune
    keep = alive & (opac >= cfg.prune_opacity) & (
        max_scale <= cfg.prune_scale * scene_extent)
    opacities = torch.where(keep, params.opacities,
                            torch.full_like(params.opacities, DEAD_LOGIT))

    # ---- densification candidates
    g_avg = stats.grad_accum / torch.clamp_min(stats.count, 1.0)
    hot = keep & (g_avg > cfg.grad_threshold)
    big = max_scale > cfg.percent_dense * scene_extent
    want_split = hot & big
    want_clone = hot & ~big

    # ---- match candidates to dead slots by sort position: the i-th best
    # candidate writes the i-th free slot
    max_new = int(cfg.max_new_fraction * c)
    priority = torch.where(hot & keep, g_avg,
                           torch.full_like(g_avg, -math.inf))
    src = torch.argsort(-priority, stable=True)          # best first
    free = torch.argsort(keep.to(torch.int32), stable=True)  # dead first
    n_free = int((~keep).sum())
    n_cand = int((want_split | want_clone).sum())
    n_new = min(n_free, n_cand, max_new)
    src = src[:n_new]
    dst = free[:n_new]

    if noise is None:
        noise = torch.randn(c, 3, generator=generator, device=dev)
    rot = quat_to_rotmat(params.quats[src])               # [n_new, 3, 3]
    v = noise[:n_new] * torch.exp(params.log_scales[src])
    offset = (rot[:, :, 0] * v[:, None, 0] + rot[:, :, 1] * v[:, None, 1]
              + rot[:, :, 2] * v[:, None, 2])
    is_split = want_split[src][:, None]
    shrink = _f32_log(cfg.split_factor)
    child_means = torch.where(is_split, params.means[src] + offset,
                              params.means[src])
    child_logs = torch.where(is_split, params.log_scales[src] - shrink,
                             params.log_scales[src])

    means = params.means.clone()
    means[dst] = child_means
    log_scales = params.log_scales.clone()
    log_scales[dst] = child_logs
    quats = params.quats.clone()
    quats[dst] = params.quats[src]
    sh = params.sh.clone()
    sh[dst] = params.sh[src]
    opacities[dst] = opacities[src]
    new_labels = labels.clone()
    new_labels[dst] = labels[src]

    # split parents shrink in place (their mass is now shared with the child)
    parent_split = (want_split & keep)[:, None]
    log_scales = torch.where(parent_split, log_scales - shrink, log_scales)

    written = ~keep
    written[dst] = True
    out = SceneParams(means=means, log_scales=log_scales, quats=quats,
                      opacities=opacities, sh=sh)
    return out, new_labels, DensifyStats.zeros(c, device=dev), written


def reset_opacities(params: SceneParams, value: float = 0.01
                    ) -> Tuple[SceneParams, torch.Tensor]:
    """Periodic opacity reset (3DGS: clamp alive opacities down so pruning
    can reconsider them). Returns (params, changed mask); the caller zeroes
    the opacity Adam moments at changed rows
    (``trainer.zero_adam_rows(..., fields=("opacities",))``)."""
    logit = _f32_log(value / (1.0 - value))

    def rows(params: SceneParams):
        alive = params.opacities > DEAD_LOGIT + 1.0
        changed = alive & (params.opacities > logit)
        new = torch.where(alive, torch.clamp_max(params.opacities, logit),
                          params.opacities)
        return params._replace(opacities=new), changed

    return per_shard(rows, params)
