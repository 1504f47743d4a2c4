#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gsplat_tpu_torch``) on one card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with an NVIDIA Hopper card
and the CUDA toolkit. It exits nonzero, printing no result, without a card
or without the repository beside it. Phases (any failure stops the run):

0. the card's name and power limit, as nvidia-smi reports them;
1. build every kernel from ``gsplat_tpu_torch/csrc`` (one nvcc per source,
   all at once) and print build seconds and ptxas' registers, shared memory
   and spills;
2. the repo's bench frame (100k gaussians, 800x608, ``bench.py``): each
   kernel against its plain PyTorch version (B4 keys exactly equal, B1 within
   1e-5 at early_stop_eps 0 and at the default, labels equal; B2 within 1e-4
   of each column's peak, zero rows equal), the instance counts against the
   JAX binning's, a small render on the card against the same render on the
   CPU, and the gradients of all five scene tensors on the card against the
   CPU's (within 1e-3 of each tensor's peak);
3. the serving path at real size: a 2M-gaussian scene written to PLY, loaded
   back through ``scene_from_ply`` and rendered with labels from 8 orbit
   views at 800x608 through ``render``; outputs finite and covered, nothing
   dropped, B4 and B1 launched once per frame; then B4, B1 and B2 against
   their plain versions on one of those frames, and B3 against a float64
   prefix sum on that frame's gradient fold (within 1e-6 of each column's
   peak prefix);
4. the training path at real size: 10 steps of
   ``make_adaptive_multiview_train_step`` over 4 views of the 2M scene,
   perturbed, padded to 1.25x capacity, with one ``densify_and_prune`` and
   ``zero_adam_rows`` after step 5; loss falls, parameters finite, nothing
   dropped, B4, B1, B2 and B3 launched once per view per step; then one
   single-view ``make_train_step`` step timed and split into its stages;
5. times on the card (CUDA events, median of 10 after warm-up) of
   projection, B4, the sort, B1, B2, B3, ``torch.cumsum`` and the whole
   render at both frames, the plain versions' times, bounds, and peak
   device memory.

The second-to-last line of stdout is the kernel table as JSON; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.config import DEFAULT, UNLABELED
from gsplat_tpu_torch.io.cameras import look_at_camera, orbit_cameras
from gsplat_tpu_torch.io.ply import scene_from_ply, scene_to_ply
from gsplat_tpu_torch.io.synthetic import random_scene
from gsplat_tpu_torch.models import densify, trainer
from gsplat_tpu_torch.render import blend, tiles
from gsplat_tpu_torch.render.api import (_render_impl, enumeration_rows,
                                         fold_instance_rows, pack_table,
                                         render, segment_sums)
from gsplat_tpu_torch.render.projection import (CameraParams, project,
                                                tile_grid)

REPO = Path(__file__).resolve().parent
WIDTH, HEIGHT = 800, 608
# The instance counts of the bench frame as the JAX package's binning
# (gsplat_tpu.render.tiles) computes them on the CPU.
BENCH_COUNTS = dict(valid=80157, tiles=475, slots=198762, tight=191177,
                    tile_max=595, tile_median=444)
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per evaluated (instance, pixel) pair of B1: dx, dy (2),
# q (7), -q/2 (1), exp counted as 1, opacity product, clamp and cut (3); and
# per live pair (alpha past the cut): the weight (1), RGB accumulation (6),
# the label test (1) and the T update (2)
B1_OPS_PER_EVAL = 14
B1_OPS_PER_LIVE = 10
# exp2 results per clock per SM of the special-function units on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction table);
# expf issues one of them
SFU_PER_CLOCK_PER_SM = 16
# f32 operations per live (instance, pixel) pair of B2, counted from
# csrc/blend_bwd.cu past what B1 counts: the weight (1), c.dC (5), the
# contribution and prefix (2), the suffix (1), 1 - alpha and the ratio (2),
# dq with its clamp test (4), the dq.dx / dq.dy products (2), the six moment
# sums (9), the colour sums (6) and the T update (1)
B2_OPS_PER_LIVE = 33
# f32 operations per bbox slot of B4: the rectangle test (4 edge minima of
# 11 operations, 4 offsets, 4 compares, 2 floors, 3 minima) plus the tile
# origin and the cut (5)
B4_OPS_PER_SLOT = 62

CFG = DEFAULT
RC = CFG.raster

# Phase 4, the training path. The schedule is the TRAIN_r05.json recipe's
# (make_adaptive_multiview_train_step, l2, lr_final = lr / 20, decay over
# the run) with lr scaled to this scene: the recipe's 0.007 was set for
# gaussians of scale 0.03-0.08, these are 0.002-0.008, and Adam's first
# update moves every visible mean by about lr, so 0.007 would throw the
# means 1-3 sigma off their targets. The rate is scaled with the gaussians'
# size, 10x smaller.
TRAIN_VIEWS = 4
TRAIN_STEPS = 10
TRAIN_LR = 0.0007
DENSIFY_AFTER = 5
# densify after step 5 writes at most 1% of the capacity, and its gradient
# threshold is set from the run's statistics so that no more gaussians are
# candidates than that: with more candidates than new slots, the densify
# step (as the JAX package's) still shrinks every split candidate, also
# those that get no child, and that shrinks most of the scene at once
DENSIFY_NEW_FRACTION = 0.01
SCENE_EXTENT = 1.5


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sfu_rate() -> float:
    """exp results per second of the whole card at its maximum SM clock."""
    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_PER_CLOCK_PER_SM * sms * mhz * 1e6


def cuda_ms(fn, reps: int = 10, warmup: int = 2):
    """Median and all times (ms) of ``fn`` between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


class Frame:
    """Every intermediate of one render, so each stage can be run alone."""

    def __init__(self, scene, cam):
        self.scene, self.cam = scene, cam
        self.camp = CameraParams.from_camera(cam, scene.device)
        self.tx, self.ty = tile_grid(cam.width, cam.height, RC.tile_size)
        self.num_tiles = self.tx * self.ty
        self.db = 32 - tiles.depth_shift(self.num_tiles)
        self.proj = self.project()
        self.qd = tiles.depth_qkeys(self.proj.depth, self.proj.valid,
                                    self.num_tiles)
        self.bb = tiles.tile_bboxes(self.proj, tiles_x=self.tx,
                                    tiles_y=self.ty, tile_size=RC.tile_size)
        self.keys, self.gauss = self.enum_keys()
        self.binning = tiles.bin_tiles(self.proj, tiles_x=self.tx,
                                       tiles_y=self.ty,
                                       tile_size=RC.tile_size)
        self.ptab = pack_table(self.proj, scene.labels)
        self.counts = (self.binning.tile_bounds[1:]
                       - self.binning.tile_bounds[:-1])
        self._work = {}
        self._bwd_args = {}

    def project(self):
        return project(self.scene, self.camp, self.cam.width,
                       self.cam.height, RC, z_near=CFG.camera.z_near,
                       z_far=CFG.camera.z_far)

    def _enum_kw(self):
        return dict(tiles_x=self.tx, num_tiles=self.num_tiles,
                    tile_size=RC.tile_size, db=self.db)

    def enum_keys(self):
        return tiles.enum_keys(self.proj, self.qd, self.bb, **self._enum_kw())

    def enum_keys_plain(self):
        return tiles._enum_keys_plain(self.proj, self.qd, self.bb,
                                      **self._enum_kw())

    def sort(self):
        return torch.sort(self.keys, stable=True)

    def _blend_kw(self, eps):
        return dict(tiles_x=self.tx, tiles_y=self.ty,
                    tile_size=RC.tile_size, width=self.cam.width,
                    height=self.cam.height, chunk=CFG.tiles.chunk,
                    alpha_min=RC.alpha_min, alpha_max=RC.alpha_max,
                    early_eps=eps, with_labels=True)

    def blend(self, eps=RC.early_stop_eps):
        return blend.blend_tiles_fwd(self.ptab, self.binning.inst_gauss,
                                     self.binning.tile_bounds,
                                     **self._blend_kw(eps))

    def blend_plain(self, eps=RC.early_stop_eps):
        return blend._blend_tiles_fwd_plain(self.ptab, self.binning.inst_gauss,
                                            self.binning.tile_bounds,
                                            **self._blend_kw(eps))

    def render(self):
        return render(self.scene, self.cam, CFG, with_labels=True,
                      device=self.scene.device)

    def instance_counts(self):
        c = self.counts.cpu().numpy()
        return dict(valid=int(self.proj.valid.sum()), tiles=self.num_tiles,
                    slots=self.bb.total,
                    tight=int(self.binning.num_instances),
                    tile_max=int(c.max()), tile_median=float(np.median(c)))

    def b4_bound(self):
        n = self.proj.u.shape[0]
        nbytes = n * 12 * 4 + self.bb.total * 8
        ops = self.bb.total * B4_OPS_PER_SLOT
        return bound(nbytes, ops)

    def b1_work(self, eps):
        """(evaluated, live) instance-pixel pairs of B1 (and B2, which walks
        the same batches) under early stop ``eps``; computed once per eps."""
        if eps not in self._work:
            self._work[eps] = self._b1_work(eps)
        return self._work[eps]

    def _b1_work(self, eps):
        """(evaluated, live) instance-pixel pairs of B1 under early stop
        ``eps``: replays the kernel's tile-wide stop rule (a batch runs only
        while the tile's max T >= eps) on T alone, step by step as the plain
        version composites, and counts the pairs of the batches that run and
        those whose alpha passes the cut."""
        b = self.binning.tile_bounds
        start, cnt = b[:-1].long(), (b[1:] - b[:-1]).long()
        ts, chunk = RC.tile_size, CFG.tiles.chunk
        dev = self.ptab.device
        pid = torch.arange(ts * ts, device=dev)
        px = ((pid % ts).float() + 0.5)[None, :]
        py = ((pid // ts).float() + 0.5)[None, :]
        tid = torch.arange(self.num_tiles, device=dev)
        x0f = ((tid % self.tx) * ts).float()[:, None]
        y0f = ((tid // self.tx) * ts).float()[:, None]
        trans = torch.ones(self.num_tiles, ts * ts, device=dev)
        alive = torch.ones(self.num_tiles, dtype=torch.bool, device=dev)
        evaluated = torch.zeros((), dtype=torch.int64, device=dev)
        live_pairs = torch.zeros((), dtype=torch.int64, device=dev)
        last = max(self.binning.inst_gauss.shape[0] - 1, 0)
        for step in range(int(cnt.max())):
            if step % chunk == 0:
                alive = alive & (trans.amax(dim=1) >= eps)
            run = alive & (step < cnt)
            row = self.ptab[self.binning.inst_gauss[
                torch.clamp(start + step, max=last)].long()]
            dx = px - (row[:, blend.P_MX, None] - x0f)
            dy = py - (row[:, blend.P_MY, None] - y0f)
            q = ((row[:, blend.P_CA, None] * dx
                  + (2.0 * row[:, blend.P_CB, None]) * dy) * dx
                 + row[:, blend.P_CC, None] * dy * dy)
            alpha = torch.clamp_max(
                row[:, blend.P_OP, None] * torch.exp(-0.5 * q), RC.alpha_max)
            cut = (alpha >= RC.alpha_min) & run[:, None]
            alpha = torch.where(cut, alpha, torch.zeros_like(alpha))
            trans = trans * (1.0 - alpha)
            evaluated += run.sum() * (ts * ts)
            live_pairs += cut.sum()
        return int(evaluated), int(live_pairs)

    def b1_bound(self, sfu_per_s: float):
        evals, live = self.b1_work(RC.early_stop_eps)
        n = self.proj.u.shape[0]
        # each input read once: the [N, 16] table, the instance indices, the
        # tile bounds; rgb, T, best weight and label written once
        nbytes = (n * 16 * 4 + self.binning.inst_gauss.numel() * 4
                  + (self.num_tiles + 1) * 4
                  + self.cam.width * self.cam.height * 6 * 4)
        ops = evals * B1_OPS_PER_EVAL + live * B1_OPS_PER_LIVE
        t_sfu = evals / sfu_per_s * 1e3   # one exp per evaluated pair
        return bound(nbytes, ops, t_sfu), evals, live, t_sfu


    def bwd_args(self, eps=RC.early_stop_eps):
        """B2's inputs at early stop ``eps``: the stream, B1's (rgb, T)
        without labels, and a seeded random cotangent."""
        if eps not in self._bwd_args:
            kw = self._blend_kw(eps)
            kw["with_labels"] = False
            out = blend.blend_tiles_fwd(self.ptab, self.binning.inst_gauss,
                                        self.binning.tile_bounds, **kw)
            gen = torch.Generator(device=self.ptab.device).manual_seed(11)
            h, w = self.cam.height, self.cam.width
            self._bwd_args[eps] = (
                self.ptab, self.binning.inst_gauss, self.binning.tile_bounds,
                out.rgb, out.transmittance,
                torch.randn(h, w, 3, generator=gen, device=self.ptab.device),
                torch.randn(h, w, generator=gen, device=self.ptab.device))
        return self._bwd_args[eps]

    def _bwd_kw(self, eps):
        kw = self._blend_kw(eps)
        del kw["with_labels"]
        return kw

    def blend_bwd(self, eps=RC.early_stop_eps):
        return blend.blend_tiles_bwd(*self.bwd_args(eps), **self._bwd_kw(eps))

    def blend_bwd_plain(self, eps=RC.early_stop_eps):
        return blend._blend_tiles_bwd_plain(*self.bwd_args(eps),
                                            **self._bwd_kw(eps))

    def fold_rows(self):
        """The fold's input: B2's rows (default eps) in enumeration order."""
        return enumeration_rows(self.blend_bwd(), self.binning.je_sorted)

    def fold(self, drows):
        return fold_instance_rows(drows, self.binning.je_sorted,
                                  self.binning.enum_start,
                                  self.binning.enum_cnt)

    def b2_bound(self, sfu_per_s: float):
        evals, live = self.b1_work(RC.early_stop_eps)
        n = self.proj.u.shape[0]
        b = self.binning.inst_gauss.numel()
        # the [N, 16] table, indices, tile bounds, rgb/T and their
        # cotangents read once; the [B, 16] rows written once
        nbytes = (n * 16 * 4 + b * 4 + (self.num_tiles + 1) * 4
                  + self.cam.width * self.cam.height * 8 * 4 + b * 16 * 4)
        ops = evals * B1_OPS_PER_EVAL + live * B2_OPS_PER_LIVE
        t_sfu = evals / sfu_per_s * 1e3
        return bound(nbytes, ops, t_sfu), evals, live, t_sfu

    def b3_bound(self):
        b = self.binning.inst_gauss.numel()
        return bound(2 * b * 16 * 4, b * 16)


def bound(nbytes: int, ops: int, t_sfu: float = 0.0):
    """(bound_ms, bound_by, bytes, ops): the larger of the bytes over the
    HBM rate and the operations over their peak rate (f32, or the exp unit
    where ``t_sfu`` is larger)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / F32_FLOPS * 1e3, t_sfu)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def check_b4(frame: Frame) -> float:
    keys, gauss = frame.enum_keys()
    pkeys, pgauss = frame.enum_keys_plain()
    torch.cuda.synchronize()
    if not (torch.equal(keys, pkeys) and torch.equal(gauss, pgauss)):
        bad = int((keys != pkeys).sum() + (gauss != pgauss).sum())
        raise AssertionError(f"B4 differs from its plain version in {bad} "
                             "entries")
    return 0.0


def check_b1(frame: Frame, tag: str) -> float:
    """Max abs error over rgb, T, best weight at eps 0 and the default."""
    worst = 0.0
    for eps in (0.0, RC.early_stop_eps):
        out = frame.blend(eps)
        ref = frame.blend_plain(eps)
        torch.cuda.synchronize()
        errs = {k: float((getattr(out, k) - getattr(ref, k)).abs().max())
                for k in ("rgb", "transmittance", "best_weight")}
        labels_equal = bool(torch.equal(out.label, ref.label))
        log({"check": "B1 blend_tiles_fwd vs plain", "frame": tag,
             "early_stop_eps": eps, "max_abs_err": errs,
             "label_mismatches": int((out.label != ref.label).sum())})
        if max(errs.values()) > 1e-5 or not labels_equal:
            raise AssertionError(f"B1 differs from its plain version at "
                                 f"eps={eps}: {errs}, labels equal "
                                 f"{labels_equal}")
        worst = max(worst, *errs.values())
    return worst


def check_small_render(device) -> None:
    """The whole slice on the card against the same slice on the CPU."""
    scene = random_scene(2000, seed=21, num_labels=6, device="cpu")
    cam = look_at_camera((0.2, -0.3, -3.0), (0, 0, 0), width=128, height=96)
    bg = (0.3, 0.6, 0.9)
    got = render(scene, cam, CFG, background=bg, with_labels=True,
                 device=device)
    want = render(scene, cam, CFG, background=bg, with_labels=True,
                  device="cpu")
    res = {}
    for key in ("image", "transmittance", "best_weight"):
        err = (got[key].cpu() - want[key]).abs()
        res[key] = (float(err.max()), float((err <= 1e-5).float().mean()))
        if res[key][0] > 5e-3 or res[key][1] < 0.999:
            raise AssertionError(f"card render differs from CPU: {key} "
                                 f"{res[key]}")
    lab = float((got["label_map"].cpu() == want["label_map"]).float().mean())
    log({"check": "render card vs CPU", "scene": "random 2000, 128x96",
         "max_abs_err_and_share_within_1e-5": res, "label_agreement": lab})
    if lab < 0.999:
        raise AssertionError(f"card label map agrees on {lab} only")


def check_b2(frame: Frame, tag: str) -> float:
    """B2 against its plain version at eps 0 and the default: each column
    within 1e-4 of its peak (the per-tile sums are associated differently),
    the same zero rows. Returns the max abs error."""
    worst = 0.0
    for eps in (0.0, RC.early_stop_eps):
        got = frame.blend_bwd(eps)
        ref = frame.blend_bwd_plain(eps)
        torch.cuda.synchronize()
        diff = (got[:, :9] - ref[:, :9]).abs().amax(0)
        rel = diff / ref[:, :9].abs().amax(0).clamp_min(1e-30)
        zeros_equal = bool(torch.equal((got == 0).all(1), (ref == 0).all(1)))
        log({"check": "B2 blend_tiles_bwd vs plain", "frame": tag,
             "early_stop_eps": eps, "rows": got.shape[0],
             "zero_rows": int((ref == 0).all(1).sum()),
             "max_abs_err": float(diff.max()),
             "max_err_over_column_peak": rel.tolist(),
             "zero_rows_equal": zeros_equal})
        if float(rel.max()) > 1e-4 or not zeros_equal or got[:, 9:].any():
            raise AssertionError(f"B2 differs from its plain version at "
                                 f"eps={eps}: {rel.tolist()}, zero rows "
                                 f"equal {zeros_equal}")
        worst = max(worst, float(diff.max()))
    return worst


def check_b3(frame: Frame, tag: str) -> float:
    """B3 on the fold's real input against a float64 prefix sum: within
    1e-6 of each column's peak |prefix|. Returns the max abs error."""
    x = frame.fold_rows()
    got = blend.cumsum_rows(x)
    lib = torch.cumsum(x, 0)
    want = torch.cumsum(x.double(), 0)
    torch.cuda.synchronize()
    peak = want[:, :9].abs().amax(0)
    err = (got[:, :9].double() - want[:, :9]).abs().amax(0)
    lib_err = (lib[:, :9].double() - want[:, :9]).abs().amax(0)
    rel = (err / peak).tolist()
    log({"check": "B3 cumsum_rows vs float64", "frame": tag,
         "rows": x.shape[0], "max_abs_err": float(err.max()),
         "max_err_over_column_peak": rel,
         "torch_cumsum_f32_err_over_column_peak": (lib_err / peak).tolist()})
    if max(rel) > 1e-6 or got[:, 9:].any():
        raise AssertionError(f"B3 differs from float64 by {rel}")
    return float(err.max())


def check_gradients(device) -> None:
    """Scene gradients through render on the card against the CPU's:
    random 2000-gaussian scene, 128x96, l2 against a fixed target; each of
    the five tensors within 1e-3 of its peak."""
    scene = random_scene(2000, seed=21, num_labels=6, device="cpu")
    cam = look_at_camera((0.2, -0.3, -3.0), (0, 0, 0), width=128, height=96)
    target = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(96, 128, 3)).astype(np.float32))
    grads = {}
    for dev in (device, torch.device("cpu")):
        s = scene.to(dev)
        params = trainer.SceneParams.from_scene(s)
        for p in params:
            p.requires_grad_(True)
        out = render(params.to_scene(s.labels), cam, CFG, device=dev)
        loss = trainer.l2_loss(out["image"], target.to(dev))
        grads[dev.type] = [g.cpu() for g in torch.autograd.grad(loss, params)]
    errs = {}
    for f, g_card, g_cpu in zip(trainer.SceneParams._fields, grads["cuda"],
                                grads["cpu"]):
        errs[f] = float((g_card - g_cpu).abs().max() / g_cpu.abs().max())
        if not bool(torch.isfinite(g_card).all()):
            raise AssertionError(f"card gradient of {f} is not finite")
    log({"check": "scene gradients card vs CPU",
         "scene": "random 2000, 128x96, l2", "max_err_over_peak": errs})
    if max(errs.values()) > 1e-3:
        raise AssertionError(f"card gradients differ from CPU: {errs}")


def reset_launches() -> None:
    for fn in (tiles.enum_keys, blend.blend_tiles_fwd, blend.blend_tiles_bwd,
               blend.cumsum_rows):
        fn.launches = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {"enum_keys": tiles.enum_keys.launches,
            "blend_tiles_fwd": blend.blend_tiles_fwd.launches,
            "blend_tiles_bwd": blend.blend_tiles_bwd.launches,
            "cumsum_rows": blend.cumsum_rows.launches}


def train_main_path(scene, device):
    """Phase 4: the adaptive multiview train steps at real size."""
    cams = orbit_cameras(TRAIN_VIEWS, 3.0, width=WIDTH, img_height=HEIGHT)
    with torch.no_grad():
        targets = torch.stack([render(scene, c, CFG, device=device)["image"]
                               for c in cams])
    gen = torch.Generator(device=device).manual_seed(5)
    n = scene.num_gaussians
    p = trainer.SceneParams.from_scene(scene)
    sh = p.sh.clone()
    sh[:, 0] += 0.05 * torch.randn(n, 3, generator=gen, device=device)
    p = p._replace(
        means=p.means + 0.002 * torch.randn(n, 3, generator=gen,
                                            device=device),
        sh=sh, opacities=p.opacities - 0.5)
    capacity = -(-int(1.25 * n) // 128) * 128
    p, labels = densify.pad_to_capacity(p, scene.labels, capacity)
    sched = dict(lr=TRAIN_LR, lr_final=TRAIN_LR / 20,
                 decay_steps=TRAIN_STEPS)
    step = trainer.make_adaptive_multiview_train_step(
        (WIDTH, HEIGHT), CFG, loss="l2", **sched)
    state = trainer.init_state(p.to_scene(labels), **sched)
    stats = densify.DensifyStats.zeros(capacity, device=device)
    camsb = trainer.stack_cameras([CameraParams.from_camera(c, device)
                                   for c in cams])
    bg = torch.zeros(3, device=device)
    losses, dropped = [], 0
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        state, stats, loss, nd = step(state, stats, labels, camsb, targets,
                                      bg)
        losses.append(float(loss))
        dropped = max(dropped, int(nd))
        if i + 1 == DENSIFY_AFTER:
            alive0 = int(densify.num_alive(state.params))
            g_avg = stats.grad_accum / stats.count.clamp_min(1.0)
            max_new = int(DENSIFY_NEW_FRACTION * capacity)
            cfg = densify.DensifyConfig(
                grad_threshold=float(torch.topk(g_avg, max_new).values[-1]),
                max_new_fraction=DENSIFY_NEW_FRACTION)
            new, labels, stats, written = densify.densify_and_prune(
                state.params, labels, stats, gen, SCENE_EXTENT, cfg)
            state = trainer.TrainState(
                new, trainer.zero_adam_rows(state.opt_state, written),
                state.step)
            log({"phase": "densify", "after_step": i + 1,
                 "alive_before": alive0,
                 "alive_after": int(densify.num_alive(state.params)),
                 "rewritten_slots": int(written.sum()),
                 "grad_threshold": cfg.grad_threshold,
                 "hot": int((g_avg > cfg.grad_threshold).sum()),
                 "capacity": capacity})
    launches = read_launches()
    wall = time.perf_counter() - t0
    with torch.no_grad():
        final = sum(float(trainer.l2_loss(
            _render_impl(state.params.to_scene(labels),
                         CameraParams.from_camera(cam, device), bg,
                         width=WIDTH, height=HEIGHT, cfg=CFG,
                         with_labels=False)["image"], target))
                    for cam, target in zip(cams, targets)) / TRAIN_VIEWS
    finite = all(bool(torch.isfinite(t).all()) for t in state.params)
    log({"phase": "train main path", "gaussians": n, "capacity": capacity,
         "views": TRAIN_VIEWS, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
         "losses": losses, "loss_after_last_step": final,
         "num_dropped": dropped, "finite": finite, "launches": launches,
         "wall_s": wall, "ms_per_step": wall / TRAIN_STEPS * 1e3})
    want = TRAIN_STEPS * TRAIN_VIEWS
    for name, count in launches.items():
        if count != want:
            raise AssertionError(f"{name} launched {count} times in "
                                 f"{TRAIN_STEPS} steps of {TRAIN_VIEWS} "
                                 "views")
    if not (finite and dropped == 0 and final < losses[0]):
        raise AssertionError(f"training went wrong: loss {losses[0]} -> "
                             f"{final}, finite {finite}, dropped {dropped}")
    return launches, state, labels, cams, targets


def time_train_step(state, labels, cam, target, device, card):
    """One single-view make_train_step step (l2) at the 2M frame, timed
    whole and split into forward, B2, fold, projection backward and Adam."""
    camp = CameraParams.from_camera(cam, device)
    bg = torch.zeros(3, device=device)
    step = trainer.make_train_step((WIDTH, HEIGHT), CFG, lr=TRAIN_LR,
                                   loss="l2")
    torch.cuda.reset_peak_memory_stats()
    row = {}
    row["step"], runs = cuda_ms(
        lambda: step(state, labels, camp, target, bg), reps=5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    leaves = [t.detach().requires_grad_(True) for t in state.params]
    scene = trainer.SceneParams(*leaves).to_scene(labels)

    def forward():
        out = _render_impl(scene, camp, bg, width=WIDTH, height=HEIGHT,
                           cfg=CFG, with_labels=False)
        return trainer.l2_loss(out["image"], target)

    row["forward"], _ = cuda_ms(forward, reps=5, warmup=1)
    loss = forward()
    row["backward"], _ = cuda_ms(
        lambda: torch.autograd.grad(loss, leaves, retain_graph=True),
        reps=5, warmup=1)
    grads = trainer.SceneParams(*torch.autograd.grad(loss, leaves))
    fr = Frame(trainer.SceneParams(*(t.detach() for t in state.params))
               .to_scene(labels), cam)
    row["B2"], _ = cuda_ms(fr.blend_bwd, reps=5, warmup=1)
    drows = fr.blend_bwd()
    row["fold"], _ = cuda_ms(lambda: fr.fold(drows), reps=5, warmup=1)
    rows = enumeration_rows(drows, fr.binning.je_sorted)
    cs = blend.cumsum_rows(rows)
    for part, fn in (
            ("fold: scatter", lambda: enumeration_rows(
                drows, fr.binning.je_sorted)),
            ("fold: B3", lambda: blend.cumsum_rows(rows)),
            ("fold: gathers", lambda: segment_sums(
                cs, fr.binning.enum_start, fr.binning.enum_cnt))):
        row[part], _ = cuda_ms(fn, reps=5, warmup=1)
    opt = trainer.scaled_adam(TRAIN_LR)
    row["adam"], _ = cuda_ms(
        lambda: opt.update(grads, state.opt_state, state.params), reps=5,
        warmup=1)
    row["projection backward"] = row["backward"] - row["B2"] - row["fold"]
    log({"measure": "train step", "frame": "2M view 0 (training state)",
         "capacity": int(state.params.means.shape[0]), "ms": row,
         "step_runs_ms": runs, "max_memory_allocated_bytes": peak,
         "card": card})
    return row, peak


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = smi("name,power.limit")
    log(card)
    sfu = sfu_rate()
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0],
         "device": torch.cuda.get_device_name(0)})

    # 1. build
    t0 = time.perf_counter()
    built = _kernels.build()
    log({"phase": "build", "wall_s": time.perf_counter() - t0,
         "per_source_s": {k: v["seconds"] for k, v in built.items()}})
    for name, info in built.items():
        for line in info["ptxas"].splitlines():
            if "ptxas info" in line or "spill" in line:
                log(f"[{name}] {line.strip()}")

    # 2. bench frame: kernels against plain versions, counts, small render
    bench = Frame(random_scene(100_000, seed=0, extent=1.5,
                               scale_range=(0.004, 0.02), num_labels=16,
                               device=device),
                  look_at_camera((0, 0, -3.0), (0, 0, 0), width=WIDTH,
                                 height=HEIGHT))
    err_b4 = check_b4(bench)
    log({"check": "B4 enum_keys vs plain", "frame": "bench",
         "keys_equal": True, "slots": bench.bb.total})
    err_b1 = check_b1(bench, "bench")
    err_b2 = check_b2(bench, "bench")
    counts = bench.instance_counts()
    log({"bench_frame_counts": counts, "jax_binning_counts": BENCH_COUNTS})
    if counts != BENCH_COUNTS:
        raise AssertionError("bench-frame instance counts differ from the "
                             "JAX binning's")
    check_small_render(device)
    check_gradients(device)

    # 3. serving path: 2M gaussians through PLY, 8 views, with labels
    t0 = time.perf_counter()
    made = random_scene(2_000_000, seed=0, extent=1.5,
                        scale_range=(0.002, 0.008), num_labels=16,
                        device=device)
    ply_dir = REPO / "build" / "chip_smoke"
    ply_dir.mkdir(parents=True, exist_ok=True)
    ply_path = ply_dir / "scene_2m.ply"
    scene_to_ply(str(ply_path), made)
    scene = scene_from_ply(str(ply_path), device=device)
    ply_bytes = ply_path.stat().st_size
    ply_path.unlink()
    for f in ("means", "log_scales", "quats", "opacities", "sh", "labels"):
        if not torch.equal(getattr(scene, f), getattr(made, f)):
            raise AssertionError(f"PLY round trip changed {f}")
    del made
    log({"phase": "scene", "gaussians": scene.num_gaussians,
         "ply_bytes": ply_bytes, "seconds": time.perf_counter() - t0})
    cams = orbit_cameras(8, 3.0, width=WIDTH, img_height=HEIGHT)

    reset_launches()
    frames = [render(scene, cam, CFG, with_labels=True, device=device)
              for cam in cams]
    launches = read_launches()
    log({"phase": "main path", "views": len(cams), "launches": launches})
    for name in ("enum_keys", "blend_tiles_fwd"):
        n = launches[name]
        if n != len(cams):
            raise AssertionError(f"{name} launched {n} times for "
                                 f"{len(cams)} frames")
    for i, out in enumerate(frames):
        finite = all(bool(torch.isfinite(out[k]).all()) for k in
                     ("image", "alpha", "transmittance", "best_weight"))
        coverage = float((out["alpha"] > 0.5).float().mean())
        labelled = float((out["label_map"] != UNLABELED).float().mean())
        lab_ok = bool(((out["label_map"] == UNLABELED)
                       | ((out["label_map"] >= 0)
                          & (out["label_map"] < 16))).all())
        dropped = int(out["num_dropped"])
        log({"view": i, "finite": finite, "coverage": coverage,
             "labelled": labelled, "num_dropped": dropped})
        if not (finite and coverage > 0 and lab_ok and dropped == 0
                and out["image"].shape == (HEIGHT, WIDTH, 3)):
            raise AssertionError(f"view {i} is wrong")
    del frames

    big = Frame(scene, cams[0])
    err_b4 = max(err_b4, check_b4(big))
    log({"check": "B4 enum_keys vs plain", "frame": "2M view 0",
         "keys_equal": True, "slots": big.bb.total})
    err_b1 = max(err_b1, check_b1(big, "2M view 0"))
    err_b2 = max(err_b2, check_b2(big, "2M view 0"))
    err_b3 = check_b3(big, "2M view 0")
    log({"main_frame_counts": big.instance_counts()})

    # 4. training path: adaptive multiview steps at 2M, one densify
    train_launches, state, labels, train_cams, targets = train_main_path(
        scene, device)
    train_row, train_peak = time_train_step(state, labels, train_cams[0],
                                            targets[0], device, card)
    del state, labels, targets

    # 5. times
    results = {}
    for tag, fr, plain_reps in (("bench", bench, 10), ("2M view 0", big, 3)):
        torch.cuda.reset_peak_memory_stats()
        row = {}
        for stage, fn in (("project", fr.project), ("B4 enum_keys",
                          fr.enum_keys), ("sort", fr.sort),
                          ("B1 blend_tiles_fwd", fr.blend),
                          ("render", fr.render)):
            ms, runs = cuda_ms(fn)
            row[stage] = ms
            log({"measure": stage, "frame": tag, "ms": ms, "runs_ms": runs,
                 "card": card})
        peak = torch.cuda.max_memory_allocated()
        rows = fr.fold_rows()
        drows = fr.blend_bwd()
        for stage, fn in (("B2 blend_tiles_bwd", fr.blend_bwd),
                          ("fold", lambda: fr.fold(drows)),
                          ("B3 cumsum_rows", lambda: blend.cumsum_rows(rows)),
                          ("torch.cumsum", lambda: torch.cumsum(rows, 0))):
            ms, runs = cuda_ms(fn)
            row[stage] = ms
            log({"measure": stage, "frame": tag, "ms": ms, "runs_ms": runs,
                 "card": card})
        for stage, fn, reps in (("B4 plain", fr.enum_keys_plain, 10),
                                ("B1 plain", fr.blend_plain, plain_reps),
                                ("B2 plain", fr.blend_bwd_plain, plain_reps),
                                ("B3 plain", lambda: blend._cumsum_rows_plain(
                                    rows), 10)):
            ms, runs = cuda_ms(fn, reps=reps, warmup=1)
            row[stage] = ms
            log({"measure": stage, "frame": tag, "ms": ms, "runs_ms": runs,
                 "card": card})
        row["glue"] = row["render"] - sum(
            row[s] for s in ("project", "B4 enum_keys", "sort",
                             "B1 blend_tiles_fwd"))
        b4 = fr.b4_bound()
        b1, evals, live, t_sfu = fr.b1_bound(sfu)
        b2, _, _, _ = fr.b2_bound(sfu)
        b3 = fr.b3_bound()
        log({"measure": "render peak memory", "frame": tag,
             "max_memory_allocated_bytes": peak, "card": card})
        log({"measure": "bounds", "frame": tag,
             "B4": {"bound_ms": b4[0], "bound_by": b4[1], "bytes": b4[2],
                    "ops": b4[3]},
             "B1": {"bound_ms": b1[0], "bound_by": b1[1], "bytes": b1[2],
                    "ops": b1[3], "evaluated_pairs": evals,
                    "live_pairs": live,
                    "all_pairs": int(fr.counts.sum()) * RC.tile_size ** 2,
                    "f32_ms": b1[3] / F32_FLOPS * 1e3, "exp_ms": t_sfu,
                    "exp_per_s": sfu},
             "B2": {"bound_ms": b2[0], "bound_by": b2[1], "bytes": b2[2],
                    "ops": b2[3], "f32_ms": b2[3] / F32_FLOPS * 1e3,
                    "exp_ms": t_sfu},
             "B3": {"bound_ms": b3[0], "bound_by": b3[1], "bytes": b3[2],
                    "ops": b3[3]},
             "glue_ms": row["glue"], "card": card})
        results[tag] = (row, b4, b1, b2, b3)

    row, b4, b1, b2, b3 = results["2M view 0"]
    by_path = {k: {"render": launches[k], "train": train_launches[k]}
               for k in launches}
    kernels = [
        {"name": "enum_keys", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/enum_keys.cu",
         "replaces": "gsplat_tpu/render/tiles.py:119",
         "launches": launches["enum_keys"], "max_abs_err": err_b4,
         "ms": row["B4 enum_keys"], "plain_ms": row["B4 plain"],
         "bound_ms": b4[0], "bound_by": b4[1], "library_ms": None},
        {"name": "blend_tiles_fwd", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/blend_fwd.cu",
         "replaces": "gsplat_tpu/render/blend_pallas.py:210",
         "launches": launches["blend_tiles_fwd"], "max_abs_err": err_b1,
         "ms": row["B1 blend_tiles_fwd"], "plain_ms": row["B1 plain"],
         "bound_ms": b1[0], "bound_by": b1[1], "library_ms": None},
        {"name": "blend_tiles_bwd", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/blend_bwd.cu",
         "replaces": "gsplat_tpu/render/blend_pallas.py:299",
         "launches": train_launches["blend_tiles_bwd"],
         "max_abs_err": err_b2, "ms": row["B2 blend_tiles_bwd"],
         "plain_ms": row["B2 plain"], "bound_ms": b2[0], "bound_by": b2[1],
         "library_ms": None},
        {"name": "cumsum_rows", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/cumsum_rows.cu",
         "replaces": "gsplat_tpu/render/blend_pallas.py:534",
         "launches": train_launches["cumsum_rows"], "max_abs_err": err_b3,
         "ms": row["B3 cumsum_rows"], "plain_ms": row["B3 plain"],
         "bound_ms": b3[0], "bound_by": b3[1],
         "library_ms": row["torch.cumsum"]},
    ]
    # "launches" counts each kernel on the path that brought it: the 8-view
    # render for B4 and B1, the 10 training steps for B2 and B3; both
    # counts are in launches_by_path. No single PyTorch call computes B4,
    # B1 or B2, hence no library time; B3's is torch.cumsum.
    for k in kernels:
        k["launches_by_path"] = by_path[k["name"]]
    log({"measure": "train step breakdown", "ms": train_row,
         "max_memory_allocated_bytes": train_peak, "card": card})
    log(card)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
