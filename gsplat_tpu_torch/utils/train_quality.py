"""Training-quality gate: fit a scene from random init and score held-out
views.

Counterpart of ``scripts/train_quality.py``. Gradients that match a
reference are necessary but not sufficient evidence that training works;
this gate drives the whole differentiable path of the port (renderer, the
backward kernels, the optimizer, adaptive density control, the PLY round
trip) on a scene whose parameters it never sees:

1. a synthetic ground-truth scene (:func:`make_gt_scene`: an opaque
   normal-coloured sphere shell and a ring of smooth-coloured satellite
   blobs) rendered from a staggered orbit ring (:func:`orbit_ring`) and
   written as PNGs (``io/png.py``) beside ``cameras_train.json``; four
   views, interleaved around the ring (:func:`held_out`), are never
   trained on;
2. a fit from random init with ``trainer.make_adaptive_multiview_train_step``
   (view-averaged gradients, l2, lr decaying to lr/20 over the run) and
   ``densify_and_prune`` every ``--densify-every`` iterations until 60% of
   the run, the rewritten slots' Adam moments zeroed;
3. the alive set compacted, written to PLY and read back, and scored on the
   held-out views with ``models/losses.py``'s PSNR and SSIM.

The artifact keeps the JAX script's keys. Left out: its budget measuring
and re-pinning (the port sizes every buffer from the exact count, so no
instance is dropped: ``budget_repin_events`` is ``[]`` and a drop is an
error). Added: the held-out PSNR of the initial scene, each densify's alive
counts and the multiview step's times (milliseconds of the steps after the
first, each ended by reading the step's ``num_dropped``). The split
noise of the densify comes from ``torch.Generator(device).manual_seed(0)``::

    python -m gsplat_tpu_torch.utils.train_quality [--device cpu] [--out PATH]

runs on the card unless ``--device`` names another device, and writes the
artifact to ``--out`` (default ``build/train_quality_torch.json``). It exits
with 2 when the mean held-out PSNR is below 28 dB.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Set

import numpy as np
import torch

from gsplat_tpu_torch.config import DEFAULT
from gsplat_tpu_torch.io import ply
from gsplat_tpu_torch.io.cameras import Camera, look_at_camera, save_cameras
from gsplat_tpu_torch.io.png import write_png
from gsplat_tpu_torch.io.synthetic import random_scene, sphere_scene
from gsplat_tpu_torch.models import densify, trainer
from gsplat_tpu_torch.models.losses import psnr, ssim
from gsplat_tpu_torch.render.api import measure_budgets_multi, render
from gsplat_tpu_torch.render.projection import CameraParams
from gsplat_tpu_torch.scene import (FIELDS, DeviceLike, GaussianScene,
                                    color_to_dc, resolve_device,
                                    scene_from_numpy)

DEFAULT_OUT = Path("build") / "train_quality_torch.json"
TARGET_PSNR_DB = 28.0
SCENE_EXTENT = 1.3


def make_gt_scene(n_sphere: int, n_blobs: int, seed: int = 0,
                  device: DeviceLike = None) -> GaussianScene:
    """The ground truth, bit for bit the JAX script's: a sphere shell of
    radius 0.8 with normal-coded colours and opacity logit 4 (opaque), and
    ``n_blobs`` blobs pushed out of the sphere onto a satellite ring of
    radius 1.0-1.3, coloured by a smooth function of position. A novel-view
    gate needs a well-posed object with a clean silhouette: random confetti
    colours are a noise texture no fit generalises, and a translucent fog
    around the cameras is depth-ambiguous."""
    sph = sphere_scene(n_sphere, radius=0.8, seed=seed, scale=0.08,
                       device="cpu").to_numpy()
    blobs = random_scene(n_blobs, seed=seed + 1, extent=1.0,
                         scale_range=(0.06, 0.12), num_labels=8,
                         device="cpu").to_numpy()
    m = np.array(blobs["means"])
    r = np.linalg.norm(m, axis=1, keepdims=True)
    m = m / np.maximum(r, 1e-6) * (1.0 + 0.3 * (r / np.abs(m).max()))
    rgb = 0.5 + 0.45 * np.stack([np.sin(2.1 * m[:, 0] + 0.3),
                                 np.sin(2.3 * m[:, 1] + 1.7),
                                 np.sin(2.7 * m[:, 2] + 3.1)], axis=-1)
    sh = np.array(blobs["sh"])
    sh[:, 0, :] = color_to_dc(rgb)
    sph["opacities"] = np.full((n_sphere,), 4.0, np.float32)
    repl = {"sh": sh, "opacities": np.full((m.shape[0],), 4.0, np.float32),
            "means": m}
    return scene_from_numpy(**{f: np.concatenate([sph[f], repl.get(
        f, blobs[f])]) for f in FIELDS}, device=device)


def orbit_ring(views: int, width: int, height: int) -> List[Camera]:
    """``views`` cameras on a ring of radius 3.4 around the origin, their
    heights staggered (1.1 sin(2.1 i)) so that the views constrain 3D
    structure, not one great circle."""
    cams = []
    for i in range(views):
        a = 2 * np.pi * i / views
        eye = np.array([3.4 * np.cos(a), 1.1 * np.sin(2.1 * i),
                        3.4 * np.sin(a)])
        cams.append(look_at_camera(eye, (0, 0, 0), width=width,
                                   height=height, cam_id=i,
                                   img_name=f"view{i:03d}"))
    return cams


def held_out(views: int) -> Set[int]:
    """The four held-out views, interleaved around the ring: novel-view
    synthesis interpolates between seen views, and a contiguous held-out
    arc would be a wedge of azimuth no training view constrains."""
    return set(int(i) for i in np.linspace(0, views, 4, endpoint=False,
                                           dtype=int) + views // 8)


def initial_state(n_init: int, capacity_factor: float, lr: float,
                  iters: int, device: DeviceLike = None):
    """(state, densify stats, labels) of the fit's start: ``n_init`` random
    gaussians (seed 5) padded with dead slots to ``n_init *
    capacity_factor``, rounded up to a multiple of 128."""
    device = resolve_device(device)
    init = random_scene(n_init, seed=5, extent=1.1, scale_range=(0.03, 0.08),
                        device=device)
    capacity = -(-int(n_init * capacity_factor) // 128) * 128
    params, labels = densify.pad_to_capacity(
        trainer.SceneParams.from_scene(init), init.labels, capacity)
    state = trainer.init_state(params.to_scene(labels), lr=lr,
                               lr_final=lr / 20.0, decay_steps=iters)
    return state, densify.DensifyStats.zeros(capacity, device=device), labels


def _score(scene: GaussianScene, cams, gt_images, device) -> list:
    """Per-view PSNR (2 decimals) and SSIM (4), as the JAX script rounds
    them; a dropped instance is an error."""
    per_view = []
    with torch.no_grad():
        for c in cams:
            out = render(scene, c, DEFAULT, device=device)
            nd = int(out["num_dropped"])
            if nd:
                raise AssertionError(f"render of {c.img_name} dropped {nd}")
            img = torch.clamp(out["image"], 0.0, 1.0)
            tgt = gt_images[c.img_name]
            per_view.append(dict(view=c.img_name,
                                 psnr=round(float(psnr(img, tgt)), 2),
                                 ssim=round(float(ssim(img, tgt)), 4)))
    return per_view


def _mean(per_view: list, key: str, digits: int) -> float:
    return round(sum(v[key] for v in per_view) / len(per_view), digits)


def main(argv: Optional[list] = None) -> int:
    """The JAX script's arguments and defaults, plus ``--device``; the
    artifact goes to ``build/`` by default."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=4500)
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--height", type=int, default=144)
    ap.add_argument("--views", type=int, default=28,
                    help="total orbit views; four are held out")
    ap.add_argument("--gt-sphere", type=int, default=1500)
    ap.add_argument("--gt-blobs", type=int, default=400)
    ap.add_argument("--init", type=int, default=4000)
    ap.add_argument("--densify-every", type=int, default=200)
    ap.add_argument("--grad-threshold", type=float, default=2e-5,
                    help="densify trigger on the view-averaged gradient "
                         "norm (the 3DGS default 2e-4 assumes per-view "
                         "accumulation, about V times larger)")
    ap.add_argument("--lr", type=float, default=7e-3)
    ap.add_argument("--capacity-factor", type=float, default=4.0,
                    help="live-set capacity = init * factor")
    ap.add_argument("--budget-headroom", type=float, default=1.35,
                    help="accepted and ignored: the port sizes its buffers "
                         "from exact counts")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t_all = time.time()
    work = Path(args.workdir or tempfile.mkdtemp(prefix="train_quality_"))
    (work / "images").mkdir(parents=True, exist_ok=True)
    print(f"workdir: {work}", file=sys.stderr)

    # --- 1. ground truth and its views -----------------------------------
    gt = make_gt_scene(args.gt_sphere, args.gt_blobs, device=device)
    cams = orbit_ring(args.views, args.width, args.height)
    hold_idx = held_out(args.views)
    train_cams = [c for i, c in enumerate(cams) if i not in hold_idx]
    hold_cams = [c for i, c in enumerate(cams) if i in hold_idx]
    gt_images = {}
    with torch.no_grad():
        for c in cams:
            out = render(gt, c, DEFAULT, device=device)
            nd = int(out["num_dropped"])
            if nd:
                raise AssertionError(f"GT render of {c.img_name} dropped "
                                     f"{nd}")
            img = torch.clamp(out["image"], 0.0, 1.0)
            gt_images[c.img_name] = img
            write_png(str(work / "images" / f"{c.img_name}.png"),
                      (img.cpu().numpy() * 255).astype(np.uint8))
    save_cameras(str(work / "cameras_train.json"), train_cams)
    print(f"GT: {gt.num_gaussians} gaussians, {len(train_cams)} train + "
          f"{len(hold_cams)} held-out views at {args.width}x{args.height}",
          file=sys.stderr)

    # --- 2. fit from random init: adaptive multiview step + densify ------
    t_train = time.time()
    state, stats, labels = initial_state(args.init, args.capacity_factor,
                                         args.lr, args.iters, device)
    initial = _score(state.params.to_scene(labels), hold_cams, gt_images,
                     device)
    step = trainer.make_adaptive_multiview_train_step(
        (args.width, args.height), DEFAULT, lr=args.lr,
        lr_final=args.lr / 20.0, decay_steps=args.iters, loss="l2")
    camsb = trainer.stack_cameras([CameraParams.from_camera(c, device)
                                   for c in train_cams])
    targets = torch.stack([gt_images[c.img_name] for c in train_cams])
    bg = torch.zeros(3, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    densify_until = int(0.6 * args.iters)
    dcfg = densify.DensifyConfig(grad_threshold=args.grad_threshold)
    densify_events, step_ms, losses = [], [], []
    for it in range(args.iters):
        t0 = time.perf_counter()
        state, stats, loss, nd = step(state, stats, labels, camsb, targets,
                                      bg)
        nd = int(nd)   # reading it ends the step on the card
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if nd:
            raise AssertionError(f"train step {it} dropped {nd} instances")
        if (args.densify_every and 0 < it < densify_until
                and it % args.densify_every == 0):
            before = int(densify.num_alive(state.params))
            params, labels, stats, written = densify.densify_and_prune(
                state.params, labels, stats, gen, SCENE_EXTENT, dcfg)
            state = trainer.TrainState(
                params, trainer.zero_adam_rows(state.opt_state, written),
                state.step)
            densify_events.append(dict(
                iter=it, alive_before=before,
                alive_after=int(densify.num_alive(state.params)),
                rewritten=int(written.sum())))
        if it % 250 == 0 or it == args.iters - 1:
            losses.append(dict(iter=it, loss=float(loss)))
            print(f"it {it}: loss {float(loss):.5f} "
                  f"alive {int(densify.num_alive(state.params))} "
                  f"dropped {nd} ({time.time() - t_train:.1f} s)",
                  file=sys.stderr)

    # PLY round trip: the alive set, compacted, written and read back
    with torch.no_grad():
        alive = state.params.opacities > densify.DEAD_LOGIT + 1.0
        final = state.params.to_scene(labels)
        final = GaussianScene(*(getattr(final, f)[alive] for f in FIELDS))
    fitted_ply = work / "fitted.ply"
    ply.scene_to_ply(str(fitted_ply), final)
    train_s = time.time() - t_train

    # --- 3. held-out evaluation ------------------------------------------
    fitted = ply.scene_from_ply(str(fitted_ply), device=device)
    reloaded = all(torch.equal(getattr(fitted, f), getattr(final, f))
                   for f in FIELDS)
    per_view = _score(fitted, hold_cams, gt_images, device)
    for v in per_view:
        print(f"held-out {v['view']}: PSNR {v['psnr']} dB SSIM {v['ssim']}",
              file=sys.stderr)
    mean_psnr = _mean(per_view, "psnr", 2)
    mean_ssim = _mean(per_view, "ssim", 4)
    counts = measure_budgets_multi(fitted, train_cams, DEFAULT,
                                   device=device)
    steady = step_ms[1:] or step_ms   # the first step loads the kernels

    artifact = dict(
        metric="held-out novel-view quality after fitting from random init "
               "(full product path: adaptive multiview steps + "
               "densification + PLY round-trip)",
        backend=(torch.cuda.get_device_name(device)
                 if device.type == "cuda" else device.type),
        gt=dict(num_gaussians=int(gt.num_gaussians), views=args.views,
                held_out=len(hold_cams), width=args.width,
                height=args.height),
        fit=dict(init_gaussians=args.init,
                 final_gaussians=int(fitted.num_gaussians),
                 iters=args.iters, loss="l2",
                 step="make_adaptive_multiview_train_step", lr=args.lr,
                 densify_every=args.densify_every,
                 train_wall_s=round(train_s, 1),
                 budget_repin_events=[],
                 final_budgets=dict(zip(
                     ("budget", "kernel_budget", "num_windows"), counts)),
                 densify_events=densify_events,
                 ply_reloaded=reloaded,
                 losses=losses,
                 step_ms=dict(median=statistics.median(steady),
                              min=min(steady), max=max(steady),
                              p90=float(np.percentile(steady, 90)),
                              first=step_ms[0], steps=len(steady))),
        held_out=per_view,
        initial_mean_psnr_db=_mean(initial, "psnr", 2),
        mean_psnr_db=mean_psnr,
        mean_ssim=mean_ssim,
        num_dropped=0,
        wall_s=round(time.time() - t_all, 1),
        target=f"mean held-out PSNR >= {TARGET_PSNR_DB:g} dB",
        reached=bool(mean_psnr >= TARGET_PSNR_DB),
    )
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=1))
    print(f"mean held-out PSNR {mean_psnr} dB, SSIM {mean_ssim} "
          f"({'PASS' if artifact['reached'] else 'BELOW TARGET'}); "
          f"wrote {out}")
    return 0 if artifact["reached"] else 2


if __name__ == "__main__":
    sys.exit(main())
