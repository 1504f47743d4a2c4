"""Hardware-parity gate: the image, labels and scene gradients of the card's
kernels against the dense autograd reference on the CPU.

Counterpart of ``scripts/verify_tpu.py`` (``PARITY_TPU.json``), on its
problem: ``random_scene(4000, seed=7, extent=1.0, scale_range=(0.01,
0.05), num_labels=8)`` seen by ``look_at_camera((0.3, -0.2, -2.5), (0, 0,
0))`` at 160x128, a seeded target and the loss ``0.5 * sum((image -
target)^2)`` (:func:`build_problem`). Two stages in one process (the
card's machine has no JAX):

1. :func:`reference_stage`, on the CPU: the dense path of
   ``render(impl="dense")`` (every pixel-gaussian pair, in the canonical
   compositing order) and autograd. Projection runs in float32, as it does
   everywhere in the port; the compositing in float64
   (``blend_dense.blend_dense`` takes the projection in float64), in
   blocks of rows so that the [pixels, N] matrices stay small, each block
   over the gaussians whose isotropic cutoff radius (plus a pixel) reaches
   its rows: the others have alpha 0 there, so they change no product;
2. :func:`kernel_stage`, on ``--device``: the tiled path through kernels
   B4, B1, B2 and the fold (``csrc/fold_rows.cu``), and a forward render
   with labels for the label map.

It writes ``--out`` (default ``build/parity_torch.json``) with
``PARITY_TPU.json``'s keys: per tensor the max and median absolute error
and the max relative to the reference's peak, ``pass`` and
``tolerances``; the oracle comparison (``pixels_vs_numpy_oracle``) is held
in the CPU tests, since the oracle is the JAX package's. The bars are
``PARITY_TPU.json``'s (pixels max abs 1e-3, gradients 1e-3 of each
tensor's peak) and the repository's parity bar's (label maps equal,
``num_dropped`` equal); past a bar it exits with 1::

    python -m gsplat_tpu_torch.utils.verify_parity [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from gsplat_tpu_torch.config import DEFAULT
from gsplat_tpu_torch.io.cameras import look_at_camera
from gsplat_tpu_torch.io.synthetic import random_scene
from gsplat_tpu_torch.models.trainer import SceneParams
from gsplat_tpu_torch.render import blend_dense
from gsplat_tpu_torch.render.api import _render_impl
from gsplat_tpu_torch.render.projection import (CameraParams, Projected,
                                                project, tile_grid)
from gsplat_tpu_torch.render.tiles import depth_qkeys
from gsplat_tpu_torch.scene import resolve_device

N, W, H, SEED = 4000, 160, 128, 7
TOL_PIXELS = 1e-3
TOL_GRADS = 1e-3
ROWS_PER_BLOCK = 16
DEFAULT_OUT = Path("build") / "parity_torch.json"
REFERENCE = ("dense render and autograd on the CPU: projection in float32, "
             "compositing in float64")


def build_problem():
    """(scene, camera, target) of ``scripts/verify_tpu.py::build_problem``,
    the scene and target on the CPU."""
    scene = random_scene(N, seed=SEED, extent=1.0, scale_range=(0.01, 0.05),
                         num_labels=8, device="cpu")
    cam = look_at_camera((0.3, -0.2, -2.5), (0, 0, 0), width=W, height=H)
    rng = np.random.default_rng(SEED)
    target = torch.from_numpy(rng.random((H, W, 3)).astype(np.float32))
    return scene, cam, target


def _leaves(scene, device):
    params = SceneParams(*(t.detach().to(device).requires_grad_(True)
                           for t in SceneParams.from_scene(scene)))
    return params, params.to_scene(scene.labels.to(device))


def reference_stage(scene, cam, target) -> Dict[str, object]:
    """The dense reference on the CPU: ``image`` [H, W, 3] and
    ``label_map`` [H, W] (numpy), ``grads`` (SceneParams of numpy arrays)
    of the loss, ``num_dropped`` 0."""
    rc = DEFAULT.raster
    params, sc = _leaves(scene, "cpu")
    camp = CameraParams.from_camera(cam, "cpu")
    proj = project(sc, camp, cam.width, cam.height, rc,
                   z_near=DEFAULT.camera.z_near, z_far=DEFAULT.camera.z_far)
    tx, ty = tile_grid(cam.width, cam.height, rc.tile_size)
    order = torch.argsort(depth_qkeys(proj.depth, proj.valid, tx * ty),
                          stable=True)
    proj64 = Projected(*(t.double() if t.is_floating_point() else t
                         for t in proj))
    bg = torch.tensor(rc.background, dtype=torch.float64)
    grads = [torch.zeros_like(p) for p in params]
    image, labels = [], []
    reach = proj.radius.detach() + 1.0
    for y0 in range(0, cam.height, ROWS_PER_BLOCK):
        y1 = min(y0 + ROWS_PER_BLOCK, cam.height)
        near = proj.valid & (proj.v.detach() + reach >= y0) & (
            proj.v.detach() - reach <= y1)
        out = blend_dense.blend_dense(proj64, order[near[order]], cam.width,
                                      cam.height,
                                      rc, labels=sc.labels, background=bg,
                                      rows=(y0, y1))
        loss = 0.5 * torch.sum((out["image"] - target[y0:y1].double()) ** 2)
        for acc, g in zip(grads, torch.autograd.grad(
                loss, list(params), retain_graph=True)):
            acc += g
        image.append(out["image"].detach())
        labels.append(out["label_map"])
    return dict(image=torch.cat(image).numpy(),
                label_map=torch.cat(labels).numpy(),
                grads=SceneParams(*(g.numpy() for g in grads)),
                num_dropped=0)


def kernel_stage(scene, cam, target, device) -> Dict[str, object]:
    """The tiled path on ``device``: the image and gradients of the loss
    through B4, B1, B2 and the fold, then the label map of a forward
    render with labels."""
    rc = DEFAULT.raster
    params, sc = _leaves(scene, device)
    camp = CameraParams.from_camera(cam, device)
    bg = torch.tensor(rc.background, dtype=torch.float32, device=device)
    kw = dict(width=cam.width, height=cam.height, cfg=DEFAULT)
    out = _render_impl(sc, camp, bg, with_labels=False, **kw)
    loss = 0.5 * torch.sum((out["image"] - target.to(device)) ** 2)
    grads = torch.autograd.grad(loss, list(params))
    with torch.no_grad():
        lab = _render_impl(sc, camp, bg, with_labels=True, **kw)
    return dict(image=out["image"].detach().cpu().numpy(),
                label_map=lab["label_map"].cpu().numpy(),
                grads=SceneParams(*(g.cpu().numpy() for g in grads)),
                num_dropped=int(out["num_dropped"]))


def errs(a, b) -> Dict[str, float]:
    """Max and median absolute error of ``a`` against ``b``, and the max
    relative to ``b``'s peak (``scripts/verify_tpu.py``'s measure)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    scale = max(float(np.abs(b).max()), 1e-12)
    return dict(max_abs=float(d.max()), median_abs=float(np.median(d)),
                max_rel_to_peak=float(d.max() / scale))


def compare(got, ref) -> Dict[str, object]:
    """The report's comparisons of a kernel stage with the reference."""
    agree = float(np.mean(got["label_map"] == ref["label_map"]))
    report = {
        "pixels_vs_dense_cpu": errs(got["image"], ref["image"]),
        "grads_vs_dense_cpu": {f: errs(getattr(got["grads"], f),
                                       getattr(ref["grads"], f))
                               for f in SceneParams._fields},
        "label_map_vs_dense_cpu": dict(agreement=agree),
        "num_dropped": dict(kernels=got["num_dropped"],
                            dense=ref["num_dropped"]),
    }
    report["pass"] = bool(
        report["pixels_vs_dense_cpu"]["max_abs"] <= TOL_PIXELS
        and all(v["max_rel_to_peak"] <= TOL_GRADS
                for v in report["grads_vs_dense_cpu"].values())
        and agree == 1.0 and got["num_dropped"] == ref["num_dropped"])
    report["tolerances"] = dict(pixels_max_abs=TOL_PIXELS,
                                grads_max_rel_to_peak=TOL_GRADS,
                                label_map_agreement=1.0,
                                num_dropped="equal")
    return report


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device of the kernel stage (default: the card)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    scene, cam, target = build_problem()
    t0 = time.time()
    ref = reference_stage(scene, cam, target)
    ref_s = time.time() - t0
    t0 = time.time()
    got = kernel_stage(scene, cam, target, device)
    wall = time.time() - t0
    report = {
        "backend": device.type,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "interpret": device.type != "cuda",
        "scene": dict(num_gaussians=N, width=W, height=H, seed=SEED),
        "generated_by": "gsplat_tpu_torch/utils/verify_parity.py",
        "reference": REFERENCE,
        "reference_wall_s": round(ref_s, 2),
        "wall_s": round(wall, 2),
        **compare(got, ref),
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report, indent=1))
    print(f"wrote {out}", file=sys.stderr)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
