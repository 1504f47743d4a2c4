"""Offline renderer CLI, the batch analogue of the reference's WebGL viewer
loop (gaussians_selection.js:1436-1640): renders PNG frames (and optional
label maps) of a gaussian PLY from cameras.json views, with the per-label
edits the viewer applies interactively (session JSON of
``gsplat_tpu_torch.interact.edit.EditState``).

    python -m gsplat_tpu_torch.cli.render --ply_file scene.ply \\
        --camera_file cameras.json --out_dir frames/ [--label_maps] \\
        [--session edits.json] [--device cpu]

The counterpart of ``gsplat_tpu.cli.render`` with the same flags and file
names (``{img_name}_{id:04d}.png``, ``_labels.npy``, ``_labels.png``), plus
``--device`` (default ``cuda``: the render runs on the card). PNGs are
written by ``io/png.py``, not PIL.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gsplat_tpu_torch.config import DEFAULT, UNLABELED
from gsplat_tpu_torch.interact.edit import EditState, apply_edits
from gsplat_tpu_torch.io import ply, png
from gsplat_tpu_torch.io.cameras import load_cameras, orbit_cameras
from gsplat_tpu_torch.label.adapters import save_visualization
from gsplat_tpu_torch.render.api import render
from gsplat_tpu_torch.scene import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ply_file", required=True)
    ap.add_argument("--camera_file", default=None,
                    help="cameras.json; default: an 8-view synthetic orbit")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--views", default=None,
                    help="comma-separated camera ids (default: all)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="resolution scale factor on camera intrinsics")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--label_maps", action="store_true")
    ap.add_argument("--session", default=None,
                    help="EditState session JSON to apply before rendering")
    ap.add_argument("--background", default="0,0,0")
    ap.add_argument("--budget", type=int, default=None,
                    help="accepted for the JAX CLI's flags; the port sizes "
                         "its buffers exactly and ignores it")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the render (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    scene = ply.scene_from_ply(args.ply_file, device=device)
    if args.session:
        scene = apply_edits(scene, EditState.load(args.session))

    if args.camera_file:
        cameras = load_cameras(args.camera_file)
    else:
        extent = float(scene.means.abs().max())
        cameras = orbit_cameras(8, radius=3.0 * extent)
    if args.views:
        wanted = {int(v) for v in args.views.split(",")}
        cameras = [c for c in cameras if c.id in wanted]
    bg = torch.tensor([float(x) for x in args.background.split(",")],
                      dtype=torch.float32)

    for cam in cameras:
        if args.width and args.height:
            cam = cam.resized(args.width, args.height)
        elif args.scale != 1.0:
            cam = cam.resized(max(int(cam.width * args.scale), 1),
                              max(int(cam.height * args.scale), 1))
        out = render(scene, cam, DEFAULT, background=bg,
                     with_labels=args.label_maps, budget=args.budget,
                     device=device)
        img = np.clip(out["image"].cpu().numpy(), 0.0, 1.0)
        rgb = (img * 255).astype(np.uint8)
        path = os.path.join(args.out_dir, f"{cam.img_name}_{cam.id:04d}.png")
        png.write_png(path, rgb)
        msg = f"rendered {path}"
        if args.label_maps:
            lm = out["label_map"].cpu().numpy()
            np.save(path.replace(".png", "_labels.npy"), lm)
            save_visualization(path.replace(".png", "_labels.png"), rgb, lm,
                               num_classes=max(int(lm.max()) + 1, 2))
            msg += f" (+labels, {len(np.unique(lm[lm != UNLABELED]))} classes)"
        print(msg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
