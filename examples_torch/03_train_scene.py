"""Differentiable scene fitting (capability the reference lacks): perturb a
scene, then recover it from rendered target images through the backward
kernels.

Twin of ``examples/03_train_scene.py`` on the PyTorch port: the same scene,
perturbation, views, schedule and printed lines (the port sizes its buffers
exactly, so it takes no instance budget). It runs on the card unless
``--device`` names another device; ``--out-dir`` (default: a new temporary
directory) receives the fitted scene as ``example_fitted.ply``.

Run: python examples_torch/03_train_scene.py [--device cpu] [--out-dir DIR]
"""

import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gsplat_tpu_torch.config import DEFAULT  # noqa: E402
from gsplat_tpu_torch.io import ply  # noqa: E402
from gsplat_tpu_torch.io.cameras import orbit_cameras  # noqa: E402
from gsplat_tpu_torch.io.synthetic import sphere_scene  # noqa: E402
from gsplat_tpu_torch.models import trainer  # noqa: E402
from gsplat_tpu_torch.render.api import render  # noqa: E402
from gsplat_tpu_torch.render.projection import CameraParams  # noqa: E402
from gsplat_tpu_torch.scene import resolve_device  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out-dir", default=None,
                    help="where the files go (default: a new temporary "
                         "directory)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="example_")
    os.makedirs(out_dir, exist_ok=True)

    scene = sphere_scene(500, radius=1.0, seed=0, device=device)
    cams = orbit_cameras(4, radius=3.0, width=96, img_height=64)
    with torch.no_grad():
        targets = [render(scene, c, DEFAULT, device=device)["image"]
                   for c in cams]

    rng = np.random.default_rng(0)
    noise = 0.07 * rng.normal(size=tuple(scene.means.shape)).astype(
        np.float32)
    pert = dataclasses.replace(
        scene, means=scene.means + torch.from_numpy(noise).to(device))

    step = trainer.make_train_step((96, 64), DEFAULT, lr=3e-3)
    state = trainer.init_state(pert)
    bg = torch.zeros(3, device=device)
    for it in range(60):
        cam = CameraParams.from_camera(cams[it % 4], device)
        state, loss, _ = step(state, pert.labels, cam, targets[it % 4], bg)
        if it % 15 == 0 or it == 59:
            print(f"step {it:3d}  loss {float(loss):.6f}")
    print("means error before:",
          float((pert.means - scene.means).abs().mean()),
          "after:",
          float((state.params.means - scene.means).abs().mean()))
    ply.scene_to_ply(os.path.join(out_dir, "example_fitted.ply"),
                     state.params.to_scene(pert.labels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
