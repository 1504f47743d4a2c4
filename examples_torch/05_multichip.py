"""Sharded rendering + training over a device mesh.

Twin of ``examples/05_multichip.py`` on the PyTorch port: the same scene,
camera and printed lines, over a (2, 2) mesh of four logical shards on one
device (``parallel/mesh.py``: several shards a device), which drives the
exchange, the interleaved tile lattice and the image gather as four cards
would. It runs on the card unless ``--device`` names another device;
``--out-dir`` (default: a new temporary directory) receives the sharded
image as ``sharded.npy``.

Run: python examples_torch/05_multichip.py [--device cpu] [--out-dir DIR]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gsplat_tpu_torch.config import DEFAULT  # noqa: E402
from gsplat_tpu_torch.io.cameras import look_at_camera  # noqa: E402
from gsplat_tpu_torch.io.synthetic import sphere_scene  # noqa: E402
from gsplat_tpu_torch.models import trainer  # noqa: E402
from gsplat_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from gsplat_tpu_torch.parallel.render_sharded import render_sharded  # noqa: E402
from gsplat_tpu_torch.render.api import render  # noqa: E402
from gsplat_tpu_torch.render.projection import CameraParams  # noqa: E402
from gsplat_tpu_torch.scene import resolve_device  # noqa: E402

MESH = (2, 2)


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

    mesh = mesh_lib.make_mesh(MESH, [device])
    print("mesh:", mesh.shape)

    scene = sphere_scene(2048, radius=1.0, seed=0, device=device)
    sharded = mesh_lib.shard_scene(scene, mesh)
    cam = look_at_camera((0, 0, -3.0), (0, 0, 0), width=128, height=96)
    camp = CameraParams.from_camera(cam, mesh.home)

    with torch.no_grad():
        img = render_sharded(sharded, camp, mesh, width=128, height=96,
                             cfg=DEFAULT)
        ref = render(scene, cam, DEFAULT, device=device)["image"]
    np.save(os.path.join(out_dir, "sharded.npy"), img.cpu().numpy())
    err = float((img[:96] - ref).abs().max())
    print(f"sharded vs single-device max pixel err: {err:.2e}")

    step = trainer.make_train_step((128, 96), DEFAULT, lr=1e-3, mesh=mesh)
    state = trainer.init_state(sharded)
    target = torch.zeros((96, 128, 3), device=mesh.home)
    state, loss, _ = step(state, sharded.labels, camp, target,
                          torch.zeros(3, device=mesh.home))
    print(f"one sharded train step: loss {float(loss):.6f} "
          f"(grads reduce-scattered over the mesh)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
