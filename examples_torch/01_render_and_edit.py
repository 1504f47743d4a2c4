"""Render, select, and edit a labeled scene (the viewer workflow, scripted).

Twin of ``examples/01_render_and_edit.py`` on the PyTorch port: the same
scene, camera, edits and printed lines. It runs on the card unless
``--device`` names another device, and writes its files into ``--out-dir``
(default: a new temporary directory).

Run: python examples_torch/01_render_and_edit.py [--device cpu] [--out-dir DIR]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gsplat_tpu_torch.config import DEFAULT  # noqa: E402
from gsplat_tpu_torch.interact.edit import (EditState, apply_edits,  # noqa: E402
                                            hit_test)
from gsplat_tpu_torch.io import ply  # noqa: E402
from gsplat_tpu_torch.io.cameras import look_at_camera  # noqa: E402
from gsplat_tpu_torch.io.splat_format import write_splat  # noqa: E402
from gsplat_tpu_torch.io.synthetic import sphere_scene  # noqa: E402
from gsplat_tpu_torch.render.api import render  # noqa: E402
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

    scene = sphere_scene(3000, radius=1.0, seed=0, device=device)  # octants
    cam = look_at_camera((0, 0, -3.0), (0, 0, 0), width=320, height=240)

    out = render(scene, cam, DEFAULT, with_labels=True, device=device)
    print("rendered", tuple(out["image"].shape), "coverage",
          float(out["alpha"].mean()))

    # click the image center -> which label is there?
    label = hit_test(scene, cam, 160, 120)
    print("hit label:", label)

    # hide it, displace another label, recolor a third
    edits = (EditState()
             .toggle_visibility(label)
             .displace(1, (0.0, 0.4, 0.0))
             .set_color(2, (1.0, 0.0, 0.0)))
    out2 = render(apply_edits(scene, edits), cam, DEFAULT, with_labels=True,
                  device=device)
    gone = int((out2["label_map"] == label).sum())
    print(f"after hide: {gone} pixels of label {label} remain")

    # persist artifacts: labeled PLY + viewer-compatible .splat + session
    ply.scene_to_ply(os.path.join(out_dir, "example_scene.ply"), scene)
    write_splat(os.path.join(out_dir, "example_scene.splat"), scene)
    edits.save(os.path.join(out_dir, "example_session.json"))
    print(f"wrote {os.path.join(out_dir, 'example_scene')}.{{ply,splat}} "
          "and session json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
