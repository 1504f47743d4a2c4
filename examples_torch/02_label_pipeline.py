"""Majority-vote labeling + IoU evaluation (the deep_learning_segmentation /
evaluation notebook workflow, scripted): render ground-truth label maps,
strip labels, recover them by voting (naive vs occlusion-aware) and score.

Twin of ``examples/02_label_pipeline.py`` on the PyTorch port: the same
scene, views and printed lines. It runs on the card unless ``--device``
names another device; ``--out-dir`` (default: a new temporary directory)
receives the re-rendered label map as ``relabeled_view0.npy``.

Run: python examples_torch/02_label_pipeline.py [--device cpu] [--out-dir DIR]
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
from gsplat_tpu_torch.evaluation.iou import mean_iou  # noqa: E402
from gsplat_tpu_torch.io.cameras import orbit_cameras  # noqa: E402
from gsplat_tpu_torch.io.synthetic import sphere_scene  # noqa: E402
from gsplat_tpu_torch.label import vote  # noqa: E402
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

    scene = sphere_scene(1000, radius=1.0, seed=0, device=device)
    cams = orbit_cameras(4, radius=3.0, width=80, img_height=64)

    # "segmentation model" = ground-truth rendered label maps
    segs = np.stack([
        render(scene, c, DEFAULT, with_labels=True,
               device=device)["label_map"].cpu().numpy()
        for c in cams])

    bare = dataclasses.replace(
        scene, labels=torch.zeros(1000, dtype=torch.int32, device=device))
    naive = vote.assign_labels(bare, cams, segs, num_classes=8,
                               device=device).cpu().numpy()
    aware = vote.assign_labels_visible(bare, cams, segs, num_classes=8,
                                       device=device).cpu().numpy()
    truth = scene.labels.cpu().numpy()
    print(f"naive vote accuracy:          {(naive == truth).mean():.3f}")
    print(f"occlusion-aware accuracy:     {(aware == truth).mean():.3f}")

    # IoU of re-rendered label maps against the originals
    relabeled = dataclasses.replace(
        bare, labels=torch.from_numpy(aware).to(device))
    lm = render(relabeled, cams[0], DEFAULT, with_labels=True,
                device=device)["label_map"].cpu().numpy()
    np.save(os.path.join(out_dir, "relabeled_view0.npy"), lm)
    print(f"mean IoU of re-rendered label map: {mean_iou(lm, segs[0]):.3f}")
    for line in vote.label_statistics(aware)[:4]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
