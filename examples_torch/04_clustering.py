"""K-means and region-growing clustering (the 3D_clustering workflow).

Twin of ``examples/04_clustering.py`` on the PyTorch port: the same scene,
parameters and printed lines. It runs on the card unless ``--device`` names
another device, and writes its PLYs into ``--out-dir`` (default: a new
temporary directory).

Run: python examples_torch/04_clustering.py [--device cpu] [--out-dir DIR]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from gsplat_tpu_torch.cluster import kmeans as km  # noqa: E402
from gsplat_tpu_torch.cluster import region_growing as rg  # noqa: E402
from gsplat_tpu_torch.io import ply  # noqa: E402
from gsplat_tpu_torch.io.synthetic import sphere_scene  # noqa: E402
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

    scene = sphere_scene(1500, radius=1.0, seed=0, device=device)

    clustered, res = km.cluster_scene(scene, k=8)
    print(f"k-means: {int(res.iterations)} iterations, "
          f"final shift {float(res.shift):.2e}")
    print("cluster sizes:",
          np.bincount(res.labels.cpu().numpy(), minlength=8).tolist())

    segmented, geo = rg.segment_scene(
        scene, normals_k=40, neighbors_k=8, residual_threshold=0.2,
        angle_threshold=0.5)
    labels = segmented.labels.cpu().numpy()
    print(f"region growing: {labels.max() + 1} regions; "
          f"median normal residual "
          f"{float(np.median(geo.residuals.cpu().numpy())):.4f}")

    ply.scene_to_ply(os.path.join(out_dir, "example_clustered.ply"),
                     clustered)
    ply.scene_to_ply(os.path.join(out_dir, "example_regions.ply"), segmented)
    print(f"wrote {os.path.join(out_dir, 'example')}_{{clustered,regions}}"
          ".ply")
    return 0


if __name__ == "__main__":
    sys.exit(main())
