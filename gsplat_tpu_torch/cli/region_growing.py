"""Region-growing segmentation CLI (3D_clustering/region_growing.py, which
only had hard-coded __main__ paths — py:263-286 — promoted to flags).

    python -m gsplat_tpu_torch.cli.region_growing --file_path scene.ply \
        --save_path regions.ply [--device cpu]

The counterpart of ``gsplat_tpu.cli.region_growing`` with the same flags and
printed lines, plus ``--device`` (default: the card; the BFS runs on the
host either way).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--file_path", required=True)
    ap.add_argument("--save_path", required=True)
    ap.add_argument("--normals_k", type=int, default=2000)  # py:272
    ap.add_argument("--neighbors_k", type=int, default=10)  # py:277
    ap.add_argument("--residual_threshold", type=float, default=0.1)
    ap.add_argument("--angle_threshold", type=float, default=0.05)
    ap.add_argument("--no_recolor", action="store_true")
    ap.add_argument("--binary", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the kNN and PCA (default: the "
                         "card)")
    args = ap.parse_args(argv)

    from gsplat_tpu_torch.cluster import region_growing as rg
    from gsplat_tpu_torch.io import ply
    from gsplat_tpu_torch.scene import resolve_device

    device = resolve_device(args.device)
    scene = ply.scene_from_ply(args.file_path, device=device)
    print(f"loaded {scene.num_gaussians} gaussians")

    out, geo = rg.segment_scene(
        scene, normals_k=args.normals_k, neighbors_k=args.neighbors_k,
        residual_threshold=args.residual_threshold,
        angle_threshold=args.angle_threshold,
        recolor=not args.no_recolor, seed=args.seed)
    labels = out.labels.cpu().numpy()
    n_reg = int(labels.max()) + 1
    print(f"{n_reg} regions (largest: "
          f"{int(np.bincount(labels[labels >= 0]).max())} gaussians)")

    ply.scene_to_ply(args.save_path, out, binary=args.binary, with_label=True)
    print(f"wrote {args.save_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
