"""K-means clustering CLI — flag-parity with 3D_clustering/k_means.py.

Usage (reference k_means.py:198-203, README.md:71-75):
    python -m gsplat_tpu_torch.cli.kmeans --file_path scene.ply \
        --save_path clustered.ply --k 10 [--device cpu]

The counterpart of ``gsplat_tpu.cli.kmeans`` with the same flags and printed
lines, plus ``--device`` (default: the card). ``--sharded`` splits the
points over a mesh of every visible card (``parallel/mesh.py``; of one CPU
shard under ``--device cpu``).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--file_path", required=True)
    ap.add_argument("--save_path", required=True)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--max_iter", type=int, default=10)   # k_means.py:210
    ap.add_argument("--tol", type=float, default=1e-4)    # k_means.py:46
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no_color_features", action="store_true",
                    help="cluster on xyz only (the k_means_kd_tree variant)")
    ap.add_argument("--no_recolor", action="store_true")
    ap.add_argument("--binary", action="store_true",
                    help="write binary PLY (reference writes ascii)")
    ap.add_argument("--sharded", action="store_true",
                    help="shard the points over all devices")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from gsplat_tpu_torch.cluster import kmeans as km
    from gsplat_tpu_torch.io import ply
    from gsplat_tpu_torch.scene import resolve_device

    device = resolve_device(args.device)
    scene = ply.scene_from_ply(args.file_path, device=device)
    print(f"loaded {scene.num_gaussians} gaussians")

    mesh = None
    if args.sharded:
        from gsplat_tpu_torch.parallel import mesh as mesh_lib
        mesh = (mesh_lib.make_mesh(devices=[device]) if device.type == "cpu"
                else mesh_lib.make_mesh())

    out, res = km.cluster_scene(
        scene, k=args.k, with_color=not args.no_color_features,
        max_iter=args.max_iter, tol=args.tol, seed=args.seed, mesh=mesh,
        recolor=not args.no_recolor)
    print(f"converged in {res.iterations} iterations "
          f"(final shift {res.shift:.2e})")
    counts = np.bincount(res.labels.cpu().numpy(), minlength=args.k)
    for c in range(args.k):
        print(f"cluster {c}: {int(counts[c])} gaussians")

    # the reference writes ascii PLY with the label property (k_means.py:193)
    ply.scene_to_ply(args.save_path, out, binary=args.binary, with_label=True)
    print(f"wrote {args.save_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
