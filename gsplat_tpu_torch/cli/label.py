"""Majority-vote labeling CLI — flag-parity with deep_learning_segmentation.py.

Usage (reference py:336-344, README.md:59-67):
    python -m gsplat_tpu_torch.cli.label --ply_file scene.ply \
        --camera_file cameras.json --input_dir images/ \
        --output_dir out/ --output_file labeled.ply \
        --model {segformer,mask2former,yolo,sam,npy} [--device cpu]

The counterpart of ``gsplat_tpu.cli.label`` with the same flags, plus
``--device`` (default ``cuda``: the vote, the visibility renders and the
segmentation model run on the card). The 'npy' model replays precomputed
``{img_name}_seg.npy`` maps from --output_dir. ``--sharded`` shards the
center vote over a mesh of every visible card (``parallel/mesh.py``; of one
CPU shard under ``--device cpu``), as the JAX CLI passes its mesh to the
center vote alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ply_file", required=True)
    ap.add_argument("--camera_file", required=True)
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--output_file", required=True)
    ap.add_argument("--model", default="segformer",
                    choices=["segformer", "mask2former", "yolo", "sam", "npy"])
    ap.add_argument("--num_classes", type=int, default=151)
    ap.add_argument("--seg_resolution", type=int, default=None,
                    help="downscale seg maps to this max dimension before "
                         "voting (default: first map's resolution)")
    ap.add_argument("--sharded", action="store_true",
                    help="shard views/gaussians over all devices")
    ap.add_argument("--mode", default="center",
                    choices=["center", "visible"],
                    help="'center' = reference-parity center projection; "
                         "'visible' = occlusion-aware (gaussians only vote "
                         "in views where they visibly contribute)")
    ap.add_argument("--visibility_threshold", type=float, default=0.05)
    ap.add_argument("--id2label_json", default=None,
                    help="class-name map for the statistics printout "
                         "(e.g. ade20k-id2label.json)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the vote and the models "
                         "(default: the card)")
    args = ap.parse_args(argv)

    from gsplat_tpu_torch.io import ply, png
    from gsplat_tpu_torch.io.cameras import load_cameras
    from gsplat_tpu_torch.label import adapters, vote
    from gsplat_tpu_torch.label.adapters import _nearest_resize
    from gsplat_tpu_torch.scene import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    cameras = load_cameras(args.camera_file)
    scene = ply.scene_from_ply(args.ply_file, device=device)
    print(f"loaded {scene.num_gaussians} gaussians, {len(cameras)} cameras")

    backend = (adapters.NpySource(args.output_dir)
               if args.model == "npy"
               else adapters.make_backend(args.model, device=device))

    seg_maps, used_cams = [], []
    shape = None
    for cam in cameras:
        img = None
        if args.model != "npy":
            img_path = os.path.join(args.input_dir, cam.img_name + ".png")
            if not os.path.exists(img_path):
                print(f"warning: image not found, skipping: {img_path}",
                      file=sys.stderr)  # reference py:257-259
                continue
            # Image.open(p).convert("RGB")'s pixels, without PIL
            img = png.decode_png(img_path)
        try:
            seg = backend(cam.img_name, img)
        except FileNotFoundError:
            print(f"warning: no seg map for {cam.img_name}, skipping",
                  file=sys.stderr)
            continue
        if args.model != "npy":
            np.save(os.path.join(args.output_dir,
                                 cam.img_name + "_seg.npy"), seg)
            adapters.save_visualization(
                os.path.join(args.output_dir, cam.img_name + "_seg.png"),
                img, seg, num_classes=args.num_classes - 1)
        if shape is None:
            if args.seg_resolution:
                sc = args.seg_resolution / max(seg.shape)
                shape = (max(int(seg.shape[0] * sc), 1),
                         max(int(seg.shape[1] * sc), 1))
            else:
                shape = seg.shape
        seg_maps.append(_nearest_resize(seg, *shape))
        used_cams.append(cam)

    if not seg_maps:
        print("error: no segmentation maps produced", file=sys.stderr)
        return 1

    mesh = None
    if args.sharded:
        from gsplat_tpu_torch.parallel import mesh as mesh_lib
        mesh = (mesh_lib.make_mesh(devices=[device]) if device.type == "cpu"
                else mesh_lib.make_mesh())

    if args.mode == "visible":
        labels = vote.assign_labels_visible(
            scene, used_cams, np.stack(seg_maps),
            num_classes=args.num_classes,
            visibility_threshold=args.visibility_threshold, device=device)
    else:
        labels = vote.assign_labels(
            scene, used_cams, np.stack(seg_maps),
            num_classes=args.num_classes, mesh=mesh, device=device)
    labels = labels.cpu().numpy()

    out_path = os.path.join(args.output_dir, args.output_file)
    ply.add_labels_to_ply(args.ply_file, out_path, labels)
    print(f"wrote {out_path}")

    id2label = None
    if args.id2label_json:
        with open(args.id2label_json) as f:
            id2label = {int(k): v for k, v in json.load(f).items()}
    for line in vote.label_statistics(labels, id2label):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
