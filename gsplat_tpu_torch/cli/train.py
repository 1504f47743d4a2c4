"""Differentiable scene optimization CLI: fit gaussian parameters to target
images through the blend kernels' backward pass.

    python -m gsplat_tpu_torch.cli.train --camera_file cameras.json \
        --image_dir images/ --out scene.ply --iters 500 [--device cpu]

The counterpart of ``gsplat_tpu.cli.train`` with the same flags, defaults
and printed lines, plus ``--device`` (default: the card). Targets are read
with ``io/png.py`` (no PIL) and resized exactly as Pillow's
``Image.resize`` does, so both CLIs train on the same pixels. Checkpoints
are ``utils/checkpoint.py``'s ``torch.save`` files (no orbax): the training
state alone, or on the adaptive path also the labels, the densify
statistics and the state of the ``torch.Generator`` that draws the split
noise (the JAX CLI's PRNG key), so a resumed run continues exactly.

The mesh flags (``--mesh``, ``--coordinator``, ``--num_processes``,
``--process_id``; ``parallel/bootstrap.py``) train the sharded scene over a
mesh, as the JAX CLI does: ``--mesh 2x2 --device cpu`` runs 4 CPU shards
in one process, the process flags (or torchrun's environment) one process
a rank. Checkpoints and the PLY hold the gathered scene and are written by
rank 0; a resumed run shards the checkpoint again.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def load_targets(camera_file: str, image_dir: str, scale: float):
    """(cameras, [H, W, 3] f32 targets in [0, 1]) for each camera whose
    ``{img_name}.png`` exists, resized to the camera's intrinsics scaled by
    ``scale`` (at least 16 px a side); a missing image warns and is
    skipped."""
    from gsplat_tpu_torch.io import png
    from gsplat_tpu_torch.io.cameras import load_cameras

    cameras, targets = [], []
    for cam in load_cameras(camera_file):
        p = os.path.join(image_dir, cam.img_name + ".png")
        if not os.path.exists(p):
            print(f"warning: missing target image {p}", file=sys.stderr)
            continue
        cam = cam.resized(max(int(cam.width * scale), 16),
                          max(int(cam.height * scale), 16))
        img = png.resize_rgb(png.decode_png(p), cam.width, cam.height)
        cameras.append(cam)
        targets.append(np.asarray(img, dtype=np.float32) / 255.0)
    return cameras, targets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--camera_file", required=True)
    ap.add_argument("--image_dir", required=True,
                    help="target images named {img_name}.png")
    ap.add_argument("--out", required=True, help="output PLY")
    ap.add_argument("--init_ply", default=None)
    ap.add_argument("--num_gaussians", type=int, default=20000,
                    help="random-init size when --init_ply is absent")
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--lr_final", type=float, default=None,
                    help="exponential lr decay target over --iters "
                         "(3DGS-style position schedule)")
    ap.add_argument("--scale", type=float, default=0.25,
                    help="resolution scale on camera intrinsics")
    ap.add_argument("--budget_factor", type=float, default=8.0,
                    help="accepted for the JAX CLI's flags; the port sizes "
                         "its buffers exactly and ignores it")
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--checkpoint_every", type=int, default=100)
    ap.add_argument("--log_every", type=int, default=20)
    ap.add_argument("--loss", default="l2",
                    choices=["l2", "l1", "dssim_l1"],
                    help="photometric objective (dssim_l1 = 3DGS standard)")
    ap.add_argument("--densify_every", type=int, default=0,
                    help="adaptive density control interval (0 = off)")
    ap.add_argument("--densify_until", type=int, default=None,
                    help="stop densifying after this step (default iters/2)")
    ap.add_argument("--capacity_factor", type=float, default=4.0,
                    help="gaussian buffer capacity as a multiple of init N")
    ap.add_argument("--opacity_reset_every", type=int, default=0,
                    help="periodic opacity reset interval (0 = off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    from gsplat_tpu_torch.parallel.bootstrap import (add_mesh_args,
                                                     mesh_from_args)
    add_mesh_args(ap)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from gsplat_tpu_torch.scene import resolve_device

    device = resolve_device(args.device)
    # the process flags join a process group even without --mesh (None
    # only for a single-device run); a group this run joined is left at
    # its end, or NCCL holds the process at exit
    joined = dist.is_available() and not dist.is_initialized()
    try:
        return _train(args, device, mesh_from_args(args, device))
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, device, mesh) -> int:
    import torch

    from gsplat_tpu_torch.config import DEFAULT
    from gsplat_tpu_torch.io import ply
    from gsplat_tpu_torch.io.synthetic import random_scene
    from gsplat_tpu_torch.models import densify as dz
    from gsplat_tpu_torch.models import trainer
    from gsplat_tpu_torch.parallel import mesh as mesh_lib
    from gsplat_tpu_torch.render.projection import CameraParams
    from gsplat_tpu_torch.utils import checkpoint as ckpt

    if mesh is not None:
        device = mesh.home
        print(f"mesh: {mesh.shape} ({mesh.world} processes)")
    cameras, targets = load_targets(args.camera_file, args.image_dir,
                                    args.scale)
    if not cameras:
        print("error: no (camera, image) pairs found", file=sys.stderr)
        return 1
    print(f"{len(cameras)} training views at "
          f"{cameras[0].width}x{cameras[0].height}")

    centers = np.stack([c.position for c in cameras])
    extent = float(np.abs(centers).max()) or 1.0
    if args.init_ply:
        scene = ply.scene_from_ply(args.init_ply, device=device)
    else:
        # init inside the cameras' joint view volume
        scene = random_scene(args.num_gaussians, seed=0, extent=extent * 0.5,
                             scale_range=(0.01 * extent, 0.05 * extent),
                             device=device)
    print(f"{scene.num_gaussians} gaussians")

    w, h = cameras[0].width, cameras[0].height
    adaptive = args.densify_every > 0
    sched = dict(lr=args.lr, lr_final=args.lr_final, decay_steps=args.iters)
    if adaptive:
        # the JAX CLI's capacity rule (a multiple of 128), so both CLIs'
        # buffers and outputs have the same length
        capacity = -(-int(scene.num_gaussians * args.capacity_factor)
                     // 128) * 128
        params0, labels0 = dz.pad_to_capacity(
            trainer.SceneParams.from_scene(scene), scene.labels, capacity)
        scene = params0.to_scene(labels0)
        print(f"adaptive density: capacity {capacity}")
    # a train state, labels and stats are gathered into checkpoints and
    # sharded again on resume (the values themselves without a mesh)
    whole = mesh_lib.gather_rows
    sharded = ((lambda x: x) if mesh is None
               else (lambda x: mesh_lib.shard_rows(x, mesh)))

    if mesh is not None:
        scene = mesh_lib.shard_scene(scene, mesh)
    if adaptive:
        step = trainer.make_adaptive_train_step((w, h), DEFAULT,
                                                loss=args.loss, mesh=mesh,
                                                **sched)
        stats = sharded(dz.DensifyStats.zeros(scene.num_gaussians,
                                              device=device))
        densify_until = (args.densify_until if args.densify_until is not None
                         else args.iters // 2)
        generator = torch.Generator(device=device).manual_seed(0)
    else:
        step = trainer.make_train_step((w, h), DEFAULT, loss=args.loss,
                                       mesh=mesh, **sched)
    state = trainer.init_state(scene, **sched)
    labels = scene.labels
    start = 0

    # The adaptive path checkpoints everything densify mutates (labels,
    # stats, the generator's state) alongside TrainState so resume is
    # exact: a resumed run must not revert labels to the initial padded
    # array while params contain densified children. Under a mesh the
    # checkpoint holds the gathered values.
    def payload():
        if adaptive:
            return dict(state=whole(state), labels=whole(labels),
                        stats=whole(stats), generator=generator.get_state())
        return dict(state=whole(state))

    rank0 = mesh is None or mesh.rank == 0
    ckpt_path = (os.path.join(args.checkpoint_dir, "state")
                 if args.checkpoint_dir else None)
    if ckpt_path and os.path.exists(ckpt_path):
        restored = ckpt.restore_pytree(ckpt_path, like=payload())
        state = sharded(restored["state"])
        if adaptive:
            labels = sharded(restored["labels"])
            stats = sharded(restored["stats"])
            generator.set_state(restored["generator"])
        start = int(state.step)
        print(f"resumed at step {start}")

    cams = [CameraParams.from_camera(c, device) for c in cameras]
    tgts = [torch.from_numpy(t).to(device) for t in targets]
    bg = torch.zeros(3, device=device)
    for it in range(start, args.iters):
        v = it % len(cameras)
        if adaptive:
            state, stats, loss, nd = step(state, stats, labels, cams[v],
                                          tgts[v], bg)
            if it > 0 and it % args.densify_every == 0 and it < densify_until:
                new_params, labels, stats, written = dz.densify_and_prune(
                    state.params, labels, stats, generator, extent)
                # fresh splats must not inherit the pruned occupant's Adam
                # moments (CUDA 3DGS rebuilds optimizer state per densify)
                opt_state = trainer.zero_adam_rows(state.opt_state, written)
                state = trainer.TrainState(new_params, opt_state, state.step)
                print(f"step {it}: densify -> "
                      f"{int(dz.num_alive(new_params))} alive")
            if (args.opacity_reset_every
                    and it % args.opacity_reset_every == 0 and it > 0):
                new_params, changed = dz.reset_opacities(state.params)
                opt_state = trainer.zero_adam_rows(
                    state.opt_state, changed, fields=("opacities",))
                state = trainer.TrainState(new_params, opt_state, state.step)
        else:
            state, loss, nd = step(state, labels, cams[v], tgts[v], bg)
        if it % args.log_every == 0 or it == args.iters - 1:
            print(f"step {it}: loss {float(loss):.6f}")
            # checked at log cadence, as in the JAX CLI; the port sizes its
            # buffers exactly, so nothing is dropped
            if int(nd) > 0:
                print(f"step {it}: WARNING {int(nd)} instances dropped "
                      f"(budget too small — raise --budget_factor)")
        if ckpt_path and it > start and it % args.checkpoint_every == 0:
            saved = payload()
            if rank0:
                ckpt.save_pytree(ckpt_path, saved)

    final = whole(state.params).to_scene(whole(labels))
    if adaptive:
        final = _compact_alive(final)
    if rank0:
        ply.scene_to_ply(args.out, final)
        print(f"wrote {args.out}")
    return 0


def _compact_alive(scene):
    """Drop dead (pruned) slots before writing the final PLY."""
    import dataclasses

    from gsplat_tpu_torch.models.densify import DEAD_LOGIT
    from gsplat_tpu_torch.scene import FIELDS

    alive = scene.opacities > DEAD_LOGIT + 1.0
    return dataclasses.replace(
        scene, **{f: getattr(scene, f)[alive] for f in FIELDS})


if __name__ == "__main__":
    raise SystemExit(main())
