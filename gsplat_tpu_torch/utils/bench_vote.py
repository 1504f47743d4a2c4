"""Majority-vote labeling throughput on one card.

Counterpart of the repository's ``bench_vote.py``, on its problem:
``random_scene(n, seed=0, extent=1.0)`` (1M gaussians by default),
``orbit_cameras(V, radius=3.0)`` (311 views) resized to the seg maps'
256x256 in center mode and to 512x512 in visible mode, and seg maps
``np.random.default_rng(0).integers(-1, C - 1, (V, S, S))`` of 151
classes::

    python -m gsplat_tpu_torch.utils.bench_vote [--mode center|visible]
        [--cpu-baseline] [--device cpu]

The run is ``label/vote.py::assign_labels`` (center) or
``assign_labels_visible`` (visible: one visibility render through kernels
B4 and B5 a view, then the vote): one warm run, then one run timed on the
host clock until the labels are on the host, the copy included.
``--cpu-baseline`` also times :func:`cpu_baseline`, ``bench_vote.py``'s
numpy transliteration of the reference's per-view loop, and prints the
speed-up on stderr.

Diagnostics go to stderr; stdout gets one JSON line, last, with
``bench_vote.py``'s keys (``metric``, ``value`` in G pair-votes/s,
``unit``, ``vs_baseline`` null) and the device, the timed seconds and the
labeled fraction.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from gsplat_tpu_torch.io.cameras import Camera, orbit_cameras
from gsplat_tpu_torch.io.synthetic import random_scene
from gsplat_tpu_torch.label.vote import assign_labels, assign_labels_visible
from gsplat_tpu_torch.scene import GaussianScene, resolve_device


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-gaussians", type=int, default=1_000_000)
    ap.add_argument("--num-views", type=int, default=311)
    ap.add_argument("--seg-size", type=int, default=256,
                    help="segmentation map resolution (square)")
    ap.add_argument("--num-classes", type=int, default=151)
    ap.add_argument("--mode", default="center",
                    choices=["center", "visible"],
                    help="center = reference-semantics projection vote; "
                         "visible = occlusion-aware (renders every view)")
    ap.add_argument("--render-size", type=int, default=512,
                    help="render resolution for --mode visible")
    ap.add_argument("--cpu-baseline", action="store_true",
                    help="also time the NumPy transliteration of the "
                         "reference loop (slow)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


class Problem(NamedTuple):
    """``bench_vote.py``'s problem on one device."""

    scene: GaussianScene
    cameras: List[Camera]
    seg_maps: np.ndarray     # [V, S, S] int32
    num_classes: int
    device: torch.device


def make_problem(args: argparse.Namespace) -> Problem:
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    scene = random_scene(args.num_gaussians, seed=0, extent=1.0,
                         device=device)
    view_size = (args.render_size if args.mode == "visible"
                 else args.seg_size)
    cameras = [c.resized(view_size, view_size)
               for c in orbit_cameras(args.num_views, radius=3.0)]
    seg_maps = rng.integers(
        -1, args.num_classes - 1,
        size=(args.num_views, args.seg_size, args.seg_size)).astype(np.int32)
    return Problem(scene, cameras, seg_maps, args.num_classes, device)


def run(problem: Problem, mode: str) -> np.ndarray:
    """The labels [N] int32 of one vote in ``mode``, on the host."""
    fn = assign_labels_visible if mode == "visible" else assign_labels
    return fn(problem.scene, problem.cameras, problem.seg_maps,
              num_classes=problem.num_classes,
              device=problem.device).cpu().numpy()


def cpu_baseline(problem: Problem) -> np.ndarray:
    """``bench_vote.py``'s numpy loop over the views (float64 center
    projection, ``np.add.at`` into the histogram): the votes [N, C + 1]
    int32, bin 0 counting label -1."""
    means = problem.scene.means.cpu().numpy()
    n = means.shape[0]
    seg_size = problem.seg_maps.shape[-1]
    votes = np.zeros((n, problem.num_classes + 1), np.int32)
    for vi, cam in enumerate(problem.cameras):
        r = cam.rotation.astype(np.float64)
        t = -r @ cam.position
        pc = means @ r.T + t
        z = pc[:, 2]
        vis = z > 0
        zs = np.where(vis, z, 1.0)
        u = cam.fx * pc[:, 0] / zs + cam.width / 2.0
        v = cam.fy * pc[:, 1] / zs + cam.height / 2.0
        vis &= (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        ui = np.clip(u.astype(np.int64), 0, seg_size - 1)
        vi_ = np.clip(v.astype(np.int64), 0, seg_size - 1)
        lab = problem.seg_maps[vi][vi_, ui] + 1
        np.add.at(votes, (np.arange(n), np.where(vis, lab, 0)),
                  vis.astype(np.int32))
    return votes


def main(argv: Optional[list] = None) -> int:
    args = parse_args(argv)
    problem = make_problem(args)
    name = (torch.cuda.get_device_name(problem.device)
            if problem.device.type == "cuda" else str(problem.device))
    run(problem, args.mode)   # warm: kernel builds, allocator

    t0 = time.perf_counter()
    labels = run(problem, args.mode)
    dt = time.perf_counter() - t0
    pairs = args.num_gaussians * args.num_views
    rate = pairs / dt
    lab_frac = float((labels != -1).mean())
    print(f"{name} vote ({args.mode}): {dt:.3f}s for {args.num_views} views"
          f" x {args.num_gaussians} gaussians ({rate/1e9:.2f} G "
          f"pair-votes/s, labeled {lab_frac:.1%})", file=sys.stderr)

    if args.cpu_baseline:
        t0 = time.perf_counter()
        cpu_baseline(problem)
        cpu_dt = time.perf_counter() - t0
        print(f"CPU vectorized-reference baseline: {cpu_dt:.3f}s "
              f"({pairs/cpu_dt/1e9:.3f} G pair-votes/s) -> {name} speedup "
              f"{cpu_dt/dt:.1f}x", file=sys.stderr)

    print(json.dumps({
        "metric": f"majority-vote labeling pair-votes/s on {name} "
                  f"({args.mode}, {args.num_gaussians} gaussians, "
                  f"{args.num_views} views)",
        "value": rate / 1e9,
        "unit": "G pair-votes/s",
        "vs_baseline": None,
        "device": name,
        "seconds": dt,
        "labeled_fraction": lab_frac,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
