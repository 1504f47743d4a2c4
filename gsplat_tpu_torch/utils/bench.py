"""Fwd+bwd rasterization throughput on one card against its own SOL.

Counterpart of the repository's ``bench.py``, on its problem: ``bench.py``'s
scene (``random_scene(n, seed=0, extent=1.5, scale_range=(0.004, 0.02),
num_labels=16)``, 100k gaussians by default) from ``look_at_camera((0, 0,
-3), (0, 0, 0))`` at 800x608, the loss ``0.5 * sum(image^2)`` of
``render/api.py::_render_impl`` without labels, differentiated with respect
to the five float tensors of ``models/trainer.py::SceneParams`` (kernels
B4, B1, B2 and the fold each iteration; ``--forward-only``:
the render alone, B4 and B1)::

    python -m gsplat_tpu_torch.utils.bench [--forward-only] [--device cpu]
        [--roofline build/roofline_torch.json]

The timer is ``bench.py``'s: interleaved (hi, lo) pairs of ``iters + 1`` and
``max(iters // 4, 1)`` iterations, each pair giving ``(t_hi - t_lo) / (n_hi
- n_lo)`` seconds a frame; a pair at or below 0, or under a quarter of the
running median, is dropped and measured again (at most ``4 * repeats``
attempts), and fewer than ``max(3, repeats // 2)`` pairs left exit with 1.
Each run is a host clock around ``n`` eager iterations ended by
``torch.cuda.synchronize``: the host's dispatch is inside the window, as
the user pays for it. The JSON line reports the median and the min/max
spread.

``vs_baseline`` is the fraction of the SOL of the blend kernels B1 and B2
on the frame that was timed (``utils/roofline.py::frame_report``: the
frame's own pairs at the card's rates, which kernels P1 measure), the same
fwd+bwd SOL in both modes, as ``bench.py`` divides both by one SOL. The
rates come from ``--roofline PATH`` (a report of ``python -m
gsplat_tpu_torch.utils.roofline``) when its ``backend`` names this card,
else from ``measure_peaks`` in this process. No TPU record and no constant
is read. On the CPU the plain versions give no device rate, so
``vs_baseline`` is null there.

Diagnostics go to stderr; stdout gets one JSON line, last, with
``bench.py``'s keys (``metric``, ``value``, ``unit``, ``vs_baseline``,
``value_median``, ``value_spread``) and the device, ms a frame with its
spread, the SOL, the frame's tight instance count and (evaluated, tested,
live) pairs, and ``num_dropped``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from gsplat_tpu_torch.config import DEFAULT, Config
from gsplat_tpu_torch.io.cameras import Camera, look_at_camera
from gsplat_tpu_torch.io.synthetic import random_scene
from gsplat_tpu_torch.models.trainer import SceneParams
from gsplat_tpu_torch.render.api import _render_impl
from gsplat_tpu_torch.render.projection import CameraParams
from gsplat_tpu_torch.scene import GaussianScene, resolve_device
from gsplat_tpu_torch.utils import roofline


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-gaussians", type=int, default=100_000)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=608)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--budget", type=int, default=None,
                    help="accepted and ignored: buffers are sized from the "
                         "exact instance count")
    ap.add_argument("--forward-only", action="store_true")
    ap.add_argument("--repeats", type=int, default=9,
                    help="interleaved (hi, lo) timing pairs; the JSON line "
                         "reports their median + min/max spread")
    ap.add_argument("--tile-size", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--roofline", default=None,
                    help="a utils.roofline report whose rates to use when "
                         "it names this card")
    return ap.parse_args(argv)


class Problem(NamedTuple):
    """``bench.py``'s problem on one device."""

    scene: GaussianScene
    params: SceneParams      # the scene's float tensors, requiring grad
    cam: Camera
    camp: CameraParams
    background: torch.Tensor
    target: torch.Tensor
    cfg: Config
    forward_only: bool
    device: torch.device


def make_problem(args: argparse.Namespace) -> Problem:
    device = resolve_device(args.device)
    cfg = DEFAULT
    if args.tile_size is not None:
        cfg = dataclasses.replace(cfg, raster=dataclasses.replace(
            cfg.raster, tile_size=args.tile_size))
    if args.chunk is not None:
        cfg = dataclasses.replace(cfg, tiles=dataclasses.replace(
            cfg.tiles, chunk=args.chunk))
    cam = look_at_camera((0.0, 0.0, -3.0), (0.0, 0.0, 0.0),
                         width=args.width, height=args.height)
    scene = random_scene(args.num_gaussians, seed=0, extent=1.5,
                         scale_range=(0.004, 0.02), num_labels=16,
                         device=device)
    params = SceneParams(*(t.detach().requires_grad_(True)
                           for t in SceneParams.from_scene(scene)))
    return Problem(scene, params, cam, CameraParams.from_camera(cam, device),
                   torch.zeros(3, device=device),
                   torch.zeros(args.height, args.width, 3, device=device),
                   cfg, args.forward_only, device)


def step(problem: Problem) -> dict:
    """One timed iteration: the render (``image``, ``num_dropped``) and, but
    with ``forward_only``, the loss and its gradients (``grads``, a
    :class:`SceneParams`)."""
    p = problem
    kw = dict(width=p.cam.width, height=p.cam.height, cfg=p.cfg,
              with_labels=False)
    if p.forward_only:
        with torch.no_grad():
            out = _render_impl(p.scene, p.camp, p.background, **kw)
        return dict(image=out["image"], num_dropped=out["num_dropped"])
    out = _render_impl(p.params.to_scene(p.scene.labels), p.camp,
                       p.background, **kw)
    loss = 0.5 * torch.sum((out["image"] - p.target) ** 2)
    grads = SceneParams(*torch.autograd.grad(loss, p.params))
    return dict(image=out["image"].detach(), num_dropped=out["num_dropped"],
                loss=loss.detach(), grads=grads)


def card_peaks(device: torch.device, path: Optional[str]) -> dict:
    """The card's P1 rates: ``path``'s report where its backend names this
    card, else measured now."""
    name = torch.cuda.get_device_name(device)
    if path is not None and Path(path).is_file():
        report = json.loads(Path(path).read_text())
        if report.get("backend") == name:
            print(f"rates from {path} ({name})", file=sys.stderr)
            return report["peaks"]
        print(f"{path} names {report.get('backend')!r}, not {name!r}: "
              "measuring the rates", file=sys.stderr)
    return roofline.measure_peaks(device)


def main(argv: Optional[list] = None) -> int:
    args = parse_args(argv)
    problem = make_problem(args)
    device = problem.device
    print(f"device={device}", file=sys.stderr)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    first = step(problem)
    sync()
    dropped = int(first["num_dropped"])
    del first
    print(f"first step: {time.perf_counter() - t0:.1f}s (kernel builds "
          f"included) dropped={dropped}", file=sys.stderr)

    def timed(n):
        sync()
        t = time.perf_counter()
        for _ in range(n):
            step(problem)
        sync()
        return time.perf_counter() - t

    n_hi, n_lo = args.iters + 1, max(args.iters // 4, 1)
    per_pair_dt = []
    attempts, max_attempts = 0, 4 * args.repeats
    while len(per_pair_dt) < args.repeats and attempts < max_attempts:
        attempts += 1
        a = timed(n_hi)
        b = timed(n_lo)
        pair_dt = (a - b) / (n_hi - n_lo)
        if pair_dt <= 0:
            print(f"discarding degenerate pair (hi {a*1e3:.1f} ms <= "
                  f"lo {b*1e3:.1f} ms); re-measuring", file=sys.stderr)
            continue
        if per_pair_dt and pair_dt < 0.25 * statistics.median(per_pair_dt):
            print(f"discarding implausible pair ({pair_dt*1e3:.3f} ms/frame"
                  f" < 0.25x running median); re-measuring", file=sys.stderr)
            continue
        per_pair_dt.append(pair_dt)
    if len(per_pair_dt) < max(3, args.repeats // 2):
        print(f"FATAL: only {len(per_pair_dt)} valid timing pairs in "
              f"{attempts} attempts; rerun on a quieter device",
              file=sys.stderr)
        return 1
    px_frame = args.width * args.height
    per_pair_mpix = [px_frame / dt / 1e6 for dt in per_pair_dt]
    dt = statistics.median(per_pair_dt)
    mpix = statistics.median(per_pair_mpix)
    lo_m, hi_m = min(per_pair_mpix), max(per_pair_mpix)
    if not all(map(math.isfinite, (mpix, lo_m, hi_m))):
        print(f"FATAL: spread [{lo_m}, {hi_m}] is not finite",
              file=sys.stderr)
        return 1

    mode = "fwd" if args.forward_only else "fwd+bwd"
    frame = dict(gaussians=args.num_gaussians, width=args.width,
                 height=args.height, cfg=problem.cfg)
    if device.type == "cuda":
        report = roofline.frame_report(card_peaks(device, args.roofline),
                                       device, **frame)
        sol = report["sol_mpix_per_s"]
        tight = report["frame"]["tight_instances"]
        pairs = report["pairs"]
        name = torch.cuda.get_device_name(device)
        vs = mpix / sol
        baseline = (f"vs_baseline = fraction of the fwd+bwd SOL of blend "
                    f"kernels B1 and B2 on this frame at the P1-measured "
                    f"rates of this card ({sol:.1f} Mpix/s, "
                    f"utils/roofline.py)")
    else:
        counted = roofline.frame_pairs(device, **frame)
        sol = vs = None
        tight = counted["frame"]["tight_instances"]
        pairs = dict(zip(("evaluated", "tested", "live"), counted["pairs"]))
        name = str(device)
        baseline = ("vs_baseline = null: on the CPU the plain versions give "
                    "no device rate, hence no SOL")
    print(f"{mode}: {dt*1e3:.2f} ms/frame (median of {len(per_pair_dt)} "
          f"interleaved pairs; spread {px_frame/hi_m/1e3:.2f}-"
          f"{px_frame/lo_m/1e3:.2f} ms)", file=sys.stderr)
    ts = problem.cfg.raster.tile_size
    print(f"gaussian-pixel blends/s: {tight * ts * ts / dt / 1e9:.1f}G "
          f"({tight} tight instances x {ts*ts} px/frame)", file=sys.stderr)
    if sol is not None:
        print(f"SOL of B1+B2: {sol:.1f} Mpix/s -> {100*vs:.3f}% of SOL",
              file=sys.stderr)
    print(json.dumps({
        "metric": f"Mpix/s on {name} {mode} rasterization "
                  f"({args.num_gaussians} gaussians, "
                  f"{args.width}x{args.height}); {baseline}; median of "
                  f"{len(per_pair_dt)} interleaved timing pairs",
        "value": mpix,
        "unit": "Mpix/s",
        "vs_baseline": vs,
        "value_median": mpix,
        "value_spread": [lo_m, hi_m],
        "device": name,
        "ms_per_frame": dt * 1e3,
        "ms_spread": [px_frame / hi_m / 1e3, px_frame / lo_m / 1e3],
        "sol_mpix_per_s": sol,
        "tight_instances": tight,
        "pairs": pairs,
        "num_dropped": dropped,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
