"""What the cells share: the spec of a run, device sync, the two sides'
cameras, and the reference's count of a frame's work."""

from __future__ import annotations

import gc
from typing import NamedTuple

import torch

from benchmark import counts, scenes
from benchmark.reference import render


class Spec(NamedTuple):
    """One run of one cell."""

    workload: str
    cfg: dict       # the configuration file
    traffic: dict   # the traffic file
    seed: int
    device: torch.device


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def program_camera(view: scenes.View, i: int = 0):
    """The program's camera of a generated view."""
    from gsplat_tpu_torch.io.cameras import Camera
    return Camera(id=i, img_name=f"view_{i:04d}", width=view.width,
                  height=view.height, position=view.pos, rotation=view.rot,
                  fx=float(view.fx), fy=float(view.fy))


def ref_camera(view: scenes.View, device) -> render.Cam:
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return render.Cam(f32(view.rot), f32(view.pos), float(view.fx),
                      float(view.fy), view.width, view.height)


def frame_counts(stream: render.Stream, pairs: tuple, n: int, width: int,
                 height: int) -> counts.Frame:
    """A frame's work as :mod:`benchmark.counts` charges it."""
    return counts.Frame(n, stream.slots, stream.tiles_x * stream.tiles_y,
                        width, height, pairs)
