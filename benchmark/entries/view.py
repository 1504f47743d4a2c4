"""The viewer: ``gsplat_tpu_torch.interact.viewer.ViewerServer``'s
``frame_pixels`` (edits, render with labels, the uint8 frame on the host),
one client in a closed loop over the traffic's orbit of poses, with the
traffic's edits in place (a label displaced, one hidden, one recoloured,
selection mode on another).

The check compares the frames of a seeded sample of the window's first
positions with the reference's: the share of uint8 values that differ, and
the share of pixels where a channel differs by more than ``FAR`` (a label
that flipped, or a wrong splat; the image's own rounding moves a value by
one).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark import counts, scenes
from benchmark.common import Spec, free, frame_counts, ref_camera
from benchmark.reference import frame as ref_frame, render

FAR = 16


class Cell:
    def __init__(self, spec: Spec):
        from gsplat_tpu_torch.interact.edit import EditState
        from gsplat_tpu_torch.interact.viewer import ViewerServer
        from gsplat_tpu_torch.scene import GaussianScene
        self.spec = spec
        cfg, tr, dev = spec.cfg, spec.traffic, spec.device
        p = scenes.scene(cfg, spec.seed, dev)
        self.server = ViewerServer(
            GaussianScene(p["means"], p["log_scales"], p["quats"],
                          p["opacities"], p["sh"], p["labels"]),
            width=cfg["width"], height=cfg["height"],
            center=np.zeros(3), device=dev)
        self.edits = scenes.edits(cfg, tr, spec.seed)
        e = self.edits
        self.server.edits = EditState(
            displacements=dict(e["displace"]),
            hidden={lab: True for lab in e["hide"]},
            colors=dict(e["recolor"]), selected_label=e["selected"],
            selection_mode=e["selection_mode"])
        self.poses = scenes.poses(tr, spec.seed)
        w = tr["warm_units"]
        self.keep = {w + k for k in scenes.sample(
            tr["check_within"], tr["check_frames"], spec.seed)}
        self.answers: Dict[int, np.ndarray] = {}
        self.i = 0
        self.failed = 0
        self.traced = []

    def unit(self):
        th, ph, r = self.poses[self.i % len(self.poses)]
        img = self.server.frame_pixels(th, ph, r, labels=True)
        if self.i in self.keep:
            self.answers[self.i] = img
        self.traced.append(self.i)
        self.i += 1

    def warm(self, n: int) -> None:
        for _ in range(n):
            self.unit()

    def finish(self) -> None:
        """Serve, outside the window, any sampled position the window did
        not reach; those are not among the traced frames."""
        traced = list(self.traced)
        while self.i <= max(self.keep):
            self.unit()
        self.traced = traced

    def work(self) -> int:
        return 1

    def e2e(self, window_s: float, times, work: int) -> Dict[str, float]:
        ms = sorted(t * 1e3 for t in times)
        p95 = ms[min(len(ms) - 1, int(np.ceil(0.95 * len(ms))) - 1)]
        return {"frame_ms": window_s * 1e3 / work, "frame_ms_p95": p95}

    # --- trace -----------------------------------------------------------
    def before_trace(self) -> None:
        self.traced = []

    def _camera(self, pos: int) -> render.Cam:
        cfg = self.spec.cfg
        th, ph, r = self.poses[pos % len(self.poses)]
        eye = r * np.array([np.cos(ph) * np.cos(th), np.sin(ph),
                            np.cos(ph) * np.sin(th)])
        fov = self.spec.traffic["poses"]["fov_x_deg"]
        return ref_camera(scenes.look_at(eye, np.zeros(3), cfg["width"],
                                         cfg["height"], fov),
                          self.spec.device)

    def _edited(self):
        cfg, tr, dev = self.spec.cfg, self.spec.traffic, self.spec.device
        p = scenes.scene(cfg, self.spec.seed, dev)
        return ref_frame.apply_edits(p, p["labels"], self.edits,
                                     tr["interact"]), p["labels"]

    def trace_counts(self) -> dict:
        """The reference's count of each traced frame's work, and the
        window's least time: B1's and the bytes each frame moves once."""
        cfg = self.spec.cfg
        ras = cfg["raster"]
        params, _ = self._edited()
        frames, step = {}, 0.0
        for k, pos in enumerate(self.traced):
            cam = self._camera(pos)
            proj = render.project(params, cam, ras)
            stream = render.bin_tiles(proj, cam.width, cam.height,
                                      ras["tile"])
            out = render.blend(proj.table, stream, cam.width, cam.height,
                               ras, chunk=ras["chunk"],
                               eps=ras["early_stop_eps"])
            frames[k] = frame_counts(stream, out.pairs, cfg["gaussians"],
                                     cam.width, cam.height)
            step += counts.blend_least("B1", frames[k]) + counts.frame_bytes(
                cfg["gaussians"], cfg["sh_degree"], cam.width,
                cam.height) / counts.HBM_BYTES_PER_S
            del proj, stream, out
        return dict(frames=frames, n_frames=len(self.traced),
                    step_least=step)

    # --- check -----------------------------------------------------------
    def release(self) -> None:
        self.server = None
        free()

    def reference(self, prec: render.Precision) -> Dict[int, torch.Tensor]:
        cfg, tr, dev = self.spec.cfg, self.spec.traffic, self.spec.device
        params, labels = self._edited()
        colours = ref_frame.palette(tr["palette_seed"], dev)
        bg = torch.zeros(3, device=dev)
        return {pos: ref_frame.frame(params, labels, self._camera(pos),
                                     cfg["raster"], cfg["raster"]["chunk"],
                                     colours, bg, prec)
                for pos in sorted(self.keep)}

    def compare(self, got, ref) -> Dict[str, float]:
        if set(got) != set(ref):
            return {"values_off": 1.0, "pixels_far": 1.0}
        off = far = total = pixels = 0
        for pos, r in ref.items():
            g = got[pos]
            g = (g if isinstance(g, torch.Tensor)
                 else torch.from_numpy(np.asarray(g))).to(r.device)
            if g.shape != r.shape:
                return {"values_off": 1.0, "pixels_far": 1.0}
            d = (g.int() - r.int()).abs()
            off += int((d > 0).sum())
            far += int((d > FAR).any(-1).sum())
            total += d.numel()
            pixels += d.shape[0] * d.shape[1]
        return {"values_off": off / total, "pixels_far": far / pixels}
