"""Labeling: ``gsplat_tpu_torch.label.vote.assign_labels_visible``, one job
labelling the whole scene from every view of the configuration's rig (the
visibility render of kernel B5 per view, then the vote) against seg maps
made from the seed and handed over as host arrays, as a segmentation
model's output would be.

The check compares, of the window's last job, the visibility rows of a
seeded sample of views with the reference's (the share of gaussians whose
visibility differs, over those the reference sees) and the labels with the
reference's vote over the job's own visibility rows of every view
(recorded as ``visibility_masks`` returns them): a reference visibility
render of every view would outlast the window. So that the vote is also
judged on visibility the reference made itself, a second job after the
window labels the scene from the sampled views alone, and its labels are
compared with the reference's vote over its own visibility of those views.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark import counts, scenes
from benchmark.common import (Spec, free, frame_counts, program_camera,
                              ref_camera, sync)
from benchmark.reference import render, vote as ref_vote


class _Recorder:
    """Keeps what the wrapped function last returned."""

    def __init__(self, fn):
        self.fn, self.value = fn, None

    def __call__(self, *a, **kw):
        self.value = self.fn(*a, **kw)
        return self.value


class Cell:
    def __init__(self, spec: Spec):
        from gsplat_tpu_torch.label import vote
        from gsplat_tpu_torch.scene import GaussianScene
        self.spec = spec
        cfg, tr, dev = spec.cfg, spec.traffic, spec.device
        p = scenes.scene(cfg, spec.seed, dev)
        self.scene = GaussianScene(p["means"], p["log_scales"], p["quats"],
                                   p["opacities"], p["sh"], p["labels"])
        self.views = scenes.ring(cfg)
        self.cams = [program_camera(v, i) for i, v in enumerate(self.views)]
        self.seg = scenes.seg_maps(cfg, scenes.seg_draws(
            cfg, tr, spec.seed, dev), range(cfg["views"])).cpu().numpy()
        self.vote = vote
        # the job's visibility rows, as visibility_masks returns them; the
        # module's own function is put back by release()
        self.recorder = _Recorder(vote.visibility_masks)
        vote.visibility_masks = self.recorder
        self.sampled = scenes.sample(cfg["views"], tr["check_views"],
                                     spec.seed)
        self.answers = None
        self.failed = 0
        self.ref_pairs = {}

    def unit(self):
        tr = self.spec.traffic
        labels = self.vote.assign_labels_visible(
            self.scene, self.cams, self.seg,
            num_classes=tr["seg"]["num_classes"],
            visibility_threshold=tr["visibility_threshold"],
            device=self.spec.device)
        sync(self.spec.device)
        self.answers = dict(labels=labels, vis=self.recorder.value)

    def warm(self, n: int) -> None:
        for _ in range(n):
            self.unit()

    def finish(self) -> None:
        """The job over the sampled views alone (module docstring)."""
        tr = self.spec.traffic
        self.answers["sample_labels"] = self.vote.assign_labels_visible(
            self.scene, [self.cams[v] for v in self.sampled],
            self.seg[self.sampled], num_classes=tr["seg"]["num_classes"],
            visibility_threshold=tr["visibility_threshold"],
            device=self.spec.device)

    def work(self) -> int:
        return len(self.cams)

    def e2e(self, window_s: float, times, work: int) -> Dict[str, float]:
        return {"label_ms_per_view": window_s * 1e3 / work}

    # --- trace -----------------------------------------------------------
    def before_trace(self) -> None:
        pass

    def trace_counts(self) -> dict:
        """The reference's count of the sampled views' work (its blends at
        no early stop, which the check makes first), by the view's place in
        the traced job, and the traced window's least time: the sample's
        mean a view (B5's and the bytes a view moves once) times the views
        of the window."""
        cfg = self.spec.cfg
        n = len(self.cams) * self.spec.traffic["trace_units"]
        if not self.ref_pairs:
            return dict(frames={}, n_frames=n, step_least=None)
        per_view = counts.label_bytes(cfg["gaussians"], cfg["sh_degree"]) \
            / counts.HBM_BYTES_PER_S
        step = sum(counts.blend_least("B5", f) + per_view
                   for f in self.ref_pairs.values())
        return dict(frames=dict(self.ref_pairs), n_frames=n,
                    step_least=step * n / len(self.ref_pairs))

    # --- check -----------------------------------------------------------
    def release(self) -> None:
        self.vote.visibility_masks = self.recorder.fn
        self.scene = None
        free()

    def reference(self, prec: render.Precision):
        """The sampled views' visibility; the vote over the job's
        visibility rows, and over the reference's own rows of the sampled
        views (module docstring)."""
        cfg, tr, dev = self.spec.cfg, self.spec.traffic, self.spec.device
        p = scenes.scene(cfg, self.spec.seed, dev)
        vis = {}
        for v in self.sampled:
            cam = ref_camera(self.views[v], dev)
            vis[v], pairs, stream = ref_vote.visibility(
                p, cam, cfg["raster"], cfg["raster"]["chunk"],
                tr["visibility_threshold"], prec)
            self.ref_pairs[v] = frame_counts(stream, pairs, cfg["gaussians"],
                                             cam.width, cam.height)
            del stream
        seg = scenes.seg_maps(cfg, scenes.seg_draws(cfg, tr, self.spec.seed,
                                                    dev), range(cfg["views"]))
        cams = [ref_camera(v, dev) for v in self.views]
        classes = tr["seg"]["num_classes"]
        labels = ref_vote.labels(p["means"], cams, seg, self.answers["vis"],
                                 classes)
        sample_labels = ref_vote.labels(
            p["means"], [cams[v] for v in self.sampled], seg[self.sampled],
            torch.stack([vis[v] for v in self.sampled]), classes)
        return dict(vis=vis, labels=labels, sample_labels=sample_labels)

    def compare(self, got, ref) -> Dict[str, float]:
        """``vis_off`` over the gaussians the reference sees, ``labels_off``
        over all, ``sample_labels_off`` over those that either side labels
        from the sample."""
        off = seen = 0
        for v, r in ref["vis"].items():
            off += int((got["vis"][v].to(r.device) != r).sum())
            seen += int(r.sum())
        dev = ref["labels"].device
        lab = (got["labels"].long().to(dev) != ref["labels"]).float().mean()
        g, r = got["sample_labels"].long().to(dev), ref["sample_labels"]
        either = (g != -1) | (r != -1)
        s_off = int(((g != r) & either).sum()) / max(int(either.sum()), 1)
        return {"vis_off": off / max(seen, 1), "labels_off": float(lab),
                "sample_labels_off": s_off}
