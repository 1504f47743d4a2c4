"""Training: ``gsplat_tpu_torch.models.trainer.make_train_step`` at the
configuration's ``fit`` group, one client in a closed loop. A step trains
on the next view of a seeded permutation of the configuration's views,
drawn anew each epoch, against that view's target; the targets are smooth
images made from the seed on the card in set-up and held there. A unit is
one step: the render, the loss, the gradient and Adam's update, ending in
the state the next step reads, with the loss read on the host.

The check recomputes with the reference (``benchmark/reference/train.py``)
a seeded sample of the window's first steps from the state each of them
started from, and compares what the timed steps themselves produced: the
image and the gradient the step's own render and ``trainer._grads`` made
(recorded as they return, for those steps alone), its loss, and the
parameters after its Adam update. The numbers:

- ``image_off``: ||image - reference|| / ||reference||;
- ``loss_off``: |loss - reference| / reference;
- ``grad_gap``: the largest over the five fields of ||g - g_ref|| /
  ||g_ref||;
- ``zero_moved``: of the gaussians whose reference gradient is exactly 0
  in all 59 floats, the share whose parameters after the step differ from
  the reference step's (which moves such a gaussian by its Adam moments
  alone, and not at all where they are 0);
- ``param_gap``: the largest over the five fields of ||dp - dp_ref|| /
  ||dp_ref||, dp the step's change of the parameters.

Each is the largest (``zero_moved`` the share) over the sampled steps.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark import counts, counts_train, scenes
from benchmark.common import (Spec, free, frame_counts, program_camera,
                              ref_camera)
from benchmark.reference import render, train as ref_train

FIELDS = ref_train.FIELDS
# purposes of the generator beside scenes.py's (which end at 7)
_TARGETS, _ORDER = 8, 9


def _generator(seed: int, purpose: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 16 + purpose) % (2 ** 63))
    return g


def targets(cfg: dict, seed: int, device, views=None) -> torch.Tensor:
    """[len(views), H, W, 3] f32 (every view by default): each view's
    grid of uniform colours, bilinear to the frame. All grids are drawn at
    once, so a subset is the same as the whole set's rows."""
    gh, gw = cfg["fit"]["targets"]["grid"]
    grids = torch.rand(cfg["views"], 3, gh, gw, device=device,
                       generator=_generator(seed, _TARGETS, device))
    views = range(cfg["views"]) if views is None else views
    out = torch.empty(len(views), cfg["height"], cfg["width"], 3,
                      device=device)
    for j, v in enumerate(views):
        out[j] = F.interpolate(grids[v:v + 1], size=(cfg["height"],
                                                    cfg["width"]),
                               mode="bilinear", align_corners=False
                               )[0].permute(1, 2, 0)
    return out


def view_order(cfg: dict, seed: int, epoch: int) -> List[int]:
    """The views of ``epoch`` in training order."""
    return torch.randperm(cfg["views"], generator=_generator(
        seed * 4096 + epoch, _ORDER, "cpu")).tolist()


def _snapshot(state) -> dict:
    """A training state's tensors by field (no copy: a step makes new
    tensors and leaves its input as it was)."""
    return dict(params=dict(zip(FIELDS, state.params)),
                mu=dict(zip(FIELDS, state.opt_state.mu)),
                nu=dict(zip(FIELDS, state.opt_state.nu)),
                count=int(state.opt_state.count))


class Cell:
    def __init__(self, spec: Spec):
        from gsplat_tpu_torch.models import trainer
        from gsplat_tpu_torch.render.projection import CameraParams
        from gsplat_tpu_torch.scene import GaussianScene
        self.spec = spec
        cfg, tr, dev = spec.cfg, spec.traffic, spec.device
        fit = cfg["fit"]
        self.trainer = trainer
        p = scenes.scene(cfg, spec.seed, dev)
        self.labels = p["labels"]
        self.state = trainer.init_state(GaussianScene(
            p["means"], p["log_scales"], p["quats"], p["opacities"], p["sh"],
            p["labels"]), lr=fit["lr"])
        del p
        self.step_fn = trainer.make_train_step(
            (cfg["width"], cfg["height"]), lr=fit["lr"], loss=fit["loss"])
        self.views = scenes.ring(cfg)
        self.cams = [CameraParams.from_camera(program_camera(v, i), dev)
                     for i, v in enumerate(self.views)]
        self.targets = targets(cfg, spec.seed, dev)
        self.bg = torch.tensor(fit["background"], dtype=torch.float32,
                               device=dev)
        w = tr["warm_units"]
        self.keep = {w + k for k in scenes.sample(
            tr["check_within"], tr["check_steps"], spec.seed)}
        self.answers: Dict[int, dict] = {}
        self.orders: Dict[int, List[int]] = {}
        self.i = 0
        self.failed = 0
        self.tracing = False
        self.traced: List[tuple] = []   # (view, parameters before)

    def view_of(self, k: int) -> int:
        n = self.spec.cfg["views"]
        e = k // n
        if e not in self.orders:
            self.orders[e] = view_order(self.spec.cfg, self.spec.seed, e)
        return self.orders[e][k % n]

    def _record(self, seen: dict):
        """Wrap the trainer's render and gradient so that the step keeps
        what they return; returns the undo."""
        tm = self.trainer
        render_fn, grads_fn = tm._render_impl, tm._grads

        def rendered(*a, **kw):
            out = render_fn(*a, **kw)
            seen["image"] = out["image"].detach()
            return out

        def graded(*a, **kw):
            out = grads_fn(*a, **kw)
            seen["grads"] = dict(zip(FIELDS, out[0]))
            return out

        tm._render_impl, tm._grads = rendered, graded

        def undo():
            tm._render_impl, tm._grads = render_fn, grads_fn
        return undo

    def unit(self):
        k = self.i
        v = self.view_of(k)
        before = self.state
        seen: dict = {}
        undo = self._record(seen) if k in self.keep else None
        try:
            state, loss, _ = self.step_fn(before, self.labels, self.cams[v],
                                          self.targets[v], self.bg)
        finally:
            if undo is not None:
                undo()
        value = float(loss)
        if not math.isfinite(value):
            self.failed += 1
        if undo is not None:
            self.answers[k] = dict(view=v, before=_snapshot(before),
                                   after=_snapshot(state), loss=value,
                                   **seen)
        if self.tracing:
            self.traced.append((v, dict(zip(FIELDS, before.params))))
        self.state = state
        self.i += 1

    def warm(self, n: int) -> None:
        for _ in range(n):
            self.unit()

    def finish(self) -> None:
        """Run, outside the window, any sampled step the window did not
        reach; those are not among the traced steps."""
        self.tracing = False
        while self.i <= max(self.keep):
            self.unit()

    def work(self) -> int:
        return 1

    def e2e(self, window_s: float, times, work: int) -> Dict[str, float]:
        return {"frame_ms": window_s * 1e3 / work}

    # --- trace -----------------------------------------------------------
    def before_trace(self) -> None:
        self.traced = []
        self.tracing = True

    def trace_counts(self) -> dict:
        """The reference's count of each traced step's work (B1 and B2 walk
        the same pairs, the fold its slots), and the window's least time:
        B1's and B2's, plus the bytes a step must move once."""
        cfg = self.spec.cfg
        ras = cfg["raster"]
        frames, step = {}, 0.0
        for k, (v, params) in enumerate(self.traced):
            cam = ref_camera(self.views[v], self.spec.device)
            proj = render.project(params, cam, ras)
            stream = render.bin_tiles(proj, cam.width, cam.height,
                                      ras["tile"])
            out = render.blend(proj.table, stream, cam.width, cam.height,
                               ras, chunk=ras["chunk"],
                               eps=ras["early_stop_eps"])
            frames[k] = frame_counts(stream, out.pairs, cfg["gaussians"],
                                     cam.width, cam.height)
            step += (counts.blend_least("B1", frames[k])
                     + counts.blend_least("B2", frames[k])
                     + counts_train.step_bytes(
                         cfg["gaussians"], cfg["sh_degree"], cam.width,
                         cam.height) / counts.HBM_BYTES_PER_S)
            del proj, stream, out
        return dict(frames=frames, n_frames=len(self.traced),
                    step_least=step)

    # --- check -----------------------------------------------------------
    def release(self) -> None:
        self.state = self.step_fn = self.targets = self.cams = None
        self.labels = None
        free()

    def reference(self, prec: render.Precision) -> Dict[int, dict]:
        cfg, dev = self.spec.cfg, self.spec.device
        bg = torch.tensor(cfg["fit"]["background"], dtype=torch.float32,
                          device=dev)
        out = {}
        for k in sorted(self.answers):
            a = self.answers[k]
            b = a["before"]
            r = ref_train.step(b["params"], b["mu"], b["nu"], b["count"],
                               ref_camera(self.views[a["view"]], dev),
                               targets(cfg, self.spec.seed, dev,
                                       [a["view"]])[0],
                               bg, cfg["fit"], cfg["raster"], prec)
            out[k] = dict(image=r.image, loss=r.loss, grads=r.grads,
                          after=dict(params=r.params))
            free()
        return out

    def compare(self, got, ref) -> Dict[str, float]:
        bad = dict(image_off=1.0, loss_off=1.0, grad_gap=1.0,
                   zero_moved=1.0, param_gap=1.0)
        if set(got) != set(ref) or not ref:
            return bad
        gap = ref_train.rel_gap
        image_off = loss_off = grad_gap = param_gap = 0.0
        moved = zeros = 0
        for k, r in ref.items():
            g = got[k]
            if "image" not in g or "grads" not in g:
                return bad
            before = self.answers[k]["before"]["params"]
            image_off = max(image_off, gap(g["image"], r["image"]))
            loss_off = max(loss_off, abs(g["loss"] - r["loss"])
                           / abs(r["loss"]))
            still = moves = None
            for f in FIELDS:
                gg, rg = g["grads"][f], r["grads"][f]
                grad_gap = max(grad_gap, gap(gg, rg))
                p, rp = g["after"]["params"][f], r["after"]["params"][f]
                param_gap = max(param_gap, gap(p - before[f],
                                               rp - before[f]))
                z = (rg == 0).reshape(rg.shape[0], -1).all(1)
                d = (p != rp).reshape(p.shape[0], -1).any(1)
                still = z if still is None else still & z
                moves = d if moves is None else moves | d
            zeros += int(still.sum())
            moved += int((still & moves).sum())
        return dict(image_off=image_off, loss_off=loss_off,
                    grad_gap=grad_gap,
                    zero_moved=moved / zeros if zeros else 0.0,
                    param_gap=param_gap)
