"""A viewer frame in plain PyTorch: the scene after the per-label edits,
rendered with labels, and the uint8 frame with the label overlay.

Edits (the configuration's ``interact`` group): a displaced label's means
move by its offset; a hidden label's opacity logit becomes ``hidden_logit``;
a recoloured label's DC colour mixes toward its colour by
``custom_color_mix``, and with selection mode on the selected label's
toward red by ``highlight_mix``; a DC colour is 0.5 + SH_C0 dc.

The frame clips the image to [0, 1]; with labels it is
0.4 image + 0.6 palette[|label| % 256] (0 where unlabeled), in f64 past
the f32 product 0.4 image; then 255 times it, truncated to uint8. The
palette is 256 colours uniform in [0.25, 1) from numpy's
``default_rng(palette_seed)``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import render
from benchmark.reference.render import SH_C0, F32, Precision


@torch.no_grad()
def apply_edits(params: dict, labels: torch.Tensor, edits: dict,
                interact: dict) -> dict:
    means, op, sh = params["means"], params["opacities"], params["sh"]
    for lab, d in edits["displace"].items():
        means = means + torch.where((labels == int(lab))[:, None],
                                    torch.tensor(d, device=means.device,
                                                 dtype=torch.float32), 0.0)
    for lab in edits["hide"]:
        op = torch.where(labels == int(lab), interact["hidden_logit"], op)

    def mix(sh, lab, rgb, a):
        base = 0.5 + SH_C0 * sh[:, 0, :]
        target = torch.tensor(rgb, device=sh.device, dtype=torch.float32)
        dc = ((1.0 - a) * base + a * target - 0.5) / SH_C0
        sel = (labels == int(lab))[:, None]
        return torch.cat([torch.where(sel, dc, sh[:, 0, :])[:, None],
                          sh[:, 1:]], 1)

    for lab, rgb in edits["recolor"].items():
        sh = mix(sh, lab, rgb, interact["custom_color_mix"])
    if edits["selection_mode"]:
        sh = mix(sh, edits["selected"], (1.0, 0.0, 0.0),
                 interact["highlight_mix"])
    return dict(params, means=means, opacities=op, sh=sh)


def palette(seed: int, device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0.25, 1.0, size=(256, 3))).to(device)


@torch.no_grad()
def frame(params: dict, labels: torch.Tensor, cam: render.Cam, raster: dict,
          chunk: int, colours: torch.Tensor, bg: torch.Tensor,
          prec: Precision = F32) -> torch.Tensor:
    """[H, W, 3] uint8 frame (on the device) of already edited ``params``."""
    proj = render.project(params, cam, raster, prec)
    stream = render.bin_tiles(proj, cam.width, cam.height, raster["tile"])
    out = render.blend(proj.table, stream, cam.width, cam.height, raster,
                       chunk=chunk, eps=raster["early_stop_eps"],
                       labels=labels.long(), prec=prec)
    img = torch.clamp(out.rgb + out.trans[..., None] * bg, 0.0, 1.0)
    lab = out.label
    overlay = colours[lab.abs() % 256] * (lab != render.UNLABELED)[..., None]
    img = (0.4 * img).double() + 0.6 * overlay
    return (img * 255).to(torch.uint8)
