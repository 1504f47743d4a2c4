"""The reference against the program's plain CPU path (its kernels' plain
PyTorch versions) at a tiny size: the image and label map, and the
per-view visibility."""

import torch

from benchmark import scenes
from benchmark.common import program_camera, ref_camera
from benchmark.reference import render, vote as ref_vote
from conftest import tiny_cell


def _setup(name="m360-overview", seed=31):
    from gsplat_tpu_torch.scene import GaussianScene
    cell = tiny_cell(name)
    p = scenes.scene(cell.cfg, seed, torch.device("cpu"))
    scene = GaussianScene(p["means"], p["log_scales"], p["quats"],
                          p["opacities"], p["sh"], p["labels"])
    return cell, p, scene, scenes.ring(cell.cfg)


def test_render_matches_the_program():
    from gsplat_tpu_torch.render.api import render as prog_render
    cell, p, scene, views = _setup()
    ras = cell.cfg["raster"]
    for v in views[:3]:
        out = prog_render(scene, program_camera(v), with_labels=True,
                          device="cpu")
        cam = ref_camera(v, "cpu")
        proj = render.project(p, cam, ras)
        stream = render.bin_tiles(proj, cam.width, cam.height, ras["tile"])
        ref = render.blend(proj.table, stream, cam.width, cam.height, ras,
                           chunk=ras["chunk"], eps=ras["early_stop_eps"],
                           labels=p["labels"].long())
        assert float((out["image"] - ref.rgb).abs().max()) < 1e-5
        assert float((out["transmittance"] - ref.trans).abs().max()) < 1e-5
        same = (out["label_map"].long() == ref.label).float().mean()
        assert float(same) >= 0.999
        assert int(stream.count.sum()) > 0


def test_visibility_matches_the_program():
    from gsplat_tpu_torch.label.vote import visibility_masks
    cell, p, scene, views = _setup("tnt-label")
    cams = [program_camera(v, i) for i, v in enumerate(views)]
    vis = visibility_masks(scene, cams, device="cpu")
    ras = cell.cfg["raster"]
    for i, v in enumerate(views):
        ref, pairs, _ = ref_vote.visibility(p, ref_camera(v, "cpu"), ras,
                                            ras["chunk"], 0.05)
        assert torch.equal(vis[i], ref)
        assert pairs[2] > 0
