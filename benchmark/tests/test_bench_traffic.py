"""The generator: the same seed gives the same inputs, another seed other
ones, and a subset of views is built from the whole set's draws."""

import torch

from benchmark import scenes
from conftest import tiny_cell


def test_scene_repeats_from_the_seed():
    cell = tiny_cell("m360-overview")
    big = 2 ** 31 + 12345
    dev = torch.device("cpu")
    a, b = scenes.scene(cell.cfg, big, dev), scenes.scene(cell.cfg, big, dev)
    for k in a:
        assert torch.equal(a[k], b[k])
    c = scenes.scene(cell.cfg, big + 1, dev)
    assert not torch.equal(a["means"], c["means"])


def test_scene_shapes_and_parts():
    cell = tiny_cell("m360-overview")
    cfg = cell.cfg
    p = scenes.scene(cfg, 5, torch.device("cpu"))
    n = cfg["gaussians"]
    assert p["sh"].shape == (n, 16, 3) and p["labels"].dtype == torch.int32
    r = torch.linalg.vector_norm(p["means"], dim=1)
    nb = round(n * cfg["geometry"]["ball_share"])
    assert float(r[:nb].max()) <= cfg["geometry"]["ball_radius"] + 1e-6
    lo, hi = cfg["geometry"]["shell_radii"]
    assert float(r[nb:].min()) >= lo - 1e-4
    assert float(r[nb:].max()) <= hi + 1e-4
    s = torch.exp(p["log_scales"])
    top = cfg["geometry"]["ball_scale_max"]
    assert float(s[:nb].max()) <= top * (1 + 1e-6)


def test_seg_maps_repeat_and_subset():
    cell = tiny_cell("tnt-label")
    cfg, dev = cell.cfg, torch.device("cpu")
    s1 = scenes.seg_maps(cfg, scenes.seg_draws(cfg, cell.traffic, 3, dev),
                         range(4))
    s2 = scenes.seg_maps(cfg, scenes.seg_draws(cfg, cell.traffic, 3, dev),
                         [2])
    assert torch.equal(s1[2], s2[0])
    assert int(s1.min()) >= -1
    assert int(s1.max()) < cell.traffic["seg"]["num_classes"]


def test_poses_edits_and_samples_repeat():
    cell = tiny_cell("m360-overview")
    assert scenes.poses(cell.traffic, 77) == scenes.poses(cell.traffic, 77)
    assert sorted(scenes.poses(cell.traffic, 77)) == sorted(
        scenes.poses(cell.traffic, 78))
    e = scenes.edits(cell.cfg, cell.traffic, 77)
    assert e == scenes.edits(cell.cfg, cell.traffic, 77)
    labs = [*e["displace"], *e["hide"], *e["recolor"], e["selected"]]
    assert len(set(labs)) == 4
    assert scenes.sample(24, 4, 5) == scenes.sample(24, 4, 5)
