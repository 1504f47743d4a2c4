"""The twins of ``examples/01-05`` (``examples_torch/``), run in process on
the CPU.

Each twin runs through ``runpy`` with ``--device cpu`` and a temporary
``--out-dir``, exits cleanly, writes its files and prints the JAX example's
lines. ``JAX_LINES`` are the lines the JAX examples print (JAX on the CPU;
05 on 8 virtual devices, a 2x4 mesh where the twin's is 2x2 logical shards
on one device); the examples are not run here, their JAX compiles alone
would take minutes. A line holding a number is held to the bar of
``chip_smoke.EXAMPLE_BARS`` (phase X holds the card's runs to the CPU's
with the same bars): labels, counts, accuracies and IoU equal; 01's
coverage within 1e-4; a loss or 03's fitted error within 1e-4 relative
plus half the last printed digit; 03's perturbation within 1e-6 relative;
05's sharded error at most 1e-5.
"""

import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import EXAMPLE_ERR, EXAMPLE_ERR_BAR, example_lines_agree

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

JAX_LINES = {
    "01_render_and_edit": [
        "rendered (240, 320, 3) coverage 0.5003548860549927",
        "hit label: 2",
        "after hide: 0 pixels of label 2 remain"],
    "02_label_pipeline": [
        "naive vote accuracy:          0.970",
        "occlusion-aware accuracy:     0.904",
        "mean IoU of re-rendered label map: 0.628",
        "label -1 (-1): 10 gaussians (1.00%)",
        "label 0 (0): 152 gaussians (15.20%)",
        "label 1 (1): 141 gaussians (14.10%)",
        "label 2 (2): 174 gaussians (17.40%)"],
    "03_train_scene": [
        "step   0  loss 0.020049",
        "step  15  loss 0.006576",
        "step  30  loss 0.002279",
        "step  45  loss 0.001288",
        "step  59  loss 0.000579",
        "means error before: 0.05527568235993385 after: 0.0216474998742342"],
    "04_clustering": [
        "k-means: 10 iterations, final shift 1.05e-01",
        "cluster sizes: [201, 222, 181, 194, 153, 193, 175, 181]",
        "region growing: 41 regions; median normal residual 0.0251"],
    "05_multichip": [
        "sharded vs single-device max pixel err: 2.38e-07",
        "one sharded train step: loss 0.049627 (grads reduce-scattered over "
        "the mesh)"],
}

FILES = {
    "01_render_and_edit": ["example_scene.ply", "example_scene.splat",
                           "example_session.json"],
    "02_label_pipeline": ["relabeled_view0.npy"],
    "03_train_scene": ["example_fitted.ply"],
    "04_clustering": ["example_clustered.ply", "example_regions.ply"],
    "05_multichip": ["sharded.npy"],
}


def run_twin(name, out_dir, capsys):
    path = REPO / "examples_torch" / f"{name}.py"
    argv = sys.argv
    sys.argv = [str(path), "--device", "cpu", "--out-dir", str(out_dir)]
    try:
        with pytest.raises(SystemExit) as done:
            runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = argv
    assert done.value.code == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name", sorted(JAX_LINES))
def test_twin_prints_the_jax_examples_lines(name, tmp_path, capsys):
    lines = run_twin(name, tmp_path, capsys)
    for f in FILES[name]:
        assert (tmp_path / f).stat().st_size > 0, f
    want = JAX_LINES[name]
    if name == "05_multichip":
        assert lines[0] == "mesh: {'host': 2, 'chip': 2}"
        want = lines[:1] + want
        err = float(re.search(EXAMPLE_ERR, lines[1]).group(1))
        assert err <= EXAMPLE_ERR_BAR
        img = np.load(tmp_path / "sharded.npy")
        assert img.shape == (96, 128, 3) and np.isfinite(img).all()
    assert example_lines_agree(name, lines, want) == []
    wrote = [ln for ln in lines if ln.startswith("wrote")]
    assert all(ln.startswith(f"wrote {tmp_path}") for ln in wrote)


def test_example_bars_catch_a_difference():
    # a label line, a loss past 1e-4 and a changed word each disagree
    assert example_lines_agree("04_clustering", ["cluster sizes: [1, 2]"],
                               ["cluster sizes: [2, 1]"])
    assert example_lines_agree("03_train_scene", ["step   0  loss 0.020060"],
                               ["step   0  loss 0.020049"])
    assert not example_lines_agree("03_train_scene",
                                   ["step   0  loss 0.020050"],
                                   ["step   0  loss 0.020049"])
    assert example_lines_agree("05_multichip", ["one step: loss 0.049627"],
                               ["two step: loss 0.049627"])


def test_twins_import_no_jax():
    for path in sorted((REPO / "examples_torch").glob("*.py")):
        src = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|gsplat_tpu)\b", src,
                             re.M), path
    assert len(list((REPO / "examples_torch").glob("0*.py"))) == 5
