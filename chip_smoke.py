#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``gsplat_tpu_torch``) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --rehearse [--views 64] [--reduce 100]

Run from the root of the repository, on a machine with an NVIDIA Hopper card
and the CUDA toolkit. It exits nonzero, printing no result, without a card
or without the repository beside it. ``--rehearse`` runs phase L alone at
reduced size on the CPU instead (see :func:`rehearse`), which is where
LABEL_AGREEMENT_BAR comes from. Phases (any failure stops the run):

0. the card's name and power limit, as nvidia-smi reports them;
1. build every kernel from ``gsplat_tpu_torch/csrc`` (one nvcc per source,
   all at once) and print build seconds and ptxas' registers, shared memory
   and spills (P2's kernels must show no stack frame and no spill); then
   the native PLY codec from ``native/gsplat_native.cpp`` (``io/native.py``,
   which phase 3's and the CLIs' PLY reads take);
P. the probes: ``python -m gsplat_tpu_torch.utils.roofline``'s path (the
   card's f32 FMA and expf rates from kernels P1, and the bench frame's
   SOL), then ``utils.scan_probe``'s check and bench (kernels P2); both P1
   chains against their plain versions (relative 1e-5) on a small launch
   and at the main path's, both scans against theirs (flat bit for bit,
   grouped within 1e-6) and float64 cumprod / cumsum (1e-5, 1e-3), the
   rounds against theirs at 1 and 1,024 passes and at the bench's launch,
   the scans' rounds replayed from a CUDA graph at 1,024 and 256 passes
   (the first at least 2.5x the second, or the passes were collapsed), and
   the probes' times, plain and library times and bounds; the measured
   rates then bound every kernel in phase 5, the data sheet's beside them;
B. the twins of the repository's two measurement programs at their
   defaults, each through its ``main`` in this process: ``utils.bench``
   (``bench.py``'s 100k-gaussian frame at 800x608) fwd+bwd and
   ``--forward-only``, given phase P's report as ``--roofline``, and
   ``utils.bench_vote`` (``bench_vote.py``'s 1M gaussians x 311 views) in
   center and visible mode; each JSON line logged with the card; every
   value finite and positive, each ``vs_baseline`` of the bench in (0,
   1.05] and its SOL phase P's, no pair shortfall (exit 1), ``num_dropped``
   0, the bench step's image (both modes) equal bit for bit to
   ``render``'s of the same scene and camera; B4, B1, B2 and the
   fold launched in the bench, B4 and B5 in the visible vote; then, on
   the visible vote's view 0 (tiles of up to ~70k instances), B4 keys
   equal to its plain version's, B5 within 1e-5 of its plain version, and
   B1 at early_stop_eps 0 equal to B5 bit for bit, or, where B1 split long
   tiles (``blend.split_counts``), within 1e-5 with labels equal (its merge
   associates the segments' products differently); and B1 within 1e-5 of
   the one-block walk's plain version at eps 0 and the default, labels
   equal, tiles split, and equal bit for bit to the split walk's plain
   version with the launch's lengths (``check_b1_split``);
2. the repo's bench frame (100k gaussians, 800x608, ``bench.py``): each
   kernel against its plain PyTorch version (B4 keys exactly equal, B1 within
   1e-5 at early_stop_eps 0 and at the default, labels equal; B2 within 1e-4
   of each column's peak, zero rows equal), the instance counts against the
   JAX binning's, a small render on the card against the same render on the
   CPU, and the gradients of all five scene tensors on the card against the
   CPU's (within 1e-3 of each tensor's peak); B5 against its plain version
   (image, T and best weight within 1e-5, labels equal, per-instance rows
   within 1e-5 and zero past the last tile), and both label votes on the
   card against the CPU on two small scenes; B1 at early_stop_eps 0 equal
   to B5 bit for bit (image, T, best weight, label; within 1e-5 where B1
   split a tile); then ``check_b1_split`` on a frame at the viewer cell's
   shapes (the 2.4M gaussians of an m360-sized ball from radius 12 at
   1237x822, tiles up to ~187k instances), where B1 splits tiles and its
   merge walks some segments again (the tile's stop inside a later
   segment); the fold's boundary
   gathers (``render.api.segment_sums``) equal to their plain version bit
   for bit on the frame's fold; the fold kernel (``render.api.fold_rows``)
   equal to its plain version bit for bit and from call to call, 0 on every
   all-zero segment, timed (CUDA events and a CUDA graph) beside its plain
   version and its bound by bytes, on the frame's fold and on a full-size
   training view of the benchmark's ``m360-fit`` deployment (3M gaussians,
   1237x822); the projection kernel
   (``render.projection.project``, ``csrc/project.cu``) equal to
   ``_project_plain`` bit for bit in every field, one launch, timed beside
   the plain version and its bound by bytes (here, on the 2M view of
   phase 3, and on scenes of SH degree 3 at the benchmark's sizes: 1.7M
   gaussians at 980x545, 3M at 1237x822); its backward kernel
   (``render.projection.project_bwd``, ``csrc/project_bwd.cu``) equal to
   ``_project_vjp_plain`` bit for bit in all five gradients and from call
   to call, one launch, timed beside the plain VJP, the autograd backward
   through ``_project_plain`` it replaced and its bound by bytes (on the
   bench frame and the two SH-3 scenes); then B1, B5 and B2
   against their plain versions (the same bars) on the thin-splat frame
   (``synthetic.thin_splats_projection``: 3,000 thin, rotated, high-opacity
   splats on the 16-px grid lines, 200x136), the skip test's hardest input;
   B1's, B5's and B2's registers and resident blocks an SM are logged after
   the build, each frame's tile lengths (max, p99, median) beside its
   checks;
3. the serving path at real size: a 2M-gaussian scene written to PLY, loaded
   back through ``scene_from_ply`` (native codec and numpy reader, each
   timed and equal to the scene) and rendered with labels from 8 orbit
   views at 800x608 through ``render``; outputs finite and covered, nothing
   dropped, B4 and B1 launched once per frame; then B4, B1, B2 and B5
   against their plain versions on one of those frames, B1 at eps 0 equal
   to B5 there (as in phase B), B3 against a
   float64 prefix sum on that frame's gradient fold (within 1e-6 of each
   column's peak prefix, and equal bit for bit over three calls with a
   call at the bench frame's size between them), and the boundary gathers
   equal to their plain version bit for bit;
R. the offline render path at real size: ``gsplat_tpu_torch.cli.render``
   over phase 3's PLY, the 8 views with label maps and a session that
   hides label 3, displaces label 1 and recolours label 2; every PNG
   decodes (zlib, here) to the render's uint8 image, label 3 is in no
   label map, B4 and B1 launched once a view, the CLI's wall time; the 2M
   scene through ``write_splat`` -> ``load_scene``; ``render(impl="dense")``
   on the card against the tiled render (3,000 gaussians, 160x120);
L. the labeling path at real size, through ``gsplat_tpu_torch.cli.label``:
   the 2M scene labeled in 16 slabs along x, 311 orbit views at 800x608,
   seg maps made from the port's own label maps at 400x304, the CLI run with
   ``--model npy`` in ``--mode visible`` and ``--mode center``; labels in
   range, B5 launched once per view in the visible run and never in the
   center run, the visible vote's agreement with the slabs above the center
   vote's and above LABEL_AGREEMENT_BAR; the visibility pass and the vote
   timed;
4. the training path at real size: 10 steps of
   ``make_adaptive_multiview_train_step`` over 4 views of the 2M scene,
   perturbed, padded to 1.25x capacity, with one ``densify_and_prune`` and
   ``zero_adam_rows`` after step 5; loss falls, parameters finite, nothing
   dropped, B4, B1, B2 and the fold launched once per view per step; then
   one single-view ``make_train_step`` step timed and split into its
   stages, the fold into its scatter and ``fold_rows`` (the kernel held
   against its plain version bit for bit on the training state, whose dead
   and off-screen gaussians have no slot);
T. the training CLI at real size: 16 orbit views of the 2M scene rendered
   at 1600x1216 and written as PNG, an init PLY of the scene moved by
   seeded noise, ``gsplat_tpu_torch.cli.train`` for 120 steps at 800x608
   (``--scale 0.5``: the Pillow-exact resize) with densify at 40 and 80, an
   opacity reset at 60 and checkpoints at 50 and 100, then the same command
   again, which resumes at step 101; B4, B1, B2 and the fold launched once
   a step, the loss falling (each view's second visit against its
   first, before any densify or reset), the resumed run's last loss within
   1e-3 relative, the same alive count in both PLYs; each run's time split into
   target load, init PLY read (native codec), steps, densify, checkpoint
   save and load and the PLY write;
K. clustering: ``cli.kmeans`` over the 2M scene's PLY at k = 10 (the
   distance and update ms per iteration) and ``cli.region_growing`` over
   its first 100k gaussians at the reference's defaults (kNN, PCA and host
   BFS timed apart), both PLYs labeling every gaussian; the card against
   the CPU at 200k (k-means labels on >= 99.99%) and 5k with normals_k 200
   (neighbour sets equal but at ties, the same regions);
V. the live viewer at real size: V1 a ``ViewerServer`` of phase 3's 2M
   scene (800x608, the 8 orbit cameras, a session file) in a thread on a
   free port, driven over HTTP by a user's session: the page, /cameras,
   /campose, 60 orbit frames, 10 with labels, the 8 presets, a /select at
   the centre, set_color, hide and four displacements of the selected
   label and the three resets (a frame after each), then POST /load of 5
   cameras, of a 20k-gaussian PLY and of the 2M PLY again (timed); every
   status and content type, every PNG decoding to 608x800x3, frames over
   HTTP equal to ``frame_pixels`` bit for bit, the /select payload equal
   to ``hit_test``'s label, name and count, the highlight raising red and
   sel=0 giving the first frame back, hide changing pixels, each reset
   giving back the frame before its edits, the session file equal to the
   edit state, the frame after the reload equal to the first, B4 and B1
   launched once a /render and nothing else launched; client ms per
   /render (p50, p95, max), the page's fps, PNG bytes, peak memory and a
   server-side breakdown (edits, render, assembly with the copy, the PNG
   encode at zlib levels 0, 1 and 6). V2 ``cli.view`` as a subprocess on
   the 2M PLY: seconds to its printed port, 10 frames and a /select equal
   to V1's. V3 the viewer on the card against the CPU on
   ``tests/test_viewer.py``'s fixture scene (>= 99.9% of uint8 values
   equal, none more than 2 apart, /select payloads equal);
5. times on the card (CUDA events, median of 10 after warm-up) of
   projection, B4, the sort, B1, B2, B3, the boundary gathers, B5,
   ``torch.cumsum`` of B3's [B, 16] input along dim 0 and of its
   column-major copy along dim 1 (copy included; B3's library time is the
   faster) and the whole render at both frames, B4, B1, B3 and the
   gathers also replayed from a CUDA graph (the kernel without its
   wrapper's host work), the plain versions' times,
   bounds (at the P1 rates and at the data sheet's), and peak device
   memory;
M. the multi-device path (``gsplat_tpu_torch/parallel/``) on phase 3's 2M
   scene at 800x608, view 0. M1: a process group of one rank over NCCL
   (``initialize_distributed``, ``make_mesh()``), the exchange and the
   image gather through NCCL's collectives: ``render_sharded`` with labels
   bit-equal to ``render`` (image, transmittance, best weight, label map;
   B1 cuts a shard's long tiles by the whole frame's stream, as ``render``
   cuts them);
   one sharded ``make_train_step`` step at phase 4's capacity, its loss
   bit-equal to the single-device step's and every gradient within 1e-3 of
   its peak; B4, B1, B2 and the fold launched once each in the step.
   M2: D = 2, 4 and 8 logical shards on the card, each render bit-equal to
   ``render``; one sharded step at D = 4, held as M1's is (B4, B1, B2 and
   the fold under a lattice of 2x2 shards, once a shard); then ``parallel.scaling``'s report at D = 1, 2, 4, 8 (each
   shard's B4, B1 and B2 replayed from a CUDA graph, max and mean over the
   shards; ``inst_eff``, ``batch_eff``; rows and bytes each shard receives
   against the all-gather's). M3: at D = 4, the center and the visible vote
   over 16 views and the visibility masks equal their single-device
   results, and k-means' labels agree on >= 99.99% (sums over shards add in
   another order). The shards share the one card, so no time here is a
   D-card time;
G. the parity gate, ``gsplat_tpu_torch.utils.verify_parity``: the image,
   label map and scene gradients of ``scripts/verify_tpu.py``'s problem
   (4,000 gaussians, 160x128) through B4, B1, B2 and the fold on the
   card against the dense autograd reference on the CPU; fails past
   ``PARITY_TPU.json``'s bars (pixels 1e-3, gradients 1e-3 of each peak),
   a label map not equal or ``num_dropped`` not 0;
Q. the training-quality gate, ``gsplat_tpu_torch.utils.train_quality``, at
   its default widths (192x144, 28 views with 4 held out, 1,900 GT
   gaussians, 4,000 at init in 16,000 slots) cut to QUALITY_ITERS
   iterations with a densify every QUALITY_DENSIFY_EVERY: no step drops an
   instance, every densify grows the live set, the PLY reloads the alive
   set, the held-out PSNR beats the initial scene's by QUALITY_MARGIN_DB;
   the multiview step's time (median, min, max, p90);
X. the twins of examples/01-05 (``examples_torch/``), each in a subprocess
   on the card and one on the CPU, all started together: each exits 0 and
   writes its files, the card's printed numbers agree with the CPU's under
   EXAMPLE_BARS, 05's sharded error is at most 1e-5 and each child's
   launch counts (B5 in 02) join ``launches_by_path``.

The second-to-last line of stdout is the kernel table as JSON; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import http.client
import io
import json
import math
import os
import queue
import re
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.assets.ade20k import label_name
from gsplat_tpu_torch.cli import kmeans as kmeans_cli
from gsplat_tpu_torch.cli import label as label_cli
from gsplat_tpu_torch.cli import region_growing as rg_cli
from gsplat_tpu_torch.cli import render as render_cli
from gsplat_tpu_torch.cli import train as train_cli
from gsplat_tpu_torch.cluster import kmeans as km
from gsplat_tpu_torch.cluster import region_growing as rg
from gsplat_tpu_torch.config import DEFAULT, NO_SELECTION, UNLABELED
from gsplat_tpu_torch.interact.edit import EditState, apply_edits, hit_test
from gsplat_tpu_torch.interact.viewer import (PNG_LEVEL, ViewerServer,
                                              assemble_frame)
from gsplat_tpu_torch.io import native, png
from gsplat_tpu_torch.io import ply as ply_mod
from gsplat_tpu_torch.io.cameras import (look_at_camera, orbit_cameras,
                                         save_cameras)
from gsplat_tpu_torch.io.ply import (load_scene, read_ply, scene_from_ply,
                                     scene_to_ply)
from gsplat_tpu_torch.io.splat_format import importance, write_splat
from gsplat_tpu_torch.io.synthetic import random_scene, thin_splats_projection
from gsplat_tpu_torch.label import vote
from gsplat_tpu_torch.label.adapters import _nearest_resize
from gsplat_tpu_torch.models import densify, trainer
from gsplat_tpu_torch.parallel import bootstrap, scaling
from gsplat_tpu_torch.parallel import mesh as mesh_lib
from gsplat_tpu_torch.parallel.render_sharded import render_sharded
from gsplat_tpu_torch.render import blend, tiles
from gsplat_tpu_torch.render.api import (_fold_rows_plain, _render_impl,
                                         _segment_sums_plain,
                                         enumeration_rows,
                                         fold_instance_rows, fold_rows,
                                         pack_table, render, segment_sums)
from gsplat_tpu_torch.render.projection import (GRAD_FIELDS, CameraParams,
                                                Projected, _project_plain,
                                                _project_vjp_plain, project,
                                                project_bwd, tile_grid)
from gsplat_tpu_torch.scene import color_to_dc, dc_color, scene_from_numpy
from gsplat_tpu_torch.utils import (checkpoint, roofline, scan_probe,
                                    train_quality, verify_parity)
from gsplat_tpu_torch.utils import bench as bench_twin
from gsplat_tpu_torch.utils import bench_vote as vote_twin
from gsplat_tpu_torch.utils.profiling import graph_ms
from gsplat_tpu_torch.utils.roofline import B4_OPS_PER_SLOT, HBM_BYTES_PER_S

REPO = Path(__file__).resolve().parent
# phase P's roofline report, which phase B's bench reads as --roofline
ROOFLINE_REPORT = REPO / "build" / "chip_smoke" / "roofline_torch.json"
WIDTH, HEIGHT = 800, 608
# The instance counts of the bench frame as the JAX package's binning
# (gsplat_tpu.render.tiles) computes them on the CPU.
BENCH_COUNTS = dict(valid=80157, tiles=475, slots=198762, tight=191177,
                    tile_max=595, tile_median=444)
CFG = DEFAULT
RC = CFG.raster

# Phase 4, the training path. The schedule is the TRAIN_r05.json recipe's
# (make_adaptive_multiview_train_step, l2, lr_final = lr / 20, decay over
# the run) with lr scaled to this scene: the recipe's 0.007 was set for
# gaussians of scale 0.03-0.08, these are 0.002-0.008, and Adam's first
# update moves every visible mean by about lr, so 0.007 would throw the
# means 1-3 sigma off their targets. The rate is scaled with the gaussians'
# size, 10x smaller.
TRAIN_VIEWS = 4
TRAIN_STEPS = 10
TRAIN_LR = 0.0007
DENSIFY_AFTER = 5
# densify after step 5 writes at most 1% of the capacity, and its gradient
# threshold is set from the run's statistics so that no more gaussians are
# candidates than that: with more candidates than new slots, the densify
# step (as the JAX package's) still shrinks every split candidate, also
# those that get no child, and that shrinks most of the scene at once
DENSIFY_NEW_FRACTION = 0.01
SCENE_EXTENT = 1.5

# Phase L, the labeling path. 311 views is the reference capture's camera
# count (and bench_vote.py's default); 151 classes is ADE20K's head, the
# CLI's default. The seg maps are half the frame, so the vote scales pixel
# coordinates to the map as it does for a segmentation model's output.
LABEL_VIEWS = 311
LABEL_CLASSES = 151
LABEL_SLABS = 16
SEG_SIZE = (WIDTH // 2, HEIGHT // 2)
VISIBILITY_THRESHOLD = 0.05
# The visible vote's share of labeled gaussians whose label is their slab
# must exceed this (16 slabs give 1/16 by chance). Set below the CPU
# rehearsals at reduced size, ``--rehearse``: 0.605 at --reduce 100 over 64
# views, 0.638 at --reduce 16 over 32 views (PERF.md).
LABEL_AGREEMENT_BAR = 0.5

# Phase T, the training CLI. 16 orbit views rendered at 1600x1216 and
# trained at 800x608 (--scale 0.5, through the Pillow-exact resize); 120
# steps with densify at 40 and 80, an opacity reset at 60, checkpoints at 50
# and 100, then the same command again, which resumes at step 101. The init
# PLY is the 2M scene with its DC colours and opacity logits moved by seeded
# noise and, as phase 4 does, its means moved by 0.002 sigma. lr is phase
# 4's, scaled to these gaussians' size for the same reason: Adam's first
# update moves every visible mean by about lr. The reset at 60 sets every
# alive opacity to 0.01, and at this lr an opacity logit moves 3.5e-4 a
# step, so the loss after it stays above step 0's (on an H100: 0.076 at
# step 0, 0.480 at step 119); progress is read where nothing intervenes:
# each view's loss at its second visit (steps 16-31) against its first
# (steps 0-15).
TRAIN_CLI_VIEWS = 16
TRAIN_CLI_SIZE = (1600, 1216)
TRAIN_CLI_ITERS = 120
TRAIN_CLI_RESUME = 101
TRAIN_CLI_KERNELS = ("enum_keys", "blend_tiles_fwd", "blend_tiles_bwd",
                     "fold_rows", "project", "project_bwd")

# Phase K, clustering: k-means over the 2M scene at the reference's k = 10;
# region growing over its first 100k gaussians at the reference's
# normals_k = 2000 (its N^2 distances at 2M would stream ~16 TB and its
# [2M, 2000] neighbours take 16 GB; its BFS is sequential host Python).
# Card against the CPU at reduced sizes: k-means at 200k, region growing at
# 5k with normals_k = 200.
KMEANS_K = 10
RG_GAUSSIANS = 100_000
KMEANS_CPU_GAUSSIANS = 200_000
RG_CPU_GAUSSIANS, RG_CPU_NORMALS_K = 5_000, 200

# Phase M, the multi-device path: logical shards on the one card (the
# card's machine has one), the votes over 16 views at D = 4, k-means'
# agreement bar of phase K's card-vs-CPU check.
MESH_SHARDS = (2, 4, 8)
MESH_STEP_SHARDS = 4
MESH_VOTE_VIEWS = 16
MESH_VOTE_SHARDS = 4
MESH_KMEANS_AGREEMENT = 0.9999

# Phase Q, the training-quality gate at its default widths (192x144, 28
# views, 1,500 + 400 GT gaussians, 4,000 at init, 16,000 slots), cut in
# iterations only. Its fit must beat the initial scene's held-out PSNR by
# QUALITY_MARGIN_DB; the full run's 28 dB bar is PERF.md's.
QUALITY_ITERS = 400
QUALITY_DENSIFY_EVERY = 100
QUALITY_MARGIN_DB = 3.0

# Phase X, the twins of examples/01-05 (examples_torch/), each run on the
# card and on the CPU in a subprocess. A line holding a number is held to
# the bar of its pattern, (relative, absolute), on each number it matches
# and equal elsewhere; every other line is equal, except the "wrote ..."
# lines, which name each run's own directory. tests/test_torch_examples.py
# holds the CPU runs to the JAX examples' lines with the same bars: 01's
# coverage is a mean of 76,800 alphas, which PERF.md section 2's image bar
# holds within 1.5e-5; a loss or a fitted error within the train steps'
# 1e-4 relative, plus half the last printed digit; 03's perturbation, a
# float32 mean summed in another order, within 1e-6; 05's sharded error
# is at most 1e-5 in each run.
EXAMPLES = ("01_render_and_edit", "02_label_pipeline", "03_train_scene",
            "04_clustering", "05_multichip")
EXAMPLE_ERR = r"err: ([0-9.e+-]+)"
EXAMPLE_ERR_BAR = 1e-5
EXAMPLE_BARS = {
    "01_render_and_edit": {r"coverage ([0-9.]+)": (0.0, 1e-4)},
    "03_train_scene": {r"loss ([0-9.]+)": (1e-4, 5e-7),
                       r"before: ([0-9.e-]+)": (1e-6, 0.0),
                       r"after: ([0-9.e-]+)": (1e-4, 0.0)},
    "05_multichip": {EXAMPLE_ERR: (0.0, EXAMPLE_ERR_BAR),
                     r"loss ([0-9.]+)": (1e-4, 5e-7)},
}
EXAMPLE_TIMEOUT_S = 300


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card_datasheet_rates() -> roofline.Rates:
    """The data sheet's rates (67 TFLOP/s, an FMA two FLOPs: 33.5 T f32
    instructions/s; 16 exp results per clock per SM at the maximum SM
    clock), which the kernel bounds used before the P1 probes measured the
    card."""
    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return roofline.datasheet_rates(sms, mhz)


def cuda_ms(fn, reps: int = 10, warmup: int = 2):
    """Median and all times (ms) of ``fn`` between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def cuda_ms_once(fn):
    """(ms, result) of one call of ``fn`` between CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


class Frame:
    """Every intermediate of one render, so each stage can be run alone."""

    def __init__(self, scene, cam, proj=None, labels=None):
        self.scene, self.cam = scene, cam
        self.tx, self.ty = tile_grid(cam.width, cam.height, RC.tile_size)
        self.num_tiles = self.tx * self.ty
        self.db = 32 - tiles.depth_shift(self.num_tiles)
        if proj is None:
            self.camp = CameraParams.from_camera(cam, scene.device)
            proj, labels = self.project(), scene.labels
        self.proj = proj
        self.qd = tiles.depth_qkeys(self.proj.depth, self.proj.valid,
                                    self.num_tiles)
        self.bb = tiles.tile_bboxes(self.proj, tiles_x=self.tx,
                                    tiles_y=self.ty, tile_size=RC.tile_size)
        self.keys, self.gauss = self.enum_keys()
        self.binning = tiles.bin_tiles(self.proj, tiles_x=self.tx,
                                       tiles_y=self.ty,
                                       tile_size=RC.tile_size)
        self.ptab = pack_table(self.proj, labels)
        self.counts = (self.binning.tile_bounds[1:]
                       - self.binning.tile_bounds[:-1])
        self._work = {}
        self._bwd_args = {}

    @classmethod
    def from_projection(cls, proj, labels, width, height):
        """A frame of a given projection (no scene, so no ``project`` or
        ``render``; the camera gives the frame's size alone)."""
        return cls(None, look_at_camera((0, 0, -3.0), (0, 0, 0), width=width,
                                        height=height), proj, labels)

    def project(self):
        return project(self.scene, self.camp, self.cam.width,
                       self.cam.height, RC, z_near=CFG.camera.z_near,
                       z_far=CFG.camera.z_far)

    def _enum_kw(self):
        return dict(tiles_x=self.tx, num_tiles=self.num_tiles,
                    tile_size=RC.tile_size, db=self.db)

    def enum_keys(self):
        return tiles.enum_keys(self.proj, self.qd, self.bb, **self._enum_kw())

    def enum_keys_plain(self):
        return tiles._enum_keys_plain(self.proj, self.qd, self.bb,
                                      **self._enum_kw())

    def sort(self):
        return torch.sort(self.keys, stable=True)

    def _blend_kw(self, eps):
        return dict(tiles_x=self.tx, tiles_y=self.ty,
                    tile_size=RC.tile_size, width=self.cam.width,
                    height=self.cam.height, chunk=CFG.tiles.chunk,
                    alpha_min=RC.alpha_min, alpha_max=RC.alpha_max,
                    early_eps=eps, with_labels=True)

    def blend(self, eps=RC.early_stop_eps):
        return blend.blend_tiles_fwd(self.ptab, self.binning.inst_gauss,
                                     self.binning.tile_bounds,
                                     **self._blend_kw(eps))

    def blend_plain(self, eps=RC.early_stop_eps):
        return blend._blend_tiles_fwd_plain(self.ptab, self.binning.inst_gauss,
                                            self.binning.tile_bounds,
                                            **self._blend_kw(eps))

    def _vis_kw(self):
        kw = self._blend_kw(0.0)
        del kw["early_eps"]
        return kw

    def blend_vis(self):
        return blend.blend_tiles_vis(self.ptab, self.binning.inst_gauss,
                                     self.binning.tile_bounds,
                                     **self._vis_kw())

    def blend_vis_plain(self):
        return blend._blend_tiles_vis_plain(self.ptab,
                                            self.binning.inst_gauss,
                                            self.binning.tile_bounds,
                                            **self._vis_kw())

    def render(self):
        return render(self.scene, self.cam, CFG, with_labels=True,
                      device=self.scene.device)

    def instance_counts(self):
        c = self.counts.cpu().numpy()
        return dict(valid=int(self.proj.valid.sum()), tiles=self.num_tiles,
                    slots=self.bb.total,
                    tight=int(self.binning.num_instances),
                    tile_max=int(c.max()), tile_median=float(np.median(c)))

    def tile_lengths(self) -> dict:
        """Max, p99, median and mean instances a tile: the busiest tile's
        block sets B2's time, and its four sub-tile blocks B5's."""
        c = self.counts.double()
        return {"max": int(c.max()), "p99": float(torch.quantile(c, 0.99)),
                "median": float(c.median()), "mean": float(c.mean()),
                "tiles": self.num_tiles}

    def b4_bound(self, rates):
        n = self.proj.u.shape[0]
        nbytes = n * 12 * 4 + self.bb.total * 8
        ops = self.bb.total * B4_OPS_PER_SLOT
        return roofline.bound(nbytes, ops, 0, rates)

    def pairs(self, eps):
        """(evaluated, tested, live) instance-pixel pairs of B1 (and B2,
        which walks the same batches; B5 at eps 0) under early stop ``eps``
        (``roofline.blend_pairs``); computed once per eps."""
        if eps not in self._work:
            self._work[eps] = roofline.blend_pairs(
                self.ptab, self.binning, self.proj, tiles_x=self.tx,
                tiles_y=self.ty, tile_size=RC.tile_size,
                chunk=CFG.tiles.chunk, alpha_min=RC.alpha_min,
                alpha_max=RC.alpha_max, eps=eps)
        return self._work[eps]

    def blend_bound(self, kernel: str, rates):
        """``roofline.blend_bound`` of B1, B2 (early stop at the default)
        or B5 (none) on this frame's data."""
        eps = 0.0 if kernel == "B5" else RC.early_stop_eps
        return roofline.blend_bound(
            kernel, self.pairs(eps), self.proj.u.shape[0],
            self.binning.inst_gauss.numel(), self.num_tiles, self.cam.width,
            self.cam.height, rates)

    def bwd_args(self, eps=RC.early_stop_eps):
        """B2's inputs at early stop ``eps``: the stream, B1's (rgb, T)
        without labels, and a seeded random cotangent."""
        if eps not in self._bwd_args:
            kw = self._blend_kw(eps)
            kw["with_labels"] = False
            out = blend.blend_tiles_fwd(self.ptab, self.binning.inst_gauss,
                                        self.binning.tile_bounds, **kw)
            gen = torch.Generator(device=self.ptab.device).manual_seed(11)
            h, w = self.cam.height, self.cam.width
            self._bwd_args[eps] = (
                self.ptab, self.binning.inst_gauss, self.binning.tile_bounds,
                out.rgb, out.transmittance,
                torch.randn(h, w, 3, generator=gen, device=self.ptab.device),
                torch.randn(h, w, generator=gen, device=self.ptab.device))
        return self._bwd_args[eps]

    def _bwd_kw(self, eps):
        kw = self._blend_kw(eps)
        del kw["with_labels"]
        return kw

    def blend_bwd(self, eps=RC.early_stop_eps):
        return blend.blend_tiles_bwd(*self.bwd_args(eps), **self._bwd_kw(eps))

    def blend_bwd_plain(self, eps=RC.early_stop_eps):
        return blend._blend_tiles_bwd_plain(*self.bwd_args(eps),
                                            **self._bwd_kw(eps))

    def fold_rows(self):
        """The fold's input: B2's rows (default eps) in enumeration order."""
        return enumeration_rows(self.blend_bwd(), self.binning.je_sorted)

    def fold(self, drows):
        return fold_instance_rows(drows, self.binning.je_sorted,
                                  self.binning.enum_start,
                                  self.binning.enum_cnt)

    def b3_bound(self, rates):
        b = self.binning.inst_gauss.numel()
        return roofline.bound(2 * b * 16 * 4, b * 16, 0, rates)

    def fold_cs(self):
        """The boundary gathers' input: B3 over :meth:`fold_rows`."""
        return blend.cumsum_rows(self.fold_rows())

    def segment_sums(self, cs):
        return segment_sums(cs, self.binning.enum_start,
                            self.binning.enum_cnt)

    def segment_sums_plain(self, cs):
        return _segment_sums_plain(cs, self.binning.enum_start,
                                   self.binning.enum_cnt)


def fold_bound(cs, enum_start, enum_cnt, rates):
    """The boundary gathers' least work on this data: each gaussian's start
    and count (8 bytes) and output row (64 bytes); each distinct row of
    ``cs`` that a gaussian with slots needs (64 bytes, read once); 16
    subtractions a gaussian with slots."""
    start, cnt = enum_start.long(), enum_cnt.long()
    live = cnt > 0
    hi = torch.clamp(start + cnt - 1, 0, cs.shape[0] - 1)[live]
    lo = (start - 1)[live & (start > 0)]
    rows = int(torch.unique(torch.cat([hi, lo])).numel())
    n = start.numel()
    return roofline.bound(n * 72 + rows * 64, int(live.sum()) * 16, 0,
                          rates)


def check_b4(frame: Frame) -> float:
    keys, gauss = frame.enum_keys()
    pkeys, pgauss = frame.enum_keys_plain()
    torch.cuda.synchronize()
    if not (torch.equal(keys, pkeys) and torch.equal(gauss, pgauss)):
        bad = int((keys != pkeys).sum() + (gauss != pgauss).sum())
        raise AssertionError(f"B4 differs from its plain version in {bad} "
                             "entries")
    return 0.0


def check_b1(frame: Frame, tag: str) -> float:
    """Max abs error over rgb, T, best weight at eps 0 and the default."""
    worst = 0.0
    for eps in (0.0, RC.early_stop_eps):
        out = frame.blend(eps)
        ref = frame.blend_plain(eps)
        torch.cuda.synchronize()
        errs = {k: float((getattr(out, k) - getattr(ref, k)).abs().max())
                for k in ("rgb", "transmittance", "best_weight")}
        labels_equal = bool(torch.equal(out.label, ref.label))
        log({"check": "B1 blend_tiles_fwd vs plain", "frame": tag,
             "early_stop_eps": eps, "max_abs_err": errs,
             "label_mismatches": int((out.label != ref.label).sum())})
        if max(errs.values()) > 1e-5 or not labels_equal:
            raise AssertionError(f"B1 differs from its plain version at "
                                 f"eps={eps}: {errs}, labels equal "
                                 f"{labels_equal}")
        worst = max(worst, *errs.values())
    return worst


def check_b1_equals_b5(frame: Frame, tag: str) -> None:
    """B5 is B1's one-block walk with no early stop, the same operations in
    the same order: at early_stop_eps 0 the two agree bit for bit where B1
    split no tile. Where it split some (``blend.split_counts``), its merge
    associates the segments' products differently: within check_b1's bar
    (1e-5, labels equal)."""
    before = blend.split_counts(frame.ptab.device)
    out = frame.blend(0.0)
    after = blend.split_counts(frame.ptab.device)
    vis, _ = frame.blend_vis()
    torch.cuda.synchronize()
    split = {k: after[k] - before[k] for k in after}
    equal = {k: bool(torch.equal(getattr(out, k), getattr(vis, k)))
             for k in ("rgb", "transmittance", "best_weight", "label")}
    errs = {k: float((getattr(out, k) - getattr(vis, k)).abs().max())
            for k in ("rgb", "transmittance", "best_weight")}
    log({"check": "B1 at eps 0 equals B5", "frame": tag, "split": split,
         "equal": equal, "max_abs_err": errs})
    if split["tiles"] == 0 and not all(equal.values()):
        raise AssertionError(f"B1 at eps 0 differs from B5: {equal}")
    if max(errs.values()) > 1e-5 or not equal["label"]:
        raise AssertionError(f"B1 (split {split}) at eps 0 differs from B5: "
                             f"{errs}, labels equal {equal['label']}")


def check_b1_split(frame: Frame, tag: str, walked_again: bool) -> float:
    """B1 on a frame with tiles far longer than the rest, which it splits:
    check_b1 (the one-block walk's plain version at eps 0 and at the
    default, within 1e-5, labels equal) with the counter reporting tiles
    split and, with ``walked_again``, segments the merge walked again (the
    tile's stop inside a later segment); then B1 at the default equal bit
    for bit to the split walk's plain version
    (``blend._blend_tiles_fwd_split_plain``) with the launch's lengths."""
    dev = frame.ptab.device
    before = blend.split_counts(dev)
    err = check_b1(frame, tag)
    split = {k: v - before[k] for k, v in blend.split_counts(dev).items()}
    seg_len, split_above, _ = blend.split_launch(
        frame.binning.inst_gauss.shape[0], frame.num_tiles, CFG.tiles.chunk,
        dev, False)
    out = frame.blend()
    ref = blend._blend_tiles_fwd_split_plain(
        frame.ptab, frame.binning.inst_gauss, frame.binning.tile_bounds,
        seg_len=seg_len, split_above=split_above,
        **frame._blend_kw(RC.early_stop_eps))
    torch.cuda.synchronize()
    equal = {k: bool(torch.equal(getattr(out, k), getattr(ref, k)))
             for k in blend.BlendOutput._fields}
    log({"check": "B1 split vs plain", "frame": tag, "split": split,
         "seg_len": seg_len, "split_above": split_above,
         "equal_to_split_plain": equal})
    if split["tiles"] == 0 or (walked_again and split["walked_again"] == 0):
        raise AssertionError(f"B1 on {tag} split {split}")
    if not all(equal.values()):
        raise AssertionError(f"B1 on {tag} differs from the split walk's "
                             f"plain version: {equal}")
    return err


def crowded_ball(device) -> Frame:
    """A frame at the viewer cell's shapes (``benchmark/configs/m360.json``
    and ``traffic/overview.json``): the 2.4M gaussians of its ball (radius
    1, log-normal scales about 0.004 capped at 0.05) seen from radius 12 at
    1237x822, 60 degrees: ~35 tiles of the 1,014 hold the stream, the
    limb's never stop."""
    rng = np.random.default_rng(23)
    n = 2_400_000
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    means = d * rng.uniform(size=(n, 1)) ** (1.0 / 3.0)
    log_scales = np.minimum(np.log(0.004) + 0.5 * rng.normal(size=(n, 3)),
                            np.log(0.05))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    sh = color_to_dc(rng.uniform(0.0, 1.0, size=(n, 1, 3)))
    scene = scene_from_numpy(means, log_scales, quats,
                             rng.uniform(-2.0, 4.0, size=n), sh,
                             rng.integers(0, 16, size=n).astype(np.int32),
                             device=device)
    return Frame(scene, look_at_camera((0.0, -1.0, -12.0), (0, 0, 0),
                                       width=1237, height=822))


def check_b5(frame: Frame, tag: str) -> float:
    """B5 against its plain version: image, T and best weight within 1e-5,
    labels equal, the per-instance rows within 1e-5 and zero past the last
    tile. Returns the max abs error."""
    out, inst_w = frame.blend_vis()
    ref, ref_w = frame.blend_vis_plain()
    torch.cuda.synchronize()
    errs = {k: float((getattr(out, k) - getattr(ref, k)).abs().max())
            for k in ("rgb", "transmittance", "best_weight")}
    errs["instance_rows"] = float((inst_w - ref_w).abs().max())
    labels_equal = bool(torch.equal(out.label, ref.label))
    tight = int(frame.binning.num_instances)
    tail_zero = not bool(inst_w[tight:].any())
    log({"check": "B5 blend_tiles_vis vs plain", "frame": tag,
         "tile_lengths": frame.tile_lengths(), "max_abs_err": errs,
         "label_mismatches": int((out.label != ref.label).sum()),
         "rows": inst_w.numel(), "rows_past_last_tile": inst_w.numel() - tight,
         "rows_past_last_tile_zero": tail_zero,
         "rows_at_or_over_threshold": int(
             (inst_w >= VISIBILITY_THRESHOLD).sum())})
    if max(errs.values()) > 1e-5 or not labels_equal or not tail_zero:
        raise AssertionError(f"B5 differs from its plain version: {errs}, "
                             f"labels equal {labels_equal}, rows past the "
                             f"last tile zero {tail_zero}")
    return max(errs.values())


def wall_and_hidden_arrays():
    """(means, log_scales, quats, opacities, sh) of a near-opaque wall of 64
    splats at z=0 that hides one gaussian at z=1 from cameras at z=-2
    (tests/test_vote_visible.py's scene); gaussian 64 is the hidden one."""
    xs = np.linspace(-0.8, 0.8, 8)
    wx, wy = np.meshgrid(xs, xs)
    wall = np.stack([wx.ravel(), wy.ravel(), np.zeros(64)], -1)
    means = np.concatenate([wall, [[0.0, 0.0, 1.0]]])
    quats = np.zeros((65, 4))
    quats[:, 0] = 1.0
    colors = np.concatenate([np.tile([[1.0, 0, 0]], (64, 1)), [[0, 1.0, 0]]])
    return (means, np.full((65, 3), np.log(0.18)), quats, np.full((65,), 9.0),
            color_to_dc(colors)[:, None, :])


def wall_and_hidden_scene():
    return scene_from_numpy(*wall_and_hidden_arrays(), device="cpu")


def check_small_labeling(device) -> None:
    """Both votes on the card against the CPU. Center labels and votes are
    exactly equal (the same f32 operations); the visibility weights agree
    within 1e-5, and visible labels are equal but for gaussians whose
    weight in some view lies within 1e-5 of the threshold (at most 1%),
    where the card's and the host's exp may differ."""
    wall_cams = [look_at_camera((x, 0, -2.0), (0, 0, 0), width=64, height=64)
                 for x in (0.0, 0.1)]
    rng = np.random.default_rng(0)
    cases = [
        ("wall and hidden, 2 views 64x64", wall_and_hidden_scene(),
         wall_cams, np.full((2, 64, 64), 3, np.int32), 5),
        ("random 2000, 6 views 128x96",
         random_scene(2000, seed=21, num_labels=6, device="cpu"),
         orbit_cameras(6, 3.0, width=128, img_height=96),
         rng.integers(-1, 6, size=(6, 48, 64)).astype(np.int32),
         LABEL_CLASSES)]
    cpu = torch.device("cpu")
    for name, scene, cams, seg, nc in cases:
        got = []
        for dev in (device, cpu):
            center, votes = vote.assign_labels(
                scene, cams, seg, num_classes=nc, return_votes=True,
                device=dev)
            visible = vote.assign_labels_visible(
                scene, cams, seg, num_classes=nc, device=dev)
            got.append((center.cpu(), votes.cpu(), visible.cpu()))
        weights = [torch.stack([render(scene, c, CFG, impl="pallas_vis",
                                       device=dev)["gaussian_weight"].cpu()
                                for c in cams]) for dev in (device, cpu)]
        band = ((weights[1] - VISIBILITY_THRESHOLD).abs() <= 1e-5).any(0)
        (cc, vc, sc), (ch, vh, sh) = got
        res = {"center_equal": bool(torch.equal(cc, ch)),
               "votes_equal": bool(torch.equal(vc, vh)),
               "weight_max_abs_err": float(
                   (weights[0] - weights[1]).abs().max()),
               "visible_equal_off_band": bool(torch.equal(sc[~band],
                                                          sh[~band])),
               "threshold_band": int(band.sum()),
               "visible_labeled": float((sh >= 0).float().mean())}
        if name.startswith("wall"):
            res["hidden"] = {"center": int(cc[64]), "visible": int(sc[64])}
            res["hidden_ok"] = int(cc[64]) == 3 and int(sc[64]) == UNLABELED
        log({"check": "label votes card vs CPU", "scene": name, **res})
        if not (res["center_equal"] and res["votes_equal"]
                and res["weight_max_abs_err"] <= 1e-5
                and res["visible_equal_off_band"]
                and res["threshold_band"] <= 0.01 * scene.num_gaussians
                and res.get("hidden_ok", True)):
            raise AssertionError(f"card votes differ from CPU on {name}: "
                                 f"{res}")


def check_small_render(device) -> None:
    """The whole slice on the card against the same slice on the CPU."""
    scene = random_scene(2000, seed=21, num_labels=6, device="cpu")
    cam = look_at_camera((0.2, -0.3, -3.0), (0, 0, 0), width=128, height=96)
    bg = (0.3, 0.6, 0.9)
    got = render(scene, cam, CFG, background=bg, with_labels=True,
                 device=device)
    want = render(scene, cam, CFG, background=bg, with_labels=True,
                  device="cpu")
    res = {}
    for key in ("image", "transmittance", "best_weight"):
        err = (got[key].cpu() - want[key]).abs()
        res[key] = (float(err.max()), float((err <= 1e-5).float().mean()))
        if res[key][0] > 5e-3 or res[key][1] < 0.999:
            raise AssertionError(f"card render differs from CPU: {key} "
                                 f"{res[key]}")
    lab = float((got["label_map"].cpu() == want["label_map"]).float().mean())
    log({"check": "render card vs CPU", "scene": "random 2000, 128x96",
         "max_abs_err_and_share_within_1e-5": res, "label_agreement": lab})
    if lab < 0.999:
        raise AssertionError(f"card label map agrees on {lab} only")


def check_b2(frame: Frame, tag: str) -> float:
    """B2 against its plain version at eps 0 and the default: each column
    within 1e-4 of its peak (the per-tile sums are associated differently),
    the same zero rows. Returns the max abs error."""
    worst = 0.0
    for eps in (0.0, RC.early_stop_eps):
        got = frame.blend_bwd(eps)
        ref = frame.blend_bwd_plain(eps)
        torch.cuda.synchronize()
        diff = (got[:, :9] - ref[:, :9]).abs().amax(0)
        rel = diff / ref[:, :9].abs().amax(0).clamp_min(1e-30)
        zeros_equal = bool(torch.equal((got == 0).all(1), (ref == 0).all(1)))
        log({"check": "B2 blend_tiles_bwd vs plain", "frame": tag,
             "early_stop_eps": eps, "tile_lengths": frame.tile_lengths(),
             "rows": got.shape[0],
             "zero_rows": int((ref == 0).all(1).sum()),
             "max_abs_err": float(diff.max()),
             "max_err_over_column_peak": rel.tolist(),
             "zero_rows_equal": zeros_equal})
        if float(rel.max()) > 1e-4 or not zeros_equal or got[:, 9:].any():
            raise AssertionError(f"B2 differs from its plain version at "
                                 f"eps={eps}: {rel.tolist()}, zero rows "
                                 f"equal {zeros_equal}")
        worst = max(worst, float(diff.max()))
    return worst


def check_b3(frame: Frame, tag: str, other: torch.Tensor) -> float:
    """B3 on the fold's real input against a float64 prefix sum: within
    1e-6 of each column's peak |prefix|, zeros in columns 9-15; two more
    calls equal to the first bit for bit, with a call on ``other`` (an
    input of another size, whose output must not move either) between
    them. Returns the max abs error."""
    x = frame.fold_rows()
    got = blend.cumsum_rows(x)
    other_first = blend.cumsum_rows(other)
    again = blend.cumsum_rows(x)
    other_again = blend.cumsum_rows(other)
    third = blend.cumsum_rows(x)
    lib = torch.cumsum(x, 0)
    want = torch.cumsum(x.double(), 0)
    torch.cuda.synchronize()
    peak = want[:, :9].abs().amax(0)
    err = (got[:, :9].double() - want[:, :9]).abs().amax(0)
    lib_err = (lib[:, :9].double() - want[:, :9]).abs().amax(0)
    rel = (err / peak).tolist()
    same = (torch.equal(got, again) and torch.equal(got, third)
            and torch.equal(other_first, other_again))
    log({"check": "B3 cumsum_rows vs float64", "frame": tag,
         "rows": x.shape[0], "max_abs_err": float(err.max()),
         "max_err_over_column_peak": rel,
         "torch_cumsum_f32_err_over_column_peak": (lib_err / peak).tolist(),
         "three_calls_bit_equal": same, "interleaved_rows": other.shape[0]})
    if max(rel) > 1e-6 or got[:, 9:].any():
        raise AssertionError(f"B3 differs from float64 by {rel}")
    if not same:
        raise AssertionError("B3 is not bit-equal from call to call")
    return float(err.max())


def check_segment_sums(cs, enum_start, enum_cnt, tag: str) -> float:
    """The fold's boundary-gather kernel against ``_segment_sums_plain``,
    bit for bit. Returns the max abs error (0)."""
    before = segment_sums.launches
    got = segment_sums(cs, enum_start, enum_cnt)
    want = _segment_sums_plain(cs, enum_start, enum_cnt)
    torch.cuda.synchronize()
    equal = torch.equal(got, want)
    log({"check": "segment_sums vs plain", "frame": tag,
         "rows": cs.shape[0], "gaussians": enum_start.numel(),
         "without_slots": int((enum_cnt == 0).sum()), "bit_equal": equal,
         "launches": segment_sums.launches - before})
    if not equal or segment_sums.launches != before + 1:
        raise AssertionError(f"segment_sums differs from its plain version "
                             f"at {tag}")
    return 0.0


def fold_rows_bytes(rows, enum_start) -> int:
    """Bytes the fold must move: every row read once, each gaussian's
    start and count read and its row written."""
    return rows.shape[0] * rows.shape[1] * 4 + enum_start.numel() * (
        8 + rows.shape[1] * 4)


def check_fold_rows(rows, enum_start, enum_cnt, tag: str, card) -> dict:
    """The fold kernel (``render.api.fold_rows``) against its plain
    version, bit for bit, one launch, equal from call to call, 0 on every
    gaussian whose rows are all 0; then its time between CUDA events and
    replayed from a CUDA graph, the plain version's, and the bound by
    bytes at the published HBM rate. Returns the row."""
    seg = (enum_start, enum_cnt)
    before = fold_rows.launches
    got = fold_rows(rows, *seg)
    launched = fold_rows.launches - before
    again = fold_rows(rows, *seg)
    want = _fold_rows_plain(rows, *seg)
    owner = torch.repeat_interleave(
        torch.arange(enum_cnt.numel(), device=rows.device),
        enum_cnt.long())
    nonzero = torch.zeros(enum_cnt.numel(), dtype=torch.long,
                          device=rows.device).index_add_(
        0, owner, rows[:owner.numel()].ne(0).any(1).long())
    zero = (enum_cnt > 0) & (nonzero == 0)
    bits = lambda t: t.view(torch.int32)
    equal = torch.equal(bits(got), bits(want))
    same = torch.equal(bits(got), bits(again))
    moved = int(got[zero].ne(0).any(1).sum())
    del got, again, want
    ms, runs = cuda_ms(lambda: fold_rows(rows, *seg))
    plain_ms, _ = cuda_ms(lambda: _fold_rows_plain(rows, *seg), reps=3,
                          warmup=1)
    nbytes = fold_rows_bytes(rows, enum_start)
    row = {"rows": rows.shape[0], "gaussians": enum_start.numel(),
           "all_zero_segments": int(zero.sum()), "ms": ms, "runs_ms": runs,
           "graph_ms": graph_ms(lambda: fold_rows(rows, *seg)),
           "plain_ms": plain_ms, "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    log({"check": "fold_rows vs plain", "frame": tag, "bit_equal": equal,
         "two_calls_bit_equal": same, "zero_segments_moved": moved,
         "launches": launched, **row, "card": card})
    if not (equal and same and moved == 0 and launched == 1):
        raise AssertionError(f"fold_rows differs from its plain version or "
                             f"moves zero segments at {tag}")
    return row


def fold_phase(bench, device, card) -> dict:
    """The fold kernel on the bench frame's B2 rows and on a full-size
    training view of the benchmark's ``m360-fit`` deployment (3M gaussians
    of SH degree 3, the first view of its rig at 1237x822), each in
    enumeration order. Returns the rows by frame."""
    from benchmark import scenes
    from benchmark.common import program_camera
    from gsplat_tpu_torch.scene import GaussianScene
    out = {"bench": check_fold_rows(
        bench.fold_rows(), bench.binning.enum_start, bench.binning.enum_cnt,
        "bench", card)}
    cfg = json.loads((REPO / "benchmark" / "configs" / "m360-fit.json")
                     .read_text())
    p = scenes.scene(cfg, 20, device)
    fr = Frame(GaussianScene(p["means"], p["log_scales"], p["quats"],
                             p["opacities"], p["sh"], p["labels"]),
               program_camera(scenes.ring(cfg)[0]))
    del p
    out["m360 training view"] = check_fold_rows(
        fr.fold_rows(), fr.binning.enum_start, fr.binning.enum_cnt,
        "m360 training view", card)
    del fr
    gc.collect()
    torch.cuda.empty_cache()
    return out


# (gaussians, width, height) of the benchmark's scenes (SH degree 3):
# Tanks and Temples truck, Mip-NeRF 360 bicycle
PROJECT_SIZES = ((1_700_000, 980, 545), (3_000_000, 1237, 822))


def project_bytes(scene) -> int:
    """Bytes the projection must move: each gaussian's input rows read once
    (means, log-scales, quaternion, opacity, SH) and its 14 f32 fields and
    valid byte written once."""
    read = sum(getattr(scene, f).element_size() * getattr(scene, f)[0].numel()
               for f in ("means", "log_scales", "quats", "opacities", "sh"))
    return scene.num_gaussians * (read + 4 * (len(Projected._fields) - 1)
                                  + 1)


def check_project(scene, cam, tag: str, card: str) -> dict:
    """The projection kernel against ``_project_plain`` on one view: every
    field equal bit for bit, one launch; then its time between CUDA events
    and replayed from a CUDA graph, the plain version's and the bound by
    bytes at the published HBM rate."""
    args = (scene, CameraParams.from_camera(cam, scene.device), cam.width,
            cam.height, RC)
    kw = dict(z_near=CFG.camera.z_near, z_far=CFG.camera.z_far)
    before = project.launches
    got = project(*args, **kw)
    want = _project_plain(*args, sh_degree=None, **kw)
    launched = project.launches - before
    differ = [f for f in Projected._fields
              if not torch.equal(getattr(got, f).view(torch.uint8),
                                 getattr(want, f).view(torch.uint8))]
    del got, want
    ms, runs = cuda_ms(lambda: project(*args, **kw))
    plain_ms, _ = cuda_ms(lambda: _project_plain(*args, sh_degree=None, **kw),
                          reps=5, warmup=1)
    nbytes = project_bytes(scene)
    row = {"gaussians": scene.num_gaussians,
           "sh_degree": math.isqrt(scene.sh.shape[1]) - 1,
           "size": [cam.width, cam.height], "ms": ms, "runs_ms": runs,
           "graph_ms": graph_ms(lambda: project(*args, **kw)),
           "plain_ms": plain_ms, "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    log({"check": "project vs plain", "frame": tag, "fields_differ": differ,
         "launches": launched, **row, "card": card})
    if differ or launched != 1:
        raise AssertionError(f"project differs from its plain version in "
                             f"{differ} on {tag} ({launched} launches)")
    return row


def project_bwd_bytes(scene, live: int) -> int:
    """Bytes the projection's backward must move: every gaussian's incoming
    gradients (one 64-byte row of the fold's [N, 16] output) read and its
    gradient rows written once, the ``live`` gaussians' (a gradient not all
    0) input rows read once."""
    row = sum(getattr(scene, f).element_size() * getattr(scene, f)[0].numel()
              for f in ("means", "log_scales", "quats", "opacities", "sh"))
    return scene.num_gaussians * (64 + row) + live * row


def check_project_bwd(scene, cam, tag: str, card: str) -> dict:
    """The projection's backward kernel against ``_project_vjp_plain`` on
    one view, its incoming gradients as a training step hands them over
    (strided columns of an [N, 16] table, seeded, zero where the gaussian
    is not ``valid``, depth's None): the five gradients equal bit for bit,
    one launch; then its time between CUDA events and replayed from a CUDA
    graph, the plain autograd backward's through ``_project_plain`` (the
    train step's path before the kernel), the plain VJP's, and the bound by
    bytes at the published HBM rate."""
    camp = CameraParams.from_camera(cam, scene.device)
    args = (scene, camp, cam.width, cam.height, RC)
    kw = dict(z_near=CFG.camera.z_near, z_far=CFG.camera.z_far)
    with torch.no_grad():
        valid = project(*args, **kw).valid
    gen = torch.Generator(device=scene.device).manual_seed(17)
    table = torch.randn(scene.num_gaussians, 16, generator=gen,
                        device=scene.device) * valid[:, None]
    cols = dict(u=0, v=1, ca=2, cb=3, cc=4, opacity=5, red=6, green=7,
                blue=8)
    grads = [table[:, cols[f]] if f in cols else None for f in GRAD_FIELDS]
    fields = trainer.SceneParams.from_scene(scene)
    call = lambda: project_bwd(fields, camp, grads, RC, **kw)
    before = project_bwd.launches
    got = call()
    launched = project_bwd.launches - before
    want = _project_vjp_plain(fields, camp, RC, grads, sh_degree=None, **kw)
    differ = [f for f, a, b in zip(trainer.SceneParams._fields, got, want)
              if not torch.equal(a.view(torch.int32), b.view(torch.int32))]
    again = call()
    repeat = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                 for a, b in zip(got, again))
    del got, want, again
    ms, runs = cuda_ms(call)
    plain_ms, _ = cuda_ms(lambda: _project_vjp_plain(
        fields, camp, RC, grads, sh_degree=None, **kw), reps=5, warmup=1)
    leaves = trainer.SceneParams(*(t.detach().requires_grad_(True)
                                   for t in fields))
    out = _project_plain(leaves, *args[1:], sh_degree=None, **kw)
    loss = sum((getattr(out, f) * g).sum()
               for f, g in zip(GRAD_FIELDS, grads) if g is not None)
    autograd_ms, _ = cuda_ms(lambda: torch.autograd.grad(
        loss, leaves, retain_graph=True), reps=5, warmup=1)
    del out, loss, leaves
    live = int((table[:, :9] != 0).any(1).sum())
    nbytes = project_bwd_bytes(scene, live)
    row = {"gaussians": scene.num_gaussians, "live": live,
           "sh_degree": math.isqrt(scene.sh.shape[1]) - 1,
           "size": [cam.width, cam.height], "ms": ms, "runs_ms": runs,
           "graph_ms": graph_ms(call), "plain_ms": plain_ms,
           "autograd_ms": autograd_ms, "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    log({"check": "project_bwd vs plain VJP", "frame": tag,
         "fields_differ": differ, "repeat_equal": repeat,
         "launches": launched, **row, "card": card})
    if differ or not repeat or launched != 1:
        raise AssertionError(f"project_bwd differs from its plain VJP in "
                             f"{differ} on {tag} (repeat equal {repeat}, "
                             f"{launched} launches)")
    return row


def check_gradients(device) -> None:
    """Scene gradients through render on the card against the CPU's:
    random 2000-gaussian scene, 128x96, l2 against a fixed target; each of
    the five tensors within 1e-3 of its peak."""
    scene = random_scene(2000, seed=21, num_labels=6, device="cpu")
    cam = look_at_camera((0.2, -0.3, -3.0), (0, 0, 0), width=128, height=96)
    target = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(96, 128, 3)).astype(np.float32))
    grads = {}
    for dev in (device, torch.device("cpu")):
        s = scene.to(dev)
        params = trainer.SceneParams.from_scene(s)
        for p in params:
            p.requires_grad_(True)
        out = render(params.to_scene(s.labels), cam, CFG, device=dev)
        loss = trainer.l2_loss(out["image"], target.to(dev))
        grads[dev.type] = [g.cpu() for g in torch.autograd.grad(loss, params)]
    errs = {}
    for f, g_card, g_cpu in zip(trainer.SceneParams._fields, grads["cuda"],
                                grads["cpu"]):
        errs[f] = float((g_card - g_cpu).abs().max() / g_cpu.abs().max())
        if not bool(torch.isfinite(g_card).all()):
            raise AssertionError(f"card gradient of {f} is not finite")
    log({"check": "scene gradients card vs CPU",
         "scene": "random 2000, 128x96, l2", "max_err_over_peak": errs})
    if max(errs.values()) > 1e-3:
        raise AssertionError(f"card gradients differ from CPU: {errs}")


WRAPPERS = (tiles.enum_keys, blend.blend_tiles_fwd, blend.blend_tiles_bwd,
            blend.cumsum_rows, segment_sums, fold_rows,
            blend.blend_tiles_vis, project, project_bwd,
            roofline.fma_chains,
            roofline.expf_chains, scan_probe.flat_scan_kernel,
            scan_probe.grouped_scan_kernel)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def train_main_path(scene, device):
    """Phase 4: the adaptive multiview train steps at real size."""
    cams = orbit_cameras(TRAIN_VIEWS, 3.0, width=WIDTH, img_height=HEIGHT)
    with torch.no_grad():
        targets = torch.stack([render(scene, c, CFG, device=device)["image"]
                               for c in cams])
    gen = torch.Generator(device=device).manual_seed(5)
    n = scene.num_gaussians
    p = trainer.SceneParams.from_scene(scene)
    sh = p.sh.clone()
    sh[:, 0] += 0.05 * torch.randn(n, 3, generator=gen, device=device)
    p = p._replace(
        means=p.means + 0.002 * torch.randn(n, 3, generator=gen,
                                            device=device),
        sh=sh, opacities=p.opacities - 0.5)
    capacity = -(-int(1.25 * n) // 128) * 128
    p, labels = densify.pad_to_capacity(p, scene.labels, capacity)
    sched = dict(lr=TRAIN_LR, lr_final=TRAIN_LR / 20,
                 decay_steps=TRAIN_STEPS)
    step = trainer.make_adaptive_multiview_train_step(
        (WIDTH, HEIGHT), CFG, loss="l2", **sched)
    state = trainer.init_state(p.to_scene(labels), **sched)
    stats = densify.DensifyStats.zeros(capacity, device=device)
    camsb = trainer.stack_cameras([CameraParams.from_camera(c, device)
                                   for c in cams])
    bg = torch.zeros(3, device=device)
    losses, dropped = [], 0
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        state, stats, loss, nd = step(state, stats, labels, camsb, targets,
                                      bg)
        losses.append(float(loss))
        dropped = max(dropped, int(nd))
        if i + 1 == DENSIFY_AFTER:
            alive0 = int(densify.num_alive(state.params))
            g_avg = stats.grad_accum / stats.count.clamp_min(1.0)
            max_new = int(DENSIFY_NEW_FRACTION * capacity)
            cfg = densify.DensifyConfig(
                grad_threshold=float(torch.topk(g_avg, max_new).values[-1]),
                max_new_fraction=DENSIFY_NEW_FRACTION)
            new, labels, stats, written = densify.densify_and_prune(
                state.params, labels, stats, gen, SCENE_EXTENT, cfg)
            state = trainer.TrainState(
                new, trainer.zero_adam_rows(state.opt_state, written),
                state.step)
            log({"phase": "densify", "after_step": i + 1,
                 "alive_before": alive0,
                 "alive_after": int(densify.num_alive(state.params)),
                 "rewritten_slots": int(written.sum()),
                 "grad_threshold": cfg.grad_threshold,
                 "hot": int((g_avg > cfg.grad_threshold).sum()),
                 "capacity": capacity})
    launches = read_launches()
    wall = time.perf_counter() - t0
    with torch.no_grad():
        final = sum(float(trainer.l2_loss(
            _render_impl(state.params.to_scene(labels),
                         CameraParams.from_camera(cam, device), bg,
                         width=WIDTH, height=HEIGHT, cfg=CFG,
                         with_labels=False)["image"], target))
                    for cam, target in zip(cams, targets)) / TRAIN_VIEWS
    finite = all(bool(torch.isfinite(t).all()) for t in state.params)
    log({"phase": "train main path", "gaussians": n, "capacity": capacity,
         "views": TRAIN_VIEWS, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
         "losses": losses, "loss_after_last_step": final,
         "num_dropped": dropped, "finite": finite, "launches": launches,
         "wall_s": wall, "ms_per_step": wall / TRAIN_STEPS * 1e3})
    want = TRAIN_STEPS * TRAIN_VIEWS
    for name in ("enum_keys", "blend_tiles_fwd", "blend_tiles_bwd",
                 "fold_rows", "project", "project_bwd"):
        count = launches[name]
        if count != want:
            raise AssertionError(f"{name} launched {count} times in "
                                 f"{TRAIN_STEPS} steps of {TRAIN_VIEWS} "
                                 "views")
    if not (finite and dropped == 0 and final < losses[0]):
        raise AssertionError(f"training went wrong: loss {losses[0]} -> "
                             f"{final}, finite {finite}, dropped {dropped}")
    return launches, state, labels, cams, targets


def time_train_step(state, labels, cam, target, device, card):
    """One single-view make_train_step step (l2) at the 2M frame, timed
    whole and split into forward, B2, fold, the rest of the backward (the
    projection's kernel, the loss's backward, the sums) and Adam;
    the fold split into its scatter and ``fold_rows`` (the kernel, also
    replayed from a CUDA graph, and its plain version); the kernel held
    against its plain version on this state, whose dead and off-screen
    gaussians have no enumeration slot."""
    camp = CameraParams.from_camera(cam, device)
    bg = torch.zeros(3, device=device)
    step = trainer.make_train_step((WIDTH, HEIGHT), CFG, lr=TRAIN_LR,
                                   loss="l2")
    torch.cuda.reset_peak_memory_stats()
    row = {}
    row["step"], runs = cuda_ms(
        lambda: step(state, labels, camp, target, bg), reps=5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    leaves = [t.detach().requires_grad_(True) for t in state.params]
    scene = trainer.SceneParams(*leaves).to_scene(labels)

    def forward():
        out = _render_impl(scene, camp, bg, width=WIDTH, height=HEIGHT,
                           cfg=CFG, with_labels=False)
        return trainer.l2_loss(out["image"], target)

    row["forward"], _ = cuda_ms(forward, reps=5, warmup=1)
    loss = forward()
    row["backward"], _ = cuda_ms(
        lambda: torch.autograd.grad(loss, leaves, retain_graph=True),
        reps=5, warmup=1)
    grads = trainer.SceneParams(*torch.autograd.grad(loss, leaves))
    fr = Frame(trainer.SceneParams(*(t.detach() for t in state.params))
               .to_scene(labels), cam)
    row["B2"], _ = cuda_ms(fr.blend_bwd, reps=5, warmup=1)
    drows = fr.blend_bwd()
    row["fold"], _ = cuda_ms(lambda: fr.fold(drows), reps=5, warmup=1)
    rows = enumeration_rows(drows, fr.binning.je_sorted)
    seg = (fr.binning.enum_start, fr.binning.enum_cnt)
    check_fold_rows(rows, *seg, "2M training state", card)
    for part, fn in (
            ("fold: scatter", lambda: enumeration_rows(
                drows, fr.binning.je_sorted)),
            ("fold: fold_rows", lambda: fold_rows(rows, *seg)),
            ("fold: fold_rows plain", lambda: _fold_rows_plain(rows, *seg))):
        row[part], _ = cuda_ms(fn, reps=5, warmup=1)
    row["fold: fold_rows graph"] = graph_ms(lambda: fold_rows(rows, *seg))
    opt = trainer.scaled_adam(TRAIN_LR)
    row["adam"], _ = cuda_ms(
        lambda: opt.update(grads, state.opt_state, state.params), reps=5,
        warmup=1)
    row["backward but B2 and fold"] = (row["backward"] - row["B2"]
                                      - row["fold"])
    log({"measure": "train step", "frame": "2M view 0 (training state)",
         "capacity": int(state.params.means.shape[0]), "ms": row,
         "step_runs_ms": runs, "max_memory_allocated_bytes": peak,
         "card": card})
    return row, peak


def slab_labels(means: torch.Tensor) -> torch.Tensor:
    """[N] i32: the index of each gaussian's slab among LABEL_SLABS equal
    slabs of the scene's x extent."""
    x = means[:, 0]
    lo, hi = x.min(), x.max()
    slab = ((x - lo) / (hi - lo) * LABEL_SLABS).to(torch.int64)
    return slab.clamp(max=LABEL_SLABS - 1).to(torch.int32)


def write_label_inputs(scene, cams, out_dir: Path, seg_size, device
                       ) -> np.ndarray:
    """The labeler's inputs in ``out_dir``: the scene as PLY without labels,
    ``cameras.json``, and per view ``{img_name}_seg.npy``: the port's own
    label map of the slab-labeled scene, nearest-resized to ``seg_size``
    (width, height). Returns the slab labels."""
    out_dir.mkdir(parents=True, exist_ok=True)
    scene_to_ply(str(out_dir / "scene.ply"), scene, with_label=False)
    save_cameras(str(out_dir / "cameras.json"), cams)
    slabs = slab_labels(scene.means)
    labeled = dataclasses.replace(scene, labels=slabs)
    seg_w, seg_h = seg_size
    for cam in cams:
        label_map = render(labeled, cam, CFG, with_labels=True,
                           device=device)["label_map"].cpu().numpy()
        np.save(out_dir / f"{cam.img_name}_seg.npy",
                _nearest_resize(label_map, seg_h, seg_w))
    return slabs.cpu().numpy()


def run_label_cli(in_dir: Path, mode: str, device) -> tuple:
    """``gsplat_tpu_torch.cli.label`` with the npy source over ``in_dir``'s
    inputs; returns the labels of the PLY it wrote and its wall seconds."""
    out = f"labeled_{mode}.ply"
    t0 = time.perf_counter()
    rc = label_cli.main([
        "--ply_file", str(in_dir / "scene.ply"),
        "--camera_file", str(in_dir / "cameras.json"),
        "--input_dir", str(in_dir), "--output_dir", str(in_dir),
        "--output_file", out, "--model", "npy",
        "--num_classes", str(LABEL_CLASSES), "--mode", mode,
        "--visibility_threshold", str(VISIBILITY_THRESHOLD),
        "--device", str(device)])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"label CLI ({mode}) returned {rc}")
    labels = read_ply(str(in_dir / out))["vertex"]["label"]
    return labels.astype(np.int32), wall


def agreement(labels: np.ndarray, slabs: np.ndarray) -> dict:
    """The share of gaussians labeled, and the share of those whose label
    is their slab."""
    lab = labels != UNLABELED
    agree = float((labels[lab] == slabs[lab]).mean()) if lab.any() else 0.0
    return {"labeled_share": float(lab.mean()), "agreement": agree}


def label_main_path(scene, device, card):
    """Phase L: the label CLI over 311 views of the 2M scene in both modes,
    then the visibility pass and the vote timed alone."""
    in_dir = REPO / "build" / "chip_smoke" / "label"
    cams = orbit_cameras(LABEL_VIEWS, 3.0, width=WIDTH, img_height=HEIGHT)
    try:
        t0 = time.perf_counter()
        slabs = write_label_inputs(scene, cams, in_dir, SEG_SIZE, device)
        log({"phase": "label inputs", "views": LABEL_VIEWS,
             "seg_size": SEG_SIZE, "seconds": time.perf_counter() - t0,
             "bytes": sum(f.stat().st_size for f in in_dir.iterdir())})
        runs = {}
        for mode in ("visible", "center"):
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            labels, wall = run_label_cli(in_dir, mode, device)
            runs[mode] = dict(
                agreement(labels, slabs), wall_s=wall,
                labels_in_range=bool(((labels >= UNLABELED)
                                      & (labels < LABEL_SLABS)).all()),
                launches=read_launches(),
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
            log({"phase": "label main path", "mode": mode,
                 "gaussians": scene.num_gaussians, "views": LABEL_VIEWS,
                 "classes": LABEL_CLASSES, **runs[mode], "card": card})

        # the visibility pass and the two votes alone (CUDA events; the
        # pass holds one host sync per view, so this is its wall time)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        vis = vote.visibility_masks(scene, cams,
                                    visibility_threshold=VISIBILITY_THRESHOLD,
                                    device=device)
        end.record()
        end.synchronize()
        times = {"visibility_pass_ms": start.elapsed_time(end)}
        seg = torch.as_tensor(np.stack([
            np.load(in_dir / f"{c.img_name}_seg.npy") for c in cams]),
            device=device)
        cams_t = vote._camera_tensors(cams, device)
        for name, mask in (("center_vote_ms", None), ("visible_vote_ms", vis)):
            times[name], _ = cuda_ms(
                lambda: vote._vote_histogram(scene.means, cams_t, seg,
                                             LABEL_CLASSES, vis=mask),
                reps=3, warmup=1)
        per_view = {k.replace("_ms", "_ms_per_view"): v / LABEL_VIEWS
                    for k, v in times.items()}
        log({"measure": "labeling", "views": LABEL_VIEWS,
             "gaussians": scene.num_gaussians, **times, **per_view,
             "visible_pairs": int(vis.sum()), "card": card})
    finally:
        shutil.rmtree(in_dir, ignore_errors=True)
    vis_run, center_run = runs["visible"], runs["center"]
    if not (vis_run["labels_in_range"] and center_run["labels_in_range"]):
        raise AssertionError("labels out of [-1, 16)")
    b5 = (vis_run["launches"]["blend_tiles_vis"],
          center_run["launches"]["blend_tiles_vis"])
    if b5 != (LABEL_VIEWS, 0):
        raise AssertionError(f"B5 launched {b5} times in the visible and "
                             f"center runs of {LABEL_VIEWS} views")
    if not (vis_run["agreement"] > center_run["agreement"]
            and vis_run["agreement"] > LABEL_AGREEMENT_BAR):
        raise AssertionError(
            f"visible vote agrees with the slabs on {vis_run['agreement']}, "
            f"center vote on {center_run['agreement']}, bar "
            f"{LABEL_AGREEMENT_BAR}")
    return vis_run["launches"], {**times, **per_view}


def p1_args(which: str):
    """(plain version's (a, b), wrapper) of one P1 probe."""
    if which == "fma":
        return (roofline.FMA_A, roofline.FMA_B), roofline.fma_chains
    return (roofline.EXP_SCALE, 0.0), roofline.expf_chains


def check_p1(device) -> dict:
    """Both chains against their plain versions on a small launch (one
    block of 256 threads an SM, 3 rounds, a uniform [0.5, 1.5) input):
    relative error within 1e-5. Returns each probe's max abs error."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x = torch.rand(roofline.PROBE_ELEMS, generator=torch.Generator(
        device=device).manual_seed(3), device=device) + 0.5
    errs = {}
    for which in ("fma", "expf"):
        ab, fn = p1_args(which)
        got = fn(x, blocks=sms, iters=3)
        want = roofline._chains_plain(x, which, sms, 3, *ab)
        torch.cuda.synchronize()
        rel = float((got / want - 1).abs().max())
        errs[which] = float((got - want).abs().max())
        log({"check": f"P1 {which} chain vs plain", "threads": got.numel(),
             "rounds": 3, "max_rel_err": rel, "max_abs_err": errs[which]})
        if not rel <= 1e-5:
            raise AssertionError(f"P1 {which} differs from its plain "
                                 f"version by {rel} (relative)")
    return errs


def p2_agrees(variant: str, got, want) -> bool:
    """A P2 kernel's output against its plain version's: flat bit for bit
    (both combine in scan_flat's order), grouped within 1e-6."""
    if variant == "flat":
        return torch.equal(got, want)
    return float((got - want).abs().max()) <= 1e-6


def check_p2(device) -> dict:
    """Both scan kernels against their plain versions (:func:`p2_agrees`)
    and float64 cumprod / cumsum (bars 1e-5 and 1e-3,
    scripts/profile_scan_variants.py:84) on [64, 1000], and the rounds
    against the plain rounds at 1 and 1024 passes. Returns each variant's
    max abs error against its plain version."""
    x = scan_probe.probe_input(device, 1000)
    errs = {}
    for variant in ("flat", "grouped"):
        res, agree = {}, True
        for op in ("prod", "sum"):
            got = scan_probe.scan(x, op, variant)
            want = scan_probe._scan_plain(x, op, variant)
            ref = (torch.cumprod if op == "prod" else torch.cumsum)(
                x.double(), 0)
            torch.cuda.synchronize()
            agree &= p2_agrees(variant, got, want)
            res[op] = (float((got - want).abs().max()),
                       float((got.double() - ref).abs().max()))
        for reps in (1, scan_probe.BENCH_REPS):
            got = scan_probe.scan_rounds(x, variant, reps)
            want = scan_probe._rounds_plain(x, variant)
            torch.cuda.synchronize()
            agree &= p2_agrees(variant, got, want)
            res[f"rounds x{reps}"] = (float((got - want).abs().max()), None)
        log({"check": f"P2 {variant} scan vs plain and float64",
             "shape": list(x.shape), "agrees_with_plain": agree,
             "max_abs_err_vs_plain_and_float64": res})
        if not (agree and res["prod"][1] < 1e-5 and res["sum"][1] < 1e-3):
            raise AssertionError(f"P2 {variant} scan is wrong: {res}")
        errs[variant] = max(v[0] for v in res.values())
    return errs


def rounds_library(x):
    """``torch.cumprod`` + ``torch.cumsum`` over the probe's four rounds."""
    acc = x
    for _ in range(scan_probe.ROUNDS):
        acc = torch.cumsum(torch.cumprod(acc, 0), 0) * 1e-6 + x
    return acc


def probe_phase(device, card) -> dict:
    """Phase P: the P1 path (``utils.roofline``'s report: the card's rates
    and the bench frame's SOL) and the P2 path (``utils.scan_probe``'s check
    and bench), each with the launch counts reset just before and read just
    after; each kernel against its plain version; the probes' times,
    plain and library times and bounds. Returns the measured peaks and the
    kernel rows."""
    out = ROOFLINE_REPORT
    reset_launches()
    t0 = time.perf_counter()
    rc = roofline.main(["--out", str(out)])
    p1_launches = read_launches()
    report = json.loads(out.read_text())
    peaks = report["peaks"]
    clocks = smi("clocks.sm,clocks.max.sm,power.draw")
    log({"phase": "P1 roofline report", "seconds": time.perf_counter() - t0,
         "launches": p1_launches, "clocks_sm_max_sm_power_after": clocks,
         "card": card})
    reset_launches()
    rc2 = scan_probe.main(["--bench"])
    p2_launches = read_launches()
    log({"phase": "P2 scan probe", "launches": p2_launches})
    paths = {"fma_chains": p1_launches, "expf_chains": p1_launches,
             "flat_scan_kernel": p2_launches,
             "grouped_scan_kernel": p2_launches}
    if rc or rc2 or any(paths[k][k] == 0 for k in paths):
        raise AssertionError(f"probe paths failed: roofline {rc}, scan "
                             f"probe {rc2}, launches {paths}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm").split()[0])
    # a folded chain would read faster than 128 f32 lanes an SM can run
    ceiling = roofline.F32_LANES_PER_SM * sms * mhz * 1e6
    if not 0 < peaks["fma_per_s"] <= 1.02 * ceiling:
        raise AssertionError(f"fma_per_s {peaks['fma_per_s']} outside (0, "
                             f"{ceiling}]")
    sheet = card_datasheet_rates()
    rates = roofline.measured_rates(peaks)
    log({"measure": "card rates", "measured": rates._asdict(),
         "datasheet": sheet._asdict(),
         "fma_per_s_over_128_lanes_at_max_clock": peaks["fma_per_s"]
         / ceiling, "sm_mhz_under_load": peaks["sm_mhz_under_load"],
         "power_w_under_load": peaks["power_w_under_load"],
         "f32_issue_per_s_under_load": peaks["f32_issue_per_s"],
         "clocks_sm_max_sm_power_after": clocks, "card": card})

    errs1 = check_p1(device)
    errs2 = check_p2(device)
    rows = []
    x = torch.ones(roofline.PROBE_ELEMS, device=device)
    blocks = peaks["blocks"]
    for which, replaces in (("fma", "scripts/roofline.py:42"),
                            ("expf", "scripts/roofline.py:57")):
        ab, fn = p1_args(which)
        iters = peaks[f"{which}_iters"]
        ms, runs = cuda_ms(lambda: fn(x, blocks=blocks, iters=iters))
        # the main path's launch (its blocks and rounds) against the plain
        # chains at the same arguments, timed once
        got = fn(x, blocks=blocks, iters=iters)
        plain_ms, want = cuda_ms_once(lambda: roofline._chains_plain(
            x, which, blocks, iters, *ab))
        rel = float((got / want - 1).abs().max())
        errs1[which] = max(errs1[which], float((got - want).abs().max()))
        log({"check": f"P1 {which} chain vs plain at the main path's launch",
             "threads": got.numel(), "rounds": iters, "max_rel_err": rel})
        if not rel <= 1e-5:
            raise AssertionError(f"P1 {which} differs from its plain version "
                                 f"by {rel} (relative) at {blocks} blocks, "
                                 f"{iters} rounds")
        del got, want
        threads = blocks * roofline.THREADS
        nbytes = x.numel() * 4 + threads * 4
        if which == "fma":
            work = (nbytes, threads * roofline.CHAINS * roofline.FMA_STEPS
                    * iters, 0)
        else:
            exps = threads * roofline.CHAINS * roofline.EXP_STEPS * iters
            work = (nbytes, roofline.EXP_STEP_OPS * exps, exps)
        # a probe's bound is the data sheet's: at the measured rates it
        # would be the probe's own time
        b = roofline.bound(*work, sheet)
        log({"measure": f"P1 {which} chain", "blocks": blocks,
             "rounds": iters, "ms": ms, "runs_ms": runs,
             "plain_ms": plain_ms, "bound_ms_datasheet": b[0],
             "bound_by": b[1], "card": card})
        rows.append({"name": fn.__name__, "route": "cuda",
                     "source": "gsplat_tpu_torch/csrc/peak_probe.cu",
                     "replaces": replaces,
                     "launches": p1_launches[fn.__name__],
                     "max_abs_err": errs1[which], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b[0],
                     "bound_by": b[1], "bound_ms_datasheet": b[0],
                     "bound_by_datasheet": b[1], "library_ms": None})

    # P2: the rounds over 1024 passes of one [64, 1024] input; the plain
    # and library versions take the same passes laid side by side, one
    # [64, 1024 x 1024] array
    xs = scan_probe.probe_input(device, scan_probe.BENCH_COLS)
    reps = scan_probe.BENCH_REPS
    wide = xs.repeat(1, reps)
    lib_ms, lib_runs = cuda_ms(lambda: rounds_library(wide), reps=5)
    elems = reps * xs.numel()
    nbytes = 2 * xs.numel() * 4
    # the least work: one combine an element a scan, two scans and the
    # update's FMA a round
    ops = elems * scan_probe.ROUNDS * 3
    for variant, replaces in (
            ("flat", "scripts/profile_scan_variants.py:87"),
            ("grouped", "scripts/profile_scan_variants.py:71")):
        fn = scan_probe.KERNELS[variant]
        ms, runs = cuda_ms(lambda: scan_probe.scan_rounds(xs, variant, reps))
        # the kernel alone, at the bench's passes and at a quarter of them:
        # passes the compiler hoisted or collapsed would not scale
        graph = {n: graph_ms(
            lambda n=n: scan_probe.scan_rounds(xs, variant, n))
            for n in (reps, reps // 4)}
        ratio = graph[reps] / graph[reps // 4]
        log({"measure": f"P2 {variant} rounds replayed from a CUDA graph",
             "graph_ms_by_passes": graph, "ratio": ratio, "card": card})
        if not ratio >= 2.5:
            raise AssertionError(f"P2 {variant}: {reps} passes take only "
                                 f"{ratio:.2f}x the time of {reps // 4}")
        # the main path's launch (the bench's input and passes) against the
        # plain rounds
        got = scan_probe.scan_rounds(xs, variant, reps)
        want = scan_probe._rounds_plain(xs, variant)
        err = float((got - want).abs().max())
        log({"check": f"P2 {variant} rounds vs plain at the main path's "
             "launch", "shape": list(xs.shape), "passes": reps,
             "max_abs_err": err})
        if not p2_agrees(variant, got, want):
            raise AssertionError(f"P2 {variant} rounds differ from their plain "
                                 f"version by {err} at {reps} passes")
        errs2[variant] = max(errs2[variant], err)
        plain_ms, _ = cuda_ms(
            lambda: scan_probe._rounds_plain(wide, variant), reps=3,
            warmup=1)
        b = roofline.bound(nbytes, ops, 0, rates)
        bs = roofline.bound(nbytes, ops, 0, sheet)
        log({"measure": f"P2 {variant} rounds", "passes": reps,
             "shape": list(xs.shape), "ms": ms, "runs_ms": runs,
             "graph_ms": graph[reps],
             "plain_ms": plain_ms, "library_ms": lib_ms,
             "library_runs_ms": lib_runs, "bound_ms": b[0],
             "bound_by": b[1], "bound_ms_datasheet": bs[0], "card": card})
        rows.append({"name": fn.__name__, "route": "cuda",
                     "source": "gsplat_tpu_torch/csrc/scan_probe.cu",
                     "replaces": replaces,
                     "launches": p2_launches[fn.__name__],
                     "max_abs_err": errs2[variant], "ms": ms,
                     "graph_ms": graph[reps], "plain_ms": plain_ms,
                     "bound_ms": b[0], "bound_by": b[1],
                     "bound_ms_datasheet": bs[0],
                     "bound_by_datasheet": bs[1], "library_ms": lib_ms})
    del wide
    return peaks, rows


# the largest vs_baseline phase B accepts: bench.py's SOL bound plus the
# timer's spread
BENCH_VS_MAX = 1.05


def twin_line(main, argv) -> tuple:
    """(exit code, the last stdout line as JSON or None) of a twin's
    ``main(argv)`` run in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)


def bench_phase(device, card, report: Path) -> tuple:
    """Phase B: the twins of ``bench.py`` (fwd+bwd, ``--forward-only``) and
    ``bench_vote.py`` (center, visible) at their defaults through their
    ``main``, the bench with phase P's ``report`` as ``--roofline``; each
    path's launches counted from 0. Fails on a value not finite or not
    positive, a ``vs_baseline`` outside (0, BENCH_VS_MAX], a SOL that is not
    ``report``'s, an exit code not 0, a dropped instance, a bench step image
    not equal to ``render``'s, or a kernel of a path not launched. Then B4
    and B5 against their plain versions, and B1 at eps 0 against B5, on the
    visible vote's view 0, whose tiles are the longest the path gives them,
    and B1 there against its plain versions (``check_b1_split``). Returns
    the bench's and the vote's launches and B4's, B5's and B1's errors
    there."""
    problem = bench_twin.make_problem(bench_twin.parse_args([]))
    want = render(problem.scene, problem.cam, problem.cfg,
                  device=device)["image"]
    for forward_only in (False, True):
        got = bench_twin.step(problem._replace(forward_only=forward_only))
        if not torch.equal(got["image"], want):
            raise AssertionError(f"B: the bench step's image (forward_only "
                                 f"{forward_only}) is not render()'s")
    log({"check": "B bench step image vs render", "equal": True,
         "frame": [problem.cam.width, problem.cam.height]})
    del want, got
    sol = json.loads(report.read_text())["sol_mpix_per_s"]
    reset_launches()
    for argv in ([], ["--forward-only"]):
        t0 = time.perf_counter()
        rc, rec = twin_line(bench_twin.main, ["--roofline", str(report)]
                            + argv)
        log({"phase": "B bench", "argv": argv, "rc": rc, "line": rec,
             "wall_s": time.perf_counter() - t0, "card": card})
        if rc != 0:
            raise AssertionError(f"B: the bench {argv} exited {rc}")
        vals = [rec["value"], *rec["value_spread"], rec["vs_baseline"]]
        if not (all(math.isfinite(v) and v > 0 for v in vals)
                and rec["vs_baseline"] <= BENCH_VS_MAX
                and rec["num_dropped"] == 0
                and abs(rec["sol_mpix_per_s"] / sol - 1) <= 1e-6):
            raise AssertionError(f"B: the bench {argv} is wrong: {rec}")
    bench_launches = read_launches()
    reset_launches()
    for mode in ("center", "visible"):
        t0 = time.perf_counter()
        rc, rec = twin_line(vote_twin.main, ["--mode", mode])
        log({"phase": "B bench_vote", "mode": mode, "rc": rc, "line": rec,
             "wall_s": time.perf_counter() - t0, "card": card})
        if rc != 0 or not (math.isfinite(rec["value"]) and rec["value"] > 0
                           and 0 < rec["labeled_fraction"] <= 1):
            raise AssertionError(f"B: the vote ({mode}) is wrong: {rec}")
    vote_launches = read_launches()
    log({"phase": "B done", "bench_launches": bench_launches,
         "bench_vote_launches": vote_launches})
    for launched, names in (
            (bench_launches, ("enum_keys", "blend_tiles_fwd",
                              "blend_tiles_bwd", "fold_rows")),
            (vote_launches, ("enum_keys", "blend_tiles_vis"))):
        if any(launched[k] == 0 for k in names):
            raise AssertionError(f"B launched {launched}")
    vp = vote_twin.make_problem(vote_twin.parse_args(["--mode", "visible"]))
    fr = Frame(vp.scene, vp.cameras[0])
    err_b4 = check_b4(fr)
    log({"check": "B4 enum_keys vs plain", "frame": "vote view 0",
         "keys_equal": True, "slots": fr.bb.total,
         "counts": fr.instance_counts()})
    err_b5 = check_b5(fr, "vote view 0")
    check_b1_equals_b5(fr, "vote view 0")
    err_b1 = check_b1_split(fr, "vote view 0", walked_again=False)
    return bench_launches, vote_launches, err_b4, err_b5, err_b1


RENDER_SESSION = (EditState().toggle_visibility(3)
                  .displace(1, (0.05, 0.0, 0.0))
                  .set_color(2, (0.1, 0.2, 0.9)))


def render_cli_phase(scene, ply_path: Path, device, card) -> dict:
    """Phase R: ``cli.render`` over the 8 orbit views at 800x608 of the 2M
    scene's PLY, with label maps and a session that hides label 3,
    displaces label 1 and recolours label 2; every PNG decodes to the
    render's uint8 image, label 3 is in no label map, B4 and B1 launch once
    a view. Then the scene through ``write_splat`` -> ``load_scene``, and
    the dense path on the card against the tiled render. Returns the
    CLI's launch counts."""
    work = REPO / "build" / "chip_smoke" / "render"
    out_dir = work / "frames"
    try:
        work.mkdir(parents=True, exist_ok=True)
        cams = orbit_cameras(8, 3.0, width=WIDTH, img_height=HEIGHT)
        save_cameras(str(work / "cameras.json"), cams)
        RENDER_SESSION.save(str(work / "session.json"))
        reset_launches()
        t0 = time.perf_counter()
        rc = render_cli.main([
            "--ply_file", str(ply_path), "--camera_file",
            str(work / "cameras.json"), "--out_dir", str(out_dir),
            "--label_maps", "--session", str(work / "session.json"),
            "--device", str(device)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        edited = apply_edits(scene, RENDER_SESSION)
        checked = []
        for cam in cams:
            want = render(edited, cam, CFG, with_labels=True, device=device)
            rgb = (np.clip(want["image"].cpu().numpy(), 0.0, 1.0)
                   * 255).astype(np.uint8)
            stem = out_dir / f"{cam.img_name}_{cam.id:04d}"
            png_ok = np.array_equal(
                png.decode_png(stem.with_suffix(".png")), rgb)
            vis = png.decode_png(f"{stem}_labels.png")
            lm = np.load(f"{stem}_labels.npy")
            checked.append({
                "view": cam.id, "png_equal": png_ok,
                "labels_png_left_equal": np.array_equal(vis[:, :WIDTH], rgb),
                "label_map_equal": np.array_equal(
                    lm, want["label_map"].cpu().numpy()),
                "label_3_pixels": int((lm == 3).sum()),
                "labelled": float((lm != UNLABELED).mean())})
        log({"phase": "render CLI main path", "gaussians":
             scene.num_gaussians, "views": len(cams), "wall_s": wall,
             "wall_s_per_view": wall / len(cams), "launches": launches,
             "views_checked": checked, "card": card})
        bad = [c for c in checked
               if not (c["png_equal"] and c["labels_png_left_equal"]
                       and c["label_map_equal"] and c["label_3_pixels"] == 0)]
        if rc != 0 or bad:
            raise AssertionError(f"render CLI returned {rc}; wrong views "
                                 f"{bad}")
        for name in ("enum_keys", "blend_tiles_fwd"):
            if launches[name] != len(cams):
                raise AssertionError(f"{name} launched {launches[name]} "
                                     f"times for {len(cams)} views")

        # .splat: the 2M scene written and read back by magic bytes
        t0 = time.perf_counter()
        splat = work / "scene_2m.splat"
        write_splat(str(splat), scene, labels_path=str(work / "labels"))
        t_write = time.perf_counter() - t0
        back = load_scene(str(splat), device=device)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0 - t_write
        s = scene.to_numpy()
        order = np.argsort(-importance(scene), kind="stable")
        b = back.to_numpy()
        res = {"rows": back.num_gaussians, "bytes": splat.stat().st_size,
               "write_s": t_write, "load_s": t_load,
               "means_equal": bool(np.array_equal(b["means"],
                                                  s["means"][order])),
               "labels_equal": bool(np.array_equal(
                   np.fromfile(work / "labels", "<i4"),
                   s["labels"][order])),
               "log_scale_max_err": float(np.abs(
                   b["log_scales"] - s["log_scales"][order]).max()),
               "color_max_err": float(np.abs(
                   dc_color(b["sh"][:, 0]) - np.clip(dc_color(
                       s["sh"][order, 0]), 0, 1)).max())}
        log({"check": "2M scene through write_splat -> load_scene", **res})
        if not (res["rows"] == scene.num_gaussians and res["means_equal"]
                and res["labels_equal"] and res["log_scale_max_err"] <= 1e-5
                and res["color_max_err"] <= 1 / 255 + 1e-6):
            raise AssertionError(f".splat round trip is wrong: {res}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check_dense(device)
    return launches


def check_dense(device) -> None:
    """``render(impl="dense")`` on the card against the tiled render on the
    card, 3,000 gaussians at 160x120, to tests/test_render_xla.py's oracle
    bar (median < 1e-5, max < 5e-3, alpha within 5e-3, labels within
    1%)."""
    scene = random_scene(3000, seed=21, num_labels=6, device=device)
    cam = look_at_camera((0.2, -0.3, -3.0), (0, 0, 0), width=160, height=120)
    dense = render(scene, cam, CFG, with_labels=True, impl="dense",
                   device=device)
    tiled = render(scene, cam, CFG, with_labels=True, device=device)
    err = (dense["image"] - tiled["image"]).abs()
    res = {"median": float(err.median()), "max": float(err.max()),
           "alpha_max": float((dense["alpha"] - tiled["alpha"]).abs().max()),
           "label_mismatch": float((dense["label_map"]
                                    != tiled["label_map"]).float().mean())}
    log({"check": "dense render vs tiled, on the card",
         "scene": "random 3000, 160x120", **res})
    if not (res["median"] < 1e-5 and res["max"] < 5e-3
            and res["alpha_max"] <= 5e-3 and res["label_mismatch"] < 0.01):
        raise AssertionError(f"dense render differs from tiled: {res}")


class CallTimes:
    """Wall seconds of each call of named module functions while active,
    with the card synchronised before and after each call, so the CLI
    phases split their time without the CLIs knowing."""

    def __init__(self, targets):
        self.targets = targets          # {label: (module, attribute name)}
        self.seconds = {label: [] for label in targets}
        self._saved = []

    def _wrap(self, label, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[label].append(time.perf_counter() - t0)
            return out
        return timed

    def __enter__(self):
        for label, (mod, name) in self.targets.items():
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(label, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()


def run_cli(main, args) -> tuple:
    """(return code, stdout lines, wall seconds) of a CLI run in process;
    the lines are echoed."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  | {line}")
    return rc, lines, wall


def logged_losses(lines) -> dict:
    """{step: loss} of the train CLI's log lines."""
    out = {}
    for line in lines:
        m = re.fullmatch(r"step (\d+): loss ([0-9.eE+-]+)", line)
        if m:
            out[int(m.group(1))] = float(m.group(2))
    return out


def write_train_inputs(scene, work: Path, device) -> None:
    """Phase T's inputs in ``work``: ``cameras.json`` of 16 orbit views at
    1600x1216, each view rendered by the port and written as PNG, and
    ``init.ply``, the scene moved by seeded noise."""
    cams = orbit_cameras(TRAIN_CLI_VIEWS, 3.0, width=TRAIN_CLI_SIZE[0],
                         img_height=TRAIN_CLI_SIZE[1])
    save_cameras(str(work / "cameras.json"), cams)
    (work / "targets").mkdir()
    for cam in cams:
        with torch.no_grad():
            img = render(scene, cam, CFG, device=device)["image"]
        rgb = (np.clip(img.cpu().numpy(), 0.0, 1.0) * 255).astype(np.uint8)
        (work / "targets" / f"{cam.img_name}.png").write_bytes(
            png.encode_png(rgb, level=1))
    s = {k: a.copy() for k, a in scene.to_numpy().items()}
    rng = np.random.default_rng(1)
    n = s["means"].shape[0]
    s["means"] = s["means"] + 0.002 * rng.standard_normal((n, 3))
    s["sh"][:, 0] += 0.05 * rng.standard_normal((n, 3))
    s["opacities"] = s["opacities"] - 0.5 + 0.25 * rng.standard_normal(n)
    scene_to_ply(str(work / "init.ply"), scene_from_numpy(**s, device="cpu"))


def densify_candidates(params, stats, extent) -> dict:
    """Split and clone candidates of a densify step at the default
    threshold against its free slots: with more candidates than slots the
    reference's fault (ROADMAP C) shrinks every split candidate."""
    cfg = densify.DensifyConfig()
    alive = params.opacities > densify.DEAD_LOGIT + 1.0
    keep = alive & (torch.sigmoid(params.opacities) >= cfg.prune_opacity) & (
        torch.exp(params.log_scales).amax(-1) <= cfg.prune_scale * extent)
    g_avg = stats.grad_accum / stats.count.clamp_min(1.0)
    hot = keep & (g_avg > cfg.grad_threshold)
    big = torch.exp(params.log_scales).amax(-1) > cfg.percent_dense * extent
    return {"candidates": int(hot.sum()), "split_candidates": int(
        (hot & big).sum()), "free_slots": int((~keep).sum())}


def train_cli_phase(scene, device, card) -> dict:
    """Phase T: ``gsplat_tpu_torch.cli.train`` twice on the same checkpoint
    directory (the second run resumes at step 101); B4, B1, B2 and the fold
    launched once per step of run 1, the loss falling (the views'
    second visits against their first), the resumed run's last logged loss
    within 1e-3 relative of run 1's, both PLYs with the same alive count
    within 0.1%. Returns run 1's launch counts."""
    work = REPO / "build" / "chip_smoke" / "train_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        write_train_inputs(scene, work, device)
        log({"phase": "train CLI inputs", "views": TRAIN_CLI_VIEWS,
             "size": TRAIN_CLI_SIZE, "seconds": time.perf_counter() - t0,
             "target_bytes": sum(f.stat().st_size for f in
                                 (work / "targets").iterdir()),
             "init_ply_bytes": (work / "init.ply").stat().st_size})
        base = ["--camera_file", str(work / "cameras.json"), "--image_dir",
                str(work / "targets"), "--init_ply", str(work / "init.ply"),
                "--scale", "0.5", "--iters", str(TRAIN_CLI_ITERS),
                "--loss", "dssim_l1", "--lr", str(TRAIN_LR),
                "--lr_final", str(TRAIN_LR / 20), "--densify_every", "40",
                "--densify_until", "100", "--capacity_factor", "1.25",
                "--opacity_reset_every", "60", "--checkpoint_dir",
                str(work / "ck"), "--checkpoint_every", "50",
                "--log_every", "20"]
        runs = []
        for out in ("fit.ply", "fit2.ply"):
            steps_ms, step_losses, candidates = [], [], []

            def make_step(*args, _make=trainer.make_adaptive_train_step,
                          **kwargs):
                step = _make(*args, **kwargs)

                def timed(*a):
                    ms, res = cuda_ms_once(lambda: step(*a))
                    steps_ms.append(ms)
                    step_losses.append(float(res[2]))
                    return res
                return timed

            def densify_and_prune(params, labels, stats, *args,
                                  _densify=densify.densify_and_prune):
                candidates.append(densify_candidates(params, stats,
                                                     args[1]))
                return _densify(params, labels, stats, *args)

            timers = CallTimes({
                "decode": (png, "decode_png"), "resize": (png, "resize_rgb"),
                "init PLY read": (ply_mod, "scene_from_ply"),
                "densify": (densify, "densify_and_prune"),
                "checkpoint save": (checkpoint, "save_pytree"),
                "checkpoint load": (checkpoint, "restore_pytree"),
                "PLY write": (ply_mod, "scene_to_ply")})
            orig = (trainer.make_adaptive_train_step,
                    densify.densify_and_prune)
            trainer.make_adaptive_train_step = make_step
            densify.densify_and_prune = densify_and_prune
            reset_launches()
            try:
                with timers:
                    rc, lines, wall = run_cli(
                        train_cli.main, base + ["--out", str(work / out)])
            finally:
                (trainer.make_adaptive_train_step,
                 densify.densify_and_prune) = orig
            launches = read_launches()
            sec = {k: sum(v) for k, v in timers.seconds.items()}
            losses = logged_losses(lines)
            run = {"out": out, "rc": rc, "wall_s": wall,
                   "steps": len(steps_ms), "losses": losses,
                   "step_losses": step_losses,
                   "ms_per_step_median": statistics.median(steps_ms),
                   "ms_per_step_min_max": [min(steps_ms), max(steps_ms)],
                   "steps_s": sum(steps_ms) / 1e3,
                   "target_load_s": sec["decode"] + sec["resize"],
                   "seconds": sec, "calls": {
                       k: len(v) for k, v in timers.seconds.items()},
                   "densify_alive": [l for l in lines if "densify" in l],
                   "densify_candidates": candidates,
                   "resumed": [l for l in lines if l.startswith("resumed")],
                   "launches": launches,
                   "checkpoint_bytes": (work / "ck" / "state").stat().st_size,
                   "card": card}
            run["host_s_other"] = wall - sum(sec.values()) - run["steps_s"]
            log({"phase": "train CLI", **run})
            runs.append(run)
            if rc != 0:
                raise AssertionError(f"train CLI returned {rc}")
        r1, r2 = runs
        fits = [scene_from_ply(str(work / r["out"]), device=device)
                for r in runs]
        n_alive = [f.num_gaussians for f in fits]
        last = TRAIN_CLI_ITERS - 1
        first = r1["step_losses"]
        v = TRAIN_CLI_VIEWS
        resumed = r2["step_losses"]
        res = {
            "launches_per_step": {k: r1["launches"][k] / TRAIN_CLI_ITERS
                                  for k in TRAIN_CLI_KERNELS},
            "second_visit_over_first": sum(first[v:2 * v])
            / sum(first[:v]),
            "views_falling": sum(b < a for a, b in zip(first[:v],
                                                       first[v:2 * v])),
            "loss_step0": r1["losses"][0], "loss_last": r1["losses"][last],
            "resumed_steps_max_rel_diff": max(
                abs(a - b) / b for a, b in
                zip(resumed, first[TRAIN_CLI_RESUME:])),
            "resumed_line": r2["resumed"],
            "loss_last_resumed": r2["losses"][last],
            "resumed_rel_diff": abs(r2["losses"][last] - r1["losses"][last])
            / r1["losses"][last],
            "alive": n_alive,
            "ply_bytes_equal": (work / "fit.ply").read_bytes()
            == (work / "fit2.ply").read_bytes()}
        log({"check": "train CLI", **res})
        if any(r1["launches"][k] != TRAIN_CLI_ITERS
               for k in TRAIN_CLI_KERNELS):
            raise AssertionError(f"train CLI launches {r1['launches']} in "
                                 f"{TRAIN_CLI_ITERS} steps")
        if not res["second_visit_over_first"] < 1:
            raise AssertionError(f"train CLI loss did not fall: {res}")
        if r2["resumed"] != [f"resumed at step {TRAIN_CLI_RESUME}"]:
            raise AssertionError(f"run 2 did not resume at "
                                 f"{TRAIN_CLI_RESUME}: {r2['resumed']}")
        if not res["resumed_rel_diff"] <= 1e-3:
            raise AssertionError(f"resumed run's last loss differs: {res}")
        if not abs(n_alive[0] - n_alive[1]) <= 1e-3 * n_alive[0]:
            raise AssertionError(f"alive counts differ: {n_alive}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return r1["launches"]


def neighbour_sets_agree(got, want, pts) -> dict:
    """kNN rows of the card against the CPU's: rows whose neighbour sets
    differ must hold the same distances, in float64, within 1e-6 relative
    of the k-th (a tie at the boundary)."""
    diff = (torch.sort(got.long(), 1).values
            != torch.sort(want.long(), 1).values).any(1)
    p = pts.double()
    bad = 0
    for i in torch.nonzero(diff).flatten().tolist():
        d = lambda idx: ((p[idx] - p[i]) ** 2).sum(1).sort().values
        a, b = d(got[i].long()), d(want[i].long())
        bad += int(not torch.allclose(a, b, rtol=1e-6, atol=0))
    return {"rows": got.shape[0], "rows_with_other_sets": int(diff.sum()),
            "rows_not_at_a_tie": bad}


def same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    """Whether two labelings split the points into the same regions. Equal
    regions may be numbered apart: regions of one size are numbered in the
    order of their seeds' residuals, which near-ties (1e-8 here, the
    card's eigenvectors against the host's) can swap."""
    pairs = len(set(zip(a.tolist(), b.tolist())))
    return pairs == len(set(a.tolist())) == len(set(b.tolist()))


def cluster_phase(scene, ply_path: Path, device, card) -> dict:
    """Phase K: ``cli.kmeans`` over the 2M scene's PLY at k = 10 and
    ``cli.region_growing`` over its first 100k gaussians at the reference's
    defaults; both PLYs label every gaussian; k-means' distance and update
    timed per iteration; the card against the CPU at reduced sizes."""
    work = REPO / "build" / "chip_smoke" / "cluster"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {}
    try:
        reset_launches()
        rc, lines, wall = run_cli(kmeans_cli.main, [
            "--file_path", str(ply_path), "--save_path",
            str(work / "kmeans.ply"), "--k", str(KMEANS_K), "--binary"])
        labels = read_ply(str(work / "kmeans.ply"))["vertex"]["label"]
        sizes = np.bincount(labels, minlength=KMEANS_K).tolist()
        feats = km.scene_features(scene)
        res = km.kmeans(feats, KMEANS_K)
        d_ms, _ = cuda_ms(lambda: km.assign(feats, res.centroids))
        u_ms, _ = cuda_ms(lambda: km.update(feats, res.labels,
                                            res.centroids))
        out["kmeans"] = {
            "gaussians": scene.num_gaussians, "k": KMEANS_K, "rc": rc,
            "wall_s": wall, "iterations": res.iterations,
            "shift": res.shift, "cluster_sizes": sizes,
            "labels_equal_to_in_process_run": bool(np.array_equal(
                labels, res.labels.cpu().numpy())),
            "distance_ms_per_iteration": d_ms,
            "update_ms_per_iteration": u_ms, "card": card}
        log({"phase": "k-means CLI", **out["kmeans"]})
        if not (rc == 0 and len(labels) == scene.num_gaussians
                and labels.min() >= 0 and labels.max() < KMEANS_K
                and out["kmeans"]["labels_equal_to_in_process_run"]):
            raise AssertionError(f"k-means CLI is wrong: {out['kmeans']}")

        sub = dataclasses.replace(scene, **{
            f: getattr(scene, f)[:RG_GAUSSIANS] for f in
            ("means", "log_scales", "quats", "opacities", "sh", "labels")})
        scene_to_ply(str(work / "sub.ply"), sub)
        timers = CallTimes({"knn_indices": (rg, "knn_indices"),
                            "pca_normals": (rg, "pca_normals"),
                            "grow_regions (host BFS)": (rg, "grow_regions")})
        with timers:
            rc, lines, wall = run_cli(rg_cli.main, [
                "--file_path", str(work / "sub.ply"), "--save_path",
                str(work / "regions.ply"), "--binary"])
        labels = read_ply(str(work / "regions.ply"))["vertex"]["label"]
        out["region_growing"] = {
            "gaussians": sub.num_gaussians, "rc": rc, "wall_s": wall,
            "seconds": {k: sum(v) for k, v in timers.seconds.items()},
            "regions": int(labels.max()) + 1,
            "largest": int(np.bincount(labels).max()), "card": card}
        log({"phase": "region growing CLI", **out["region_growing"]})
        if not (rc == 0 and len(labels) == sub.num_gaussians
                and labels.min() >= 0):
            raise AssertionError(f"region growing CLI is wrong: "
                                 f"{out['region_growing']}")
        out["launches"] = read_launches()

        # the card against the CPU at reduced sizes
        feats = feats[:KMEANS_CPU_GAUSSIANS]
        card_run = km.kmeans(feats, KMEANS_K)
        cpu_run = km.kmeans(feats.cpu(), KMEANS_K)
        agree = float((card_run.labels.cpu() == cpu_run.labels)
                      .float().mean())
        pts = scene.means[:RG_CPU_GAUSSIANS]
        geo = [rg.compute_geometry(p, normals_k=RG_CPU_NORMALS_K)
               for p in (pts, pts.cpu())]
        regions = [rg.grow_regions(g) for g in geo]
        nb = neighbour_sets_agree(
            rg.knn_indices(pts, RG_CPU_NORMALS_K).cpu(),
            rg.knn_indices(pts.cpu(), RG_CPU_NORMALS_K), pts.cpu())
        out["card_vs_cpu"] = {
            "kmeans_gaussians": KMEANS_CPU_GAUSSIANS,
            "kmeans_label_agreement": agree,
            "kmeans_iterations": [card_run.iterations, cpu_run.iterations],
            "rg_gaussians": RG_CPU_GAUSSIANS,
            "rg_normals_k": RG_CPU_NORMALS_K, "knn": nb,
            "normals_max_abs_err": float(
                (geo[0].normals.cpu() - geo[1].normals).abs().max()),
            "regions_equal": same_partition(*regions),
            "labels_equal": bool(np.array_equal(*regions)),
            "regions": int(regions[1].max()) + 1}
        log({"check": "clustering card vs CPU", **out["card_vs_cpu"]})
        if not (agree >= 0.9999 and nb["rows_not_at_a_tie"] == 0
                and out["card_vs_cpu"]["regions_equal"]):
            raise AssertionError(f"clustering on the card differs from the "
                                 f"CPU: {out['card_vs_cpu']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# Phase V, the live viewer. The scripted session is a user's: the page,
# its camera list and a preset's pose, a drag of 60 frames (theta 0.01 a
# frame, as the page turns a pixel of mouse motion), 10 frames with the
# label overlay, the 8 presets, a click that selects a label, one edit of
# each kind and the resets, and three drag-drop loads. V3 compares the card
# with the CPU on tests/test_viewer.py's fixture scene.
VIEW_POSE = (0.8, 0.3, 3.0)         # the page's initial theta, phi, r
VIEW_ORBIT, VIEW_LABELS = 60, 10
VIEW_CLI_FRAMES = 10
VIEW_CLI_START_S = 300
VIEW_LOAD_GAUSSIANS = 20_000
VIEW_ENCODE_LEVELS = (0, 1, 6)
VIEW_SMALL = dict(n=200, seed=3, size=(64, 48), cameras=4)


def fetch(port: int, path: str, method: str = "GET", body=None) -> tuple:
    """(status, content type, body, client wall ms) of one request on a
    new connection, as the page's ``img.src`` and ``fetch`` make them."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        data = r.read()
    finally:
        conn.close()
    return (r.status, r.getheader("Content-Type"), data,
            (time.perf_counter() - t0) * 1e3)


def fetch_ok(port: int, path: str, ctype: str, method: str = "GET",
             body=None) -> tuple:
    """``fetch`` that fails unless the answer is 200 with ``ctype``."""
    status, got, data, ms = fetch(port, path, method, body)
    if (status, got) != (200, ctype):
        raise AssertionError(f"{method} {path} answered {status} {got}: "
                             f"{data[:200]!r}")
    return data, ms


def view_query(theta, phi, r, labels=False, sel=False, cam=-1) -> str:
    """The page's /render query string (``qs()`` in the page)."""
    return (f"theta={theta!r}&phi={phi!r}&r={r!r}&px=0&py=0&pz=0&cam={cam}"
            f"&labels={int(labels)}&sel={int(sel)}")


def uncounted(fn):
    """``fn()`` with the launch counts as they were before it: the
    in-process comparisons are not part of the session."""
    saved = [w.launches for w in WRAPPERS]
    out = fn()
    torch.cuda.synchronize()
    for w, n in zip(WRAPPERS, saved):
        w.launches = n
    return out


def percentiles(ms) -> dict:
    a = np.asarray(ms)
    return {"n": len(ms), "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)), "max": float(a.max())}


class ViewerSession:
    """Phase V1's client: every /render is decoded, checked for its shape
    and kept with its wall time under a group name."""

    def __init__(self, srv, port, size):
        self.srv, self.port, self.size = srv, port, size
        self.ms = {}
        self.png_bytes = []
        self.renders = 0

    def frame(self, group, query) -> np.ndarray:
        data, ms = fetch_ok(self.port, "/render?" + query, "image/png")
        self.renders += 1
        self.ms.setdefault(group, []).append(ms)
        self.png_bytes.append(len(data))
        pix = png.decode_png(data)
        w, h = self.size
        if pix.shape != (h, w, 3):
            raise AssertionError(f"frame {query} has shape {pix.shape}")
        return pix

    def same_in_process(self, pix, theta, phi, r, labels=False, sel=False,
                        cam=-1) -> None:
        want = uncounted(lambda: self.srv.frame_pixels(
            theta, phi, r, labels, cam_idx=cam, selection=sel))
        if not np.array_equal(pix, want):
            raise AssertionError(f"HTTP frame at {(theta, phi, r)} differs "
                                 f"from frame_pixels")

    def edit(self, query) -> None:
        before = read_launches()
        fetch_ok(self.port, "/edit?" + query, "application/json")
        if read_launches() != before:
            raise AssertionError("an /edit launched a kernel")
        with open(self.srv.session_path) as f:
            if f.read() != self.srv.edits.to_json():
                raise AssertionError(f"session file after {query} is not "
                                     f"the edit state")


def serve_in_thread(srv):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def viewer_session(scene, ply_path: Path, work: Path, device,
                   size=(WIDTH, HEIGHT)) -> dict:
    """Phase V1: the scripted session against a ViewerServer of the 2M
    scene served from a thread; returns its numbers, the launch counts and
    the frames V2 compares with."""
    w, h = size
    cams = orbit_cameras(8, 3.0, width=w, img_height=h)
    srv = ViewerServer(scene, width=w, height=h, cameras=cams,
                       session_path=str(work / "session.json"),
                       device=device)
    srv.prewarm()
    httpd = serve_in_thread(srv)
    port = httpd.server_address[1]
    s = ViewerSession(srv, port, size)
    th0, ph0, r0 = VIEW_POSE
    out = {}
    try:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_launches()
        page, _ = fetch_ok(port, "/", "text/html")
        ncams = json.loads(fetch_ok(port, "/cameras", "application/json")[0])
        pose = json.loads(fetch_ok(port, "/campose?cam=3",
                                   "application/json")[0])
        if ncams != {"count": 8} or pose != srv.campose(3) or (
                b"gsplat-tpu viewer" not in page):
            raise AssertionError(f"page, /cameras or /campose is wrong: "
                                 f"{ncams}, {pose}")
        if fetch(port, "/campose?cam=8")[0] != 404:
            raise AssertionError("/campose of a missing camera is not 404")

        orbit = [s.frame("orbit", view_query(th0 + 0.01 * i, ph0, r0))
                 for i in range(VIEW_ORBIT)]
        first = orbit[0]
        s.same_in_process(first, th0, ph0, r0)
        th1 = th0 + 0.01 * VIEW_ORBIT
        labelled = [s.frame("labels", view_query(th1 + 0.01 * i, ph0, r0,
                                                 labels=True))
                    for i in range(VIEW_LABELS)]
        s.same_in_process(labelled[-1], th1 + 0.01 * (VIEW_LABELS - 1), ph0,
                          r0, labels=True)
        for i in range(len(cams)):
            pix = s.frame("presets", view_query(0, 0, r0, cam=i))
        s.same_in_process(pix, 0, 0, r0, cam=len(cams) - 1)

        # select at the frame's centre, as a click in selection mode
        before = read_launches()
        sel = json.loads(fetch_ok(port, "/select?x=0.5&y=0.5&" + view_query(
            th0, ph0, r0, sel=True), "application/json")[0])
        select_launches = {k: v - before[k]
                           for k, v in read_launches().items()}
        lab = uncounted(lambda: hit_test(
            apply_edits(scene, EditState()), srv._camera(th0, ph0, r0),
            0.5 * w, 0.5 * h, radius_px=CFG.interact.hit_radius_px))
        want = {"label": lab, "name": label_name(lab),
                "count": int((scene.labels == lab).sum())}
        if lab == NO_SELECTION or sel != want or any(select_launches.values()):
            raise AssertionError(f"/select answered {sel}, want {want}; "
                                 f"launches {select_launches}")
        selected = s.frame("edits", view_query(th0, ph0, r0, sel=True))
        s.same_in_process(selected, th0, ph0, r0, sel=True)
        red = int(selected[..., 0].sum(dtype=np.int64)
                  - first[..., 0].sum(dtype=np.int64))
        again = s.frame("edits", view_query(th0, ph0, r0))
        if red <= 0 or not np.array_equal(again, first):
            raise AssertionError(f"the highlight moved red by {red}, or sel=0 "
                                 f"did not give the first frame back")

        # one edit of each kind on the selected label, a frame after each;
        # then the resets, each giving back the frame before its edits
        after = {}
        for name, query in (
                ("set_color", f"action=set_color&label={lab}&r=0.1&g=0.9"
                              f"&b=0.2"),
                ("hide", f"action=hide&label={lab}"),
                ("displace_h", f"action=displace&label={lab}&dx=-1&dy=0"
                               f"&dz=0"),
                ("displace_k", f"action=displace&label={lab}&dx=1&dy=0"
                               f"&dz=0"),
                ("displace_u", f"action=displace&label={lab}&dx=0&dy=-1"
                               f"&dz=0"),
                ("displace_j", f"action=displace&label={lab}&dx=0&dy=1"
                               f"&dz=0")):
            s.edit(query)
            after[name] = s.frame("edits", view_query(th0, ph0, r0,
                                                      sel=True))
        s.same_in_process(after["displace_j"], th0, ph0, r0, sel=True)
        if np.array_equal(after["hide"], after["set_color"]):
            raise AssertionError("hide changed no pixel")
        for reset, back_to in (("reset_disp", "hide"),
                               ("reset_vis", "set_color"),
                               ("reset_color", None)):
            s.edit("action=" + reset)
            pix = s.frame("edits", view_query(th0, ph0, r0, sel=True))
            want = selected if back_to is None else after[back_to]
            if not np.array_equal(pix, want):
                raise AssertionError(f"{reset} did not give back the frame "
                                     f"before its edits")

        # drag-drop loads: cameras, a small scene, the 2M PLY again
        cams5 = json.dumps([c.to_json() for c in orbit_cameras(
            5, 2.5, width=w, img_height=h)]).encode()
        res = json.loads(fetch_ok(port, "/load", "application/json", "POST",
                                  cams5)[0])
        if res != {"cameras": 5} or len(srv.cameras) != 5:
            raise AssertionError(f"camera load answered {res}")
        small = random_scene(VIEW_LOAD_GAUSSIANS, seed=11, extent=1.5,
                             scale_range=(0.01, 0.04), num_labels=16,
                             device="cpu")
        small_ply = work / "small.ply"
        scene_to_ply(str(small_ply), small)
        res = json.loads(fetch_ok(port, "/load", "application/json", "POST",
                                  small_ply.read_bytes())[0])
        if res != {"gaussians": VIEW_LOAD_GAUSSIANS}:
            raise AssertionError(f"small PLY load answered {res}")
        s.frame("edits", view_query(th0, ph0, r0))
        body = ply_path.read_bytes()
        t0 = time.perf_counter()
        res = json.loads(fetch_ok(port, "/load", "application/json", "POST",
                                  body)[0])
        reload_s = time.perf_counter() - t0
        del body
        if res != {"gaussians": scene.num_gaussians}:
            raise AssertionError(f"2M PLY load answered {res}")
        if not np.array_equal(s.frame("edits", view_query(th0, ph0, r0)),
                              first):
            raise AssertionError("the frame after the 2M reload differs from "
                                 "the first")
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        for name in ("project", "enum_keys", "blend_tiles_fwd"):
            if launches[name] != s.renders:
                raise AssertionError(f"{name} launched {launches[name]} "
                                     f"times for {s.renders} /render")
        others = {k: v for k, v in launches.items()
                  if k not in ("project", "enum_keys", "blend_tiles_fwd")
                  and v}
        if others:
            raise AssertionError(f"the viewer launched {others}")

        fps = 0.0
        for ms in s.ms["orbit"]:       # the page's EMA (js:1582-1583)
            fps = 0.9 * fps + 0.1 * (1000 / max(ms, 1))
        out = {"renders": s.renders, "launches": launches,
               "render_ms": {g: percentiles(v) for g, v in s.ms.items()},
               "page_fps_ema": fps,
               "png_bytes": percentiles(s.png_bytes),
               "reload_2m_s": reload_s,
               "max_memory_allocated_bytes": peak,
               "allocated_before_the_session_bytes": held,
               "orbit_frames": orbit[:VIEW_CLI_FRAMES], "select_payload": sel}
        out["breakdown_ms"] = viewer_breakdown(srv, port, lab, device,
                                               s.ms["orbit"])
    finally:
        httpd.shutdown()
        httpd.server_close()
    return out


def on_new_thread(fn, srv) -> None:
    """``fn()`` on a thread of its own with the viewer's device current, as
    its handlers run it."""
    def run():
        with srv._on_device():
            fn()
    t = threading.Thread(target=run)
    t.start()
    t.join()


def viewer_breakdown(srv, port, lab, device, orbit_ms) -> dict:
    """Server-side times of one frame at the session's first pose: the
    edits, ``render``, the frame's assembly with its copy to the host and
    the PNG encode at each level (median of 10 after 2 warm-ups; CUDA
    events for the device work, the host clock with the card synchronised
    for the rest), the same steps each on a new thread as a handler runs
    them, and a round trip that carries no frame; the rest of the client's
    p50 is HTTP and parsing."""
    cam = srv._camera(*VIEW_POSE)
    every = (EditState().displace(lab, (0.1, 0.0, 0.0))
             .toggle_visibility((lab + 1) % 16)
             .set_color(lab, (0.1, 0.9, 0.2)))
    every.selected_label, every.selection_mode = lab, True

    def host_ms(fn, reps=10, warmup=2):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    row = {}
    row["apply_edits none"] = cuda_ms(
        lambda: apply_edits(srv.scene, EditState()))[0]
    row["apply_edits each kind + highlight"] = cuda_ms(
        lambda: apply_edits(srv.scene, every))[0]
    row["render"] = cuda_ms(lambda: render(srv.scene, cam, CFG,
                                           device=device))[0]
    row["render labels"] = cuda_ms(lambda: render(
        srv.scene, cam, CFG, with_labels=True, device=device))[0]
    out = render(srv.scene, cam, CFG, with_labels=True, device=device)
    row["assemble + copy"] = host_ms(
        lambda: assemble_frame(out["image"], None, srv.palette))
    row["assemble + copy labels"] = host_ms(
        lambda: assemble_frame(out["image"], out["label_map"], srv.palette))
    pix = assemble_frame(out["image"], None, srv.palette)
    encode = {}
    for level in VIEW_ENCODE_LEVELS:
        encode[level] = {"ms": host_ms(lambda: png.encode_png(pix, level)),
                         "bytes": len(png.encode_png(pix, level))}
        row[f"encode_png level {level}"] = encode[level]["ms"]
    row["frame_pixels (in process)"] = host_ms(
        lambda: srv.frame_pixels(*VIEW_POSE))
    row["render_frame (in process)"] = host_ms(
        lambda: srv.render_frame(*VIEW_POSE))
    # ThreadingHTTPServer answers each request on a new thread
    for name, fn in (
            ("render", lambda: render(srv.scene, cam, CFG, device=device)),
            ("assemble + copy",
             lambda: assemble_frame(out["image"], None, srv.palette)),
            (f"encode_png level {PNG_LEVEL}",
             lambda: png.encode_png(pix, PNG_LEVEL)),
            ("render_frame", lambda: srv.render_frame(*VIEW_POSE)),
            ("nothing", lambda: None)):
        row[f"{name} on a new thread"] = host_ms(
            lambda: on_new_thread(fn, srv))
    row["HTTP round trip /cameras"] = statistics.median(
        fetch(port, "/cameras")[3] for _ in range(20))
    row["client p50 (orbit)"] = statistics.median(orbit_ms)
    row["rest: HTTP + parsing"] = row["client p50 (orbit)"] - (
        row["apply_edits none"] + row["render"] + row["assemble + copy"]
        + row[f"encode_png level {PNG_LEVEL}"])
    row["png_level"] = PNG_LEVEL
    row["encode"] = encode
    return row


def viewer_cli(ply_path: Path, work: Path, device, v1: dict,
               size=(WIDTH, HEIGHT)) -> dict:
    """Phase V2: ``cli.view`` as a subprocess on the 2M PLY; seconds from
    its start to the printed port (PLY read, kernel load, prewarm), then
    10 frames and a /select equal to V1's. The subprocess is stopped in a
    ``finally``: terminate, wait, then kill."""
    w, h = size
    save_cameras(str(work / "cameras.json"),
                 orbit_cameras(8, 3.0, width=w, img_height=h))
    cmd = [sys.executable, "-u", "-m", "gsplat_tpu_torch.cli.view",
           "--ply_file", str(ply_path), "--camera_file",
           str(work / "cameras.json"), "--port", "0", "--width", str(w),
           "--height", str(h)]
    if device.type != "cuda":       # the CLI's default is the card
        cmd += ["--device", str(device)]
    lines = queue.Queue()
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def read():
        for line in proc.stdout:
            lines.put(line.rstrip("\n"))
        lines.put(None)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        port = None
        while port is None:
            try:
                line = lines.get(timeout=max(
                    1.0, t0 + VIEW_CLI_START_S - time.perf_counter()))
            except queue.Empty:
                raise AssertionError(f"cli.view printed no port in "
                                     f"{VIEW_CLI_START_S} s") from None
            if line is None:
                raise AssertionError(f"cli.view exited with "
                                     f"{proc.wait()} before serving")
            log(f"  | {line}")
            m = re.search(r"viewer at http://[^/]+:(\d+)/", line)
            port = int(m.group(1)) if m else None
        startup_s = time.perf_counter() - t0
        th0, ph0, r0 = VIEW_POSE
        ms = []
        for i, want in enumerate(v1["orbit_frames"]):
            data, t = fetch_ok(port, "/render?" + view_query(
                th0 + 0.01 * i, ph0, r0), "image/png")
            ms.append(t)
            if not np.array_equal(png.decode_png(data), want):
                raise AssertionError(f"cli.view frame {i} differs from V1's")
        sel = json.loads(fetch_ok(port, "/select?x=0.5&y=0.5&" + view_query(
            th0, ph0, r0, sel=True), "application/json")[0])
        if sel != v1["select_payload"]:
            raise AssertionError(f"cli.view /select answered {sel}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        reader.join(timeout=30)
    return {"startup_s": startup_s, "render_ms": percentiles(ms),
            "frames_equal_to_v1": len(ms), "select": sel}


def viewer_card_vs_cpu(device) -> dict:
    """Phase V3: on tests/test_viewer.py's fixture scene, the card server's
    frames with and without labels against a CPU server's (>= 99.9% of
    uint8 values equal, none more than 2 apart: the render's 5e-3 after
    truncation) and their /select payloads equal."""
    n, seed = VIEW_SMALL["n"], VIEW_SMALL["seed"]
    w, h = VIEW_SMALL["size"]
    scene = random_scene(n, seed=seed, extent=1.0, scale_range=(0.05, 0.1),
                         num_labels=4, device="cpu")
    cams = orbit_cameras(VIEW_SMALL["cameras"], 3.0, width=w, img_height=h)
    servers = [ViewerServer(scene, width=w, height=h, cameras=cams,
                            device=d) for d in (device, "cpu")]
    httpds = [serve_in_thread(s) for s in servers]
    ports = [x.server_address[1] for x in httpds]
    try:
        queries = [view_query(t, 0.2, 3.0, labels=lab)
                   for t in (0.0, 0.5, 1.7, 3.0, 4.4) for lab in (0, 1)]
        queries += [view_query(0, 0, 3.0, labels=lab, cam=i)
                    for i in range(len(cams)) for lab in (0, 1)]
        equal = worst = 0
        values = 0
        for q in queries:
            card_pix, cpu_pix = (png.decode_png(fetch_ok(
                p, "/render?" + q, "image/png")[0]) for p in ports)
            d = np.abs(card_pix.astype(np.int32) - cpu_pix)
            equal += int((d == 0).sum())
            values += d.size
            worst = max(worst, int(d.max()))
        selects = []
        for x, y, t in ((0.5, 0.5, 0.0), (0.3, 0.6, 0.5), (0.7, 0.4, 2.0),
                        (0.5, 0.5, 4.4), (-4, -4, 0.0)):
            q = f"/select?x={x}&y={y}&" + view_query(t, 0.2, 3.0)
            a, b = (json.loads(fetch_ok(p, q, "application/json")[0])
                    for p in ports)
            selects.append(a == b)
    finally:
        for x in httpds:
            x.shutdown()
            x.server_close()
    res = {"frames": len(queries), "equal_share": equal / values,
           "max_diff": worst, "selects_equal": selects}
    if not (res["equal_share"] >= 0.999 and worst <= 2 and all(selects)):
        raise AssertionError(f"the card's viewer differs from the CPU's: "
                             f"{res}")
    return res


def viewer_phase(scene, ply_path: Path, device, card) -> dict:
    """Phase V: the live viewer at real size (V1 in process over HTTP, V2
    the CLI, V3 the card against the CPU). Returns V1's launch counts."""
    work = REPO / "build" / "chip_smoke" / "viewer"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        v1 = viewer_session(scene, ply_path, work, device)
        frames = v1.pop("orbit_frames")
        log({"phase": "V1 viewer session", "wall_s": time.perf_counter() - t0,
             **{k: v for k, v in v1.items() if k != "breakdown_ms"},
             "card": card})
        log({"measure": "viewer frame breakdown", "ms": v1["breakdown_ms"],
             "card": card})
        t0 = time.perf_counter()
        v2 = viewer_cli(ply_path, work, device,
                        {"orbit_frames": frames,
                         "select_payload": v1["select_payload"]})
        log({"phase": "V2 viewer CLI", "wall_s": time.perf_counter() - t0,
             **v2, "card": card})
        v3 = viewer_card_vs_cpu(device)
        log({"check": "viewer card vs CPU", **v3})
    finally:
        shutil.rmtree(work, ignore_errors=True)
        # a handler class holds its viewer, and with it a scene on the
        # card, in a reference cycle: free it before phase 5 measures
        gc.collect()
    return v1["launches"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def perturbed_capacity_state(scene, device):
    """Phase 4's training input: the scene's DC colours, means and
    opacities moved by seeded noise, padded to 1.25x capacity."""
    gen = torch.Generator(device=device).manual_seed(5)
    n = scene.num_gaussians
    p = trainer.SceneParams.from_scene(scene)
    sh = p.sh.clone()
    sh[:, 0] += 0.05 * torch.randn(n, 3, generator=gen, device=device)
    p = p._replace(
        means=p.means + 0.002 * torch.randn(n, 3, generator=gen,
                                            device=device),
        sh=sh, opacities=p.opacities - 0.5)
    capacity = -(-int(1.25 * n) // 128) * 128
    return densify.pad_to_capacity(p, scene.labels, capacity)


def sharded_render_equal(scene, cam, mesh, want, device) -> dict:
    """``render_sharded`` with labels of ``scene`` over ``mesh`` against
    ``render``'s ``want``: equal bit for bit (B1 cuts a shard's long tiles
    by the whole frame's stream, as ``render`` cuts them), the tiles B1
    split, and its CUDA-event ms."""
    camp = CameraParams.from_camera(cam, device)
    sharded = mesh_lib.shard_scene(scene, mesh)
    before = blend.split_counts(device)
    ms, got = cuda_ms_once(lambda: render_sharded(
        sharded, camp, mesh, width=cam.width, height=cam.height, cfg=CFG,
        with_labels=True))
    split = blend.split_counts(device)["tiles"] - before["tiles"]
    equal = {k: bool(torch.equal(got[k], want[k]))
             for k in ("image", "transmittance", "best_weight", "label_map")}
    if not all(equal.values()):
        raise AssertionError(f"sharded render over {mesh.dims} differs "
                             f"from render: {equal}")
    return {"mesh": list(mesh.dims), "equal": equal, "tiles_split": split,
            "ms": ms}


def single_step_reference(scene, cam, target, device) -> dict:
    """Phase 4's capacity state of ``scene``, the single-device
    ``make_train_step`` step's loss on it (l2 against ``target``, view
    ``cam``) and its gradients: what phase M's sharded steps are held
    to."""
    params, labels = perturbed_capacity_state(scene, device)
    camp = CameraParams.from_camera(cam, device)
    bg = torch.zeros(3, device=device)
    step = trainer.make_train_step((WIDTH, HEIGHT), CFG, lr=TRAIN_LR,
                                   loss="l2")
    _, loss, _ = step(trainer.init_state(params.to_scene(labels),
                                         lr=TRAIN_LR), labels, camp, target,
                      bg)
    grads = trainer._grads(params, labels, [(camp, target, bg)],
                           trainer.l2_loss, width=WIDTH, height=HEIGHT,
                           cfg=CFG, mesh=None)[0]
    return {"params": params, "labels": labels, "camp": camp,
            "target": target, "bg": bg, "loss": float(loss),
            "grads": grads}


def sharded_step_check(tag, mesh, ref, counted) -> dict:
    """One sharded ``make_train_step`` step over ``mesh`` on ``ref``'s
    state (:func:`single_step_reference`): its loss bit-equal to the
    single-device step's, every gradient within 1e-3 of its peak (the
    card-vs-CPU bar), and B4, B1, B2 and the fold launched once a
    shard. Raises otherwise."""
    d = mesh.size
    sharded = mesh_lib.shard_scene(ref["params"].to_scene(ref["labels"]),
                                   mesh)
    step = trainer.make_train_step((WIDTH, HEIGHT), CFG, lr=TRAIN_LR,
                                   loss="l2", mesh=mesh)
    (state, loss, nd), got = counted(tag, lambda: step(
        trainer.init_state(sharded, lr=TRAIN_LR), sharded.labels,
        ref["camp"], ref["target"], ref["bg"]))
    if any(got[name] != d for name in TRAIN_CLI_KERNELS):
        raise AssertionError(f"{tag} launched {got}")
    views = [(ref["camp"], ref["target"], ref["bg"])]
    g_mesh = mesh_lib.gather_rows(trainer._grads(
        sharded.map(trainer.SceneParams.from_scene), sharded.labels, views,
        trainer.l2_loss, width=WIDTH, height=HEIGHT, cfg=CFG, mesh=mesh)[0])
    errs = {f: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for f, a, b in zip(trainer.SceneParams._fields, g_mesh,
                               ref["grads"])}
    res = {"mesh": list(mesh.dims), "loss": float(loss),
           "single_device_loss": ref["loss"],
           "loss_equal": float(loss) == ref["loss"],
           "num_dropped": int(nd),
           "capacity": int(ref["params"].means.shape[0]),
           "grad_max_err_over_peak": errs, "step": state.step}
    if not (res["loss_equal"] and int(nd) == 0
            and max(errs.values()) <= 1e-3):
        raise AssertionError(f"{tag}: {res}")
    return res


def mesh_phase(scene, cam, device, card) -> dict:
    """Phase M: M1 over a one-rank NCCL process group, M2 D logical shards
    and the scaling report, M3 the sharded votes and k-means (module
    docstring). Returns the sharded main path's launches: M1's render and
    train step, M2's renders and M3's votes."""
    out = {}
    want = render(scene, cam, CFG, with_labels=True, device=device)
    torch.cuda.synchronize()
    launches = {}

    def counted(tag, fn):
        reset_launches()
        res = fn()
        got = read_launches()
        out.setdefault("launches", {})[tag] = got
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return res, got

    # the single-device step's loss and gradients, which M1's and M2's
    # sharded steps are held to
    ref = single_step_reference(scene, cam, want["image"], device)

    # M1: one rank over NCCL
    t0 = time.perf_counter()
    bootstrap.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                     backend="nccl")
    try:
        mesh = mesh_lib.make_mesh()
        if not (mesh.distributed and mesh.dims == (1, 1)):
            raise AssertionError(f"NCCL mesh of one rank: {mesh}")
        out["M1 render"], got = counted(
            "M1 render", lambda: sharded_render_equal(scene, cam, mesh, want,
                                                      device))
        if not (got["enum_keys"] == got["blend_tiles_fwd"] == 1):
            raise AssertionError(f"M1 render launched {got}")
        out["M1 train step"] = sharded_step_check(
            "M1 train step", mesh, ref, counted)
    finally:
        torch.distributed.destroy_process_group()
    out["M1 wall_s"] = time.perf_counter() - t0
    log({"phase": "M1 NCCL world size 1", **out["M1 render"],
         **out["M1 train step"], "launches": out["launches"],
         "wall_s": out["M1 wall_s"], "card": card})

    # M2: D logical shards on the card, then the scaling report
    t0 = time.perf_counter()
    for d in MESH_SHARDS:
        mesh = mesh_lib.make_mesh(scaling._shape(d), [device])
        res, got = counted(f"M2 render D={d}", lambda: sharded_render_equal(
            scene, cam, mesh, want, device))
        if not (got["enum_keys"] == got["blend_tiles_fwd"] == d):
            raise AssertionError(f"M2 render at D={d} launched {got}")
        log({"phase": "M2 sharded render", "shards": d, **res,
             "launches": got, "card": card})
    # B4, B1, B2 and the fold under a lattice that is not the whole
    # grid, at the 2M frame, against the single-device step
    mesh = mesh_lib.make_mesh(scaling._shape(MESH_STEP_SHARDS), [device])
    out["M2 train step"] = sharded_step_check(
        f"M2 train step D={MESH_STEP_SHARDS}", mesh, ref, counted)
    log({"phase": "M2 sharded train step", "shards": MESH_STEP_SHARDS,
         **out["M2 train step"],
         "launches": out["launches"][f"M2 train step D={MESH_STEP_SHARDS}"],
         "card": card})
    del ref
    rows = scaling.efficiencies([
        scaling.scaling_row(scene, cam, d, device, CFG, timed=True)
        for d in scaling.SHARDS])
    for r in rows:
        log({"measure": "scaling", **r, "card": card})
    out["scaling"] = rows
    out["M2 wall_s"] = time.perf_counter() - t0

    # M3: the sharded votes and k-means at D = 4
    t0 = time.perf_counter()
    mesh = mesh_lib.make_mesh(scaling._shape(MESH_VOTE_SHARDS), [device])
    vcams = orbit_cameras(MESH_VOTE_VIEWS, 3.0, width=WIDTH,
                          img_height=HEIGHT)
    seg = np.random.default_rng(3).integers(
        -1, LABEL_CLASSES - 1, size=(MESH_VOTE_VIEWS, SEG_SIZE[1],
                                     SEG_SIZE[0])).astype(np.int32)
    res = {}
    for fn in ("assign_labels", "assign_labels_visible"):
        one = getattr(vote, fn)(scene, vcams, seg, num_classes=LABEL_CLASSES,
                                return_votes=True, device=device)
        (got_l, got_v), got = counted(f"M3 {fn}", lambda: getattr(vote, fn)(
            scene, vcams, seg, num_classes=LABEL_CLASSES, return_votes=True,
            mesh=mesh, device=device))
        res[fn] = {"labels_equal": bool(torch.equal(got_l, one[0])),
                   "votes_equal": bool(torch.equal(got_v, one[1])),
                   "labeled": float((got_l >= 0).float().mean())}
    res["visibility_masks_equal"] = bool(torch.equal(
        vote.visibility_masks(scene, vcams, mesh=mesh, device=device),
        vote.visibility_masks(scene, vcams, device=device)))
    if out["launches"]["M3 assign_labels_visible"]["blend_tiles_vis"] \
            != MESH_VOTE_VIEWS:
        raise AssertionError("the sharded visibility pass launched B5 "
                             f"{out['launches']} times")
    feats = km.scene_features(scene)
    k_one = km.kmeans(feats, KMEANS_K)
    k_mesh = km.kmeans(feats, KMEANS_K, mesh=mesh)
    res["kmeans"] = {
        "labels_equal": bool(torch.equal(k_mesh.labels, k_one.labels)),
        "agreement": float((k_mesh.labels == k_one.labels).float().mean()),
        "iterations": [k_one.iterations, k_mesh.iterations],
        "centroid_max_abs_err": float(
            (k_mesh.centroids - k_one.centroids).abs().max())}
    out["M3"] = res
    out["M3 wall_s"] = time.perf_counter() - t0
    log({"phase": "M3 sharded votes and k-means", "shards": MESH_VOTE_SHARDS,
         "views": MESH_VOTE_VIEWS, **res, "wall_s": out["M3 wall_s"],
         "card": card})
    if not (all(res[f]["labels_equal"] and res[f]["votes_equal"]
                for f in ("assign_labels", "assign_labels_visible"))
            and res["visibility_masks_equal"]
            and res["kmeans"]["agreement"] >= MESH_KMEANS_AGREEMENT):
        raise AssertionError(f"M3: sharded results differ: {res}")
    out["sharded_launches"] = launches
    return out


def parity_phase(card) -> dict:
    """Phase G: ``utils.verify_parity`` with its kernel stage on the card;
    fails past a bar. Returns its launches."""
    out = REPO / "build" / "chip_smoke" / "parity_torch.json"
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = verify_parity.main(["--out", str(out)])
    launches = read_launches()
    report = json.loads(out.read_text())
    log({"phase": "G parity", "rc": rc,
         **{k: report[k] for k in ("device", "reference", "reference_wall_s",
                                   "wall_s", "pixels_vs_dense_cpu",
                                   "grads_vs_dense_cpu",
                                   "label_map_vs_dense_cpu", "num_dropped",
                                   "pass", "tolerances")},
         "launches": launches, "phase_wall_s": time.perf_counter() - t0,
         "card": card})
    if rc != 0 or not report["pass"]:
        raise AssertionError(f"G: the kernels miss the parity bars: {report}")
    want = {"enum_keys": 2, "blend_tiles_fwd": 2, "blend_tiles_bwd": 1,
            "fold_rows": 1}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"G launched {launches}, not {want}")
    return launches


def quality_phase(card) -> dict:
    """Phase Q: ``utils.train_quality`` at its default widths for
    QUALITY_ITERS iterations, densifying every QUALITY_DENSIFY_EVERY; no
    step drops an instance (the gate raises), every densify grows the live
    set, the PLY reloads the alive set and the held-out PSNR beats the
    initial scene's by QUALITY_MARGIN_DB. Returns its launches."""
    work = REPO / "build" / "chip_smoke" / "quality"
    out = work / "train_quality_torch.json"
    reset_launches()
    t0 = time.perf_counter()
    rc = train_quality.main(["--iters", str(QUALITY_ITERS), "--densify-every",
                             str(QUALITY_DENSIFY_EVERY), "--out", str(out),
                             "--workdir", str(work)])
    launches = read_launches()
    art = json.loads(out.read_text())
    fit = art["fit"]
    log({"phase": "Q training-quality gate", "rc": rc,
         "gt": art["gt"], "iters": fit["iters"],
         "init_gaussians": fit["init_gaussians"],
         "final_gaussians": fit["final_gaussians"],
         "densify_events": fit["densify_events"],
         "step_ms": fit["step_ms"], "losses": fit["losses"],
         "initial_mean_psnr_db": art["initial_mean_psnr_db"],
         "mean_psnr_db": art["mean_psnr_db"], "mean_ssim": art["mean_ssim"],
         "held_out": art["held_out"], "num_dropped": art["num_dropped"],
         "train_wall_s": fit["train_wall_s"], "ply_reloaded":
         fit["ply_reloaded"], "launches": launches,
         "phase_wall_s": time.perf_counter() - t0, "card": card})
    views = art["gt"]["views"] - art["gt"]["held_out"]
    steps = QUALITY_ITERS * views
    densified = fit["densify_events"]
    gain = art["mean_psnr_db"] - art["initial_mean_psnr_db"]
    if not (rc in (0, 2) and art["num_dropped"] == 0 and densified
            and all(e["alive_after"] > e["alive_before"] for e in densified)
            and fit["ply_reloaded"] and gain >= QUALITY_MARGIN_DB):
        raise AssertionError(f"Q: the gate went wrong: rc {rc}, gain {gain} "
                             f"dB, densify {densified}, PLY reloaded "
                             f"{fit['ply_reloaded']}")
    for k in ("blend_tiles_bwd", "fold_rows", "project_bwd"):
        if launches[k] != steps:
            raise AssertionError(f"Q launched {k} {launches[k]} times in "
                                 f"{QUALITY_ITERS} steps of {views} views")
    if any(launches[k] < steps for k in ("enum_keys", "blend_tiles_fwd",
                                         "project")):
        raise AssertionError(f"Q launched {launches}")
    return launches


_EXAMPLE_CHILD = r"""
import json, runpy, sys
from gsplat_tpu_torch.render import blend, projection, tiles
from gsplat_tpu_torch.render.api import fold_rows, segment_sums

path = sys.argv[1]
sys.argv = [path] + sys.argv[2:]
try:
    runpy.run_path(path, run_name="__main__")
    code = 0
except SystemExit as stop:
    code = stop.code
wrappers = (tiles.enum_keys, blend.blend_tiles_fwd, blend.blend_tiles_bwd,
            blend.cumsum_rows, segment_sums, fold_rows,
            blend.blend_tiles_vis, projection.project,
            projection.project_bwd)
print("LAUNCHES " + json.dumps({w.__name__: w.launches for w in wrappers}))
sys.exit(code)
"""


def example_lines_agree(name: str, got, want) -> list:
    """The lines of ``got`` that miss ``want``'s under EXAMPLE_BARS (empty
    when every line agrees); "wrote ..." lines are skipped."""
    got = [ln for ln in got if not ln.startswith("wrote")]
    want = [ln for ln in want if not ln.startswith("wrote")]
    if len(got) != len(want):
        return [f"{len(got)} lines, not {len(want)}"]
    bad = []
    for g, w in zip(got, want):
        masked_g, masked_w = g, w
        for pattern, (rtol, atol) in EXAMPLE_BARS.get(name, {}).items():
            mg, mw = re.search(pattern, g), re.search(pattern, w)
            if mg is None or mw is None:
                continue
            a, b = float(mg.group(1)), float(mw.group(1))
            if abs(a - b) > rtol * abs(b) + atol:
                bad.append(f"{g!r} vs {w!r}")
            masked_g = masked_g.replace(mg.group(1), "#", 1)
            masked_w = masked_w.replace(mw.group(1), "#", 1)
        if masked_g != masked_w:
            bad.append(f"{g!r} vs {w!r}")
    return bad


def examples_phase(device, card) -> dict:
    """Phase X: each twin of examples/01-05 in a subprocess on the card and
    one on the CPU, all started together; each exits 0, the card's lines
    agree with the CPU's under EXAMPLE_BARS and 05's sharded error is at
    most EXAMPLE_ERR_BAR on both. Returns the card runs' launches, which
    each child counts from 0 and prints last."""
    work = REPO / "build" / "chip_smoke" / "examples"
    t0 = time.perf_counter()
    procs = {}
    try:
        for name in EXAMPLES:
            for dev in (device.type, "cpu"):
                out_dir = work / dev / name
                out_dir.mkdir(parents=True, exist_ok=True)
                env = dict(os.environ, OMP_NUM_THREADS="2")
                procs[name, dev] = subprocess.Popen(
                    [sys.executable, "-c", _EXAMPLE_CHILD,
                     str(REPO / "examples_torch" / f"{name}.py"), "--device",
                     dev, "--out-dir", str(out_dir)], cwd=REPO, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
        runs = {}
        for key, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            lines = stdout.splitlines()
            counts = json.loads(lines[-1].split(" ", 1)[1]) \
                if lines and lines[-1].startswith("LAUNCHES ") else None
            runs[key] = (proc.returncode, lines[:-1], counts, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    launches = {fn.__name__: 0 for fn in WRAPPERS}
    rows = {}
    for name in EXAMPLES:
        (rc_c, card_lines, counts, err_c), (rc_h, cpu_lines, _, err_h) = (
            runs[name, device.type], runs[name, "cpu"])
        if rc_c or rc_h or counts is None:
            raise AssertionError(f"X: {name} failed: card rc {rc_c}, CPU rc "
                                 f"{rc_h}\n{err_c[-2000:]}\n{err_h[-2000:]}")
        for k, v in counts.items():
            launches[k] += v
        bad = example_lines_agree(name, card_lines, cpu_lines)
        rows[name] = {"card": card_lines, "cpu": cpu_lines,
                      "launches": counts, "disagree": bad}
        log({"phase": "X example", "example": name,
             "card_lines": card_lines, "cpu_lines": cpu_lines,
             "launches": counts, "disagree": bad,
             "card_files": sorted(p.name for p in
                                  (work / device.type / name).iterdir()),
             "card": card})
        if bad:
            raise AssertionError(f"X: {name} on the card differs from the "
                                 f"CPU: {bad}")
    errs = [float(re.search(EXAMPLE_ERR, ln).group(1))
            for dev in ("card", "cpu") for ln in rows["05_multichip"][dev]
            if re.search(EXAMPLE_ERR, ln)]
    if len(errs) != 2 or max(errs) > EXAMPLE_ERR_BAR:
        raise AssertionError(f"X: 05's sharded error {errs}")
    if rows["02_label_pipeline"]["launches"]["blend_tiles_vis"] == 0:
        raise AssertionError("X: example 02 never launched B5")
    for k in ("enum_keys", "blend_tiles_fwd", "blend_tiles_bwd",
              "fold_rows", "project", "project_bwd"):
        if launches[k] == 0:
            raise AssertionError(f"X: the examples never launched {k}")
    log({"phase": "X done", "launches": launches,
         "wall_s": time.perf_counter() - t0, "card": card})
    return launches


def rehearse(views: int, reduce: int) -> int:
    """Phase L at reduced size on the CPU, where the kernel wrappers take
    their plain versions: the 2M scene with ``reduce`` times fewer
    gaussians, each sqrt(reduce) times larger, so the optical depth (N times
    the squared scale) stays; a quarter of the frame's width and height, so
    ``reduce`` 16 also keeps each gaussian's size in pixels. Prints one JSON
    line per mode with the labeled share and the agreement with the
    slabs."""
    width, height = WIDTH // 4, HEIGHT // 4
    grow = reduce ** 0.5
    scene = random_scene(2_000_000 // reduce, seed=0, extent=1.5,
                         scale_range=(0.002 * grow, 0.008 * grow),
                         num_labels=16, device="cpu")
    cams = orbit_cameras(views, 3.0, width=width, img_height=height)
    in_dir = REPO / "build" / "label_rehearsal"
    try:
        slabs = write_label_inputs(scene, cams, in_dir,
                                   (width // 2, height // 2), "cpu")
        for mode in ("visible", "center"):
            labels, wall = run_label_cli(in_dir, mode, "cpu")
            log({"rehearsal": mode, "reduce": reduce,
                 "gaussians": scene.num_gaussians, "views": views,
                 "frame": [width, height], **agreement(labels, slabs),
                 "wall_s_cpu": wall})
    finally:
        shutil.rmtree(in_dir, ignore_errors=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Drive the PyTorch/CUDA port on one card.")
    ap.add_argument("--rehearse", action="store_true",
                    help="run phase L at reduced size on the CPU instead")
    ap.add_argument("--views", type=int, default=64,
                    help="views of the rehearsal")
    ap.add_argument("--reduce", type=int, default=100,
                    help="the rehearsal's cut of the 2M scene")
    args = ap.parse_args(argv)
    if args.rehearse:
        return rehearse(args.views, args.reduce)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = smi("name,power.limit")
    log(card)
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0],
         "device": torch.cuda.get_device_name(0)})

    # 1. build
    t0 = time.perf_counter()
    built = _kernels.build()
    log({"phase": "build", "wall_s": time.perf_counter() - t0,
         "per_source_s": {k: v["seconds"] for k, v in built.items()}})
    t0 = time.perf_counter()
    lib = native.build()
    log({"phase": "build native codec", "library": lib.name,
         "wall_s": time.perf_counter() - t0})
    for name, info in built.items():
        for line in info["ptxas"].splitlines():
            if "ptxas info" in line or "spill" in line:
                log(f"[{name}] {line.strip()}")
    # P2 holds each column's 64 rows in registers: a stack frame or a spill
    # means an array went to local memory
    local = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads",
                       built.get("scan_probe", {}).get("ptxas", ""))
    if "scan_probe" in built and (
            not local or any(int(n) for row in local for n in row)):
        raise AssertionError(f"P2's kernels use local memory: {local}")
    log({"occupancy": {name: _kernels.occupancy(name)
                       for name in ("blend_fwd", "blend_vis", "blend_bwd")},
         "sms": torch.cuda.get_device_properties(0).multi_processor_count})

    # P. the probes: the card's rates (P1) and the scans (P2)
    peaks, probe_rows = probe_phase(device, card)
    rates = roofline.measured_rates(peaks)
    sheet = card_datasheet_rates()

    # B. the twins of bench.py and bench_vote.py at their defaults
    t0 = time.perf_counter()
    (bench_launches, vote_launches, err_b4_vote, err_b5_vote,
     err_b1_vote) = bench_phase(device, card, ROOFLINE_REPORT)
    log({"phase": "B wall", "wall_s": time.perf_counter() - t0})

    # 2. bench frame: kernels against plain versions, counts, small render
    bench = Frame(random_scene(100_000, seed=0, extent=1.5,
                               scale_range=(0.004, 0.02), num_labels=16,
                               device=device),
                  look_at_camera((0, 0, -3.0), (0, 0, 0), width=WIDTH,
                                 height=HEIGHT))
    err_b4 = max(err_b4_vote, check_b4(bench))
    log({"check": "B4 enum_keys vs plain", "frame": "bench",
         "keys_equal": True, "slots": bench.bb.total})
    err_b1 = max(err_b1_vote, check_b1(bench, "bench"))
    err_b2 = check_b2(bench, "bench")
    counts = bench.instance_counts()
    log({"bench_frame_counts": counts, "jax_binning_counts": BENCH_COUNTS})
    if counts != BENCH_COUNTS:
        raise AssertionError("bench-frame instance counts differ from the "
                             "JAX binning's")
    check_small_render(device)
    check_gradients(device)
    err_b5 = max(err_b5_vote, check_b5(bench, "bench"))
    check_b1_equals_b5(bench, "bench")
    err_fold = check_segment_sums(bench.fold_cs(), bench.binning.enum_start,
                                  bench.binning.enum_cnt, "bench")
    fold_rows_rows = fold_phase(bench, device, card)
    proj_rows = {"bench": check_project(bench.scene, bench.cam, "bench",
                                        card)}
    proj_bwd_rows = {"bench": check_project_bwd(bench.scene, bench.cam,
                                                "bench", card)}
    check_small_labeling(device)
    thin = Frame.from_projection(*thin_splats_projection(
        3000, width=200, height=136, seed=7, device=device), 200, 136)
    err_b1 = max(err_b1, check_b1(thin, "thin splats"))
    err_b5 = max(err_b5, check_b5(thin, "thin splats"))
    err_b2 = max(err_b2, check_b2(thin, "thin splats"))
    del thin
    crowded = crowded_ball(device)
    log({"crowded ball tiles": crowded.tile_lengths()})
    err_b1 = max(err_b1, check_b1_split(crowded, "crowded ball",
                                        walked_again=True))
    del crowded

    # 3. serving path: 2M gaussians through PLY, 8 views, with labels
    t0 = time.perf_counter()
    made = random_scene(2_000_000, seed=0, extent=1.5,
                        scale_range=(0.002, 0.008), num_labels=16,
                        device=device)
    ply_dir = REPO / "build" / "chip_smoke"
    ply_dir.mkdir(parents=True, exist_ok=True)
    ply_path = ply_dir / "scene_2m.ply"
    scene_to_ply(str(ply_path), made)
    # the PLY read through the native codec and through the numpy reader
    # (wall seconds, the scene on the card in each)
    reads = {}
    for codec, native_read in (("native", True), ("numpy", False)):
        t1 = time.perf_counter()
        scene = scene_from_ply(str(ply_path), use_native=native_read,
                               device=device)
        torch.cuda.synchronize()
        reads[f"read_{codec}_s"] = time.perf_counter() - t1
        for f in ("means", "log_scales", "quats", "opacities", "sh",
                  "labels"):
            if not torch.equal(getattr(scene, f), getattr(made, f)):
                raise AssertionError(f"PLY round trip ({codec}) changed {f}")
    ply_bytes = ply_path.stat().st_size
    del made
    log({"phase": "scene", "gaussians": scene.num_gaussians,
         "ply_bytes": ply_bytes, "seconds": time.perf_counter() - t0,
         **reads, "card": card})
    cams = orbit_cameras(8, 3.0, width=WIDTH, img_height=HEIGHT)

    reset_launches()
    frames = [render(scene, cam, CFG, with_labels=True, device=device)
              for cam in cams]
    launches = read_launches()
    log({"phase": "main path", "views": len(cams), "launches": launches})
    for name in ("project", "enum_keys", "blend_tiles_fwd"):
        n = launches[name]
        if n != len(cams):
            raise AssertionError(f"{name} launched {n} times for "
                                 f"{len(cams)} frames")
    for i, out in enumerate(frames):
        finite = all(bool(torch.isfinite(out[k]).all()) for k in
                     ("image", "alpha", "transmittance", "best_weight"))
        coverage = float((out["alpha"] > 0.5).float().mean())
        labelled = float((out["label_map"] != UNLABELED).float().mean())
        lab_ok = bool(((out["label_map"] == UNLABELED)
                       | ((out["label_map"] >= 0)
                          & (out["label_map"] < 16))).all())
        dropped = int(out["num_dropped"])
        log({"view": i, "finite": finite, "coverage": coverage,
             "labelled": labelled, "num_dropped": dropped})
        if not (finite and coverage > 0 and lab_ok and dropped == 0
                and out["image"].shape == (HEIGHT, WIDTH, 3)):
            raise AssertionError(f"view {i} is wrong")
    del frames

    # R. the offline render path: the render CLI over the PLY, .splat, dense
    cli_launches = render_cli_phase(scene, ply_path, device, card)

    big = Frame(scene, cams[0])
    err_b4 = max(err_b4, check_b4(big))
    log({"check": "B4 enum_keys vs plain", "frame": "2M view 0",
         "keys_equal": True, "slots": big.bb.total})
    err_b1 = max(err_b1, check_b1(big, "2M view 0"))
    err_b2 = max(err_b2, check_b2(big, "2M view 0"))
    err_b3 = check_b3(big, "2M view 0", bench.fold_rows())
    err_fold = max(err_fold, check_segment_sums(
        big.fold_cs(), big.binning.enum_start, big.binning.enum_cnt,
        "2M view 0"))
    err_b5 = max(err_b5, check_b5(big, "2M view 0"))
    check_b1_equals_b5(big, "2M view 0")
    log({"main_frame_counts": big.instance_counts()})
    proj_rows["2M view 0"] = check_project(scene, cams[0], "2M view 0", card)
    for n, w, h in PROJECT_SIZES:
        sized = random_scene(n, seed=n, extent=1.5,
                             scale_range=(0.002, 0.008), sh_degree=3,
                             device=device)
        sized_cam = look_at_camera((2.5, 0.3, 0.0), (0, 0, 0), width=w,
                                   height=h)
        proj_rows[f"{n} SH 3"] = check_project(
            sized, sized_cam, f"{n} SH 3, {w}x{h}", card)
        proj_bwd_rows[f"{n} SH 3"] = check_project_bwd(
            sized, sized_cam, f"{n} SH 3, {w}x{h}", card)
        del sized

    # L. labeling path: the label CLI over 311 views of the 2M scene
    label_launches, label_times = label_main_path(scene, device, card)

    # 4. training path: adaptive multiview steps at 2M, one densify
    train_launches, state, labels, train_cams, targets = train_main_path(
        scene, device)
    train_row, train_peak = time_train_step(state, labels, train_cams[0],
                                            targets[0], device, card)
    del state, labels, targets

    # T. the training CLI: 120 steps at 2M, then a resumed run
    t0 = time.perf_counter()
    train_cli_launches = train_cli_phase(scene, device, card)
    log({"phase": "T done", "wall_s": time.perf_counter() - t0})

    # K. clustering: the k-means and region-growing CLIs
    t0 = time.perf_counter()
    cluster = cluster_phase(scene, ply_path, device, card)
    log({"phase": "K done", "wall_s": time.perf_counter() - t0})

    # V. the live viewer: the 2M scene over HTTP, its CLI, card vs CPU
    t0 = time.perf_counter()
    view_launches = viewer_phase(scene, ply_path, device, card)
    ply_path.unlink()
    log({"phase": "V done", "wall_s": time.perf_counter() - t0})

    # 5. times
    results = {}
    for tag, fr, plain_reps, b5_reps in (("bench", bench, 10, 10),
                                         ("2M view 0", big, 3, 2)):
        torch.cuda.reset_peak_memory_stats()
        row = {}
        for stage, fn in (("project", fr.project), ("B4 enum_keys",
                          fr.enum_keys), ("sort", fr.sort),
                          ("B1 blend_tiles_fwd", fr.blend),
                          ("render", fr.render)):
            ms, runs = cuda_ms(fn)
            row[stage] = ms
            log({"measure": stage, "frame": tag, "ms": ms, "runs_ms": runs,
                 "card": card})
        peak = torch.cuda.max_memory_allocated()
        rows = fr.fold_rows()
        drows = fr.blend_bwd()
        cs = blend.cumsum_rows(rows)
        for stage, fn in (("B2 blend_tiles_bwd", fr.blend_bwd),
                          ("fold", lambda: fr.fold(drows)),
                          ("B3 cumsum_rows", lambda: blend.cumsum_rows(rows)),
                          ("torch.cumsum", lambda: torch.cumsum(rows, 0)),
                          ("torch.cumsum column-major",
                           lambda: torch.cumsum(rows.t().contiguous(), 1).t()),
                          ("segment_sums", lambda: fr.segment_sums(cs)),
                          ("B5 blend_tiles_vis", fr.blend_vis)):
            ms, runs = cuda_ms(fn)
            row[stage] = ms
            log({"measure": stage, "frame": tag, "ms": ms, "runs_ms": runs,
                 "card": card})
        # the kernels alone, replayed from a CUDA graph: at the bench frame
        # B4, B3 and the gathers are shorter than their wrappers' host work
        # (checks, allocations, the launch), which CUDA events around one
        # call time instead
        for stage, fn in (("B4 enum_keys graph", fr.enum_keys),
                          ("B1 blend_tiles_fwd graph", fr.blend),
                          ("B3 cumsum_rows graph",
                           lambda: blend.cumsum_rows(rows)),
                          ("segment_sums graph",
                           lambda: fr.segment_sums(cs))):
            row[stage] = graph_ms(fn)
            log({"measure": stage, "frame": tag, "ms": row[stage],
                 "card": card})
        # the plain B5 at 2M evaluates all 2.5 G pairs: 2 runs, no warm-up
        # (check_b5 ran it)
        for stage, fn, reps, warmup in (
                ("B4 plain", fr.enum_keys_plain, 10, 1),
                ("B1 plain", fr.blend_plain, plain_reps, 1),
                ("B2 plain", fr.blend_bwd_plain, plain_reps, 1),
                ("B3 plain", lambda: blend._cumsum_rows_plain(rows), 10, 1),
                ("segment_sums plain", lambda: fr.segment_sums_plain(cs), 10,
                 1),
                ("B5 plain", fr.blend_vis_plain, b5_reps,
                 int(b5_reps > 2))):
            ms, runs = cuda_ms(fn, reps=reps, warmup=warmup)
            row[stage] = ms
            log({"measure": stage, "frame": tag, "ms": ms, "runs_ms": runs,
                 "card": card})
        row["glue"] = row["render"] - sum(
            row[s] for s in ("project", "B4 enum_keys", "sort",
                             "B1 blend_tiles_fwd"))
        b4 = fr.b4_bound(rates)
        b3 = fr.b3_bound(rates)
        fb = fold_bound(cs, fr.binning.enum_start, fr.binning.enum_cnt,
                        rates)
        blends = {k: (fr.blend_bound(k, rates), fr.blend_bound(k, sheet))
                  for k in ("B1", "B2", "B5")}
        log({"measure": "render peak memory", "frame": tag,
             "max_memory_allocated_bytes": peak, "card": card})
        bounds = {"B4": {"bound_ms": b4[0], "bound_by": b4[1],
                         "bytes": b4[2], "ops": b4[3]},
                  "B3": {"bound_ms": b3[0], "bound_by": b3[1],
                         "bytes": b3[2], "ops": b3[3]},
                  "segment_sums": {"bound_ms": fb[0], "bound_by": fb[1],
                                   "bytes": fb[2], "ops": fb[3]}}
        for k, (m, d) in blends.items():
            evals, tested, live = fr.pairs(0.0 if k == "B5"
                                           else RC.early_stop_eps)
            bounds[k] = {
                "bound_ms": m[0], "bound_by": m[1],
                "bound_ms_datasheet": d[0], "bound_by_datasheet": d[1],
                "bytes": m[2], "ops": m[3], "evaluated_pairs": evals,
                "tested_pairs": tested, "live_pairs": live,
                "bytes_ms": m[2] / HBM_BYTES_PER_S * 1e3,
                "f32_ms": m[3] / rates.ops_per_s * 1e3,
                "exp_ms": live / rates.exp_per_s * 1e3,
                "f32_ms_datasheet": m[3] / sheet.ops_per_s * 1e3,
                "exp_ms_datasheet": live / sheet.exp_per_s * 1e3}
        bounds["B1"]["all_pairs"] = (int(fr.counts.sum())
                                     * RC.tile_size ** 2)
        log({"measure": "bounds", "frame": tag, **bounds,
             "rates": rates._asdict(), "rates_datasheet": sheet._asdict(),
             "glue_ms": row["glue"], "card": card})
        results[tag] = (row, b4, b3, fb, blends)

    row, b4, b3, fb, blends = results["2M view 0"]
    del bench, big, fr, rows, drows, cs
    gc.collect()

    # M. the multi-device path: NCCL at one rank, D shards on the card
    t0 = time.perf_counter()
    meshed = mesh_phase(scene, cams[0], device, card)
    log({"phase": "M done", "wall_s": time.perf_counter() - t0})
    sharded_launches = meshed["sharded_launches"]

    # G. the parity gate: the kernels on the card against the dense CPU
    # reference
    parity_launches = parity_phase(card)

    # Q. the training-quality gate at its default widths, cut in iterations
    quality_launches = quality_phase(card)

    # X. the example twins on the card and on the CPU
    example_launches = examples_phase(device, card)

    by_path = {k: {"render": launches[k], "train": train_launches[k],
                   "label": label_launches[k], "render_cli": cli_launches[k],
                   "train_cli": train_cli_launches[k],
                   "cluster": cluster["launches"][k],
                   "view": view_launches[k],
                   "sharded": sharded_launches[k],
                   "parity": parity_launches[k],
                   "quality": quality_launches[k],
                   "examples": example_launches[k],
                   "bench": bench_launches[k],
                   "bench_vote": vote_launches[k]}
               for k in launches}

    def blend_row(k):
        m, d = blends[k]
        return {"bound_ms": m[0], "bound_by": m[1], "bound_ms_datasheet": d[0],
                "bound_by_datasheet": d[1]}

    kernels = [
        {"name": "enum_keys", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/enum_keys.cu",
         "replaces": "gsplat_tpu/render/tiles.py:119",
         "launches": launches["enum_keys"], "max_abs_err": err_b4,
         "ms": row["B4 enum_keys"], "graph_ms": row["B4 enum_keys graph"],
         "plain_ms": row["B4 plain"],
         "bound_ms": b4[0], "bound_by": b4[1], "library_ms": None},
        {"name": "blend_tiles_fwd", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/blend_fwd.cu",
         "replaces": "gsplat_tpu/render/blend_pallas.py:210",
         "launches": launches["blend_tiles_fwd"], "max_abs_err": err_b1,
         "ms": row["B1 blend_tiles_fwd"],
         "graph_ms": row["B1 blend_tiles_fwd graph"],
         "plain_ms": row["B1 plain"],
         **blend_row("B1"), "library_ms": None},
        {"name": "blend_tiles_bwd", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/blend_bwd.cu",
         "replaces": "gsplat_tpu/render/blend_pallas.py:299",
         "launches": train_launches["blend_tiles_bwd"],
         "max_abs_err": err_b2, "ms": row["B2 blend_tiles_bwd"],
         "plain_ms": row["B2 plain"], **blend_row("B2"),
         "library_ms": None},
        {"name": "cumsum_rows", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/cumsum_rows.cu",
         "replaces": "gsplat_tpu/render/blend_pallas.py:534",
         "launches": train_launches["cumsum_rows"], "max_abs_err": err_b3,
         "ms": row["B3 cumsum_rows"], "graph_ms": row["B3 cumsum_rows graph"],
         "plain_ms": row["B3 plain"],
         "bound_ms": b3[0], "bound_by": b3[1],
         "library_ms": min(row["torch.cumsum"],
                           row["torch.cumsum column-major"]),
         "library_ms_dim0": row["torch.cumsum"],
         "library_ms_column_major": row["torch.cumsum column-major"]},
        {"name": "segment_sums", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/fold_segments.cu",
         "replaces": "gsplat_tpu/render/api.py:156-160 (XLA gathers)",
         "launches": train_launches["segment_sums"],
         "max_abs_err": err_fold, "ms": row["segment_sums"],
         "graph_ms": row["segment_sums graph"],
         "plain_ms": row["segment_sums plain"],
         "bound_ms": fb[0], "bound_by": fb[1], "library_ms": None},
        {"name": "fold_rows", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/fold_rows.cu",
         "replaces": "gsplat_tpu/render/api.py:148-161 (XLA glue: the fold "
                     "as a difference of prefix sums)",
         "launches": train_launches["fold_rows"], "max_abs_err": 0.0,
         **fold_rows_rows["m360 training view"], "by_frame": fold_rows_rows,
         "library_ms": None},
        {"name": "project", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/project.cu",
         "replaces": "gsplat_tpu/render/projection.py:project and "
                     "gsplat_tpu/render/sh.py:eval_sh_soa (XLA glue)",
         "launches": launches["project"], "max_abs_err": 0.0,
         **proj_rows["2M view 0"], "by_frame": proj_rows,
         "library_ms": None},
        {"name": "project_bwd", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/project_bwd.cu",
         "replaces": "the VJP of gsplat_tpu/render/projection.py:project "
                     "and sh.py:eval_sh_soa (XLA glue, jax.grad)",
         "launches": train_launches["project_bwd"], "max_abs_err": 0.0,
         **proj_bwd_rows["3000000 SH 3"], "by_frame": proj_bwd_rows,
         "library_ms": None},
        {"name": "blend_tiles_vis", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/blend_vis.cu",
         "replaces": "gsplat_tpu/render/blend_pallas.py:250",
         "launches": label_launches["blend_tiles_vis"],
         "max_abs_err": err_b5, "ms": row["B5 blend_tiles_vis"],
         "plain_ms": row["B5 plain"], **blend_row("B5"),
         "library_ms": None},
    ]
    # "launches" counts each kernel on the path that brought it: the 8-view
    # render for B4, B1 and the projection (XLA glue in the JAX package, no
    # TPU kernel; its row times the 2M view, by_frame every checked frame),
    # the 10 training steps for B2 and the fold (``fold_rows``, XLA glue
    # too; its row times the m360 training view, by_frame both frames; B3
    # and the boundary gathers left the training path with it), the
    # visible-mode label run of 311 views for B5, the roofline report for
    # P1 and the scan probe for P2; every path's counts are in
    # launches_by_path. No single PyTorch call computes B4, B1, B2, B5, the
    # projection, the gathers or the fold (B5's segment max onto gaussians
    # is a scatter_reduce outside the kernel), hence no library time; B3's is
    # the faster of
    # torch.cumsum along dim 0 of the [B, 16] rows (PyTorch's outer-dimension
    # scan) and of the column-major copy along dim 1, the copy included.
    # Bounds take the P1 probes' rates, those of the data sheet beside them.
    for k in kernels:
        k["launches_by_path"] = by_path[k["name"]]
    kernels += probe_rows
    log({"measure": "train step breakdown", "ms": train_row,
         "max_memory_allocated_bytes": train_peak, "card": card})
    log({"measure": "labeling breakdown", "ms": label_times, "card": card})
    log(card)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
