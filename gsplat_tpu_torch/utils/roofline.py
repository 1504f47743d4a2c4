"""The card's peak rates (kernels P1a, P1b) and the least time of the blend
kernels.

Counterpart of ``scripts/roofline.py``, which measures the TPU's f32 FMA
and exp rates with two Pallas probes and derives a speed-of-light (SOL)
frame time for the bench scene. Here the probes are ``csrc/peak_probe.cu``
(:func:`fma_chains`, :func:`expf_chains`) and the SOL is the least time of
kernels B1 (forward) and B2 (backward) on the bench frame, counted from the
port's own binning: the bytes each must move, the f32 operations and the
expf results this frame's data needs (:func:`blend_pairs`,
:func:`blend_bound`). ``chip_smoke.py`` takes its kernel bounds from the
same counts and rates, so the report and the kernel table count work the
same way::

    python -m gsplat_tpu_torch.utils.roofline [--out PATH] [--device cpu]

prints the report and writes it as JSON to ``--out`` (default
``build/roofline_torch.json``). On the CPU the rates are the host's, of the
plain versions: no device rate. The bandwidth is the data sheet's; no probe
measures it.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import statistics
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.config import DEFAULT, Config
from gsplat_tpu_torch.io.cameras import look_at_camera
from gsplat_tpu_torch.io.synthetic import random_scene
from gsplat_tpu_torch.render import blend
from gsplat_tpu_torch.render.api import pack_table
from gsplat_tpu_torch.render.projection import (CameraParams, Projected,
                                                project, tile_grid)
from gsplat_tpu_torch.render.tiles import TileBinning, bin_tiles
from gsplat_tpu_torch.scene import DeviceLike, resolve_device
from gsplat_tpu_torch.utils.profiling import device_timer

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / \
    "roofline_torch.json"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores (an FMA counted as two), and the exp2 results per
# clock per SM of the special-function units on compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction table).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
SFU_PER_CLOCK_PER_SM = 16
# f32 lanes an SM issues one instruction to each clock (compute capability
# 9.0): the peak f32 instruction rate is this x SMs x the SM clock
F32_LANES_PER_SM = 128

# The least work of the blend kernels B1, B2 and B5, as a frame's data
# needs it, in f32 instructions: a multiply feeding an add counts as one
# FMA, as a kernel computing the same function may fuse them (the port's
# kernels are built with -fmad=false only to match their plain versions bit
# for bit). The cut alpha >= alpha_min is a test of q alone (q <= the
# gaussian's 2 ln(opacity / alpha_min)), so only the pairs past the cut need
# an exp; the q test itself is needed only for the pixels inside each
# instance's cutoff box (the projection's ex, ey half-extents). That box
# holds the alpha cut's ellipse only because config.sigma_cutoff = 3.33 >=
# sqrt(2 ln 255) = 3.329, the cutoff at opacity 1 and alpha_min 1/255, and
# only up to float rounding: a pair past the cut outside the box is
# possible at the box's edge, so blend_pairs counts a tested pair as one
# inside the box or past the cut, and the counts hold either way. Per
# tested (instance, pixel) pair: dx, dy (2),
# q = (ca dx + cb2 dy) dx + cc dy dy (5: cb2 dy, fma(ca, dx, .), cc dy,
# its product with dy, fma(., dx, .)) and the compare (1); per live pair
# (alpha past the cut): -q/2, the opacity product
# and the clamp (3), and for B1 the weight (1), RGB accumulation (3 FMAs),
# the label test (1) and the T update (1).
Q_TEST_OPS = 8
ALPHA_OPS = 3
B1_OPS_PER_LIVE = 6
# per live (instance, pixel) pair of B2, counted from csrc/blend_bwd.cu
# past the q test and alpha: the weight (1), c.dC (3), the contribution and
# prefix (2), the suffix (1), 1 - alpha and the ratio (2), dq with its clamp
# test (3), the dq.dx / dq.dy products (2), the six moment sums (6), the
# colour sums (3) and the T update (1)
B2_OPS_PER_LIVE = 24
# B5 is B1 plus the max of each live weight into its instance's row
B5_OPS_PER_LIVE = B1_OPS_PER_LIVE + 1
# per bbox slot of B4: the rectangle test (4 edge minima of 9 instructions,
# 4 offsets, 4 compares, 2 floors, 3 minima) plus the tile origin and the
# cut (5)
B4_OPS_PER_SLOT = 54
OPS_PER_LIVE = {"B1": B1_OPS_PER_LIVE, "B2": B2_OPS_PER_LIVE,
                "B5": B5_OPS_PER_LIVE}

# The probes: scripts/roofline.py's chains (8 per element, 48 FMA or 6 exp
# steps, a = 1.0000001, b = 1e-7, exp scale 1e-3) on an [8, 256] block.
CHAINS = 8
FMA_STEPS = 48
EXP_STEPS = 6
FMA_A = 1.0000001
FMA_B = 1e-7
EXP_SCALE = 1e-3
PROBE_ELEMS = 8 * 256
THREADS = 256
# 8 blocks of 256 threads fill an SM (64 warps); one timed launch lasts
# about TARGET_S; the rates are the median of SAMPLES launches
BLOCKS_PER_SM = 8
TARGET_S = 2e-3
SAMPLES = 5
# seconds of FMA chain launches queued while nvidia-smi reads the SM clock
LOAD_S = 1.5
# f32 instructions of one expf chain step besides the expf itself, charged at
# the FMA rate: the SASS of c <- expf(-|c| a) folds the negated |c| into the
# one FMUL by a as operand modifiers (cuobjdump -sass of csrc/peak_probe.cu),
# so a step is that FMUL and the expf's own 8 instructions
EXP_STEP_OPS = 1
_WHICH = {"fma": 0, "expf": 1}


def _chains_plain(x: torch.Tensor, which: str, blocks: int, iters: int,
                  a: float, b: float) -> torch.Tensor:
    """Plain PyTorch version of the probes: thread t's 8 chains start at
    x[t % n] (1 + s i) and take ``iters`` rounds of the steps; the FMA step
    rounds once (the product and sum in f64, exact but for a rare double
    rounding, then one rounding to f32), the exp step as the kernel's
    expf(-|c| a); the chains are summed in order."""
    steps, start = (FMA_STEPS, 1e-6) if which == "fma" else (EXP_STEPS, 1e-3)
    dev = x.device
    xv = x[torch.arange(blocks * THREADS, device=dev) % x.shape[0]]
    factors = torch.tensor([1.0 + start * i for i in range(CHAINS)],
                           dtype=torch.float32, device=dev)
    c = xv[None, :] * factors[:, None]
    if which == "fma":
        a64 = torch.tensor(a, dtype=torch.float32).double().to(dev)
        b64 = torch.tensor(b, dtype=torch.float32).double().to(dev)
        for _ in range(iters * steps):
            c = (c.double() * a64 + b64).float()
    else:
        scale = torch.tensor(a, dtype=torch.float32, device=dev)
        for _ in range(iters * steps):
            c = torch.exp(-c.abs() * scale)
    acc = c[0]
    for i in range(1, CHAINS):
        acc = acc + c[i]
    return acc


def _launch_chains(wrapper, which: str, x: torch.Tensor, blocks: int,
                   iters: int, a: float, b: float) -> torch.Tensor:
    if x.dtype != torch.float32 or x.dim() != 1 or x.numel() == 0 or \
            not x.is_contiguous():
        raise ValueError(f"{wrapper.__name__} takes a contiguous non-empty "
                         "f32 [n] input")
    if blocks < 1 or iters < 1:
        raise ValueError(f"{wrapper.__name__} needs blocks >= 1, iters >= 1")
    dev = x.device
    if dev.type == "cpu":
        return _chains_plain(x, which, blocks, iters, a, b)
    if dev.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: no kernel for {dev}")
    out = torch.empty(blocks * THREADS, device=dev)
    fn = _kernels.function("peak_probe")
    err = fn(_WHICH[which], x.data_ptr(), x.numel(), out.data_ptr(), blocks,
             iters, a, b, _kernels.stream(dev))
    wrapper.launches += 1
    _kernels.check("peak_probe", err)
    return out


def fma_chains(x: torch.Tensor, *, blocks: int, iters: int,
               a: float = FMA_A, b: float = FMA_B) -> torch.Tensor:
    """Kernel P1a wrapper: [blocks * 256] f32, thread t's 8 chains of
    ``iters`` x 48 steps c <- c a + b from x[t % n] (1 + 1e-6 i), summed.

    Replaces ``scripts/roofline.py::_fma_kernel``. On the card it launches
    ``csrc/peak_probe.cu`` (``__fmaf_rn``: one instruction a step under
    -fmad=false; bound by operations); CPU tensors take the plain
    version."""
    return _launch_chains(fma_chains, "fma", x, blocks, iters, a, b)


fma_chains.launches = 0


def expf_chains(x: torch.Tensor, *, blocks: int, iters: int,
                scale: float = EXP_SCALE) -> torch.Tensor:
    """Kernel P1b wrapper: [blocks * 256] f32, thread t's 8 chains of
    ``iters`` x 6 steps c <- expf(-|c| scale) from x[t % n] (1 + 1e-3 i),
    summed.

    Replaces ``scripts/roofline.py::_exp_kernel``. On the card it launches
    ``csrc/peak_probe.cu`` (IEEE expf under the blend kernels' flags; bound
    by operations); CPU tensors take the plain version."""
    return _launch_chains(expf_chains, "expf", x, blocks, iters, scale, 0.0)


expf_chains.launches = 0


def _time_launch(fn, x: torch.Tensor, blocks: int) -> tuple:
    """(iters, median seconds): ``iters`` grown until one launch lasts
    about TARGET_S, then SAMPLES launches timed."""
    iters = 1

    def seconds():
        return device_timer(lambda xx, c: fn(xx, blocks=blocks, iters=iters),
                            (x,), iters=1)

    t = seconds()
    while t < 0.5 * TARGET_S:
        iters = max(iters + 1, min(64 * iters,
                                   math.ceil(iters * TARGET_S / t)))
        t = seconds()
    return iters, statistics.median(seconds() for _ in range(SAMPLES))


def _sm_clock_under_load(x: torch.Tensor, blocks: int, iters: int,
                         t_launch: float) -> tuple:
    """(SM MHz, power) that nvidia-smi reads while about LOAD_S of FMA
    chain launches (of about 20 ms each) are queued on the card; (None,
    None) without nvidia-smi or when the queue ran dry before the read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None, None
    scale = max(1, round(0.02 / t_launch))
    for _ in range(math.ceil(LOAD_S / (t_launch * scale))):
        fma_chains(x, blocks=blocks, iters=iters * scale)
    done = torch.cuda.Event()
    done.record()
    index = x.device.index if x.device.index is not None else \
        torch.cuda.current_device()
    out = subprocess.run(
        [smi, "-i", str(index), "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    loaded = not done.query()
    done.synchronize()
    mhz, power = out.strip().splitlines()[0].split(",")
    return (float(mhz), power.strip()) if loaded else (None, None)


def pure_expf_rate(exps: int, t_exp: float, fma_rate: float) -> float:
    """expf results per second of an expf chain launch that computed
    ``exps`` results in ``t_exp`` seconds, once each step's EXP_STEP_OPS
    other f32 instructions are charged at ``fma_rate``."""
    return exps / max(t_exp - exps * EXP_STEP_OPS / fma_rate, 1e-9)


def measure_peaks(device: DeviceLike = None) -> dict:
    """The device's f32 FMA rate and IEEE expf rate from the P1 probes:
    each the counted operations of one launch over its median time.

    ``fma_per_s`` counts FMA instructions, ``f32_flops_per_s`` is twice
    that. ``expf_per_s`` is :func:`pure_expf_rate`: the expf chain's
    results per second once each step's one other instruction (the product
    with the folded -|c|, EXP_STEP_OPS) is charged at the FMA rate. On the
    card,
    ``f32_issue_per_s`` is 128 lanes x SMs x the SM clock that nvidia-smi
    reads under the FMA chain's load (None where it cannot)."""
    device = resolve_device(device)
    x = torch.ones(PROBE_ELEMS, device=device)
    blocks = BLOCKS_PER_SM
    mhz = power = issue = None
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        blocks *= sms
    threads = blocks * THREADS
    fma_iters, t_fma = _time_launch(fma_chains, x, blocks)
    fma_rate = threads * CHAINS * FMA_STEPS * fma_iters / t_fma
    if device.type == "cuda":
        mhz, power = _sm_clock_under_load(x, blocks, fma_iters, t_fma)
        if mhz is not None:
            issue = F32_LANES_PER_SM * sms * mhz * 1e6
    exp_iters, t_exp = _time_launch(expf_chains, x, blocks)
    exps = threads * CHAINS * EXP_STEPS * exp_iters
    return dict(
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu (plain versions; not a device rate)"),
        blocks=blocks, threads=threads,
        fma_iters=fma_iters, fma_launch_s=t_fma,
        expf_iters=exp_iters, expf_launch_s=t_exp,
        fma_per_s=fma_rate, f32_flops_per_s=2.0 * fma_rate,
        expf_per_s=pure_expf_rate(exps, t_exp, fma_rate),
        sm_mhz_under_load=mhz, power_w_under_load=power,
        f32_issue_per_s=issue)


class Rates(NamedTuple):
    """Peak rates a bound divides work by."""

    ops_per_s: float   # f32 instructions, an FMA one
    exp_per_s: float   # expf results


def measured_rates(peaks: dict) -> Rates:
    """The card's peaks from the P1 probes (:func:`measure_peaks`): f32
    instructions at the larger of the FMA chain's rate and the issue rate
    under load, expf results at the exp chain's rate."""
    return Rates(max(peaks["fma_per_s"], peaks["f32_issue_per_s"] or 0.0),
                 peaks["expf_per_s"])


def datasheet_rates(sms: int, max_sm_mhz: float) -> Rates:
    """The data sheet's: 67 TFLOP/s, an FMA two FLOPs, so 33.5 T f32
    instructions/s, and one exp per special-function result at the maximum
    SM clock."""
    return Rates(F32_FLOPS / 2, SFU_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6)


def bound(nbytes: int, ops: int, exps: int, rates: Rates) -> tuple:
    """(bound_ms, bound_by, bytes, ops): the larger of the bytes over the
    HBM rate and the operations over their rate (f32 operations, or the
    expf results where those take longer)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / rates.ops_per_s * 1e3, exps / rates.exp_per_s * 1e3)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def blend_pairs(ptab: torch.Tensor, binning: TileBinning, proj: Projected, *,
                tiles_x: int, tiles_y: int, tile_size: int, chunk: int,
                alpha_min: float, alpha_max: float, eps: float) -> tuple:
    """(evaluated, tested, live) instance-pixel pairs of B1 under early
    stop ``eps`` (B2 walks the same batches; B5 is eps 0): replays the
    kernel's tile-wide stop rule (a batch runs only while the tile's max T
    >= eps) on T alone, step by step as the plain version composites, and
    counts the pairs of the batches that run, those of them inside the
    instance's cutoff box (or past the cut), and those whose alpha passes
    the cut."""
    num_tiles = tiles_x * tiles_y
    b = binning.tile_bounds
    start, cnt = b[:-1].long(), (b[1:] - b[:-1]).long()
    ts = tile_size
    dev = ptab.device
    pid = torch.arange(ts * ts, device=dev)
    px = ((pid % ts).float() + 0.5)[None, :]
    py = ((pid // ts).float() + 0.5)[None, :]
    tid = torch.arange(num_tiles, device=dev)
    x0f = ((tid % tiles_x) * ts).float()[:, None]
    y0f = ((tid // tiles_x) * ts).float()[:, None]
    trans = torch.ones(num_tiles, ts * ts, device=dev)
    alive = torch.ones(num_tiles, dtype=torch.bool, device=dev)
    evaluated = torch.zeros((), dtype=torch.int64, device=dev)
    tested = torch.zeros((), dtype=torch.int64, device=dev)
    live_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    last = max(binning.inst_gauss.shape[0] - 1, 0)
    steps = int(cnt.max()) if num_tiles else 0
    for step in range(steps):
        if step % chunk == 0:
            alive = alive & (trans.amax(dim=1) >= eps)
        run = alive & (step < cnt)
        g = binning.inst_gauss[torch.clamp(start + step, max=last)].long()
        row = ptab[g]
        dx = px - (row[:, blend.P_MX, None] - x0f)
        dy = py - (row[:, blend.P_MY, None] - y0f)
        q = ((row[:, blend.P_CA, None] * dx
              + (2.0 * row[:, blend.P_CB, None]) * dy) * dx
             + row[:, blend.P_CC, None] * dy * dy)
        alpha = torch.clamp_max(
            row[:, blend.P_OP, None] * torch.exp(-0.5 * q), alpha_max)
        cut = (alpha >= alpha_min) & run[:, None]
        inbox = ((dx.abs() <= proj.ex[g, None])
                 & (dy.abs() <= proj.ey[g, None]))
        alpha = torch.where(cut, alpha, torch.zeros_like(alpha))
        trans = trans * (1.0 - alpha)
        evaluated += run.sum() * (ts * ts)
        tested += ((inbox & run[:, None]) | cut).sum()
        live_pairs += cut.sum()
    return int(evaluated), int(tested), int(live_pairs)


def blend_bytes(kernel: str, n: int, b: int, num_tiles: int, width: int,
                height: int) -> int:
    """Bytes kernel ``kernel`` (B1, B2 or B5) must move: each input read
    once (the [N, 16] table, the [B] instance indices, the tile bounds; for
    B2 also rgb, T and their cotangents) and each output written once (B1:
    rgb, T, best weight and label; B5: those and the [B] rows; B2: the
    [B, 16] rows)."""
    common = n * 16 * 4 + b * 4 + (num_tiles + 1) * 4
    if kernel == "B2":
        return common + width * height * 8 * 4 + b * 16 * 4
    extra = b * 4 if kernel == "B5" else 0
    return common + width * height * 6 * 4 + extra


def blend_bound(kernel: str, pairs: tuple, n: int, b: int, num_tiles: int,
                width: int, height: int, rates: Rates) -> tuple:
    """:func:`bound` of blend kernel ``kernel`` on a frame whose
    (evaluated, tested, live) pairs are ``pairs``: the q test per tested
    pair, alpha and the kernel's operations per live pair, one expf per live
    pair."""
    _, tested, live = pairs
    ops = tested * Q_TEST_OPS + live * (ALPHA_OPS + OPS_PER_LIVE[kernel])
    return bound(blend_bytes(kernel, n, b, num_tiles, width, height), ops,
                 live, rates)


def frame_pairs(device: torch.device, *, gaussians: int = 100_000,
                width: int = 800, height: int = 608,
                cfg: Config = DEFAULT) -> dict:
    """The bench frame (``bench.py``'s scene: ``gaussians`` gaussians, seed
    0, scales 0.004-0.02, from (0, 0, -3) at ``width`` x ``height``) binned
    by the port under ``cfg``: its tight instance count, tile grid and
    (evaluated, tested, live) pairs (:func:`blend_pairs`)."""
    rc = cfg.raster
    scene = random_scene(gaussians, seed=0, extent=1.5,
                         scale_range=(0.004, 0.02), num_labels=16,
                         device=device)
    cam = look_at_camera((0, 0, -3.0), (0, 0, 0), width=width, height=height)
    proj = project(scene, CameraParams.from_camera(cam, device), width,
                   height, rc, z_near=cfg.camera.z_near,
                   z_far=cfg.camera.z_far)
    tx, ty = tile_grid(width, height, rc.tile_size)
    binning = bin_tiles(proj, tiles_x=tx, tiles_y=ty, tile_size=rc.tile_size)
    ptab = pack_table(proj, scene.labels)
    pairs = blend_pairs(ptab, binning, proj, tiles_x=tx, tiles_y=ty,
                        tile_size=rc.tile_size, chunk=cfg.tiles.chunk,
                        alpha_min=rc.alpha_min, alpha_max=rc.alpha_max,
                        eps=rc.early_stop_eps)
    return dict(frame=dict(gaussians=gaussians, width=width, height=height,
                           tight_instances=int(binning.num_instances)),
                instances=binning.inst_gauss.numel(), tiles=tx * ty,
                pairs=pairs)


def frame_report(peaks: dict, device: torch.device, *,
                 gaussians: int = 100_000, width: int = 800,
                 height: int = 608, cfg: Config = DEFAULT) -> dict:
    """The SOL report: the bench frame of :func:`frame_pairs` (by default
    ``bench.py``'s, 100k gaussians at 800x608), its pairs counted, and B1's
    and B2's bounds at the measured rates."""
    counted = frame_pairs(device, gaussians=gaussians, width=width,
                          height=height, cfg=cfg)
    pairs = counted["pairs"]
    rates = measured_rates(peaks)
    args = (pairs, gaussians, counted["instances"], counted["tiles"], width,
            height, rates)
    fwd, bwd = blend_bound("B1", *args), blend_bound("B2", *args)
    t_frame = (fwd[0] + bwd[0]) * 1e-3
    return dict(
        backend=peaks["device"],
        fma_per_s=peaks["fma_per_s"],
        f32_flops_per_s=peaks["f32_flops_per_s"],
        expf_per_s=peaks["expf_per_s"],
        sm_mhz_under_load=peaks["sm_mhz_under_load"],
        f32_ops_per_s=rates.ops_per_s,
        hbm_bytes_per_s=HBM_BYTES_PER_S,
        q_test_ops_per_tested_pair=Q_TEST_OPS,
        fwd_ops_per_live_pair=ALPHA_OPS + B1_OPS_PER_LIVE,
        bwd_ops_per_live_pair=ALPHA_OPS + B2_OPS_PER_LIVE,
        expf_per_live_pair=1,
        frame=counted["frame"],
        pairs=dict(zip(("evaluated", "tested", "live"), pairs)),
        sol_fwd_ms=fwd[0], sol_fwd_bound_by=fwd[1],
        sol_bwd_ms=bwd[0], sol_bwd_bound_by=bwd[1],
        sol_frame_ms=t_frame * 1e3,
        sol_mpix_per_s=width * height / t_frame / 1e6,
        peaks=peaks,
        note="SOL of the blend kernels B1 and B2 alone on the bench frame: "
             "for each the larger of its bytes at the data sheet's HBM rate "
             "and its f32 operations and expf results at the measured "
             "rates; binning, projection and the fold excluded.")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="where to write the report as JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    peaks = measure_peaks(device)
    report = frame_report(peaks, device)
    print(json.dumps(report, indent=1))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
