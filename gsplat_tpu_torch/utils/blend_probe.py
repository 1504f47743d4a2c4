"""Where the time of the blend kernels B5 and B2 goes on the card.

    python -m gsplat_tpu_torch.utils.blend_probe [--out PATH]

On ``chip_smoke.py``'s 2M frame (2,000,000 gaussians of ``random_scene``
seed 0, view 0 of 8 orbit views at 800x608) it prints one JSON line per
measurement and writes them all to ``--out`` (default
``build/blend_probe.json``):

- ``tiles``: instances a tile;
- ``skip``: what the skip test of ``csrc/blend_cull.cuh`` keeps, counted
  on the card with its plain mirror (``render.blend._cull_rect_skip``):
  instances a 16x16 sub-tile keeps (B5's blocks), and (instance, warp
  strip) pairs for B5's 16x2 strips and B2's 32x4 ones;
- ``blocks``: per block of B5 and B2, the global timer at entry and exit,
  from builds of ``csrc/blend_vis.cu`` and ``csrc/blend_bwd.cu`` with those
  two reads added: durations, the blocks that start after the first wave,
  and the span;
- ``variants``: B2 built with the row-major lane map and without its
  register cap, each held against the committed build and timed in turns
  with it (CUDA events, median of 10).

Needs the card and ``nvcc``; the builds go to ``build/blend_probe/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.config import DEFAULT
from gsplat_tpu_torch.io.cameras import orbit_cameras
from gsplat_tpu_torch.io.synthetic import random_scene
from gsplat_tpu_torch.render import blend
from gsplat_tpu_torch.render.api import pack_table
from gsplat_tpu_torch.render.projection import (CameraParams, project,
                                                tile_grid)
from gsplat_tpu_torch.render.tiles import bin_tiles

BUILD = _kernels.BUILD_DIR.parent / "blend_probe"
DEFAULT_OUT = _kernels.BUILD_DIR.parent / "blend_probe.json"
WIDTH, HEIGHT = 800, 608

# the two reads of the global timer (ns) and the SM id, added to a copy of
# a kernel's source: at entry, after `lane`, and before its stores
PROBE_DECLS = r'''
namespace {
__device__ unsigned long long g_probe[3 * 65536];
__device__ __forceinline__ unsigned long long probe_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned probe_sm() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
}  // namespace
extern "C" int probe_read(void* dst, int blocks) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, g_probe, static_cast<size_t>(blocks) * 3 * 8));
}
'''
PROBE_ENTRY = "  const unsigned long long probe_t0 = probe_clock();\n"
PROBE_EXIT = ("  if (threadIdx.x == 0) {\n"
              "    g_probe[3 * blockIdx.x] = probe_t0;\n"
              "    g_probe[3 * blockIdx.x + 1] = probe_clock();\n"
              "    g_probe[3 * blockIdx.x + 2] = probe_sm();\n"
              "  }\n")
LANE = "  const int lane = threadIdx.x & 31;\n"
EXITS = {"blend_vis": "  if (!on) return;",
         "blend_bwd": "  // rows of the batches early stop skipped"}
B2_PATCHES = "  const bool patches = tile_size % 8 == 0;"
B2_CAP = "__launch_bounds__(kThreads, 4)"


def _edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"source no longer holds {old!r}")
    return text.replace(old, new, 1)


def _load(tag: str, name: str, text: str):
    """Build ``text`` (a variant of csrc/<name>.cu) and load its entry."""
    BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD / f"{tag}.cu", BUILD / f"{tag}.so"
    src.write_text(text)
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC),
           "-o", str(lib), str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on {tag}:\n{out.stderr}")
    so = ctypes.CDLL(str(lib))
    symbol, argtypes = _kernels.SIGNATURES[name]
    fn = getattr(so, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    info = [line.strip() for line in (out.stdout + out.stderr).splitlines()
            if "registers" in line or "spill" in line]
    return so, fn, info


class _Swap:
    """Route a blend wrapper to another build of its kernel."""

    def __init__(self, name, fn):
        self.name, self.fn = name, fn

    def __enter__(self):
        _kernels.function(self.name)
        self.saved = _kernels._functions[self.name]
        _kernels._functions[self.name] = self.fn

    def __exit__(self, *exc):
        _kernels._functions[self.name] = self.saved


def _ms(fn, reps: int = 10) -> float:
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
    return statistics.median(times)


def _summary(x: torch.Tensor) -> dict:
    x = x.double().flatten()
    return {"n": x.numel(), "max": float(x.max()), "mean": float(x.mean()),
            "median": float(x.median()),
            "p99": float(torch.quantile(x, 0.99)), "min": float(x.min())}


class _Frame:
    """The 2M frame: projection, binning, table, and B2's inputs."""

    def __init__(self, device):
        cfg = DEFAULT
        rc = cfg.raster
        scene = random_scene(2_000_000, seed=0, extent=1.5,
                             scale_range=(0.002, 0.008), num_labels=16,
                             device=device)
        cam = orbit_cameras(8, 3.0, width=WIDTH, img_height=HEIGHT)[0]
        self.proj = project(scene, CameraParams.from_camera(cam, device),
                            WIDTH, HEIGHT, rc, z_near=cfg.camera.z_near,
                            z_far=cfg.camera.z_far)
        self.tx, self.ty = tile_grid(WIDTH, HEIGHT, rc.tile_size)
        self.binning = bin_tiles(self.proj, tiles_x=self.tx, tiles_y=self.ty,
                                 tile_size=rc.tile_size)
        self.ptab = pack_table(self.proj, scene.labels)
        self.kw = dict(tiles_x=self.tx, tiles_y=self.ty,
                       tile_size=rc.tile_size, width=WIDTH, height=HEIGHT,
                       chunk=cfg.tiles.chunk, alpha_min=rc.alpha_min,
                       alpha_max=rc.alpha_max)
        fwd = blend.blend_tiles_fwd(self.ptab, self.binning.inst_gauss,
                                    self.binning.tile_bounds, **self.kw,
                                    early_eps=rc.early_stop_eps,
                                    with_labels=False)
        gen = torch.Generator(device=device).manual_seed(11)
        self.bwd_args = (fwd.rgb, fwd.transmittance,
                         torch.randn(HEIGHT, WIDTH, 3, generator=gen,
                                     device=device),
                         torch.randn(HEIGHT, WIDTH, generator=gen,
                                     device=device))
        self.eps = rc.early_stop_eps

    def vis(self):
        return blend.blend_tiles_vis(self.ptab, self.binning.inst_gauss,
                                     self.binning.tile_bounds, **self.kw,
                                     with_labels=True)

    def bwd(self):
        return blend.blend_tiles_bwd(self.ptab, self.binning.inst_gauss,
                                     self.binning.tile_bounds,
                                     *self.bwd_args, **self.kw,
                                     early_eps=self.eps)


def skip_counts(fr: _Frame) -> dict:
    """What the skip test keeps on this frame, by its plain mirror."""
    b = fr.binning.tile_bounds
    counts = (b[1:] - b[:-1]).long()
    tight = int(b[-1])
    tile = torch.repeat_interleave(
        torch.arange(counts.numel(), device=b.device), counts)
    row = fr.ptab[fr.binning.inst_gauss[:tight].long()]
    ts = fr.kw["tile_size"]
    mx = row[:, blend.P_MX] - ((tile % fr.tx) * ts).float()
    my = row[:, blend.P_MY] - ((tile // fr.tx) * ts).float()
    args = (mx, my, row[:, blend.P_CA], row[:, blend.P_CB],
            row[:, blend.P_CC],
            blend._cull_q_cut(row[:, blend.P_OP], fr.kw["alpha_min"]))
    c = lambda v: torch.tensor(v + 0.5, device=b.device)

    def kept(x0, x1, y0, y1):
        return ~blend._cull_rect_skip(*args, c(x0), c(x1), c(y0), c(y1))

    sub = torch.stack([kept(sx, sx + 15, sy, sy + 15)
                       for sy in (0, 16) for sx in (0, 16)], 1)
    per_sub = torch.zeros(counts.numel(), 4, device=b.device)
    per_sub.index_add_(0, tile, sub.float())
    b5 = sum(kept(sx, sx + 15, sy + r, sy + r + 1).long()
             for sy in (0, 16) for sx in (0, 16) for r in range(0, 16, 2))
    b2 = sum(kept(0, ts - 1, r, r + 3).long() for r in range(0, ts, 4))
    return {"instances": tight, "subtile_share_kept": float(sub.float().mean()),
            "kept_per_subtile": _summary(per_sub),
            "b5_strip_pairs_per_instance": float(b5.double().mean()),
            "b2_strip_pairs_per_instance": float(b2.double().mean())}


def block_times(fr: _Frame, name: str, call, blocks: int) -> dict:
    """Per-block entry and exit times of a probe build of ``name``."""
    text = (_kernels.CSRC / f"{name}.cu").read_text()
    text = _edit(text, "#include <cuda_runtime.h>\n",
                 "#include <cuda_runtime.h>\n" + PROBE_DECLS)
    text = _edit(text, LANE, LANE + PROBE_ENTRY)
    text = _edit(text, EXITS[name], PROBE_EXIT + EXITS[name])
    so, fn, info = _load(f"{name}_probe", name, text)
    with _Swap(name, fn):
        call()
        torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (3 * blocks))()
    _kernels.check("probe_read", so.probe_read(buf, blocks))
    t = torch.tensor(list(buf), dtype=torch.float64).reshape(blocks, 3)
    start = (t[:, 0] - t[:, 0].min()) / 1e6
    end = (t[:, 1] - t[:, 0].min()) / 1e6
    return {"kernel": name, "build": info, "blocks": blocks,
            "block_ms": _summary(end - start),
            "blocks_starting_after_0.1_ms": int((start > 0.1).sum()),
            "last_start_ms": float(start.max()), "span_ms": float(end.max()),
            "sms": len(set(t[:, 2].long().tolist()))}


def b2_variants(fr: _Frame) -> list:
    """B2's lane map and register cap, each against the committed build."""
    base = fr.bwd()
    committed = _ms(fr.bwd)
    text = (_kernels.CSRC / "blend_bwd.cu").read_text()
    rows = []
    for tag, old, new in (
            ("row-major lane map", B2_PATCHES,
             "  const bool patches = false;"),
            ("no register cap", B2_CAP, "__launch_bounds__(kThreads)")):
        _, fn, info = _load(tag.replace(" ", "_"), "blend_bwd",
                            _edit(text, old, new))
        with _Swap("blend_bwd", fn):
            got = fr.bwd()
        peak = base[:, :9].abs().amax(0).clamp_min(1e-30)
        err = float(((got[:, :9] - base[:, :9]).abs().amax(0) / peak).max())
        times = {"variant": [], "committed": []}
        for side in ("variant", "committed", "committed", "variant",
                     "variant", "committed"):
            if side == "variant":
                with _Swap("blend_bwd", fn):
                    times[side].append(_ms(fr.bwd))
            else:
                times[side].append(_ms(fr.bwd))
        rows.append({"variant": tag, "build": info,
                     "max_err_over_column_peak": err, "ms": times,
                     "committed_ms_before": committed})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("blend_probe: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    _kernels.build(("enum_keys", "blend_fwd", "blend_bwd", "blend_vis"))
    fr = _Frame(device)
    b = fr.binning.tile_bounds
    report = {"device": torch.cuda.get_device_name(0),
              "occupancy": {n: _kernels.occupancy(n)
                            for n in ("blend_vis", "blend_bwd")},
              "tiles": _summary(b[1:] - b[:-1]),
              "skip": skip_counts(fr)}
    nsub = math.ceil(fr.kw["tile_size"] / 16) ** 2
    report["blocks"] = [
        block_times(fr, "blend_vis", fr.vis, fr.tx * fr.ty * nsub),
        block_times(fr, "blend_bwd", fr.bwd, fr.tx * fr.ty)]
    report["variants"] = b2_variants(fr)
    for key, value in report.items():
        print(json.dumps({key: value}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
