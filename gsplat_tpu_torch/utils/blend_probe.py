"""Where the time of the blend kernels B1, B5 and B2, of the key
enumeration B4 and of the prefix sum B3 goes on the card.

    python -m gsplat_tpu_torch.utils.blend_probe [--out PATH]
        [--b3-source PATH]

On ``chip_smoke.py``'s 2M frame (2,000,000 gaussians of ``random_scene``
seed 0, view 0 of 8 orbit views at 800x608) it prints one JSON line per
measurement and writes them all to ``--out`` (default
``build/blend_probe.json``):

- ``tiles``: instances a tile;
- ``skip``: what the skip test of ``csrc/blend_cull.cuh`` keeps, counted
  on the card with its plain mirror (``render.blend._cull_rect_skip``):
  instances a 16x16 sub-tile keeps (B5's blocks), and (instance, warp
  strip) pairs for B5's 16x2 strips and B2's 32x4 ones;
- ``split``: the tiles B1 splits on this frame, their segments and the
  segments its merge walks again (``render.blend.split_counts`` over one
  call), and its segment length;
- ``blocks``: per block of B1, B5 and B2, the global timer at entry and
  exit, from builds of ``csrc/blend_fwd.cu``, ``csrc/blend_vis.cu`` and
  ``csrc/blend_bwd.cu`` with those two reads added: durations, the blocks
  that start after the first wave, and the span (B1's grid holds its
  segment blocks);
- ``variants``: B1 and B2 built with the row-major lane map and without
  their register cap, each held against the committed build (B1 bit for
  bit) and timed in turns with it (CUDA events, median of 10);
- ``enum_variants``: B4 at this frame and at the bench frame (``bench.py``'s
  100k scene) against builds of ``csrc/enum_keys.cu`` that walk each
  gaussian's bbox in one thread (the design B4 had before its slot-parallel
  one) and that store nothing, timed in turns with the committed build;
- ``b3_variants``: B3 at the bench frame's and this frame's fold sizes
  (198,762 and 2,493,215 rows of seeded random rows) against builds of
  ``csrc/cumsum_rows.cu`` whose look-back polls one item at a time with
  acquire loads and publishes after a ``__threadfence()`` (bit-equal to
  the committed build), and that skip the look-back (wrong sums: the
  floor of the tile walk alone), and against ``--b3-source`` (another B3
  source with the same C entry point, e.g. an earlier design from git
  history, held against float64), timed in turns with the committed build
  as CUDA graph replays and under CUDA events, beside a copy of the array
  (``clone``).

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
from gsplat_tpu_torch.io.cameras import look_at_camera, orbit_cameras
from gsplat_tpu_torch.io.synthetic import random_scene
from gsplat_tpu_torch.render import blend
from gsplat_tpu_torch.render.api import pack_table
from gsplat_tpu_torch.render.projection import (CameraParams, project,
                                                tile_grid)
from gsplat_tpu_torch.render.tiles import (bin_tiles, depth_qkeys,
                                           depth_shift, enum_keys,
                                           tile_bboxes)
from gsplat_tpu_torch.utils.profiling import graph_ms

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
# the line after which a kernel's timer starts, and the one before which it
# stops (B1's blocks leave from its body: its kernel wraps the body)
ENTRIES = {"blend_fwd": "    blend_fwd_kernel(const FwdArgs a) {\n",
           "blend_vis": LANE, "blend_bwd": LANE}
EXITS = {"blend_fwd": "  // the block's end",
         "blend_vis": "  if (!on) return;",
         "blend_bwd": "  // rows of the batches early stop skipped"}
# build variants of B1 and B2: (tag, text in the source, replacement)
BLEND_VARIANTS = (
    ("row-major lane map", "  const bool patches = tile_size % 8 == 0;",
     "  const bool patches = false;"),
    ("no register cap", "__launch_bounds__(kThreads, 4)",
     "__launch_bounds__(kThreads)"))
# build variants of B4: its slot loop as one thread per gaussian walking the
# bbox serially, and its stores behind a test that never holds
B4_LOOP = """  for (int slot = s.off[0] + t; slot < end; slot += kThreads) {
    // the last gaussian j < nb whose offset is <= slot
    int j = 0;
#pragma unroll
    for (int step = kThreads / 2; step > 0; step >>= 1) {
      if (j + step < nb && s.off[j + step] <= slot) j += step;
    }
"""
B4_SERIAL = """  const int j = t;
  const int jend = t < nb ? (t + 1 < nb ? s.off[t + 1] : end) : 0;
  for (int slot = t < nb ? s.off[t] : 0; slot < jend; ++slot) {
"""
B4_STORES = """    keys[slot] = (tile << db) | s.qd[j];
    gauss[slot] = g0 + j;
"""
B4_NO_STORES = """    if (tile < 0) {
      keys[slot] = (tile << db) | s.qd[j];
      gauss[slot] = g0 + j;
    }
"""


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

    def fwd(self, with_labels=True):
        return blend.blend_tiles_fwd(self.ptab, self.binning.inst_gauss,
                                     self.binning.tile_bounds, **self.kw,
                                     early_eps=self.eps,
                                     with_labels=with_labels)

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
    text = _edit(text, ENTRIES[name], ENTRIES[name] + PROBE_ENTRY)
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


def _in_turns(variant_fn, call, timer=_ms) -> dict:
    """Times (ms, by ``timer``) of ``call`` through ``variant_fn`` and
    through the committed build, in turns: variant, committed, committed,
    variant, variant, committed."""
    times = {"variant": [], "committed": []}
    for side in ("variant", "committed", "committed", "variant", "variant",
                 "committed"):
        if side == "variant":
            with _Swap(*variant_fn):
                times[side].append(timer(call))
        else:
            times[side].append(timer(call))
    return times


def blend_variants(fr: _Frame, name: str) -> list:
    """B1's or B2's lane map and register cap, each against the committed
    build: B1 bit for bit, B2 within each column's peak."""
    call = fr.fwd if name == "blend_fwd" else fr.bwd
    base = call()
    committed = _ms(call)
    text = (_kernels.CSRC / f"{name}.cu").read_text()
    rows = []
    for tag, old, new in BLEND_VARIANTS:
        _, fn, info = _load(f"{name}_{tag.replace(' ', '_')}", name,
                            _edit(text, old, new))
        with _Swap(name, fn):
            got = call()
        if name == "blend_fwd":
            agree = {"bit_equal": all(torch.equal(a, b)
                                      for a, b in zip(got, base))}
        else:
            peak = base[:, :9].abs().amax(0).clamp_min(1e-30)
            agree = {"max_err_over_column_peak": float(
                ((got[:, :9] - base[:, :9]).abs().amax(0) / peak).max())}
        rows.append({"kernel": name, "variant": tag, "build": info, **agree,
                     "ms": _in_turns((name, fn), call),
                     "committed_ms_before": committed})
    return rows


def enum_variants(device, fr: _Frame) -> list:
    """B4 against its one-thread-per-gaussian and store-free builds, at
    this frame and the bench frame: keys of the serial build equal the
    committed build's; times in turns, of the wrapper's call (CUDA events
    around it, ``ms``) and of the kernel alone (``graph_ms``: replayed from
    a CUDA graph, without the wrapper's host work)."""
    cfg = DEFAULT
    bench = random_scene(100_000, seed=0, extent=1.5,
                         scale_range=(0.004, 0.02), num_labels=16,
                         device=device)
    cam = look_at_camera((0, 0, -3.0), (0, 0, 0), width=WIDTH,
                         height=HEIGHT)
    bench_proj = project(bench, CameraParams.from_camera(cam, device), WIDTH,
                         HEIGHT, cfg.raster, z_near=cfg.camera.z_near,
                         z_far=cfg.camera.z_far)
    text = (_kernels.CSRC / "enum_keys.cu").read_text()
    builds = {}
    for tag, edits in (
            ("one thread per gaussian", ((B4_LOOP, B4_SERIAL),)),
            ("no stores", ((B4_STORES, B4_NO_STORES),)),
            ("one thread per gaussian, no stores",
             ((B4_LOOP, B4_SERIAL), (B4_STORES, B4_NO_STORES)))):
        src = text
        for old, new in edits:
            src = _edit(src, old, new)
        builds[tag] = _load(f"enum_keys_{len(builds)}", "enum_keys", src)
    rows = []
    for frame, proj in (("2M view 0", fr.proj), ("bench", bench_proj)):
        nt = fr.tx * fr.ty
        qd = depth_qkeys(proj.depth, proj.valid, nt)
        bb = tile_bboxes(proj, tiles_x=fr.tx, tiles_y=fr.ty,
                         tile_size=cfg.raster.tile_size)

        def call():
            return enum_keys(proj, qd, bb, tiles_x=fr.tx, num_tiles=nt,
                             tile_size=cfg.raster.tile_size,
                             db=32 - depth_shift(nt))

        base = call()
        for tag, (_, fn, info) in builds.items():
            row = {"frame": frame, "variant": tag, "build": info,
                   "slots": bb.total, "gaussians": proj.u.numel()}
            if "no stores" not in tag:
                with _Swap("enum_keys", fn):
                    got = call()
                row["keys_equal"] = all(torch.equal(a, b)
                                        for a, b in zip(got, base))
            row["ms"] = _in_turns(("enum_keys", fn), call)
            row["graph_ms"] = _in_turns(("enum_keys", fn), call, graph_ms)
            rows.append(row)
    return rows


# build variants of B3: its look-back with acquire loads an item at a time
# and a fence before each publication, and with no look-back at all
B3_PUBLISH = """  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(bits)
               : "memory");"""
B3_PUBLISH_FENCED = """  __threadfence();
  asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(bits)
               : "memory");"""
B3_LANE_SUM = """  double acc;
  for (;;) {
    acc = 0.0;
    bool ready = true;
#pragma unroll 8
    for (int i = l; i < n; i += kLanes) {
      const long long v =
          ld_relaxed(vals + static_cast<size_t>(base + i) * kCols + c);
      ready &= v != kUnset;
      acc += __longlong_as_double(v);
    }
    if (ready) break;
    __nanosleep(32);
  }
  part[l][c] = acc;"""
B3_LANE_SUM_ACQUIRE = """  double acc = 0.0;
  for (int i = l; i < n; i += kLanes) {
    long long v;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.b64 %0, [%1];"
                   : "=l"(v)
                   : "l"(vals + static_cast<size_t>(base + i) * kCols + c)
                   : "memory");
      if (v != kUnset) break;
      __nanosleep(32);
    }
    acc += __longlong_as_double(v);
  }
  part[l][c] = acc;"""
B3_NO_LOOK_BACK = "  part[l][c] = 0.0;"


def b3_variants(device, source=None) -> list:
    """B3's look-back against builds that poll with acquire loads an item
    at a time and fence each publication, that skip it, and ``source``;
    times in turns (graph replay and CUDA events) at the bench frame's
    and the 2M frame's fold sizes."""
    text = (_kernels.CSRC / "cumsum_rows.cu").read_text()
    builds = {
        "acquire and fence": _load(
            "cumsum_rows_acquire", "cumsum_rows",
            _edit(_edit(text, B3_PUBLISH, B3_PUBLISH_FENCED), B3_LANE_SUM,
                  B3_LANE_SUM_ACQUIRE)),
        "no look-back": _load("cumsum_rows_no_look_back", "cumsum_rows",
                              _edit(text, B3_LANE_SUM, B3_NO_LOOK_BACK))}
    if source is not None:
        builds[f"source {source}"] = _load("cumsum_rows_source",
                                           "cumsum_rows",
                                           Path(source).read_text())
    gen = torch.Generator(device=device).manual_seed(5)
    rows_out = []
    for rows in (198_762, 2_493_215):
        x = torch.randn(rows, 16, generator=gen, device=device) + 0.1
        want = torch.cumsum(x.double(), 0)
        base = blend.cumsum_rows(x)
        call = lambda: blend.cumsum_rows(x)
        for tag, (_, fn, info) in builds.items():
            with _Swap("cumsum_rows", fn):
                got = call()
            err = (got.double() - want).abs().amax(0) / want.abs().amax(0)
            rows_out.append({
                "rows": rows, "variant": tag, "build": info,
                "bit_equal": torch.equal(got, base),
                "max_err_over_column_peak": float(err.max()),
                "graph_ms": _in_turns(("cumsum_rows", fn), call, graph_ms),
                "ms": _in_turns(("cumsum_rows", fn), call),
                "clone_graph_ms": graph_ms(x.clone)})
    return rows_out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--b3-source", default=None,
                    help="another csrc/cumsum_rows.cu to time against")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("blend_probe: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    _kernels.build(("enum_keys", "blend_fwd", "blend_bwd", "blend_vis",
                    "cumsum_rows"))
    fr = _Frame(device)
    b = fr.binning.tile_bounds
    report = {"device": torch.cuda.get_device_name(0),
              "occupancy": {n: _kernels.occupancy(n)
                            for n in ("blend_fwd", "blend_vis", "blend_bwd")},
              "tiles": _summary(b[1:] - b[:-1]),
              "skip": skip_counts(fr)}
    nsub = math.ceil(fr.kw["tile_size"] / 16) ** 2
    seg_len, split_above, extra = blend.split_launch(
        fr.binning.inst_gauss.shape[0], fr.tx * fr.ty, fr.kw["chunk"], device,
        False)
    before = blend.split_counts(device)
    fr.fwd()
    after = blend.split_counts(device)
    report["split"] = {"seg_len": seg_len, "split_above": split_above,
                       "extra_blocks": extra,
                       **{k: after[k] - before[k] for k in after}}
    report["blocks"] = [
        block_times(fr, "blend_fwd", fr.fwd, fr.tx * fr.ty + extra),
        block_times(fr, "blend_vis", fr.vis, fr.tx * fr.ty * nsub),
        block_times(fr, "blend_bwd", fr.bwd, fr.tx * fr.ty)]
    report["variants"] = (blend_variants(fr, "blend_fwd")
                          + blend_variants(fr, "blend_bwd"))
    report["enum_variants"] = enum_variants(device, fr)
    report["b3_variants"] = b3_variants(device, args.b3_source)
    for key, value in report.items():
        print(json.dumps({key: value}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
