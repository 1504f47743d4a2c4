"""Scaling report of the sharded render: D logical shards on one device.

The port's twin of the repository's ``bench_sharded.py`` and of
``__graft_entry__.dryrun_multichip``:

    python -m gsplat_tpu_torch.parallel.scaling [--num-gaussians 2000000]
        [--device cpu] [--out build/scaling_torch.json]

For D in {1, 2, 4, 8} shards of one scene on one device (a mesh whose
shards share the device, as the JAX package's virtual CPU mesh shares the
host) it reports, per D:

- ``inst_max``, the most tight instances a shard blends, and
  ``inst_eff = inst(1) / (D * inst_max)``, the work partition's efficiency
  under the interleaved tile lattice;
- ``tiles`` a shard (one B1 block each) and ``batch_max``, the most
  (tile, chunk) batches a shard walks (each tile at least one: the JAX
  package's window count), with ``batch_eff = batch(1) / (D * batch_max)``,
  the analogue of ``bench_sharded.py``'s ``win_eff``;
- the exchange: rows each shard receives (max and mean) and their bytes at
  64 B a row, against the all-gather's N * 64 B;
- on the card, each shard's kernel times, B4, B1 and B2 replayed from a
  CUDA graph (``utils.profiling.graph_ms``), the max and the mean over the
  shards. The shards run one after another on the one card: their sum is
  no D-card frame time, and no speed-up is claimed from it;
- the dry run: one sharded ``make_train_step`` at D, its loss finite.

Every number names its device. The report never reads or writes the JAX
package's ``SCALING.json``; it prints one JSON line per D and writes
``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

from gsplat_tpu_torch._kernels import BUILD_ROOT
from gsplat_tpu_torch.config import DEFAULT, Config
from gsplat_tpu_torch.io.cameras import look_at_camera
from gsplat_tpu_torch.io.synthetic import random_scene
from gsplat_tpu_torch.models import trainer
from gsplat_tpu_torch.parallel import mesh as mesh_lib
from gsplat_tpu_torch.parallel.render_sharded import (COMPACT_COLS,
                                                      _unpack_compact,
                                                      exchanged_rows,
                                                      shard_binning)
from gsplat_tpu_torch.render import blend, tiles
from gsplat_tpu_torch.render.projection import CameraParams
from gsplat_tpu_torch.scene import resolve_device

SHARDS = (1, 2, 4, 8)
ROW_BYTES = COMPACT_COLS * 4


def _shape(d: int):
    """The JAX dry run's factorization: 2 hosts when D is even."""
    return (2, d // 2) if d > 1 and d % 2 == 0 else (1, d)


def _kernel_ms(rows, shard, layout, cfg: Config) -> dict:
    """Graph-replayed ms of B4, B1 and B2 on one shard's received rows."""
    from gsplat_tpu_torch.utils.profiling import graph_ms

    ptab, b, st = shard_binning(rows, shard, layout, cfg)
    proj = _unpack_compact(rows)
    lat = st.lattice
    nt = st.tiles_x * st.tiles_y
    qd = tiles.depth_qkeys(proj.depth, proj.valid, nt)
    bb = tiles.tile_bboxes(proj, tiles_x=st.tiles_x, tiles_y=st.tiles_y,
                           tile_size=st.tile_size, lattice=lat)
    kw = st._asdict()
    fwd = blend.blend_tiles_fwd(ptab, b.inst_gauss, b.tile_bounds, **kw,
                                with_labels=False)
    gen = torch.Generator(device=rows.device).manual_seed(11)
    drgb = torch.randn(fwd.rgb.shape, generator=gen, device=rows.device)
    dtrans = torch.randn(fwd.transmittance.shape, generator=gen,
                         device=rows.device)
    return {
        "B4": graph_ms(lambda: tiles.enum_keys(
            proj, qd, bb, tiles_x=st.tiles_x, num_tiles=nt,
            tile_size=st.tile_size, db=32 - tiles.depth_shift(nt),
            lattice=lat)),
        "B1": graph_ms(lambda: blend.blend_tiles_fwd(
            ptab, b.inst_gauss, b.tile_bounds, **kw, with_labels=True)),
        "B2": graph_ms(lambda: blend.blend_tiles_bwd(
            ptab, b.inst_gauss, b.tile_bounds, fwd.rgb, fwd.transmittance,
            drgb, dtrans, **kw), launches=5, reps=5),
    }


def scaling_row(scene, cam, d: int, device: torch.device,
                cfg: Config = DEFAULT, timed: bool = False) -> dict:
    """One D's counts (and, with ``timed``, per-shard kernel times) for the
    frame of ``scene`` from ``cam`` over D shards on ``device``."""
    mesh = mesh_lib.make_mesh(_shape(d), [device])
    sharded = mesh_lib.shard_scene(scene, mesh)
    camp = CameraParams.from_camera(cam, device)
    with torch.no_grad():
        received, layout = exchanged_rows(sharded, camp, mesh,
                                          width=cam.width, height=cam.height,
                                          cfg=cfg)
        inst, batches, times = [], [], []
        for e, rows in zip(mesh.local, received):
            _, b, st = shard_binning(rows, e, layout, cfg)
            n_t = (b.tile_bounds[1:] - b.tile_bounds[:-1]).long()
            inst.append(int(b.num_instances))
            batches.append(int(torch.clamp_min(
                -(-n_t // cfg.tiles.chunk), 1).sum()))
            if timed:
                times.append(_kernel_ms(rows, e, layout, cfg))
    recv = [int(r.shape[0]) for r in received]
    row = {"shards": d, "mesh": list(mesh.dims), "lattice": list(layout[:2]),
           "tiles": layout[2] * layout[3], "inst_max": max(inst),
           "inst_total": sum(inst), "batch_max": max(batches),
           "recv_rows_max": max(recv),
           "recv_rows_mean": statistics.fmean(recv),
           "recv_bytes_max": max(recv) * ROW_BYTES,
           "all_gather_bytes": sharded.num_gaussians * ROW_BYTES,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    if timed:
        for k in ("B4", "B1", "B2"):
            ms = [t[k] for t in times]
            row[f"{k}_ms_max"] = max(ms)
            row[f"{k}_ms_mean"] = statistics.fmean(ms)
            row[f"{k}_ms"] = ms
    return row


def efficiencies(rows) -> list:
    """Each row with ``inst_eff`` and ``batch_eff`` against the D=1 row."""
    one = next(r for r in rows if r["shards"] == 1)
    for r in rows:
        d = r["shards"]
        r["inst_eff"] = one["inst_max"] / (d * r["inst_max"])
        r["batch_eff"] = one["batch_max"] / (d * r["batch_max"])
    return rows


def dryrun(d: int, device: torch.device) -> float:
    """One sharded train step on a (hosts, chips) mesh of D shards, as
    ``__graft_entry__.dryrun_multichip`` runs it; returns its loss."""
    mesh = mesh_lib.make_mesh(_shape(d), [device])
    cam = look_at_camera((0.0, 0.0, -3.0), (0.0, 0.0, 0.0), width=64,
                         height=16 * max(d, 4))
    scene = mesh_lib.shard_scene(random_scene(32 * d, seed=1, num_labels=4,
                                              device=device), mesh)
    step = trainer.make_train_step((cam.width, cam.height), DEFAULT, lr=1e-3,
                                   mesh=mesh)
    state, loss, _ = step(trainer.init_state(scene), scene.labels,
                          CameraParams.from_camera(cam, device),
                          torch.zeros(cam.height, cam.width, 3,
                                      device=device),
                          torch.zeros(3, device=device))
    loss = float(loss)
    if not loss == loss or loss < 0.0 or state.step != 1:
        raise AssertionError(f"dry run at D={d}: bad loss {loss}")
    return loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-gaussians", type=int, default=2_000_000)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=608)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; on the CPU no "
                         "kernel is timed)")
    ap.add_argument("--out", default=str(BUILD_ROOT / "scaling_torch.json"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # phase 3's 2M scene of chip_smoke.py (bench.py's at 100k)
    scene = random_scene(args.num_gaussians, seed=0, extent=1.5,
                         scale_range=(0.002, 0.008), num_labels=16,
                         device=device)
    cam = look_at_camera((0.0, 0.0, -3.0), (0.0, 0.0, 0.0),
                         width=args.width, height=args.height)
    rows = efficiencies([scaling_row(scene, cam, d, device,
                                     timed=device.type == "cuda")
                         for d in SHARDS])
    for r in rows:
        r["dryrun_loss"] = dryrun(r["shards"], device)
        print(json.dumps(r), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
