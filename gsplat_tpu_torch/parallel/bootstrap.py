"""Multi-process bootstrap: ``torch.distributed`` process group + mesh from
flags.

Counterpart of ``gsplat_tpu.parallel.bootstrap``: one process per rank
joins a process group over TCP (NCCL between cards, gloo between CPU
processes), and the ('host', 'chip') mesh the sharded pipeline runs on
(``parallel/mesh.py``) is built over it. torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) takes the place
of a TPU pod's auto-detection; elsewhere pass the coordinator, the process
count and the process id.

Usage from a CLI (see :func:`add_mesh_args` / :func:`mesh_from_args`):

    python -m gsplat_tpu_torch.cli.train ... --mesh 2x4 \\
        --coordinator host0:9999 --num_processes 2 --process_id $RANK
"""

from __future__ import annotations

import argparse
import os
from datetime import timedelta
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from gsplat_tpu_torch.parallel.mesh import Mesh, make_mesh

# a collective that waits longer than this raises instead of hanging
TIMEOUT = timedelta(minutes=10)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (idempotent: nothing if one exists).

    ``coordinator_address`` is ``host:port`` of rank 0's store; without
    arguments torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
    ``WORLD_SIZE`` give all three, and a missing one raises. ``backend``
    defaults to NCCL when a card is visible, else gloo."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        port = env.get("MASTER_PORT", "29500")
        coordinator_address = f"{env['MASTER_ADDR']}:{port}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "a process group needs the coordinator address, the process "
            "count and the process id (--coordinator, --num_processes, "
            "--process_id), or torchrun's MASTER_ADDR, WORLD_SIZE and RANK")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def parse_mesh_shape(spec: str) -> Tuple[int, int]:
    """'2x4' -> (2, 4); '8' -> (1, 8)."""
    parts = spec.lower().split("x")
    if len(parts) == 1:
        return (1, int(parts[0]))
    if len(parts) != 2:
        raise ValueError(f"mesh spec must be 'HxC' or 'C', got {spec!r}")
    return (int(parts[0]), int(parts[1]))


def add_mesh_args(ap: argparse.ArgumentParser) -> None:
    """Attach the standard distributed/mesh flags to a CLI parser."""
    ap.add_argument("--mesh", default=None,
                    help="device mesh shape 'HOSTSxCHIPS' (e.g. 2x4) or "
                         "'CHIPS'; default: all local devices as (1, n)")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port for multi-process "
                         "runs (torchrun's MASTER_ADDR:MASTER_PORT when "
                         "absent)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)


def process_cards(per: int, rank: int, count: int,
                  local_rank: Optional[int] = None) -> List[torch.device]:
    """The cards of a process that holds ``per`` shards, of the ``count``
    cards its host shows: run ``local_rank`` of ``per`` consecutive cards
    (torchrun's ``LOCAL_RANK``; by default ``rank`` modulo the runs a host
    holds, so one process a host takes cards 0 .. per - 1). With fewer
    cards than shards the shards share the cards in consecutive runs, as
    :func:`make_mesh` shares them without a process group."""
    if count < 1:
        raise RuntimeError("no CUDA device is available for the mesh's "
                           "shards")
    if per > count:
        if per % count:
            raise ValueError(f"{count} cards cannot hold a process's {per} "
                             f"shards")
        return [torch.device("cuda", s * count // per) for s in range(per)]
    runs = count // per
    local = rank % runs if local_rank is None else local_rank
    if not 0 <= local < runs:
        raise ValueError(f"local rank {local} has no run of {per} of the "
                         f"host's {count} cards")
    return [torch.device("cuda", local * per + i) for i in range(per)]


def mesh_from_args(args: argparse.Namespace,
                   device: Optional[torch.device] = None) -> Optional[Mesh]:
    """Build the mesh requested by :func:`add_mesh_args` flags; None unless
    --mesh or any multi-process flag was given (sharding is opt-in: a
    multi-device host without --mesh still runs the single-device path).

    ``device`` is the CLI's ``--device``: on the CPU the shards are CPU
    shards (and a process group uses gloo). On the card each process of a
    group holds --mesh's shards divided by the process count, on its own
    cards (:func:`process_cards`); one process's shards share the visible
    cards in consecutive runs."""
    multi = (args.coordinator is not None or args.num_processes is not None
             or args.process_id is not None)
    cpu = device is not None and device.type == "cpu"
    if multi:
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id,
                               backend="gloo" if cpu else None)
    shape = parse_mesh_shape(args.mesh) if args.mesh is not None else None
    if shape is None and not multi:
        return None
    if shape is None:
        return make_mesh(None, [device] if cpu else None)
    world = dist.get_world_size() if multi else 1
    if (shape[0] * shape[1]) % world:
        raise ValueError(f"a {shape[0]}x{shape[1]} mesh does not split "
                         f"over {world} processes")
    per = shape[0] * shape[1] // world
    if cpu:
        return make_mesh(shape, [device] * per)
    if not multi:
        return make_mesh(shape)
    local = os.environ.get("LOCAL_RANK")
    return make_mesh(shape, process_cards(
        per, dist.get_rank(), torch.cuda.device_count(),
        None if local is None else int(local)))
