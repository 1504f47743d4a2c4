"""Device mesh, the gaussians' shards, and the collectives between them.

Counterpart of ``gsplat_tpu.parallel.mesh``. The JAX package's mesh is a
single-controller array of devices of shape (host, chip), and a sharded
array is one value whose slices live on them; GSPMD and ``shard_map`` move
data between the slices. Torch has neither, so the port makes both
explicit:

- :class:`Mesh` has shape (host, chip) (``AXES``, ``AXIS_HOST``,
  ``AXIS_CHIP``: the JAX names) and holds D shards. Shard s belongs to
  process ``s // L`` of a ``torch.distributed`` process group (L shards a
  process; one process and no group when the mesh is built without one)
  and lives on a ``torch.device``. A device may repeat: D logical shards
  can share one card or the CPU, as the JAX package's virtual CPU mesh
  shares the host (``tests/conftest.py``).
- :class:`Sharded` is a value split over a mesh along its first axis: the
  list of this process's shards, in mesh order, each on its shard's
  device. :class:`ShardedScene` is a sharded ``GaussianScene``. A process
  holds only its own shards.
- :func:`per_shard`, :func:`sum_shards` and :func:`on_whole` run a
  function on a value that may be sharded: shard by shard, summed over
  the shards, or on the gathered whole.
- :func:`gather_rows` and :func:`shard_rows` move between a sharded value
  (or a train state of them) and the whole one; :func:`all_gather_shards` and :func:`all_reduce_sum`
  are the collectives, a tensor copy between shards of one process and a
  ``torch.distributed`` call across processes.

``gaussian_sharding`` and ``replicated`` (JAX ``NamedSharding``s) have no
meaning in torch and are not ported: a value is sharded by being a
:class:`Sharded`, and replicated by being a plain tensor each process holds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from gsplat_tpu_torch.scene import FIELDS, GaussianScene

AXIS_HOST = "host"
AXIS_CHIP = "chip"
AXES = (AXIS_HOST, AXIS_CHIP)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (host, chip) mesh of ``dims[0] * dims[1]`` shards.

    ``devices`` are this process's shards' devices, in mesh order: the
    shards ``rank * L .. rank * L + L - 1`` of ``world`` processes with L
    shards each. ``distributed``: built over a process group, whose
    collectives then move data between processes (also at a world size of
    1); otherwise one process holds every shard."""

    dims: Tuple[int, int]
    devices: Tuple[torch.device, ...]
    rank: int = 0
    world: int = 1
    distributed: bool = False

    axis_names = AXES

    def __post_init__(self):
        if self.dims[0] * self.dims[1] != self.world * len(self.devices):
            raise ValueError(
                f"a {self.dims[0]}x{self.dims[1]} mesh needs "
                f"{self.dims[0] * self.dims[1]} shards; {self.world} "
                f"processes hold {len(self.devices)} each")

    @property
    def size(self) -> int:
        """D, the number of shards."""
        return self.dims[0] * self.dims[1]

    @property
    def shape(self) -> dict:
        """{axis name: size}, as JAX's ``Mesh.shape``."""
        return dict(zip(AXES, self.dims))

    @property
    def local(self) -> range:
        """This process's shard ids."""
        n = len(self.devices)
        return range(self.rank * n, (self.rank + 1) * n)

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard: where whole values
        (the image, the loss, a gathered scene) are assembled, and the
        device of the process's collectives."""
        return self.devices[0]

    def shards_of(self, rank: int) -> range:
        n = len(self.devices)
        return range(rank * n, (rank + 1) * n)


def on_device(device: torch.device):
    """Make ``device`` the calling thread's current CUDA device for the
    block (ctypes kernel launches go to the current device); nothing for
    the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _default_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=[torch.device('cpu')"
            ", ...] to build a mesh of CPU shards")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _rank_device() -> torch.device:
    """This process's device when each rank holds one shard: its local
    rank's card under NCCL, the CPU under gloo."""
    if dist.get_backend() != "nccl":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK",
                               dist.get_rank() % torch.cuda.device_count()))
    return torch.device("cuda", local)


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (host, chip) mesh.

    With no process group, one process holds every shard: the shards are
    ``devices`` (default: every visible CUDA device), and the shape
    defaults to (1, len(devices)). Fewer devices than ``shape`` asks for
    are shared by the shards in consecutive runs (D logical shards on one
    card: ``make_mesh((1, 4), [torch.device("cuda", 0)])``).

    With an initialised process group, ``devices`` are each process's own
    shards (all processes the same count). By default each rank holds one
    shard, on its local card under NCCL and on the CPU under gloo, and the
    shape is (world size / local size, local size), local size from
    torchrun's ``LOCAL_WORLD_SIZE`` (default: the world size); given
    ``devices``, the shape defaults to (processes, len(devices)), as the
    JAX package's ``make_mesh`` does."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if devices is None:
            devs = [_rank_device()]
            if shape is None:
                local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
                if world % local:
                    raise ValueError(f"{world} processes do not split into "
                                     f"hosts of {local}")
                shape = (world // local, local)
        else:
            devs = [torch.device(d) for d in devices]
            if shape is None:
                shape = (world, len(devs))
        return Mesh(tuple(shape), tuple(devs), rank, world, True)
    devs = [torch.device(d) for d in
            (_default_devices() if devices is None else devices)]
    if shape is None:
        shape = (1, len(devs))
    d = shape[0] * shape[1]
    if d != len(devs):
        if d % len(devs):
            raise ValueError(f"{len(devs)} devices cannot hold the {d} "
                             f"shards of a {shape[0]}x{shape[1]} mesh")
        devs = [devs[s * len(devs) // d] for s in range(d)]
    return Mesh(tuple(shape), tuple(devs))


class Sharded(list):
    """A value split over ``mesh``'s shards along its first axis: the list
    of this process's shards (tensors, NamedTuples of tensors or scenes),
    in mesh order, each on its shard's device."""

    def __init__(self, shards, mesh: Mesh):
        super().__init__(shards)
        if len(self) != len(mesh.devices):
            raise ValueError(f"{len(self)} shards for a mesh whose process "
                             f"holds {len(mesh.devices)}")
        self.mesh = mesh

    def map(self, fn: Callable, *others) -> "Sharded":
        """``fn`` applied shard by shard (with the matching shards of
        ``others``), each on its shard's device."""
        out = []
        for k, (x, dev) in enumerate(zip(self, self.mesh.devices)):
            with on_device(dev):
                out.append(fn(x, *(o[k] for o in others)))
        return Sharded(out, self.mesh)


class ShardedScene(Sharded):
    """A ``GaussianScene`` padded to a multiple of D and split into D
    contiguous slices (:func:`shard_scene`)."""

    @property
    def labels(self) -> Sharded:
        return Sharded([s.labels for s in self], self.mesh)

    @property
    def num_gaussians(self) -> int:
        """The padded global count."""
        return self[0].num_gaussians * self.mesh.size


def all_gather_shards(tensors: Sequence[torch.Tensor], mesh: Mesh
                      ) -> List[torch.Tensor]:
    """Every shard's tensor (all of one shape and dtype), in mesh order, on
    ``mesh.home``, from this process's shards' ``tensors``. Not
    differentiable."""
    local = [t.to(mesh.home) for t in tensors]
    if not mesh.distributed:
        return local
    stacked = torch.stack(local)
    parts = [torch.empty_like(stacked) for _ in range(mesh.world)]
    dist.all_gather(parts, stacked.contiguous())
    return [t for p in parts for t in p.unbind(0)]


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the processes (``t`` itself in one process).
    Every process gets the same bits."""
    if not mesh.distributed:
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t


def per_shard(fn: Callable, x, *others):
    """``fn(x, *others)`` for a plain ``x``. For a :class:`Sharded` ``x``,
    ``fn`` runs shard by shard on the matching shards of ``others``
    (:meth:`Sharded.map`), and a result that is a plain tuple comes back as
    a tuple of sharded values. The port's modules branch on a sharded
    value here and nowhere else."""
    if not isinstance(x, Sharded):
        return fn(x, *others)
    out = x.map(fn, *others)
    if type(out[0]) is tuple:
        return tuple(Sharded(list(c), x.mesh) for c in zip(*out))
    return out


def sum_shards(x):
    """A per-shard tensor summed over every shard of the mesh, the same
    bits on every process; a plain ``x`` itself."""
    if not isinstance(x, Sharded):
        return x
    parts = [t.to(x.mesh.home) for t in x]
    total = parts[0]
    for t in parts[1:]:
        total = total + t
    return all_reduce_sum(total, x.mesh)


def on_whole(fn: Callable, *xs):
    """``fn(*xs)`` for plain values. For sharded ones ``fn`` runs on the
    gathered values, alike on every process, and each value of the tuple it
    returns is sharded again."""
    if not isinstance(xs[0], Sharded):
        return fn(*xs)
    mesh = xs[0].mesh
    return tuple(shard_rows(o, mesh) for o in fn(*map(gather_rows, xs)))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _parts(x) -> Tuple[Any, List[torch.Tensor]]:
    """(rebuild, tensors) of a row value: a tensor, a NamedTuple of tensors
    or a scene; None for anything else."""
    if isinstance(x, torch.Tensor):
        return (lambda ts: ts[0]), [x]
    if isinstance(x, GaussianScene):
        return (lambda ts: GaussianScene(*ts)), [getattr(x, f)
                                                  for f in FIELDS]
    if _is_namedtuple(x) and all(isinstance(t, torch.Tensor) for t in x):
        return (lambda ts: type(x)(*ts)), list(x)
    return None


def gather_rows(x):
    """The whole value of a sharded one (every shard's rows, in mesh
    order), on ``mesh.home``: a copy within one process, an all-gather
    across processes. A NamedTuple that holds sharded values (a train
    state) is gathered field by field; anything else is returned as it is.
    Not differentiable."""
    if isinstance(x, Sharded):
        rebuild, _ = _parts(x[0])
        cols = zip(*(_parts(s)[1] for s in x))
        return rebuild([torch.cat(all_gather_shards(list(c), x.mesh))
                        for c in cols])
    if _is_namedtuple(x):
        return type(x)(*map(gather_rows, x))
    return x


def shard_rows(x, mesh: Mesh):
    """This process's shards of ``x`` (a tensor, a NamedTuple of tensors or
    a scene whose first axis D divides): D contiguous slices, each on its
    shard's device. A NamedTuple of other values (a train state) is sharded
    field by field, its counts kept as they are."""
    split = _parts(x)
    if split is None:
        if _is_namedtuple(x):
            return type(x)(*(shard_rows(f, mesh) for f in x))
        return x
    rebuild, ts = split
    n = ts[0].shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split into {mesh.size} shards")
    ns = n // mesh.size
    cls = ShardedScene if isinstance(x, GaussianScene) else Sharded
    return cls([rebuild([t[s * ns:(s + 1) * ns].to(dev) for t in ts])
                for s, dev in zip(mesh.local, mesh.devices)], mesh)


def shard_scene(scene: GaussianScene, mesh: Mesh) -> ShardedScene:
    """Pad N up to a multiple of D, as ``gsplat_tpu/parallel/mesh.py:52-83``
    does (opacity logit -30, so sigmoid ~ 0 and the padding never
    contributes; quaternion components 1.0; label 0; the rest 0), and split
    the scene into D contiguous slices on the shards' devices."""
    n = scene.num_gaussians
    pad = -n % mesh.size
    fills = dict(quats=1.0, opacities=-30.0)

    def padded(f):
        t = getattr(scene, f)
        if pad == 0:
            return t
        return torch.cat([t, torch.full((pad,) + tuple(t.shape[1:]),
                                        fills.get(f, 0), dtype=t.dtype,
                                        device=t.device)])

    return shard_rows(GaussianScene(*(padded(f) for f in FIELDS)), mesh)
