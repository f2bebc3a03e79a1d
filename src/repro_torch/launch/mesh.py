"""Device meshes, placement and multi-process bring-up (port of
`repro.launch.mesh`).

A `Mesh` is a description: axis names, axis sizes and the devices, if any.
`make_local_mesh` gives the card's (``("data", "model")`` of sizes
``(torch.cuda.device_count(), 1)``; ``(1, 1)`` on the host), and
`make_production_mesh` the reference's production shapes -- ``(16, 16)``
and ``(2, 16, 16)`` -- with no devices, which only the dry-run reads
(`repro_torch.launch.dryrun`).  A mesh may list one device more than once:
``Mesh(("data", "model"), (4, 1), (cpu,) * 4)`` is the port's counterpart
of the reference's forced host devices
(``--xla_force_host_platform_device_count``), and ``cuda:0`` listed three
times shards over one card.

`data_sharding(mesh)` is the reference's `NamedSharding` of the leading
axis over ``data``; `place` puts a tensor under it as a `Sharded` value --
shard ``i`` holds rows ``[i Bp / n, (i + 1) Bp / n)`` on the ``i``-th
device of the data axis, XLA's layout -- or as a plain tensor where the
spec is replicated or the data axis has one device.  `drive` runs one
stage per shard in turns, so shards on distinct cards overlap and shards
that share a device run one after another; a member's bits never depend
on the shard count.  Sharding model parameters across cards (``place`` /
``constrain`` of a parameter tree) is ROADMAP item 10b (c).

`init_distributed` brings up a `torch.distributed` process group over gloo
(the runner exchanges files and one barrier, the compressed gradient
exchange int8 payloads, so the same launch works on hosts with and
without a card) and `process_shard` reads this process's (shard,
num_shards) from it.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "Mesh", "NamedSharding", "Sharded", "make_production_mesh", "make_local_mesh",
    "mesh_axis_sizes", "data_axis_size", "data_sharding", "place", "gather", "drive",
    "init_distributed", "process_shard",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a device mesh, and its devices in row-major
    order (none for a mesh that only the dry-run reads; a device may
    repeat)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    devices: tuple[torch.device, ...] = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"mesh: axes {self.axis_names} and shape {self.shape} differ")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"mesh: {len(self.devices)} devices for shape {self.shape}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes, with no cards: one pod
    ``(data=16, model=16)``, or two, ``(pod=2, data=16, model=16)``."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(device: str | torch.device = "cuda") -> Mesh:
    """Every local card on ``data`` (one shard each), ``model`` of size 1;
    on the host (``device="cpu"``) the one-device mesh ``(1, 1)``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        devices = tuple(torch.device("cuda", i) for i in range(n))
    else:
        n, devices = 1, (dev,)
    return Mesh(("data", "model"), (n, 1), devices)


def mesh_axis_sizes(mesh: Mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def data_axis_size(mesh: Mesh) -> int:
    """Number of shards along the ensemble (``data``) axis."""
    return int(mesh_axis_sizes(mesh).get("data", 1))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A partition spec on a mesh (`jax.sharding.NamedSharding`): ``spec``
    names the mesh axis the leading dimension is split over, or is empty
    (replicated).  Two shardings are equal when their meshes and specs
    are."""

    mesh: Mesh
    spec: tuple = ()

    def __post_init__(self):
        head, rest = self.spec[:1], self.spec[1:]
        if any(a is not None for a in rest) or (head and not isinstance(head[0], (str, type(None)))):
            raise ValueError(
                f"sharding {self.spec}: only the leading axis over one mesh axis is "
                f"placed (parameter sharding is ROADMAP item 10b (c))"
            )
        if self.axis is not None and self.axis not in self.mesh.axis_names:
            raise ValueError(f"sharding {self.spec}: mesh {self.mesh.axis_names} has no such axis")

    @property
    def axis(self) -> str | None:
        """The mesh axis of the leading dimension (None: replicated)."""
        return self.spec[0] if self.spec else None

    @property
    def num_shards(self) -> int:
        return 1 if self.axis is None else mesh_axis_sizes(self.mesh)[self.axis]

    def devices(self) -> tuple[torch.device, ...]:
        """The device of each shard: the mesh's devices along the axis,
        the other axes at index 0 (each checked: a card the host lacks
        raises)."""
        if not self.mesh.devices:
            raise ValueError(f"mesh {self.mesh.shape} has no devices to place on")
        if self.axis is None:
            idx = [0]
        else:
            a = self.mesh.axis_names.index(self.axis)
            idx = [
                int(np.ravel_multi_index(
                    tuple(i if d == a else 0 for d in range(len(self.mesh.shape))),
                    self.mesh.shape,
                ))
                for i in range(self.num_shards)
            ]
        return tuple(resolve_device(self.mesh.devices[i]) for i in idx)


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A tensor split along its leading axis: one shard a device, in
    order, under ``sharding``."""

    shards: tuple
    sharding: NamedSharding

    @property
    def shape(self) -> tuple:
        head = self.shards[0].shape
        return (sum(s.shape[0] for s in self.shards), *head[1:])

    def gather(self, device: str | torch.device | None = None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first shard's)."""
        dev = self.shards[0].device if device is None else torch.device(device)
        return torch.cat([s.to(dev) for s in self.shards])


def data_sharding(mesh: Mesh) -> NamedSharding:
    """The `NamedSharding` that splits an array's leading axis over
    ``data``, trailing axes replicated: the ensemble member axis of every
    batched scheduling stage."""
    if "data" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no data axis")
    return NamedSharding(mesh, ("data",))


def place(
    x, sharding: NamedSharding | tuple | None = None, device: str | torch.device = "cuda"
) -> torch.Tensor | Sharded:
    """Stage-input placement.

    Under a `NamedSharding` of more than one shard, ``x`` as a `Sharded`
    value: shard ``i`` is rows ``[i Bp / n, (i + 1) Bp / n)``, copied to
    the ``i``-th device (the leading axis must divide evenly).  A
    replicated spec, or one shard, gives a plain tensor on the sharding's
    first device.  With no sharding, or a bare partition spec (which must
    fit ``x``'s rank), a tensor on ``device``.
    """
    if isinstance(sharding, NamedSharding):
        devices = sharding.devices()
        t = torch.as_tensor(x)
        n = len(devices)
        if n == 1:
            return t.to(devices[0])
        if t.dim() == 0 or t.shape[0] % n:
            raise ValueError(
                f"place: a leading axis of {tuple(t.shape)[:1]} does not split into {n} shards"
            )
        rows = t.shape[0] // n
        return Sharded(
            tuple(t[i * rows:(i + 1) * rows].to(d, copy=True) for i, d in enumerate(devices)),
            sharding,
        )
    t = torch.as_tensor(x, device=resolve_device(device))
    if sharding is not None and len(sharding) > t.dim():
        raise ValueError(f"place: spec {sharding} for a tensor of rank {t.dim()}")
    return t


def gather(x, device: str | torch.device | None = None):
    """``x`` whole: a `Sharded` value concatenated on ``device`` (default
    its first shard's), a tensor moved there; anything else as it is."""
    if isinstance(x, Sharded):
        return x.gather(device)
    if isinstance(x, torch.Tensor) and device is not None:
        return x.to(device)
    return x


def drive(stages: Sequence[Iterator]) -> list:
    """Run one generator per shard to its end, a step of each in turn;
    returns their return values in order.

    Each step issues its shard's work (asynchronous on a card) before the
    next shard's step is taken, so shards on distinct cards overlap; a
    step that reads a value back to the host waits for its own shard
    only.  Shards on one device run one after another.
    """
    out: list = [None] * len(stages)
    live = list(range(len(stages)))
    while live:
        still = []
        for i in live:
            try:
                next(stages[i])
                still.append(i)
            except StopIteration as stop:
                out[i] = stop.value
        live = still
    return out


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Bring up `torch.distributed` for a multi-process sweep; returns
    whether more than one process takes part.

    ``coordinator_address`` is ``host:port`` of rank 0 (tcp init).  Unset
    arguments fall back to torch's environment contract: ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  With no coordinator and
    one process it is a no-op returning False, so the runner can call it
    unconditionally.  A process group already up is kept as it is.
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes in (None, 1):
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs the coordinator address, the number of "
            "processes and this process's id (arguments, or MASTER_ADDR / "
            "MASTER_PORT / WORLD_SIZE / RANK)"
        )
    if not dist.is_available():
        raise RuntimeError("this PyTorch build has no torch.distributed")
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )
    return dist.get_world_size() > 1


def process_shard() -> tuple[int, int]:
    """This process's (shard, num_shards): its rank and the world size,
    or ``(0, 1)`` with no process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank()), int(dist.get_world_size())
    return 0, 1
