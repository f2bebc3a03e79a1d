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

A `NamedSharding` is a partition spec of any length on a mesh, each
entry ``None``, a mesh axis or a tuple of axes, as the reference's
`jax.sharding.PartitionSpec`; `place` puts a tensor under it as a
`Sharded` value -- one block per mesh device in row-major mesh order, the
devices of a replicated axis holding copies, XLA's layout -- or as a
plain tensor where the spec splits nothing, and `gather` assembles it
again.  `data_sharding(mesh)` is the leading axis over ``data``: shard
``i`` holds rows ``[i Bp / n, (i + 1) Bp / n)``.  `drive` runs one stage
per shard in turns, so shards on distinct cards overlap and shards that
share a device run one after another; a member's bits never depend on
the shard count.

`device_mesh` gives the `torch.distributed.DeviceMesh` of a mesh over a
process group, and `placements` the DTensor placements of a spec on it:
the port's counterpart of GSPMD's partitioner (`repro_torch.launch.
sharding.constrain`, the dry-run's partition).

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
    "init_distributed", "process_shard", "device_mesh", "placements",
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


def _entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry: none, one name, or a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A partition spec on a mesh (`jax.sharding.NamedSharding`): one entry
    per leading dimension of the tensor, each ``None`` (replicated), a mesh
    axis, or a tuple of mesh axes (the dimension split over their product,
    the first axis major, as `jax.sharding.PartitionSpec`).  A mesh axis
    appears once at most.  Two shardings are equal when their meshes and
    specs are."""

    mesh: Mesh
    spec: tuple = ()

    def __post_init__(self):
        used: list[str] = []
        for entry in self.spec:
            if entry is not None and not isinstance(entry, (str, tuple)):
                raise ValueError(f"sharding {self.spec}: an entry is None, an axis or a tuple")
            used.extend(_entry_axes(entry))
        for a in used:
            if a not in self.mesh.axis_names:
                raise ValueError(f"sharding {self.spec}: mesh {self.mesh.axis_names} has no such axis")
        if len(set(used)) != len(used):
            raise ValueError(f"sharding {self.spec}: a mesh axis may appear once")

    def dim_shards(self, dim: int) -> int:
        """Into how many blocks dimension ``dim`` splits."""
        sizes = mesh_axis_sizes(self.mesh)
        entry = self.spec[dim] if dim < len(self.spec) else None
        return math.prod(sizes[a] for a in _entry_axes(entry))

    @property
    def num_shards(self) -> int:
        """The number of distinct blocks: the product over the spec's axes."""
        return math.prod(self.dim_shards(d) for d in range(len(self.spec)))

    def block_index(self, flat: int) -> tuple[int, ...]:
        """Per spec entry, the block the mesh device at row-major position
        ``flat`` holds: its coordinates on the entry's axes, raveled with the
        first axis major (XLA's order for a tuple of axes)."""
        coord = dict(zip(self.mesh.axis_names, np.unravel_index(flat, self.mesh.shape)))
        sizes = mesh_axis_sizes(self.mesh)
        out = []
        for entry in self.spec:
            axes = _entry_axes(entry)
            idx = 0
            for a in axes:
                idx = idx * sizes[a] + int(coord[a])
            out.append(idx)
        return tuple(out)

    def _shard_positions(self) -> list[int]:
        """Row-major mesh positions of the first device holding each
        distinct block, in block order (the spec's axes in mesh order, the
        other axes at index 0)."""
        first: dict[tuple, int] = {}
        for flat in range(self.mesh.size):
            first.setdefault(self.block_index(flat), flat)
        return [first[k] for k in sorted(first)]

    def block_devices(self) -> tuple[torch.device, ...]:
        """Every mesh device in row-major order (each checked: a card the
        host lacks raises)."""
        if not self.mesh.devices:
            raise ValueError(f"mesh {self.mesh.shape} has no devices to place on")
        return tuple(resolve_device(d) for d in self.mesh.devices)

    def devices(self) -> tuple[torch.device, ...]:
        """The device of each distinct block, in block order: for a spec of
        the leading axis over one mesh axis, the mesh's devices along it,
        the other axes at index 0 (each checked: a card the host lacks
        raises)."""
        if not self.mesh.devices:
            raise ValueError(f"mesh {self.mesh.shape} has no devices to place on")
        return tuple(resolve_device(self.mesh.devices[i]) for i in self._shard_positions())


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A tensor split into blocks under ``sharding``: ``blocks`` holds one
    block per mesh device, in row-major mesh order, the devices of a
    replicated axis holding copies."""

    blocks: tuple
    sharding: NamedSharding

    @classmethod
    def from_shards(cls, shards, sharding: NamedSharding) -> "Sharded":
        """From the distinct blocks in block order (`shards`), each given
        to every mesh device that holds it."""
        where = {k: i for i, k in enumerate(sorted(
            {sharding.block_index(f) for f in range(sharding.mesh.size)}))}
        return cls(tuple(shards[where[sharding.block_index(f)]]
                         for f in range(sharding.mesh.size)), sharding)

    @property
    def shards(self) -> tuple:
        """The distinct blocks in block order, each from the first device
        that holds it (for the leading axis over ``data``: shard ``i`` is
        rows ``[i Bp / n, (i + 1) Bp / n)``)."""
        return tuple(self.blocks[i] for i in self.sharding._shard_positions())

    @property
    def shape(self) -> tuple:
        head = self.blocks[0].shape
        return tuple(n * self.sharding.dim_shards(d) for d, n in enumerate(head))

    def gather(self, device: str | torch.device | None = None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first block's)."""
        dev = self.blocks[0].device if device is None else torch.device(device)
        head = self.blocks[0]
        out = torch.empty(self.shape, dtype=head.dtype, device=dev)
        for flat in self.sharding._shard_positions():
            index = self.sharding.block_index(flat)
            out[tuple(slice(i * n, (i + 1) * n) for i, n in zip(index, head.shape))] = (
                self.blocks[flat].to(dev))
        return out


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
    """Stage-input and parameter placement.

    Under a `NamedSharding` of more than one distinct block, ``x`` as a
    `Sharded` value: each mesh device gets a copy of its block (dimension
    ``d`` cut into `NamedSharding.dim_shards` equal parts, each of which
    must divide evenly), devices of a replicated axis copies of the same
    block.  A sharding of one block gives a plain tensor on the mesh's
    first device.  With no sharding, or a bare partition spec (which must
    fit ``x``'s rank), a tensor on ``device``.
    """
    if isinstance(sharding, NamedSharding):
        devices = sharding.block_devices()
        t = torch.as_tensor(x)
        if len(sharding.spec) > t.dim():
            raise ValueError(f"place: spec {sharding.spec} for a tensor of rank {t.dim()}")
        cuts = [sharding.dim_shards(d) for d in range(len(sharding.spec))]
        if math.prod(cuts) == 1:
            return t.to(devices[0])
        for d, n in enumerate(cuts):
            if t.shape[d] % n:
                raise ValueError(
                    f"place: axis {d} of {tuple(t.shape)} does not split into {n} shards"
                )
        size = [t.shape[d] // n for d, n in enumerate(cuts)]
        return Sharded(tuple(
            t[tuple(slice(i * n, (i + 1) * n)
                    for i, n in zip(sharding.block_index(flat), size))].to(dev, copy=True)
            for flat, dev in enumerate(devices)), sharding)
    t = torch.as_tensor(x, device=resolve_device(device))
    if sharding is not None and len(sharding) > t.dim():
        raise ValueError(f"place: spec {sharding} for a tensor of rank {t.dim()}")
    return t


def gather(x, device: str | torch.device | None = None):
    """``x`` whole: a `Sharded` value assembled on ``device`` (default its
    first block's), a tensor moved there; anything else as it is."""
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


def device_mesh(mesh: Mesh, group=None):
    """The `torch.distributed.DeviceMesh` of ``mesh``: its axis names and
    shape over the ranks of ``group`` (the default group when None), which
    must hold exactly ``mesh.size`` ranks, rank ``r`` at row-major
    position ``r``.  Its device type is the mesh's devices', ``cuda`` for
    a mesh with none (the production meshes, which the dry-run partitions
    with ``meta`` tensors: DTensor then plans a shard-to-shard move as the
    card's all-to-all, where on a ``cpu`` mesh it would gather)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("device_mesh: no process group is up")
    group = dist.group.WORLD if group is None else group
    if group is not dist.group.WORLD:
        raise ValueError("device_mesh: only the default group is laid out as a mesh")
    if dist.get_world_size(group) != mesh.size:
        raise ValueError(
            f"device_mesh: {dist.get_world_size(group)} ranks for a mesh of {mesh.size}")
    from repro_torch.launch.sharding import register_missing_rules

    register_missing_rules()
    kind = resolve_device(mesh.devices[0]).type if mesh.devices else "cuda"
    return DeviceMesh(kind, torch.arange(mesh.size).reshape(mesh.shape),
                      mesh_dim_names=tuple(mesh.axis_names))


def placements(spec: tuple, mesh: Mesh) -> tuple:
    """DTensor placements of a partition spec, one per mesh axis:
    ``Shard(d)`` on each mesh axis that entry ``d`` names, ``Replicate()``
    on the others.  DTensor orders the shards of a dimension split over
    several mesh axes by mesh-axis order, the first major; XLA orders a
    tuple of axes the same way as written, so the tuple must follow the
    mesh's order (``("pod", "data")``), else `ValueError`."""
    from torch.distributed.tensor import Replicate, Shard

    NamedSharding(mesh, tuple(spec))  # the axes exist, each once
    out = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        where = [mesh.axis_names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(
                f"placements: {entry} splits one dim against the mesh's order "
                f"{mesh.axis_names}")
        for i in where:
            out[i] = Shard(d)
    return tuple(out)
