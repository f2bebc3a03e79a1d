"""Device meshes, placement and multi-process bring-up (port of
`repro.launch.mesh`).

A `Mesh` is a description: axis names, axis sizes and the cards, if any.
`make_local_mesh` gives the card's (``("data", "model")`` of sizes
``(torch.cuda.device_count(), 1)``; ``(1, 1)`` on the host), and
`make_production_mesh` the reference's production shapes -- ``(16, 16)``
and ``(2, 16, 16)`` -- with no cards, which only the dry-run reads
(`repro_torch.launch.dryrun`).  A partition spec is a tuple with one entry
per leading dimension: ``None``, a mesh axis name, or a tuple of names.
On one card `place` puts a tensor on the device and the spec places
nothing more; sharding across cards is ROADMAP item 10b (b).

`init_distributed` brings up a `torch.distributed` process group over gloo
(the runner exchanges files and one barrier, never a tensor, so the same
launch works on hosts with and without a card) and `process_shard` reads
this process's (shard, num_shards) from it.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from repro_torch.device import resolve_device

__all__ = [
    "Mesh", "make_production_mesh", "make_local_mesh", "mesh_axis_sizes", "data_axis_size",
    "data_sharding", "place", "init_distributed", "process_shard",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a device mesh, and its cards in row-major
    order (none for a mesh that only the dry-run reads)."""

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


def data_sharding(mesh: Mesh) -> tuple:
    """The partition spec that splits an array's leading axis over
    ``data``, trailing axes replicated."""
    if "data" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no data axis")
    return ("data",)


def place(x, sharding: tuple | None = None, device: str | torch.device = "cuda") -> torch.Tensor:
    """Stage-input placement: ``x`` as a tensor on ``device``.  A partition
    spec (`data_sharding`) must fit ``x``'s rank; on one card it places
    nothing more."""
    t = torch.as_tensor(x, device=resolve_device(device))
    if sharding is not None and len(sharding) > t.dim():
        raise ValueError(f"place: spec {sharding} for a tensor of rank {t.dim()}")
    return t


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
