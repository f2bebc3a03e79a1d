"""Multi-process bring-up for the sharded sweep runner (port of the two
distributed functions of `repro.launch.mesh`).

`init_distributed` brings up a `torch.distributed` process group over gloo
(the runner exchanges files and one barrier, never a tensor, so the same
launch works on hosts with and without a card) and
`process_shard` reads this process's (shard, num_shards) from it.  The
rest of the reference module (device meshes, data sharding, placement)
belongs to the launch tooling (ROADMAP item 10b).
"""

from __future__ import annotations

import os

__all__ = ["init_distributed", "process_shard"]


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
