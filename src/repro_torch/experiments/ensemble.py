"""Ensemble construction: bucket instances by padded shape for batched LP.

Port of `repro.experiments.ensemble`.  Instances are grouped into shape
buckets (M and 2N rounded up to a quantum) and each bucket is solved by
the batched solver (`lp.pack_lp_arrays` -> `lp.solve_subgradient_batch_arrays`)
on the device.  A quantum of ``None`` collapses that axis to the ensemble
maximum (one bucket, one solve).  With ``mesh=`` each bucket's member axis
is padded to a multiple of the mesh's ``data`` size and solved sharded
(`repro_torch.launch.mesh.data_sharding`), then gathered to the host
(`repro_torch.experiments.results.device_gather`); members are
independent, so each member's bits are the unsharded solve's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import lp
from repro_torch.core.coflow import CoflowInstance
from repro_torch.device import resolve_device
from repro_torch.experiments.results import device_gather
from repro_torch.launch.mesh import Mesh, data_axis_size, data_sharding

__all__ = ["COLLAPSED", "Bucket", "bucket_shape", "build_buckets", "solve_ensemble_lp"]

#: `bucket_shape` sentinel for an axis collapsed to the ensemble maximum
#: (quantum ``None``).  Distinct from 0: an M = 0 instance rounds to 0
#: under any quantum and keeps its own zero-shaped bucket.
COLLAPSED = -1


def _round_up(n: int, quantum: int) -> int:
    return -(-n // quantum) * quantum


def bucket_shape(
    instance: CoflowInstance,
    m_quantum: int | None = 8,
    p_quantum: int | None = 8,
) -> tuple[int, int]:
    """Padded (coflows, flat ports) bucket an instance falls into; a
    ``None`` quantum gives `COLLAPSED` on that axis (resolved to the
    ensemble maximum in `build_buckets`)."""
    return (
        COLLAPSED if m_quantum is None else _round_up(instance.num_coflows, m_quantum),
        COLLAPSED if p_quantum is None else _round_up(2 * instance.num_ports, p_quantum),
    )


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A group of instances sharing one padded LP shape."""

    num_coflows: int  # padded M
    num_flat_ports: int  # padded 2N
    indices: tuple[int, ...]  # positions in the original ensemble

    def __len__(self) -> int:
        return len(self.indices)


def build_buckets(
    instances: Sequence[CoflowInstance],
    m_quantum: int | None = 8,
    p_quantum: int | None = 8,
) -> list[Bucket]:
    """Group ensemble members by padded shape, preserving input order.

    ``None`` quanta collapse that axis to the ensemble maximum
    (``m_quantum=p_quantum=None``: a single bucket).
    """
    groups: dict[tuple[int, int], list[int]] = {}
    for i, inst in enumerate(instances):
        groups.setdefault(bucket_shape(inst, m_quantum, p_quantum), []).append(i)
    max_m = max((inst.num_coflows for inst in instances), default=0)
    max_p = max((2 * inst.num_ports for inst in instances), default=0)
    return [
        Bucket(
            num_coflows=max_m if m == COLLAPSED else m,
            num_flat_ports=max_p if p == COLLAPSED else p,
            indices=tuple(idx),
        )
        for (m, p), idx in sorted(groups.items())
    ]


def solve_ensemble_lp(
    instances: Sequence[CoflowInstance],
    iters: int = 3000,
    m_quantum: int | None = 8,
    p_quantum: int | None = 8,
    device: str | torch.device = "cuda",
    mesh: Mesh | None = None,
) -> list[lp.LPSolution]:
    """Ordering-LP solutions for a whole ensemble, one batched solve per
    shape bucket on ``device``.  Returns solutions in input order.

    With ``mesh`` every bucket's padded member axis is sharded over the
    mesh's ``data`` axis; bucket sizes that do not divide the shard count
    round up with fully masked members.
    """
    device = resolve_device(device)
    instances = list(instances)
    solutions: list = [None] * len(instances)
    sharding, n_shards = None, 1
    if mesh is not None:
        sharding, n_shards = data_sharding(mesh), data_axis_size(mesh)
    for bucket in build_buckets(instances, m_quantum, p_quantum):
        members = [instances[i] for i in bucket.indices]
        arrays = lp.pack_lp_arrays(
            members,
            pad_coflows=bucket.num_coflows,
            pad_ports=bucket.num_flat_ports,
            pad_members=_round_up(len(members), n_shards),
            device=device,
        )
        batch = lp.solve_subgradient_batch_arrays(arrays, iters=iters, sharding=sharding)
        if sharding is not None:
            batch = device_gather(batch)
        sols = batch.unpack([inst.num_coflows for inst in members])
        for i, sol in zip(bucket.indices, sols):
            solutions[i] = sol
    return solutions
