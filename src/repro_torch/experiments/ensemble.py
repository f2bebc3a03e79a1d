"""Ensemble construction: bucket instances by padded shape for batched LP.

Port of `repro.experiments.ensemble`.  Instances are grouped into shape
buckets (M and 2N rounded up to a quantum) and each bucket is solved by
the batched solver (`lp.pack_lp_arrays` -> `lp.solve_subgradient_batch_arrays`)
on the device.  The ``mesh`` member sharding of the reference is not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import lp
from repro_torch.core.coflow import CoflowInstance
from repro_torch.device import resolve_device

__all__ = ["Bucket", "bucket_shape", "build_buckets", "solve_ensemble_lp"]


#: Bucket quanta of the reference: coflows and flat ports round up to 8.
_M_QUANTUM = 8
_P_QUANTUM = 8


def _round_up(n: int, quantum: int) -> int:
    return -(-n // quantum) * quantum


def bucket_shape(instance: CoflowInstance) -> tuple[int, int]:
    """Padded (coflows, flat ports) bucket an instance falls into."""
    return (
        _round_up(instance.num_coflows, _M_QUANTUM),
        _round_up(2 * instance.num_ports, _P_QUANTUM),
    )


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A group of instances sharing one padded LP shape."""

    num_coflows: int  # padded M
    num_flat_ports: int  # padded 2N
    indices: tuple[int, ...]  # positions in the original ensemble

    def __len__(self) -> int:
        return len(self.indices)


def build_buckets(instances: Sequence[CoflowInstance]) -> list[Bucket]:
    """Group ensemble members by padded shape, preserving input order."""
    groups: dict[tuple[int, int], list[int]] = {}
    for i, inst in enumerate(instances):
        groups.setdefault(bucket_shape(inst), []).append(i)
    return [
        Bucket(num_coflows=m, num_flat_ports=p, indices=tuple(idx))
        for (m, p), idx in sorted(groups.items())
    ]


def solve_ensemble_lp(
    instances: Sequence[CoflowInstance],
    iters: int = 3000,
    device: str | torch.device = "cuda",
) -> list[lp.LPSolution]:
    """Ordering-LP solutions for a whole ensemble, one batched solve per
    shape bucket on ``device``.  Returns solutions in input order."""
    device = resolve_device(device)
    instances = list(instances)
    solutions: list = [None] * len(instances)
    for bucket in build_buckets(instances):
        members = [instances[i] for i in bucket.indices]
        arrays = lp.pack_lp_arrays(
            members,
            pad_coflows=bucket.num_coflows,
            pad_ports=bucket.num_flat_ports,
            device=device,
        )
        batch = lp.solve_subgradient_batch_arrays(arrays, iters=iters)
        sols = batch.unpack([inst.num_coflows for inst in members])
        for i, sol in zip(bucket.indices, sols):
            solutions[i] = sol
    return solutions
