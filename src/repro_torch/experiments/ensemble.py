"""Ensemble construction: bucket instances by padded shape for batched LP.

Port of `repro.experiments.ensemble`.  Instances are grouped into shape
buckets (M and 2N rounded up to a quantum) and each bucket is solved by
the batched solver (`lp.pack_lp_arrays` -> `lp.solve_subgradient_batch_arrays`)
on the device.  A quantum of ``None`` collapses that axis to the ensemble
maximum (one bucket, one solve).  The reference's ``mesh`` member sharding
is left for the launch tooling (ROADMAP item 10b): members are independent,
so a sharded solve gives the same bits per member.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import lp
from repro_torch.core.coflow import CoflowInstance
from repro_torch.device import resolve_device

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
) -> list[lp.LPSolution]:
    """Ordering-LP solutions for a whole ensemble, one batched solve per
    shape bucket on ``device``.  Returns solutions in input order."""
    device = resolve_device(device)
    instances = list(instances)
    solutions: list = [None] * len(instances)
    for bucket in build_buckets(instances, m_quantum, p_quantum):
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
