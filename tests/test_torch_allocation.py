"""The port's batched allocation against `repro.core.allocation.allocate`.

Contract: bit-identical (core choices, flow sequence, prefix port stats
and prefix lower bounds, dtypes included), with and without the tau term,
on mixed-shape ensembles whose members pad flows, ports and cores
differently.  Tolerance: none.
"""

import numpy as np
import pytest
import torch

from repro.core.allocation import allocate
from repro.traffic.instances import random_instance
from repro_torch.convert import from_reference
from repro_torch.pipeline.batch_alloc import allocate_batch_arrays
from repro_torch.pipeline.ensemble_batch import build_ensemble_batch

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

FIELDS = ("coflow", "src", "dst", "size", "core", "rho_ports", "tau_ports", "prefix_lb")


def _mixed(seed):
    rng = np.random.default_rng(seed)
    return [
        random_instance(
            num_coflows=int(rng.integers(1, 12)), num_ports=int(rng.integers(2, 7)),
            num_cores=int(rng.integers(1, 4)), delta=float(rng.choice([0.0, 2.0, 8.0])),
            density=float(rng.uniform(0.15, 0.8)), seed=100 * seed + i,
        )
        for i in range(4)
    ]


@pytest.mark.parametrize("include_tau", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocation_bit_identical(seed, include_tau):
    refs = _mixed(seed)
    rng = np.random.default_rng(seed)
    orders = [rng.permutation(r.num_coflows) for r in refs]
    ens = build_ensemble_batch([from_reference(r, "cpu") for r in refs], device="cpu")
    batch = allocate_batch_arrays(ens, ens.pad_orders(orders), include_tau=include_tau)
    for inst, order, got in zip(refs, orders, batch.materialize(ens)):
        want = allocate(inst, order, include_tau=include_tau)
        for f in FIELDS:
            x, y = getattr(got, f), getattr(want, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert x.tobytes() == y.tobytes(), f


def test_allocation_of_single_flow_and_padding_members():
    """F=1 beside a larger member: the short member's padded flow steps
    must leave its state bit-identical."""
    one = random_instance(num_coflows=1, num_ports=2, num_cores=3, density=0.01, seed=3)
    big = random_instance(num_coflows=9, num_ports=5, num_cores=2, seed=4)
    refs = [one, big]
    orders = [np.arange(r.num_coflows) for r in refs]
    ens = build_ensemble_batch([from_reference(r, "cpu") for r in refs], device="cpu")
    batch = allocate_batch_arrays(ens, ens.pad_orders(orders))
    for inst, order, got in zip(refs, orders, batch.materialize(ens)):
        want = allocate(inst, order)
        for f in FIELDS:
            assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f
