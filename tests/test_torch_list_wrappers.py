"""The port's list-in, list-out batch wrappers and lower bounds against the
reference's oracles, on the host, bit for bit in f64:

  * `pipeline.batch_alloc.allocate_batch` (one ensemble build, the batched
    allocation, materialized) against `repro.core.allocation.allocate` per
    instance, with and without tau;
  * `pipeline.batch_circuit.schedule_batch` on every calendar engine and
    both disciplines against `repro.core.scheduler._schedule_all_cores`
    and `repro.core.validate.ccts_from_schedules` per instance;
  * `core.lower_bounds.single_core_lb_ports`, `single_core_lb` and
    `allocation_upper_bound_rhs` against `repro.core.lower_bounds`.

The instances differ in every dimension (coflows, ports, cores, flows,
releases), so one batch mixes shapes as the reference's does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import allocation as ref_alloc
from repro.core import lower_bounds as ref_lb
from repro.core import scheduler as ref_sched
from repro.core.validate import ccts_from_schedules as ref_ccts
from repro.traffic.instances import paper_default_instance, random_instance, sample_instance
from repro_torch.convert import from_reference
from repro_torch.core import allocation as port_alloc
from repro_torch.core import lower_bounds as port_lb
from repro_torch.pipeline.batch_alloc import allocate_batch
from repro_torch.pipeline.batch_circuit import schedule_batch

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

ALLOC_FIELDS = ("coflow", "src", "dst", "size", "core", "rho_ports", "tau_ports", "prefix_lb")
SCHED_FIELDS = ("coflow", "src", "dst", "size", "establish", "complete", "rate", "delta")


def _empty_core():
    """delta = 0, K = 3, two single-flow coflows: one core gets no flow."""
    d = np.zeros((2, 3, 3))
    d[0, 1, 2] = 5e-324
    d[1, 0, 2] = 7.0
    base = random_instance(num_coflows=2, num_ports=3, num_cores=3, seed=0, delta=0.0)
    return dataclasses.replace(base, demands=d)


def _refs():
    return [
        random_instance(num_coflows=10, num_ports=4, num_cores=3, seed=0),
        random_instance(num_coflows=9, num_ports=5, num_cores=2, seed=1, release_span=25.0),
        sample_instance(num_ports=6, num_coflows=12, seed=1, release="trace"),
        paper_default_instance(seed=2),
        _empty_core(),
    ]


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.fixture(scope="module")
def ensemble():
    refs = _refs()
    orders = [np.random.default_rng(i).permutation(r.num_coflows) for i, r in enumerate(refs)]
    return refs, [from_reference(r, "cpu") for r in refs], orders


@pytest.mark.parametrize("include_tau", [True, False])
def test_allocate_batch_equals_the_reference_per_instance(ensemble, include_tau):
    refs, insts, orders = ensemble
    got = allocate_batch(insts, orders, include_tau=include_tau, device="cpu")
    assert len(got) == len(refs)
    for ref, order, alloc in zip(refs, orders, got):
        want = ref_alloc.allocate(ref, order, include_tau=include_tau)
        for f in ALLOC_FIELDS:
            _same(getattr(alloc, f), getattr(want, f), f)
    assert allocate_batch([], [], device="cpu") == []
    with pytest.raises(ValueError, match="mismatch"):
        allocate_batch(insts, orders[:1], device="cpu")


@pytest.mark.parametrize("engine", ["wide", "kernel", "jax", "auto"])
@pytest.mark.parametrize("discipline", ["greedy", "reserving"])
def test_schedule_batch_equals_the_reference_per_instance(ensemble, discipline, engine):
    """Every engine (the card engines run their kernels' plain twins on the
    host; ``auto`` resolves to ``wide`` there) against the per-instance
    oracle and its CCTs."""
    refs, insts, orders = ensemble
    allocs = [port_alloc.allocate(i, o) for i, o in zip(insts, orders)]
    got = schedule_batch(insts, allocs, orders, discipline=discipline, engine=engine,
                         device="cpu")
    for ref, order, (schedules, ccts) in zip(refs, orders, got):
        want = ref_sched._schedule_all_cores(ref, ref_alloc.allocate(ref, order), order,
                                             discipline=discipline)
        assert len(schedules) == len(want) == ref.num_cores
        for a, b in zip(schedules, want):
            for f in SCHED_FIELDS:
                _same(getattr(a, f), getattr(b, f), f)
        _same(ccts, ref_ccts(ref.num_coflows, want), "ccts")
    assert schedule_batch([], [], [], device="cpu") == []


def test_lower_bounds_equal_the_reference(ensemble):
    refs, insts, orders = ensemble
    for ref, inst, order in zip(refs, insts, orders):
        rho, tau = inst.port_stats()
        for k in range(ref.num_cores):
            rate, delta = float(ref.rates[k]), float(ref.delta)
            _same(port_lb.single_core_lb_ports(rho, tau, rate, delta),
                  ref_lb.single_core_lb_ports(rho, tau, rate, delta), "ports")
            for m in range(ref.num_coflows):
                got = port_lb.single_core_lb(rho[m], tau[m], rate, delta)
                assert isinstance(got, float)
                assert got == ref_lb.single_core_lb(rho[m], tau[m], rate, delta)
        rp, tp = port_lb.prefix_port_stats(inst, order)
        rmax, tmax = rp.max(axis=1), tp.max(axis=1)
        _same(port_lb.allocation_upper_bound_rhs(inst, rmax, tmax),
              ref_lb.allocation_upper_bound_rhs(ref, rmax, tmax), "rhs")
