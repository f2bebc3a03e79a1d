"""The port's host NumPy oracles against the JAX package's, bit for bit.

Each function below is called on the same inputs (made from NumPy seeds)
on both sides and must return the same arrays, byte for byte
(tolerance: none):

* `allocate` (both ``include_tau``) and `Allocation.per_core_demand`;
* the five `core/circuit.py` functions: `resolve_event`, `pair_heads`,
  `resolve_event_pairs`, `schedule_core` (both disciplines) and
  `schedule_core_sequential`, with an empty core, a zero-size flow under
  delta = 0 and a coflow released late; `CoreSchedule.cct_per_coflow`;
* `_flow_priorities`, `_schedule_all_cores` (list and sequential),
  `tail_cct`, `ScheduleResult.normalized_to`;
* `core/bvn.py`: `stuff_to_constant_line_sums`, `_perfect_matching`,
  `bvn_decompose`, `bvn_execute_core`;
* `core/eps.py`: `fluid_schedule_core`, `eps_ccts`;
* `wspt_order`, `fifo_order` and `CoflowInstance.global_lower_bound`, with
  ties in the WSPT score and in the releases.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import allocation as ref_alloc
from repro.core import bvn as ref_bvn
from repro.core import circuit as ref_circuit
from repro.core import eps as ref_eps
from repro.core import ordering as ref_ordering
from repro.core import scheduler as ref_sched
from repro.traffic.instances import paper_default_instance, random_instance, sample_instance
from repro_torch.convert import from_reference
from repro_torch.core import allocation as port_alloc
from repro_torch.core import bvn as port_bvn
from repro_torch.core import circuit as port_circuit
from repro_torch.core import eps as port_eps
from repro_torch.core import ordering as port_ordering
from repro_torch.core import scheduler as port_sched

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

DISCIPLINES = ["greedy", "reserving"]


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _same_fields(a, b, fields):
    for f in fields:
        _same(getattr(a, f), getattr(b, f), f)


def _tie_instance():
    """Equal weights, equal lower bounds: four coflows with one identical
    demand matrix, and two with another; WSPT's score ties in two groups."""
    d = np.zeros((6, 3, 3))
    d[[0, 2, 3, 5]] = np.array([[0, 4.0, 0], [1.0, 0, 0], [0, 0, 2.0]])
    d[[1, 4]] = np.array([[3.0, 0, 0], [0, 0, 3.0], [0, 3.0, 0]])
    base = random_instance(num_coflows=6, num_ports=3, num_cores=2, seed=4)
    return dataclasses.replace(
        base, demands=d, weights=np.ones(6), releases=np.array([0, 2.0, 0, 2.0, 0, 0])
    )


def _late_instance():
    """A coflow released long after the others have finished."""
    base = random_instance(num_coflows=6, num_ports=4, num_cores=2, seed=9)
    rel = np.zeros(6)
    rel[2] = 1e4
    return dataclasses.replace(base, releases=rel)


def _empty_core_zero_delta():
    """delta = 0, K = 3, two single-flow coflows: one core gets no flow."""
    d = np.zeros((2, 3, 3))
    d[0, 1, 2] = 5e-324
    d[1, 0, 2] = 7.0
    base = random_instance(num_coflows=2, num_ports=3, num_cores=3, seed=0, delta=0.0)
    return dataclasses.replace(base, demands=d)


INSTANCES = {
    "zero": lambda: random_instance(num_coflows=10, num_ports=4, num_cores=3, seed=0),
    "arbitrary": lambda: random_instance(num_coflows=9, num_ports=5, num_cores=2, seed=1,
                                         release_span=25.0),
    "trace": lambda: sample_instance(num_ports=6, num_coflows=12, seed=1, release="trace"),
    "paper": lambda: paper_default_instance(seed=2),
    "ties": _tie_instance,
    "late": _late_instance,
    "empty_core": _empty_core_zero_delta,
}


def _pair(name):
    ref = INSTANCES[name]()
    return ref, from_reference(ref, "cpu")


def _order(ref, seed):
    return np.random.default_rng(seed).permutation(ref.num_coflows)


# ---------------------------------------------------------------------------
# Orders and instance statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(INSTANCES))
def test_orders_and_lower_bound(name):
    ref, inst = _pair(name)
    _same(inst.global_lower_bound(), ref.global_lower_bound(), "glb")
    _same(inst.max_port_load(), ref.max_port_load(), "max load")
    for a, b in zip(inst.port_stats(), ref.port_stats()):
        _same(a, b, "port stats")
    _same(port_ordering.wspt_order(inst), ref_ordering.wspt_order(ref), "wspt")
    _same(port_ordering.fifo_order(inst), ref_ordering.fifo_order(ref), "fifo")


def test_tie_instance_has_ties():
    ref, _ = _pair("ties")
    score = ref.weights / ref.global_lower_bound()
    assert len(np.unique(score)) == 2
    assert len(np.unique(ref.releases)) == 2
    # Stable: equal scores keep index order.
    assert list(ref_ordering.wspt_order(ref)) in ([1, 4, 0, 2, 3, 5], [0, 2, 3, 5, 1, 4])


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------

ALLOC_FIELDS = ("coflow", "src", "dst", "size", "core", "rho_ports", "tau_ports", "prefix_lb")


@pytest.mark.parametrize("include_tau", [True, False])
@pytest.mark.parametrize("name", list(INSTANCES))
def test_allocate(name, include_tau):
    ref, inst = _pair(name)
    for seed in range(2):
        order = _order(ref, seed)
        want = ref_alloc.allocate(ref, order, include_tau=include_tau)
        got = port_alloc.allocate(inst, order, include_tau=include_tau)
        _same_fields(got, want, ALLOC_FIELDS)
        assert got.num_flows() == want.num_flows()
        _same(got.per_core_demand(ref.num_coflows, ref.num_ports),
              want.per_core_demand(ref.num_coflows, ref.num_ports), "per-core demand")


# ---------------------------------------------------------------------------
# Circuit primitives
# ---------------------------------------------------------------------------


def _round_state(seed, F, N):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, F)
    dst = rng.integers(0, N, F)
    free_in = rng.choice([0.0, 1.0, 2.5, 4.0], N)
    free_out = rng.choice([0.0, 1.0, 2.5, 4.0], N)
    waiting = rng.random(F) < 0.7
    return src, dst, free_in, free_out, waiting


@pytest.mark.parametrize("discipline", DISCIPLINES)
@pytest.mark.parametrize("seed,F,N", [(0, 1, 1), (1, 12, 3), (2, 40, 5), (3, 200, 8), (4, 0, 4)])
def test_resolve_event(seed, F, N, discipline):
    src, dst, free_in, free_out, waiting = _round_state(seed, F, N)
    for t in (0.0, 1.0, 2.5, 5.0):
        want = ref_circuit.resolve_event(src, dst, free_in, free_out, waiting, t, discipline)
        got = port_circuit.resolve_event(src, dst, free_in, free_out, waiting, t, discipline)
        _same(got, want, f"t={t}")


@pytest.mark.parametrize("seed,F,N", [(0, 1, 1), (1, 12, 3), (2, 40, 5), (3, 200, 8), (4, 0, 4)])
def test_pair_heads_and_pair_round(seed, F, N):
    src, dst, free_in, free_out, waiting = _round_state(seed, F, N)
    want = ref_circuit.pair_heads(src, dst, waiting, N)
    got = port_circuit.pair_heads(src, dst, waiting, N)
    _same(got, want, "heads")
    idle = (free_in[:, None] <= 1.0) & (free_out[None, :] <= 1.0) & (want < F)
    _same(port_circuit.resolve_event_pairs(got, idle),
          ref_circuit.resolve_event_pairs(want, idle), "pair round")


def _core_flows(seed, F, N, M, delta_zero=False):
    """One core's subflows: sizes with ties (and a zero size when
    ``delta_zero``), a random priority, releases with a late one."""
    rng = np.random.default_rng(seed)
    coflow = rng.integers(0, M, F)
    src = rng.integers(0, N, F)
    dst = rng.integers(0, N, F)
    size = rng.integers(1, 6, F).astype(np.float64) * 1.5
    if delta_zero and F:
        size[rng.integers(0, F)] = 0.0
    priority = rng.permutation(F).astype(np.float64)
    releases = rng.choice([0.0, 0.0, 3.0, 11.0], M)
    releases[M - 1] = 1e3
    return coflow, src, dst, size, priority, releases


SCHED_FIELDS = ("coflow", "src", "dst", "size", "establish", "complete")
CORE_CASES = [(0, 0, 3, 4), (1, 1, 3, 2), (2, 30, 4, 6), (3, 120, 6, 10), (4, 400, 10, 25)]


@pytest.mark.parametrize("delta", [0.0, 2.0])
@pytest.mark.parametrize("discipline", DISCIPLINES)
@pytest.mark.parametrize("seed,F,N,M", CORE_CASES)
def test_schedule_core(seed, F, N, M, discipline, delta):
    coflow, src, dst, size, prio, rel = _core_flows(seed, F, N, M, delta_zero=delta == 0.0)
    args = (coflow, src, dst, size, prio, rel, N, 3.0, delta)
    want = ref_circuit.schedule_core(*args, discipline=discipline)
    got = port_circuit.schedule_core(*args, discipline=discipline)
    _same_fields(got, want, SCHED_FIELDS)
    assert (got.rate, got.delta) == (want.rate, want.delta)
    _same(got.cct_per_coflow(M), want.cct_per_coflow(M), "cct per coflow")


@pytest.mark.parametrize("delta", [0.0, 2.0])
@pytest.mark.parametrize("seed,F,N,M", CORE_CASES)
def test_schedule_core_sequential(seed, F, N, M, delta):
    coflow, src, dst, size, prio, rel = _core_flows(seed, F, N, M, delta_zero=delta == 0.0)
    rank = np.random.default_rng(seed + 100).permutation(M)
    args = (coflow, src, dst, size, prio, rank, rel, N, 3.0, delta)
    want = ref_circuit.schedule_core_sequential(*args)
    got = port_circuit.schedule_core_sequential(*args)
    _same_fields(got, want, SCHED_FIELDS)


def test_schedule_core_refuses_unknown_discipline_and_unscheduled_ccts():
    coflow, src, dst, size, prio, rel = _core_flows(0, 5, 3, 2)
    with pytest.raises(ValueError, match="discipline"):
        port_circuit.schedule_core(coflow, src, dst, size, prio, rel, 3, 1.0, 1.0,
                                   discipline="fifo")
    cs = port_circuit.schedule_core(coflow, src, dst, size, prio, rel, 3, 1.0, 1.0)
    cs.complete[0] = port_circuit.NOT_SCHEDULED
    with pytest.raises(ValueError, match="NOT_SCHEDULED"):
        cs.cct_per_coflow(2)


# ---------------------------------------------------------------------------
# Per-instance scheduling primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(INSTANCES))
def test_schedule_all_cores(name):
    ref, inst = _pair(name)
    order = _order(ref, 7)
    want_alloc = ref_alloc.allocate(ref, order)
    got_alloc = port_alloc.allocate(inst, order)
    M = ref.num_coflows
    _same(port_sched._flow_priorities(got_alloc, order, M),
          ref_sched._flow_priorities(want_alloc, order, M), "priorities")
    cases = [dict(sequential=True)] + [dict(discipline=d) for d in DISCIPLINES]
    for kw in cases:
        want = ref_sched._schedule_all_cores(ref, want_alloc, order, **kw)
        got = port_sched._schedule_all_cores(inst, got_alloc, order, **kw)
        assert len(got) == len(want) == ref.num_cores
        for a, b in zip(got, want):
            _same_fields(a, b, SCHED_FIELDS)


@pytest.mark.parametrize("q", [0.0, 0.5, 0.95, 0.99, 1.0])
def test_tail_cct(q):
    rng = np.random.default_rng(int(q * 100))
    for ccts in (rng.exponential(10.0, 100), np.array([3.0]), rng.integers(0, 4, 17) * 1.0):
        assert port_sched.tail_cct(ccts, q) == ref_sched.tail_cct(ccts, q)


def test_normalized_to():
    a = port_sched.ScheduleResult("A", None, None, None, None, 6.0, None, 0.0)
    b = port_sched.ScheduleResult("B", None, None, None, None, 4.0, None, 0.0)
    ra = ref_sched.ScheduleResult("A", None, None, None, None, 6.0, None, 0.0)
    rb = ref_sched.ScheduleResult("B", None, None, None, None, 4.0, None, 0.0)
    assert a.normalized_to(b) == ra.normalized_to(rb) == 1.5


# ---------------------------------------------------------------------------
# BvN
# ---------------------------------------------------------------------------


def _bvn_matrices(seed):
    rng = np.random.default_rng(seed)
    out = [np.zeros((3, 3)), np.diag([2.0, 0.0, 0.0])]
    for n in (1, 3, 5, 8):
        m = rng.exponential(5.0, (n, n)) * (rng.random((n, n)) < 0.4)
        out.append(m)
        out.append(np.round(m))  # integer entries: ties in the deficits
    return out


@pytest.mark.parametrize("seed", range(3))
def test_bvn(seed):
    for mat in _bvn_matrices(seed):
        want_s = ref_bvn.stuff_to_constant_line_sums(mat)
        got_s = port_bvn.stuff_to_constant_line_sums(mat)
        _same(got_s, want_s, "stuffed")
        for thr in (0.0, 1e-9):
            w, g = ref_bvn._perfect_matching(want_s > thr), port_bvn._perfect_matching(got_s > thr)
            assert (w is None) == (g is None)
            if w is not None:
                _same(g, w, "matching")
        want = ref_bvn.bvn_decompose(want_s)
        got = port_bvn.bvn_decompose(got_s)
        assert len(got) == len(want)
        for (cg, pg), (cw, pw) in zip(got, want):
            assert cg == cw
            _same(pg, pw, "permutation")


def test_perfect_matching_none_without_one():
    pos = np.array([[True, True, False], [True, True, False], [True, True, False]])
    assert port_bvn._perfect_matching(pos) is None
    assert ref_bvn._perfect_matching(pos) is None


@pytest.mark.parametrize("name", ["zero", "arbitrary", "trace", "late", "empty_core"])
def test_bvn_execute_core(name):
    ref, inst = _pair(name)
    order = _order(ref, 3)
    alloc = ref_alloc.allocate(ref, order)
    per_core = alloc.per_core_demand(ref.num_coflows, ref.num_ports)
    for k in range(ref.num_cores):
        mats = [(int(m), per_core[k, m]) for m in order]
        args = (mats, ref.releases, float(ref.rates[k]), ref.delta)
        assert port_bvn.bvn_execute_core(*args) == ref_bvn.bvn_execute_core(*args)


# ---------------------------------------------------------------------------
# EPS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,F,N,M", CORE_CASES)
def test_fluid_schedule_core(seed, F, N, M):
    coflow, src, dst, size, prio, rel = _core_flows(seed, F, N, M)
    args = (coflow, src, dst, size, prio, rel, N, 4.0)
    want = ref_eps.fluid_schedule_core(*args)
    got = port_eps.fluid_schedule_core(*args)
    _same_fields(got, want, ("coflow", "src", "dst", "size", "complete"))
    assert got.rate == want.rate


@pytest.mark.parametrize("name", ["zero", "arbitrary", "trace", "late", "empty_core"])
def test_eps_ccts(name):
    ref, inst = _pair(name)
    ref = dataclasses.replace(ref, delta=0.0)
    inst = from_reference(ref, "cpu")
    order = _order(ref, 5)
    alloc = ref_alloc.allocate(ref, order, include_tau=False)
    prio = ref_sched._flow_priorities(alloc, order, ref.num_coflows)
    want_s, got_s = [], []
    for h in range(ref.num_cores):
        sel = alloc.core == h
        args = (alloc.coflow[sel], alloc.src[sel], alloc.dst[sel], alloc.size[sel],
                prio[sel], ref.releases, ref.num_ports, float(ref.rates[h]))
        want_s.append(ref_eps.fluid_schedule_core(*args))
        got_s.append(port_eps.fluid_schedule_core(*args))
    _same(port_eps.eps_ccts(inst, got_s), ref_eps.eps_ccts(ref, want_s), "eps ccts")
