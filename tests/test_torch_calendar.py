"""The port's circuit calendars against the NumPy event loop.

Contract: under both engines (``"kernel"``, pair space on `pair_resolve`;
``"jax"``, flow space on `event_resolve`) establish and complete times
bit-identical to `repro.core.scheduler._schedule_all_cores` (hence
`schedule_core`) on both disciplines -- mixed shapes, zero and arbitrary
releases, zero-duration chains, empty cores and F=1 -- and to each other.
The host checks for live members only every few rounds;
`test_idle_rounds_change_nothing` shows that the extra rounds this runs
are exact no-ops.  Tolerance: none.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.allocation import Allocation, allocate
from repro.core.ordering import wspt_order
from repro.core.scheduler import _schedule_all_cores
from repro.core.validate import ccts_from_schedules
from repro.traffic.instances import random_instance
from repro_torch.convert import from_reference
from repro_torch.kernels.event_resolve import event_resolve_plain
from repro_torch.kernels.pair_resolve import pair_resolve_plain
from repro_torch.pipeline import batch_circuit as bc
from repro_torch.pipeline.batch_alloc import allocate_batch_arrays
from repro_torch.pipeline.ensemble_batch import build_ensemble_batch

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

DISCIPLINES = ["reserving", "greedy"]
ENGINES = ["kernel", "jax"]
SCHED_FIELDS = ("coflow", "src", "dst", "size", "establish", "complete")


def _assert_same(got, ref, ctx):
    assert len(got) == len(ref), ctx
    for k, (a, b) in enumerate(zip(got, ref)):
        for f in SCHED_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, (ctx, k, f)
            assert x.tobytes() == y.tobytes(), (ctx, k, f)
        assert a.rate == b.rate and a.delta == b.delta, (ctx, k)


def _run_ensemble(refs, discipline, engine):
    orders = [wspt_order(r) for r in refs]
    ens = build_ensemble_batch([from_reference(r, "cpu") for r in refs], device="cpu")
    alloc = allocate_batch_arrays(ens, ens.pad_orders(orders))
    got = bc.schedule_batch_arrays(ens, alloc, discipline=discipline, engine=engine)
    for inst, order, (schedules, ccts) in zip(refs, orders, got):
        ref = _schedule_all_cores(inst, allocate(inst, order), order, discipline=discipline)
        _assert_same(schedules, ref, discipline)
        assert ccts.tobytes() == ccts_from_schedules(inst.num_coflows, ref).tobytes()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("discipline", DISCIPLINES)
@pytest.mark.parametrize("seed", range(4))
def test_fuzz_mixed_shapes_and_releases(seed, discipline, engine):
    rng = np.random.default_rng(seed)
    refs = [
        random_instance(
            num_coflows=int(rng.integers(2, 12)), num_ports=int(rng.integers(2, 7)),
            num_cores=int(rng.integers(1, 4)), delta=float(rng.choice([0.0, 2.0, 8.0])),
            density=float(rng.uniform(0.15, 0.8)),
            release_span=float(rng.choice([0.0, 25.0])), seed=1000 * seed + i,
        )
        for i in range(4)
    ]
    _run_ensemble(refs, discipline, engine)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_trace_releases(discipline, engine):
    from repro.traffic.instances import sample_instance

    refs = [sample_instance(num_ports=5, num_coflows=10, seed=s, release="trace") for s in range(2)]
    _run_ensemble(refs, discipline, engine)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_single_flow_and_empty_cores(discipline, engine):
    demands = np.zeros((1, 3, 3))
    demands[0, 1, 2] = 7.0
    inst = dataclasses.replace(
        random_instance(num_coflows=1, num_ports=3, num_cores=3, seed=0), demands=demands
    )
    _run_ensemble([inst], discipline, engine)


def _raw_alloc(coflow, src, dst, size, core, K, N):
    z = np.zeros((K, 2 * N))
    return Allocation(
        coflow=np.asarray(coflow, dtype=np.int64), src=np.asarray(src, dtype=np.int64),
        dst=np.asarray(dst, dtype=np.int64), size=np.asarray(size, dtype=np.float64),
        core=np.asarray(core, dtype=np.int64), rho_ports=z, tau_ports=z.copy(),
        prefix_lb=np.zeros(int(np.max(coflow)) + 1),
    )


def _run_tables(inst, alloc, order, discipline, engine, check_every=bc._CHECK_EVERY):
    tabs = bc.member_tables(from_reference(inst, "cpu"), from_reference(alloc, "cpu"), order)
    live = [t for t in tabs if t["coflow"].shape[0]]
    est, comp = bc._execute_members(
        live, inst.num_ports, discipline, torch.device("cpu"),
        labels=[str(g) for g in range(len(live))], engine=engine,
        check_every=check_every,
    )
    return live, est, comp


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_zero_duration_chains(discipline, engine):
    """size=0 + delta=0 flows chain same-pair starts at one instant."""
    N, K = 4, 2
    inst = dataclasses.replace(
        random_instance(num_coflows=3, num_ports=N, num_cores=K, seed=1), delta=0.0
    )
    alloc = _raw_alloc(
        coflow=[0, 0, 1, 2, 2], src=[0, 0, 1, 0, 3], dst=[1, 1, 2, 1, 3],
        size=[0.0, 0.0, 5.0, 0.0, 2.0], core=[0, 0, 0, 0, 1], K=K, N=N,
    )
    order = np.arange(3)
    live, est, comp = _run_tables(inst, alloc, order, discipline, engine)
    ref = _schedule_all_cores(inst, alloc, order, discipline=discipline)
    for g, (tab, cs) in enumerate(zip(live, ref)):
        F = tab["src"].shape[0]
        assert est[g, :F].tobytes() == cs.establish.tobytes()
        assert comp[g, :F].tobytes() == cs.complete.tobytes()
        assert (est[g, :F] >= 0).all()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_idle_rounds_change_nothing(discipline, engine):
    """Checking for live members after every round, or never (running all
    `event_bound` rounds), gives the same bits; and rounds on a finished
    calendar leave every carried tensor untouched."""
    refs = [
        random_instance(num_coflows=8, num_ports=4, num_cores=2, seed=s, release_span=10.0 * s)
        for s in range(3)
    ]
    for inst in refs:
        order = wspt_order(inst)
        alloc = allocate(inst, order)
        runs = [_run_tables(inst, alloc, order, discipline, engine, k)[1:] for k in (1, 10**9)]
        assert runs[0][0].tobytes() == runs[1][0].tobytes()
        assert runs[0][1].tobytes() == runs[1][1].tobytes()
        live, est, comp = _run_tables(inst, alloc, order, discipline, engine)
        ref = _schedule_all_cores(inst, alloc, order, discipline=discipline)
        for g, cs in enumerate(c for c in ref if len(c.coflow)):
            F = cs.establish.shape[0]
            assert est[g, :F].tobytes() == cs.establish.tobytes()

    pad = bc._pad_members(live, refs[-1].num_ports)
    cal = bc._CALENDARS[engine](pad, discipline == "reserving", torch.device("cpu"))
    cal.run()
    assert not cal.live()
    before = {k: v.clone() for k, v in cal.state.items()}
    for _ in range(5):
        cal.round()
    for k, v in cal.state.items():
        assert torch.equal(v, before[k]), k


# Engine -> (the wrapper its rounds call, that wrapper's plain twin).
_ROUND_KERNELS = {
    "kernel": ("pair_resolve", pair_resolve_plain),
    "jax": ("event_resolve", event_resolve_plain),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_rounds_count_pair_resolve_calls(discipline, engine, monkeypatch):
    """`ROUNDS[engine]` advances by exactly the number of calls of the
    engine's round kernel (`pair_resolve` or `event_resolve`), the count
    its launch counter is held to on the card; the other engine's count
    and kernel stay untouched."""
    calls = {name: [] for name, _ in _ROUND_KERNELS.values()}
    for name, plain in _ROUND_KERNELS.values():
        def counted(*args, _name=name, _plain=plain):
            calls[_name].append(1)
            return _plain(*args)

        monkeypatch.setattr(bc, name, counted)
    monkeypatch.setattr(bc, "ROUNDS", dict.fromkeys(ENGINES, 0))
    inst = random_instance(num_coflows=6, num_ports=4, num_cores=2, seed=5, release_span=8.0)
    order = wspt_order(inst)
    _run_tables(inst, allocate(inst, order), order, discipline, engine)
    name = _ROUND_KERNELS[engine][0]
    other = next(e for e in ENGINES if e != engine)
    assert bc.ROUNDS[engine] == len(calls[name]) > 0
    assert bc.ROUNDS[other] == len(calls[_ROUND_KERNELS[other][0]]) == 0


@pytest.mark.parametrize("discipline", DISCIPLINES)
@pytest.mark.parametrize("seed", range(3))
def test_engines_agree_and_count_rounds(seed, discipline, monkeypatch):
    """Both engines give the same bits.  Under reserving they advance on
    the same condition, so they run the same rounds; under greedy the flow
    engine may run more (it also holds the clock for an idle later flow of
    a pair whose head just started)."""
    rng = np.random.default_rng(seed)
    inst = random_instance(
        num_coflows=10, num_ports=int(rng.integers(2, 6)), num_cores=2,
        delta=float(rng.choice([0.0, 4.0])), release_span=20.0 * seed, seed=seed,
    )
    order = wspt_order(inst)
    alloc = allocate(inst, order)
    monkeypatch.setattr(bc, "ROUNDS", dict.fromkeys(ENGINES, 0))
    runs = {e: _run_tables(inst, alloc, order, discipline, e, check_every=1) for e in ENGINES}
    for a, b in zip(runs["kernel"][1:], runs["jax"][1:]):
        assert a.tobytes() == b.tobytes()
    if discipline == "reserving":
        assert bc.ROUNDS["jax"] == bc.ROUNDS["kernel"] > 0
    else:
        assert bc.ROUNDS["jax"] >= bc.ROUNDS["kernel"] > 0


def test_event_bound_and_bad_discipline():
    assert bc.event_bound(0) == 4 and bc.event_bound(100) == 304
    ens = build_ensemble_batch([from_reference(random_instance(seed=0), "cpu")], device="cpu")
    alloc = allocate_batch_arrays(ens, ens.pad_orders([np.arange(12)]))
    with pytest.raises(ValueError, match="unknown discipline"):
        bc.schedule_batch_arrays(ens, alloc, discipline="nope")


@pytest.mark.parametrize("engine,msg", [
    ("wide", "'wide' .* not ported yet"),
    ("auto", "'auto' is not ported"),
    ("loop", "unknown circuit engine 'loop'"),
])
def test_unported_and_unknown_engines_raise(engine, msg, monkeypatch):
    """The reference's host engine ``"wide"`` and its ``"auto"`` choice are
    not ported, and no environment variable picks an engine."""
    from repro_torch.pipeline import get_pipeline
    from repro_torch.pipeline.stages import ListCircuit

    monkeypatch.setenv("REPRO_CIRCUIT_ENGINE", "jax")
    ens = build_ensemble_batch([from_reference(random_instance(seed=0), "cpu")], device="cpu")
    alloc = allocate_batch_arrays(ens, ens.pad_orders([np.arange(12)]))
    with pytest.raises(ValueError, match=msg):
        bc.schedule_batch_arrays(ens, alloc, engine=engine)
    with pytest.raises(ValueError, match=msg):
        ListCircuit("greedy", engine)
    with pytest.raises(ValueError, match=msg):
        get_pipeline("ours", circuit_engine=engine)
