"""The port's circuit calendars against the NumPy event loop.

Contract: under every engine (``"kernel"``, pair space on `pair_resolve`;
``"jax"``, flow space on `event_resolve`; ``"wide"``, the host NumPy pair
engine) establish and complete times bit-identical to
`repro.core.scheduler._schedule_all_cores` (hence `schedule_core`) on both
disciplines -- mixed shapes, zero and arbitrary releases, zero-duration
chains, empty cores, F=1 and the empty ensemble -- and to each other; the
lean `cct_batch_arrays` gives the full stage's CCTs.  The host checks for
live members only every few rounds; `test_idle_rounds_change_nothing`
shows that the extra rounds this runs are exact no-ops.  ``"auto"`` and
``REPRO_CIRCUIT_ENGINE`` resolve as the reference's `_check_engine`, with
the device for its backend, and ``circuit_backend="loop"`` gives the
batch backend's bits.  Tolerance: none.
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
# The device engines and the host one.
ALL_ENGINES = ENGINES + ["wide"]
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


@pytest.mark.parametrize("engine", ALL_ENGINES)
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


@pytest.mark.parametrize("engine", ALL_ENGINES)
@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_trace_releases(discipline, engine):
    from repro.traffic.instances import sample_instance

    refs = [sample_instance(num_ports=5, num_coflows=10, seed=s, release="trace") for s in range(2)]
    _run_ensemble(refs, discipline, engine)


@pytest.mark.parametrize("engine", ALL_ENGINES)
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


@pytest.mark.parametrize("engine", ALL_ENGINES)
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
    ("loop", "unknown circuit engine 'loop'"),
    ("turbo", "unknown circuit engine 'turbo'"),
])
def test_unported_and_unknown_engines_raise(engine, msg, monkeypatch):
    """A name that is no engine raises everywhere, whatever
    ``REPRO_CIRCUIT_ENGINE`` says (it stands in for ``"auto"`` only)."""
    from repro_torch.pipeline import get_pipeline
    from repro_torch.pipeline.stages import ListCircuit

    monkeypatch.setenv("REPRO_CIRCUIT_ENGINE", "jax")
    ens = build_ensemble_batch([from_reference(random_instance(seed=0), "cpu")], device="cpu")
    alloc = allocate_batch_arrays(ens, ens.pad_orders([np.arange(12)]))
    with pytest.raises(ValueError, match=msg):
        bc.schedule_batch_arrays(ens, alloc, engine=engine)
    with pytest.raises(ValueError, match=msg):
        bc.cct_batch_arrays(ens, alloc, engine=engine)
    with pytest.raises(ValueError, match=msg):
        ListCircuit("greedy", engine=engine)
    with pytest.raises(ValueError, match=msg):
        get_pipeline("ours", circuit_engine=engine)


def test_resolve_engine_auto_env_and_explicit(monkeypatch):
    """The cases of the reference's `_check_engine` test, with the device
    standing in for ``jax.default_backend()``: ``"auto"`` is ``"kernel"``
    on a card and ``"wide"`` on the host; a non-empty
    ``REPRO_CIRCUIT_ENGINE`` overrides ``"auto"`` only, never an explicit
    engine; junk in it raises."""
    monkeypatch.delenv("REPRO_CIRCUIT_ENGINE", raising=False)
    for device, want in (("cpu", "wide"), (torch.device("cpu"), "wide"),
                         ("cuda", "kernel"), (torch.device("cuda", 0), "kernel")):
        assert bc.resolve_engine("auto", device) == want
    monkeypatch.setenv("REPRO_CIRCUIT_ENGINE", " JAX ")
    assert bc.resolve_engine("auto", "cpu") == "jax"
    assert bc.resolve_engine("auto", "cuda") == "jax"
    for engine in ALL_ENGINES:  # an explicit engine wins over the variable
        assert bc.resolve_engine(engine, "cpu") == engine
    monkeypatch.setenv("REPRO_CIRCUIT_ENGINE", "  ")
    assert bc.resolve_engine("auto", "cpu") == "wide"
    monkeypatch.setenv("REPRO_CIRCUIT_ENGINE", "turbo")
    with pytest.raises(ValueError, match="REPRO_CIRCUIT_ENGINE"):
        bc.resolve_engine("auto", "cpu")
    assert bc.resolve_engine("kernel", "cpu") == "kernel"


@pytest.mark.parametrize("env,runs", [(None, "wide"), ("jax", "jax"), ("kernel", "kernel")])
def test_auto_runs_the_resolved_engine(env, runs, monkeypatch):
    """``circuit_engine="auto"`` on host tensors runs the engine it resolves
    to (counted by `ROUNDS`; ``"wide"`` counts none) with the same bits."""
    if env is None:
        monkeypatch.delenv("REPRO_CIRCUIT_ENGINE", raising=False)
    else:
        monkeypatch.setenv("REPRO_CIRCUIT_ENGINE", env)
    monkeypatch.setattr(bc, "ROUNDS", dict.fromkeys(ENGINES, 0))
    refs = [random_instance(num_coflows=7, num_ports=4, num_cores=2, seed=s,
                            release_span=9.0 * s) for s in range(3)]
    orders = [wspt_order(r) for r in refs]
    ens = build_ensemble_batch([from_reference(r, "cpu") for r in refs], device="cpu")
    alloc = allocate_batch_arrays(ens, ens.pad_orders(orders))
    got = bc.schedule_batch_arrays(ens, alloc, discipline="greedy", engine="auto")
    rounds = dict(bc.ROUNDS)
    want = bc.schedule_batch_arrays(ens, alloc, discipline="greedy", engine="kernel")
    for (sg, cg), (sw, cw) in zip(got, want):
        _assert_same(sg, sw, "auto")
        assert cg.tobytes() == cw.tobytes()
    assert {e for e, n in rounds.items() if n} == ({runs} if runs in ENGINES else set())


@pytest.mark.parametrize("engine", ALL_ENGINES)
@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_cct_batch_arrays_equals_full_stage(discipline, engine):
    """The lean CCTs equal `ccts_from_schedules` of the full stage bit for
    bit in each row's real prefix, and are 0 on padding."""
    rng = np.random.default_rng(7)
    refs = [
        random_instance(num_coflows=int(rng.integers(2, 10)), num_ports=int(rng.integers(2, 6)),
                        num_cores=int(rng.integers(1, 4)), release_span=12.0 * i, seed=50 + i)
        for i in range(4)
    ]
    orders = [wspt_order(r) for r in refs]
    ens = build_ensemble_batch([from_reference(r, "cpu") for r in refs], device="cpu")
    alloc = allocate_batch_arrays(ens, ens.pad_orders(orders))
    cct = bc.cct_batch_arrays(ens, alloc, discipline=discipline, engine=engine)
    full = bc.schedule_batch_arrays(ens, alloc, discipline=discipline, engine=engine)
    assert cct.shape == (len(refs), ens.pad_coflows) and cct.dtype == np.float64
    for b, (ref, (_, ccts)) in enumerate(zip(refs, full)):
        M = ref.num_coflows
        assert cct[b, :M].tobytes() == ccts.tobytes()
        assert not cct[b, M:].any()


def test_wide_runs_no_device_round_and_empty_ensemble(monkeypatch):
    """The host engine calls neither round kernel and counts no round; an
    empty ensemble and empty member arrays give empty results."""
    monkeypatch.setattr(bc, "ROUNDS", dict.fromkeys(ENGINES, 0))

    def refuse(*args):
        raise AssertionError("the wide engine called a round kernel")

    monkeypatch.setattr(bc, "pair_resolve", refuse)
    monkeypatch.setattr(bc, "event_resolve", refuse)
    _run_ensemble([random_instance(num_coflows=6, num_ports=4, num_cores=2, seed=3,
                                   release_span=5.0)], "greedy", "wide")
    assert bc.ROUNDS == {"kernel": 0, "jax": 0}
    empty = build_ensemble_batch([], device="cpu")
    assert bc.schedule_batch_arrays(empty, None, engine="wide") == []
    assert bc.cct_batch_arrays(empty, None, engine="wide").shape == (0, 0)
    z = np.zeros((0, 0))
    est, comp = bc._run_calendar_wide(z.astype(np.int64), z.astype(np.int64), z, z,
                                      z.astype(bool), 4, True, 10)
    assert est.shape == comp.shape == (0, 0)


LOOP_SCHEMES = ["ours", "wspt_order", "load_only", "ours_ls"]


@pytest.mark.parametrize("scheme", LOOP_SCHEMES)
@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_loop_backend_equals_batch(scheme, discipline):
    """``circuit_backend="loop"`` (the per-instance host oracle) gives the
    batch backend's orders, core choices, times and CCTs bit for bit; for
    ``ours_ls`` its refinement runs `refine_sequential`, which
    ``require_batch=True`` refuses, as it refuses the loop's circuit."""
    from repro.core import lp as ref_lp
    from repro_torch.pipeline import get_pipeline

    refs = [random_instance(num_coflows=m, num_ports=n, num_cores=k, seed=s,
                            release_span=10.0 * (s % 2))
            for m, n, k, s in [(6, 3, 2, 0), (8, 4, 3, 1), (5, 5, 1, 2)]]
    insts = [from_reference(r, "cpu") for r in refs]
    sols = [from_reference(ref_lp.solve_exact(r), "cpu") for r in refs]
    batch = get_pipeline(scheme, discipline=discipline).run_batch(insts, sols, device="cpu")
    loop_pipe = get_pipeline(scheme, discipline=discipline, circuit_backend="loop")
    loop = loop_pipe.run_batch(insts, sols, device="cpu")
    for a, b in zip(loop, batch):
        assert a.order.tobytes() == b.order.tobytes()
        assert a.allocation.core.tobytes() == b.allocation.core.tobytes()
        _assert_same(a.core_schedules, b.core_schedules, scheme)
        assert a.ccts.tobytes() == b.ccts.tobytes()
        assert a.total_weighted_cct == b.total_weighted_cct
    match = "sequential refinement" if scheme == "ours_ls" else "per-instance circuit loop"
    with pytest.raises(RuntimeError, match=match):
        loop_pipe.run_batch(insts, sols, device="cpu", require_batch=True)


def test_unknown_backend_raises():
    from repro_torch.pipeline import get_pipeline
    from repro_torch.pipeline.stages import ListCircuit

    with pytest.raises(ValueError, match="unknown circuit backend 'vector'"):
        ListCircuit("greedy", backend="vector")
    with pytest.raises(ValueError, match="unknown circuit backend"):
        get_pipeline("ours", circuit_backend="vector")
    # Stages with no batched form ignore the backend, as the reference's do.
    assert get_pipeline("bvn_s", circuit_backend="vector").circuit_stage.kind == "bvn"
    loop = ListCircuit("greedy", backend="loop")
    assert loop.schedule_batch_arrays(None, None) is None
    assert loop.cct_batch_arrays(None, None) is None
