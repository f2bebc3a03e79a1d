"""`repro_torch.experiments.stream` end to end on the CPU, against the
reference.

`repro.streaming` cannot be imported under the installed JAX, so the
reference's own `stream` (with `EpochRecord`, `StreamResult`,
`_WarmState`, `_Calendar`, `_Busy` and `_arrival_batches`) is compiled
from `src/repro/streaming/service.py` with `ast`, its `SlotPool` loaded
from `pool.py` by file path, and the names it imports from
`repro.pipeline` are bound to the port's CPU counterparts, which the
other `test_torch_*` files hold to the reference: `get_pipeline`,
`build_ensemble_batch`, `schedule_batch_arrays`, `order_view`,
`ListCircuit`, `build_slot_pool_batch`, `update_slots`,
`set_slot_releases`, `free_slots`, `_round_up`, `CoreSchedule`,
`CoflowInstance` and `validate_schedule`; its `lp` is the reference's
`repro.core.lp` for `solve_exact` and the port's for the batched solver
and the warm starts, and its `jnp` makes host tensors.  Adapters turn its
NumPy arrays into tensors where the port's stages take tensors.  Nothing
in the JAX package changes.  Tolerance: none, except where the (8K+1)
bound is a bound.

* The event loop equals the reference's loop: every epoch (time, actives,
  admissions, order, projected CCTs, committed circuits, LP objective,
  warm flag, iterations) and the admission and finish vectors, under both
  epoch modes, both LP methods, preemption on and off, warm and cold, each
  admission policy, bounded and unbounded pools.
* Replay: one batch without preemption is `run_batch` bit for bit, and
  with the exact LP `_legacy_run` (the reference's `PARITY_GRID`).
* Epoch modes: resident equals rebuild with warm starts off.
* Bound: within (8K + 1[release > 0]) x the exact LP of the full
  instance, warm or cold, with or without preemption, any batching.
* The reference's grids of `tests/test_streaming.py` and
  `tests/test_streaming_resident.py` at their sizes: pool-bound drains,
  the admission policies, `StreamResult` rows and `save`, committed
  circuits across epochs, the build and growth counters, `epoch_mode`
  validation.
* On the card (``cuda`` marker): card equals host with the exact LP
  (both card engines, preemption on and off); resident equals rebuild.
"""

import ast
import dataclasses
import importlib.util
import pathlib
import sys
import time
import types

import numpy as np
import pytest
import torch

from repro.core import lp as ref_lp
from repro.core.scheduler import _legacy_run
from repro.traffic import instances as ref_instances
from repro_torch.convert import from_reference
from repro_torch.core import lp
from repro_torch.core.circuit import CoreSchedule
from repro_torch.core.coflow import CoflowInstance
from repro_torch.core.validate import validate_schedule
from repro_torch.experiments import stream
from repro_torch.pipeline import batch_circuit as bc
from repro_torch.pipeline import ensemble_batch as eb
from repro_torch.pipeline import get_pipeline
from repro_torch.pipeline.pipeline import order_view
from repro_torch.pipeline.stages import ListCircuit
from repro_torch.streaming import ADMISSION_POLICIES
from repro_torch.traffic import poisson_arrivals, with_releases

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

# The compiled reference loop writes host tensors into NumPy arrays.
pytestmark = pytest.mark.filterwarnings("ignore:__array__ implementation doesn't accept")

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = dict(device="cpu")


def random_instance(**kw):
    return from_reference(ref_instances.random_instance(**kw), "cpu")


def _bound(instance) -> float:
    return 8.0 * instance.num_cores + (1.0 if (instance.releases > 0).any() else 0.0)


def _trace(M, N, K, seed, mean_ms=4.0):
    return with_releases(random_instance(num_coflows=M, num_ports=N, num_cores=K, seed=seed),
                         poisson_arrivals(M, mean_interarrival_ms=mean_ms, seed=seed))


# ---------------------------------------------------------------------------
# The reference's stream, compiled from its source
# ---------------------------------------------------------------------------


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


class _Stage:
    """A port stage whose tensor-taking methods also take NumPy arrays."""

    def __init__(self, stage):
        self._stage = stage

    def __getattr__(self, name):
        return getattr(self._stage, name)

    def order_batch(self, view, comp=None):
        if comp is None:
            return self._stage.order_batch(view)
        return self._stage.order_batch(view, _tensor(comp))

    def allocate_batch_arrays(self, ensemble, orders):
        return self._stage.allocate_batch_arrays(ensemble, _tensor(orders))


def _reference_get_pipeline(scheme, **kw):
    pipe = get_pipeline(scheme, **kw)
    pipe.order_stage = _Stage(pipe.order_stage)
    pipe.allocate_stage = _Stage(pipe.allocate_stage)
    return pipe


def _reference_stream():
    path = ROOT / "src" / "repro" / "streaming" / "service.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    names = {"EpochRecord", "StreamResult", "_WarmState", "_Calendar", "_Busy",
             "_arrival_batches", "stream", "EPOCH_MODES"}
    defs = [n for n in tree.body if getattr(n, "name", None) in names
            or (isinstance(n, ast.Assign) and n.targets[0].id in names)]
    future = ast.ImportFrom(module="__future__", names=[ast.alias(name="annotations")], level=0)
    module = ast.fix_missing_locations(ast.Module(body=[future] + defs, type_ignores=[]))
    spec = importlib.util.spec_from_file_location(
        "_reference_streaming_pool_e2e", ROOT / "src" / "repro" / "streaming" / "pool.py")
    pool = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = pool
    spec.loader.exec_module(pool)
    port_lp = types.SimpleNamespace(
        LPSolution=lp.LPSolution,
        solve_exact=ref_lp.solve_exact,
        pack_lp_arrays=lambda insts, **kw: {
            k: v.numpy() for k, v in lp.pack_lp_arrays(insts, **kw, device="cpu").items()},
        solve_subgradient_batch_arrays=lambda arrays, iters: lp.solve_subgradient_batch_arrays(
            {k: _tensor(v) for k, v in arrays.items()}, iters=iters),
        warm_start_Y0_dense=lambda w, g: lp.warm_start_Y0_dense(_tensor(w), _tensor(g)).numpy(),
        warm_gather_device=lp.warm_gather_device,
        warm_scatter_device=lp.warm_scatter_device,
    )
    jnp = types.SimpleNamespace(zeros=torch.zeros, float32=torch.float32, asarray=_tensor)
    mod = types.ModuleType("_reference_compiled_stream")
    sys.modules[mod.__name__] = mod  # dataclasses look their module up
    mod.__dict__.update(
        np=np, dataclasses=dataclasses, time=time, Any=object, lp=port_lp, jnp=jnp,
        Allocation=object, CoreSchedule=CoreSchedule, CoflowInstance=CoflowInstance,
        validate_schedule=validate_schedule, get_pipeline=_reference_get_pipeline,
        build_ensemble_batch=lambda insts, **kw: eb.build_ensemble_batch(insts, "cpu", **kw),
        order_view=lambda *a: order_view(*(_tensor(x) for x in a)),
        schedule_batch_arrays=bc.schedule_batch_arrays, ListCircuit=ListCircuit,
        _round_up=eb._round_up,
        build_slot_pool_batch=lambda *a, **kw: eb.build_slot_pool_batch(*a, **kw, device="cpu"),
        update_slots=eb.update_slots, set_slot_releases=eb.set_slot_releases,
        free_slots=eb.free_slots, SlotPool=pool.SlotPool,
    )
    exec(compile(module, str(path), "exec"), mod.__dict__)
    return mod.stream


REF_STREAM = _reference_stream()

EPOCH_FIELDS = ("index", "time", "actives", "admitted", "order", "ccts", "warm",
                "lp_iters_used", "num_busy", "lp_objective")


def _same_stream(got, want):
    assert got.num_resolves == want.num_resolves
    assert got.epoch_mode == want.epoch_mode
    for f in ("admission", "finish", "arrival", "weights"):
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f
    for e, f in zip(got.epochs, want.epochs):
        for name in EPOCH_FIELDS:
            a, b = getattr(e, name), getattr(f, name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (e.index, name)
            else:
                assert a == b, (e.index, name)
        assert (e.allocation is None) == (f.allocation is None)
        if e.allocation is not None:
            for fl in dataclasses.fields(e.allocation):
                x, y = getattr(e.allocation, fl.name), getattr(f.allocation, fl.name)
                assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), fl.name
    assert got.realized_weighted_cct == want.realized_weighted_cct


def _same_modes(res, reb):
    """A resident and a rebuild stream bit-identical: every epoch's time,
    actives, order, projected CCTs and LP objective; admissions, finishes."""
    assert res.num_resolves == reb.num_resolves
    assert res.admission.tobytes() == reb.admission.tobytes()
    assert res.finish.tobytes() == reb.finish.tobytes()
    for er, eb_ in zip(res.epochs, reb.epochs):
        assert er.time == eb_.time and er.lp_objective == eb_.lp_objective
        assert np.array_equal(er.actives, eb_.actives) and np.array_equal(er.order, eb_.order)
        assert er.ccts.tobytes() == eb_.ccts.tobytes()


# (instance seed, kwargs of both streams)
LOOP_GRID = [
    (0, dict(lp_method="exact", n_batches=3, preempt=True)),
    (1, dict(lp_method="exact", preempt=False)),
    (2, dict(lp_method="exact", n_batches=4, pool_size=3, preempt=False, admission="weighted")),
    (3, dict(lp_method="exact", batch_window=6.0, pool_size=4, admission="size_aware",
             discipline="reserving")),
    (4, dict(lp_method="batch", lp_iters=60, n_batches=4, pool_size=4, epoch_mode="rebuild")),
    (5, dict(lp_method="batch", lp_iters=60, n_batches=4, epoch_mode="rebuild",
             warm_start=False, preempt=False)),
    (6, dict(lp_method="batch", lp_iters=60, n_batches=4, pool_size=4)),
    (7, dict(lp_method="batch", lp_iters=60, n_batches=5, pool_size=3, preempt=False)),
    (8, dict(lp_method="batch", lp_iters=60, warm_start=False, admission="weighted",
             pool_size=5)),
    (9, dict(scheme="wspt_order", n_batches=3, pool_size=4, engine="kernel")),
]


@pytest.mark.parametrize("seed,kw", LOOP_GRID)
def test_event_loop_equals_reference_stream(seed, kw):
    inst = _trace(9, 4, 2, seed=50 + seed)
    _same_stream(stream(inst, **kw, **CPU), REF_STREAM(inst, **kw))


# ---------------------------------------------------------------------------
# Replay: one batch, no preemption == the offline pipeline
# ---------------------------------------------------------------------------

# (num_coflows, num_ports, num_cores, release_span, discipline, scheme)
PARITY_GRID = [
    (4, 3, 1, 0.0, "greedy", "ours"),
    (6, 4, 2, 25.0, "greedy", "ours"),
    (6, 3, 3, 0.0, "reserving", "ours"),
    (8, 5, 4, 40.0, "reserving", "ours"),
    (1, 2, 1, 0.0, "greedy", "ours"),
    (9, 4, 4, 60.0, "greedy", "ours"),
    (5, 4, 2, 30.0, "greedy", "wspt_order"),
    (7, 3, 3, 15.0, "reserving", "wspt_order"),
    (6, 4, 1, 35.0, "reserving", "ours"),
]


@pytest.mark.parametrize("M,N,K,span,discipline,scheme", PARITY_GRID)
@pytest.mark.parametrize("seed", [0, 1])
def test_single_batch_replay_is_bit_identical_to_offline(M, N, K, span, discipline, scheme,
                                                         seed):
    ref = ref_instances.random_instance(num_coflows=M, num_ports=N, num_cores=K,
                                        seed=seed + 13 * M, release_span=span)
    inst = from_reference(ref, "cpu")
    pipe = get_pipeline(scheme, discipline=discipline)
    sol = lp.solve_exact(inst) if pipe.order_stage.needs_lp else None
    off = pipe.run_batch([inst], lp_solutions=[sol], **CPU)[0]
    res = stream(inst, scheme=scheme, discipline=discipline, lp_method="exact", n_batches=1,
                 preempt=False, **CPU)
    assert res.num_resolves == 1
    e0 = res.epochs[0]
    assert np.array_equal(e0.order, off.order)
    for f in dataclasses.fields(off.allocation):
        assert np.array_equal(getattr(off.allocation, f.name), getattr(e0.allocation, f.name))
    assert res.finish.tobytes() == off.ccts.tobytes()
    assert res.realized_weighted_cct == off.total_weighted_cct
    legacy = _legacy_run(ref, scheme, lp_solution=ref_lp.solve_exact(ref), discipline=discipline)
    assert res.finish.tobytes() == legacy.ccts.tobytes()


def test_single_batch_parity_holds_with_preemption_enabled():
    inst = random_instance(num_coflows=7, num_ports=4, num_cores=2, seed=11, release_span=20.0)
    off = get_pipeline("ours").run_batch([inst], [lp.solve_exact(inst)], **CPU)[0]
    res = stream(inst, lp_method="exact", n_batches=1, preempt=True, **CPU)
    assert res.finish.tobytes() == off.ccts.tobytes()


@pytest.mark.parametrize("mode", ["rebuild", "resident"])
@pytest.mark.parametrize("M,N,K,span,seed", [(6, 4, 2, 25.0, 0), (8, 5, 3, 0.0, 1),
                                             (5, 3, 4, 40.0, 2)])
def test_single_batch_replay_matches_offline_batched_lp(mode, M, N, K, span, seed):
    inst = random_instance(num_coflows=M, num_ports=N, num_cores=K, seed=seed + 13 * M,
                           release_span=span)
    sols = lp.solve_subgradient_batch([inst], iters=200, **CPU)
    off = get_pipeline("ours").run_batch([inst], lp_solutions=sols, **CPU)[0]
    res = stream(inst, lp_method="batch", lp_iters=200, n_batches=1, preempt=False,
                 epoch_mode=mode, **CPU)
    assert res.epoch_mode == mode and res.num_resolves == 1
    assert np.array_equal(res.epochs[0].order, off.order)
    assert res.epochs[0].ccts.tobytes() == off.ccts.tobytes()
    assert res.realized_weighted_cct == float(np.dot(inst.weights, off.ccts))


# ---------------------------------------------------------------------------
# Epoch modes: resident == rebuild with warm starts off
# ---------------------------------------------------------------------------

# (num_coflows, num_ports, num_cores, n_batches, pool_size, preempt)
MODE_GRID = [
    (8, 5, 2, 3, None, True),
    (10, 6, 3, 4, 4, True),
    (9, 5, 2, None, 3, False),
    (12, 4, 4, 5, 6, True),
]


@pytest.mark.parametrize("M,N,K,n_batches,pool,preempt", MODE_GRID)
def test_resident_epochs_bit_identical_to_rebuild(M, N, K, n_batches, pool, preempt):
    inst = _trace(M, N, K, seed=31 + M)
    kw = dict(lp_method="batch", lp_iters=100, n_batches=n_batches, pool_size=pool,
              preempt=preempt, warm_start=False, validate=False, **CPU)
    reb = stream(inst, epoch_mode="rebuild", **kw)
    res = stream(inst, epoch_mode="resident", **kw)
    assert reb.epoch_mode == "rebuild" and res.epoch_mode == "resident"
    assert res.num_resolves > 1
    _same_modes(res, reb)


def test_resident_stream_builds_once_and_does_not_grow_when_rerun():
    """The reference's "zero retraces after warm-up" has no PyTorch
    counterpart; its stand-in: one build a stream, and no arena growth
    when a warmed stream is run again."""
    inst = _trace(9, 4, 3, seed=11)
    kw = dict(lp_method="batch", lp_iters=100, n_batches=3, validate=False,
              epoch_mode="resident", **CPU)
    stream(inst, **kw)
    builds, scatters, grows = eb.BUILD_COUNT, eb.SLOT_SCATTER_COUNT, eb.SLOT_GROW_COUNT
    res = stream(inst, **kw)
    assert res.num_resolves >= 2
    assert eb.BUILD_COUNT == builds + 1
    assert eb.SLOT_SCATTER_COUNT > scatters
    assert eb.SLOT_GROW_COUNT == grows


def test_small_arena_grows_and_stays_exact():
    inst = _trace(10, 5, 2, seed=3)
    kw = dict(lp_method="batch", lp_iters=60, n_batches=4, pool_size=5, warm_start=False,
              validate=True, **CPU)
    grows = eb.SLOT_GROW_COUNT
    res = stream(inst, epoch_mode="resident", flow_quantum=1, **kw)
    assert eb.SLOT_GROW_COUNT > grows
    _same_stream(res, REF_STREAM(inst, epoch_mode="resident", flow_quantum=1, **{
        k: v for k, v in kw.items() if k != "device"}))


def test_epoch_mode_validation():
    inst = _trace(4, 3, 1, seed=3)
    with pytest.raises(ValueError):
        stream(inst, epoch_mode="fused", **CPU)
    with pytest.raises(ValueError):
        stream(inst, lp_method="exact", epoch_mode="resident", **CPU)
    with pytest.raises(ValueError):
        stream(inst, lp_method="simplex", **CPU)
    with pytest.raises(ValueError, match="batched list-circuit"):
        stream(inst, scheme="sunflow_s", **CPU)
    res = stream(inst, lp_method="exact", n_batches=1, preempt=False, **CPU)
    assert res.epoch_mode == "rebuild"
    res = stream(inst, lp_method="batch", lp_iters=50, n_batches=1, preempt=False, **CPU)
    assert res.epoch_mode == "resident"
    empty = CoflowInstance(demands=np.zeros((0, 2, 2)), weights=np.zeros(0),
                           releases=np.zeros(0), rates=np.ones(1), delta=1.0)
    assert stream(empty, **CPU).num_resolves == 0


# ---------------------------------------------------------------------------
# The (8K+1) bound and the reference's mechanics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preempt", [True, False])
@pytest.mark.parametrize("n_batches", [2, 4])
def test_streamed_runs_respect_the_paper_bound(preempt, n_batches):
    for seed in range(4):
        inst = random_instance(num_coflows=8, num_ports=4, num_cores=1 + seed % 4,
                               seed=100 + seed, release_span=40.0)
        res = stream(inst, lp_method="exact", n_batches=n_batches, preempt=preempt, **CPU)
        lb = ref_lp.solve_exact(inst).objective
        assert res.realized_weighted_cct <= _bound(inst) * lb * (1 + 1e-9)
        assert (res.finish > res.arrival).all()


@pytest.mark.parametrize("mode", ["rebuild", "resident"])
def test_warm_resolves_never_violate_bound_vs_cold(mode):
    for seed in (3, 5):
        inst = random_instance(num_coflows=10, num_ports=4, num_cores=3, seed=seed,
                               release_span=60.0)
        lb = ref_lp.solve_exact(inst).objective
        kw = dict(lp_method="batch", lp_iters=200, n_batches=4, epoch_mode=mode, **CPU)
        cold = stream(inst, warm_start=False, **kw)
        hot = stream(inst, warm_start=True, validate=True, **kw)
        for res in (cold, hot):
            assert res.realized_weighted_cct <= _bound(inst) * lb * (1 + 1e-9)
        assert cold.warm_resolves == 0 and cold.iteration_savings == 0
        assert hot.warm_resolves >= 1
        assert hot.iteration_savings >= hot.warm_resolves * (hot.lp_iters - hot.lp_iters_warm)


try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAVE_HYPOTHESIS = False


if HAVE_HYPOTHESIS:

    @st.composite
    def stream_cases(draw):
        seed = draw(st.integers(0, 10**6))
        M = draw(st.integers(2, 7))
        inst = random_instance(num_coflows=M, num_ports=draw(st.integers(2, 4)),
                               num_cores=draw(st.integers(1, 4)), seed=seed,
                               release_span=draw(st.sampled_from([0.0, 25.0, 90.0])))
        return (inst, draw(st.integers(1, min(4, M))), draw(st.booleans()),
                draw(st.sampled_from(["greedy", "reserving"])))

    @settings(max_examples=25, deadline=None)
    @given(stream_cases())
    def test_streaming_bound_property(case):
        inst, n_batches, preempt, discipline = case
        res = stream(inst, lp_method="exact", n_batches=n_batches, preempt=preempt,
                     discipline=discipline, **CPU)
        lb = ref_lp.solve_exact(inst).objective
        assert res.realized_weighted_cct <= _bound(inst) * lb * (1 + 1e-9)
        assert (res.finish > res.arrival).all()


def test_pool_bound_queues_and_drains():
    inst = random_instance(num_coflows=9, num_ports=4, num_cores=2, seed=21, release_span=30.0)
    res = stream(inst, lp_method="exact", n_batches=3, pool_size=3, preempt=False, **CPU)
    assert res.pool_size == 3 and res.num_resolves >= 3
    assert (res.admission >= res.arrival - 1e-12).any() and (res.finish > 0).all()
    lb = ref_lp.solve_exact(inst).objective
    assert res.realized_weighted_cct <= _bound(inst) * lb * (1 + 1e-9)
    assert max(int(e.actives.shape[0]) for e in res.epochs) <= 3


def test_stream_result_rows_and_save(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path))
    inst = random_instance(num_coflows=6, num_ports=3, num_cores=2, seed=2, release_span=15.0)
    res = stream(inst, lp_method="exact", n_batches=3, **CPU)
    rows = res.coflow_rows()
    assert len(rows) == 6 and all(r["completion"] >= r["arrival"] for r in rows)
    assert len(res.epoch_rows()) == res.num_resolves
    paths = res.save("stream_smoke")
    assert set(paths) == {"coflows_json", "coflows_csv", "epochs_json", "epochs_csv",
                          "summary_json"}
    for p in paths.values():
        assert pathlib.Path(p).parent == tmp_path and pathlib.Path(p).stat().st_size > 0
    s = res.summary()
    assert s["num_resolves"] == res.num_resolves
    assert s["realized_weighted_cct"] == res.realized_weighted_cct


def test_stream_commits_in_flight_circuits_across_epochs():
    inst = random_instance(num_coflows=8, num_ports=3, num_cores=2, seed=42, release_span=12.0)
    res = stream(inst, lp_method="exact", preempt=False, **CPU)
    assert res.num_resolves >= 2
    assert any(e.num_busy > 0 for e in res.epochs)
    lb = ref_lp.solve_exact(inst).objective
    assert res.realized_weighted_cct <= _bound(inst) * lb * (1 + 1e-9)


def _contention_instance(weights, demands_scale):
    """Coflows contending for one port pair on one unit-rate core: with
    ``pool_size=1`` the admission policy decides the service order."""
    M = len(weights)
    demands = np.zeros((M, 2, 2))
    demands[:, 0, 1] = demands_scale
    return CoflowInstance(demands=demands, weights=np.asarray(weights, dtype=np.float64),
                          releases=np.zeros(M), rates=np.ones(1), delta=0.0)


def test_admission_policies():
    kw = dict(lp_method="exact", n_batches=1, pool_size=1, preempt=False, **CPU)
    inst = _contention_instance([1.0, 50.0, 1.0], [10.0, 10.0, 10.0])
    fifo = stream(inst, admission="fifo", **kw)
    wgt = stream(inst, admission="weighted", **kw)
    assert wgt.admission_policy == "weighted"
    assert wgt.realized_weighted_cct < fifo.realized_weighted_cct
    assert wgt.admission[1] <= min(wgt.admission[0], wgt.admission[2])
    inst = _contention_instance([1.0, 1.0, 1.0], [30.0, 30.0, 3.0])
    fifo = stream(inst, admission="fifo", **kw)
    sz = stream(inst, admission="size_aware", **kw)
    assert sz.admission[2] <= sz.admission[0]
    assert sz.finish[2] < min(sz.finish[0], sz.finish[1])
    assert sz.realized_weighted_cct <= fifo.realized_weighted_cct
    assert sz.summary()["admission_policy"] == "size_aware"
    with pytest.raises(ValueError):
        stream(inst, admission="lifo", **kw)
    assert set(ADMISSION_POLICIES) == {"fifo", "weighted", "size_aware"}


def test_fifo_policy_preserves_replay_parity():
    inst = random_instance(num_coflows=7, num_ports=3, num_cores=2, seed=31)
    off = get_pipeline("ours").run_batch([inst], [lp.solve_exact(inst)], **CPU)[0]
    rep = stream(inst, lp_method="exact", n_batches=1, preempt=False, admission="fifo", **CPU)
    assert rep.finish.tobytes() == off.ccts.tobytes()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["kernel", "jax"])
@pytest.mark.parametrize("preempt", [True, False])
def test_card_stream_equals_host(cuda, engine, preempt):
    inst = _trace(10, 5, 2, seed=7)
    kw = dict(lp_method="exact", n_batches=4, pool_size=4, preempt=preempt, engine=engine)
    _same_stream(stream(inst, **kw, device=cuda), stream(inst, **kw, **CPU))


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,n_batches,pool,preempt", MODE_GRID)
def test_card_resident_equals_rebuild(cuda, M, N, K, n_batches, pool, preempt):
    inst = _trace(M, N, K, seed=31 + M)
    kw = dict(lp_method="batch", lp_iters=100, n_batches=n_batches, pool_size=pool,
              preempt=preempt, warm_start=False, validate=True, device=cuda)
    _same_modes(stream(inst, epoch_mode="resident", **kw),
                  stream(inst, epoch_mode="rebuild", **kw))
