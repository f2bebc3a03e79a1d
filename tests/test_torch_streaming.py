"""The streaming service's host pieces, the warm starts, the slot pool and
the committed circuits, against the reference.

Where the reference's code comes from (nothing in the JAX package changes):

* `repro.streaming` cannot be imported under the installed JAX (its
  package imports `repro.pipeline`, which imports `enable_x64`).  Its
  `pool.py` imports only NumPy, so it is loaded by file path; the helpers
  `_arrival_batches`, `_Calendar`, `_Busy` and `_WarmState` are compiled
  from `src/repro/streaming/service.py` with `ast` (their host half: the
  device half is tested through `repro.core.lp`'s jitted functions).
* `src/repro/pipeline/ensemble_batch.py` imports only `jax` and
  `repro.core`, so it is loaded by file path: its `build_slot_pool_batch`,
  `update_slots`, `set_slot_releases`, `free_slots` and `build_ensemble_batch`
  are the reference's own, in host NumPy.
* `_run_calendar_wide` is compiled from `src/repro/pipeline/batch_circuit.py`
  with `ast`; it needs only NumPy and `NOT_SCHEDULED`.
* `warm_start_Y0_dense`, `warm_gather_device`, `warm_scatter_device` and
  `pack_lp_arrays` come from `repro.core.lp`, which imports.

Contracts, tolerance none throughout:

* `SlotPool` equals the reference's over random push / admit / release
  sequences under every policy; `_arrival_batches`, `_Calendar`, `_Busy`
  and the host `_WarmState` equal the reference's.
* The warm starts equal the reference's bits, padded slot vectors
  included, and `pack_lp_arrays(warm_start_orders=)` /
  `build_ensemble_batch(pad_*=, warm_start_orders=, with_lp_arrays=)`
  equal the reference's arrays.
* Every tensor of a slot pool equals the reference's arrays after every
  step of each lifecycle: scatter fidelity, slot reuse with no residue,
  the empty pool, an extent reused in place, first fit, compaction that
  moves an extent over itself, and geometric growth.  A slot-space
  allocation and calendar equal the dense ones (free slots' flows are
  exact no-ops).
* ``schedule_batch_arrays(busy=)`` under ``"kernel"``, ``"jax"`` and
  ``"wide"``: the reference's three phantom cases, and random
  port-exclusive phantom tables against the reference's
  `_run_calendar_wide` on the same member tables; ``busy=None`` and an
  empty map change nothing.  On the card (``cuda`` marker) the card's
  engines give the host's bits.
"""

import ast
import dataclasses
import importlib.util
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from repro.core import lp as ref_lp
from repro.core.circuit import NOT_SCHEDULED
from repro.traffic.instances import random_instance
from repro_torch.convert import from_reference
from repro_torch.core import lp
from repro_torch.core.circuit import CoreSchedule
from repro_torch.core.coflow import CoflowInstance
from repro_torch.pipeline import batch_circuit as bc
from repro_torch.pipeline import ensemble_batch as eb
from repro_torch.pipeline import get_pipeline
from repro_torch.pipeline.batch_alloc import allocate_batch_arrays
from repro_torch.streaming import ADMISSION_POLICIES, SlotPool
from repro_torch.streaming import service

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENGINES = ("kernel", "jax", "wide")


def _load_reference(relpath: str):
    """A reference module that imports nothing of `repro.pipeline`, loaded
    by file path (its package `__init__` is not run)."""
    name = "_reference_" + relpath.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, ROOT / "src" / "repro" / relpath)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def compile_reference(relpath: str, names, ns: dict) -> types.ModuleType:
    """The reference's own top-level functions and classes ``names`` from
    ``relpath``, compiled with ``ns`` standing in for its imports."""
    path = ROOT / "src" / "repro" / relpath
    tree = ast.parse(path.read_text(), filename=str(path))
    defs = [n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name in names]
    assert {d.name for d in defs} == set(names)
    future = ast.ImportFrom(module="__future__", names=[ast.alias(name="annotations")], level=0)
    module = ast.fix_missing_locations(ast.Module(body=[future] + defs, type_ignores=[]))
    mod = types.ModuleType("_reference_compiled_" + relpath.replace("/", "_").removesuffix(".py"))
    sys.modules[mod.__name__] = mod  # dataclasses look their module up
    mod.__dict__.update(ns)
    exec(compile(module, str(path), "exec"), mod.__dict__)
    return mod


REF_POOL = _load_reference("streaming/pool.py")
REF_EB = _load_reference("pipeline/ensemble_batch.py")
REF_SERVICE = compile_reference(
    "streaming/service.py", ["_WarmState", "_Calendar", "_Busy", "_arrival_batches"],
    {"np": np, "dataclasses": dataclasses, "CoreSchedule": CoreSchedule},
)
REF_WIDE = compile_reference(
    "pipeline/batch_circuit.py", ["_run_calendar_wide"],
    {"np": np, "NOT_SCHEDULED": NOT_SCHEDULED},
)._run_calendar_wide


# ---------------------------------------------------------------------------
# Host pieces: SlotPool, _arrival_batches, _Calendar, _Busy, _WarmState
# ---------------------------------------------------------------------------


def _same_pool_state(a, b):
    assert a.num_active == b.num_active and a.num_free == b.num_free
    assert a.active_ids() == b.active_ids()
    assert a.active_array().tobytes() == b.active_array().tobytes()
    assert list(a.queue) == list(b.queue)
    ids = a.active_ids()
    assert a.slots_of(ids).tobytes() == b.slots_of(ids).tobytes()


@pytest.mark.parametrize("policy", ADMISSION_POLICIES)
@pytest.mark.parametrize("seed", range(4))
def test_slot_pool_equals_reference(policy, seed):
    rng = np.random.default_rng(seed)
    M, S = 40, int(rng.integers(1, 7))
    weights = rng.integers(1, 5, M).astype(np.float64)  # ties on purpose
    sizes = rng.integers(1, 4, M).astype(np.float64)
    got = SlotPool(S, policy=policy, weights=weights, sizes=sizes)
    want = REF_POOL.SlotPool(S, policy=policy, weights=weights, sizes=sizes)
    pending = list(rng.permutation(M))
    for _ in range(60):
        op = rng.integers(3)
        if op == 0 and pending:
            k = int(rng.integers(1, 5))
            ids, pending = pending[:k], pending[k:]
            got.push(ids)
            want.push(ids)
        elif op == 1:
            assert got.admit_waiting() == want.admit_waiting()
        elif got.num_active:
            act = got.active_ids()
            drop = list(rng.choice(act, size=int(rng.integers(1, len(act) + 1)), replace=False))
            if len(drop) == 1:
                assert got.release(int(drop[0])) == want.release(int(drop[0]))
            else:
                assert got.release_many(drop).tobytes() == want.release_many(drop).tobytes()
        _same_pool_state(got, want)


def test_slot_pool_reference_cases():
    """The reference's own pool cases (`tests/test_streaming.py`)."""
    pool = SlotPool(3)
    pool.push([10, 11, 12, 13, 14])
    assert pool.admit_waiting() == [10, 11, 12]
    assert pool.num_free == 0 and list(pool.queue) == [13, 14]
    pool.release(11)
    assert pool.admit_waiting() == [13] and pool.slot_of(13) == 1
    pool.release(10)
    assert pool.admit_waiting() == [14] and pool.slot_of(14) == 0
    assert pool.active_ids() == [12, 13, 14]
    pool = SlotPool(1, policy="weighted", weights=np.array([5.0, 5.0, 5.0]))
    pool.push([2, 0, 1])
    assert pool.admit_waiting() == [2]
    pool = SlotPool(2, policy="size_aware", sizes=np.array([30.0, 4.0, 11.0]))
    pool.push([0, 1, 2])
    assert pool.admit_waiting() == [1, 2]
    for kw in ({"size": 0}, {"size": 2, "policy": "lifo"}, {"size": 2, "policy": "weighted"},
               {"size": 2, "policy": "size_aware"}):
        with pytest.raises(ValueError):
            SlotPool(**kw)
    assert set(ADMISSION_POLICIES) == {"fifo", "weighted", "size_aware"}


@pytest.mark.parametrize("seed", range(3))
def test_arrival_batches_equal_reference(seed):
    rng = np.random.default_rng(seed)
    rel = np.round(rng.uniform(0, 30, 25), 0)  # ties on purpose
    for n_batches, window in [(None, None), (1, None), (3, None), (7, None), (100, None),
                              (None, 0.0), (None, 4.0), (None, 50.0)]:
        got = service._arrival_batches(rel, n_batches, window)
        want = REF_SERVICE._arrival_batches(rel, n_batches, window)
        assert got == want, (n_batches, window)
    assert service._arrival_batches(np.zeros(0), 3, None) == []
    for args in ((2, 1.0), (0, None), (None, -1.0)):
        with pytest.raises(ValueError):
            service._arrival_batches(rel, *args)


def _random_schedules(rng, K, M):
    out = []
    for k in range(K):
        F = int(rng.integers(0, 6))
        est = rng.uniform(0, 20, F)
        out.append(CoreSchedule(
            coflow=rng.integers(0, M, F), src=rng.integers(0, 4, F), dst=rng.integers(0, 4, F),
            size=rng.uniform(1, 9, F), establish=est, complete=est + rng.uniform(1, 9, F),
            rate=10.0, delta=1.0))
    return out


def _same_fields(a, b, names):
    for f in names:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("seed", range(4))
def test_calendar_and_busy_equal_reference(seed):
    rng = np.random.default_rng(seed)
    schedules = _random_schedules(rng, 3, 6)
    cmap = rng.permutation(20)[:6]
    names = ("m", "k", "i", "j", "size", "est", "comp")
    _same_fields(service._Calendar.from_schedules(schedules, cmap),
                 REF_SERVICE._Calendar.from_schedules(schedules, cmap), names)
    _same_fields(service._Calendar.empty(), REF_SERVICE._Calendar.empty(), names)
    got, want = service._Busy.empty(), REF_SERVICE._Busy.empty()
    assert got.tables(1.0, 3) is None and want.tables(1.0, 3) is None
    for step in range(4):
        n = int(rng.integers(0, 5))
        args = (rng.integers(0, 3, n), rng.integers(0, 4, n), rng.integers(0, 4, n),
                rng.uniform(0, 30, n))
        got, want = got.extend(*args), want.extend(*args)
        now = float(step * 5)
        got, want = got.keep_after(now), want.keep_after(now)
        _same_fields(got, want, ("k", "i", "j", "end"))
        tg, tw = got.tables(now, 3), want.tables(now, 3)
        assert (tg is None) == (tw is None)
        if tg is not None:
            assert tg.keys() == tw.keys()
            for key in tg:
                for f in ("src", "dst", "rel", "dur"):
                    assert tg[key][f].tobytes() == tw[key][f].tobytes()


@pytest.mark.parametrize("seed", range(3))
def test_host_warm_state_equals_reference(seed):
    rng = np.random.default_rng(seed)
    S = 7
    got, want = service._WarmState(S), REF_SERVICE._WarmState(S, device=False)
    for _ in range(12):
        op = rng.integers(3)
        slots = np.sort(rng.choice(S, size=int(rng.integers(1, S + 1)), replace=False))
        if op == 0:
            default = np.triu(rng.uniform(0, 1, (slots.size, slots.size)).astype(np.float32), 1)
            (a, wa), (b, wb) = got.gather(slots, default), want.gather(slots, default)
            assert wa == wb and np.asarray(a).tobytes() == np.asarray(b).tobytes()
        elif op == 1:
            prec = rng.uniform(0, 1, (slots.size, slots.size))
            got.scatter(slots, prec)
            want.scatter(slots, prec)
        else:
            got.forget_slots(slots[:2])
            want.forget_slots(slots[:2])
        assert got.Y.tobytes() == want.Y.tobytes()
        assert got.solved.tobytes() == want.solved.tobytes()


# ---------------------------------------------------------------------------
# Warm starts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_warm_start_Y0_dense_equals_reference(seed):
    rng = np.random.default_rng(seed)
    M = int(rng.integers(1, 12))
    w = rng.uniform(1, 10, M)
    glb = np.round(rng.uniform(0, 4, M), 1)  # ties and zeros on purpose
    for order in (None, rng.permutation(M)):
        got = lp.warm_start_Y0_dense(torch.from_numpy(w), torch.from_numpy(glb), order)
        assert got.numpy().tobytes() == ref_lp.warm_start_Y0_dense(w, glb, order).tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_warm_gather_and_scatter_equal_reference(seed):
    rng = np.random.default_rng(seed)
    S = 9
    Yw = rng.uniform(0, 1, (S, S)).astype(np.float32)
    solved = rng.random(S) < 0.6
    Me = int(rng.integers(0, S + 1))
    slots = np.full(S, S, dtype=np.int32)  # padded with the out-of-range S
    slots[:Me] = rng.permutation(S)[:Me]
    default = np.triu(rng.uniform(0, 1, (S, S)).astype(np.float32), 1)
    y = rng.uniform(0, 1, (S, S)).astype(np.float32)
    t = torch.from_numpy
    Y0, any_warm = lp.warm_gather_device(t(Yw), t(solved), t(slots), t(default))
    rY0, r_any = ref_lp.warm_gather_device(Yw, solved, slots, default)
    assert Y0.numpy().tobytes() == np.asarray(rY0).tobytes()
    assert bool(any_warm) == bool(r_any)
    got = lp.warm_scatter_device(t(Yw), t(slots), t(y))
    assert got.numpy().tobytes() == np.asarray(ref_lp.warm_scatter_device(Yw, slots, y)).tobytes()


@pytest.mark.parametrize("seed", range(3))
def test_solve_subgradient_starts_from_the_given_order(seed):
    """With no steps the solver returns its start: the warm start of the
    given order (the reference's `warm_start_Y0_dense` of it)."""
    ref = random_instance(num_coflows=6, num_ports=4, seed=seed, release_span=5.0)
    order = np.random.default_rng(seed).permutation(6)
    got = lp.solve_subgradient(from_reference(ref, "cpu"), iters=0, warm_start_order=order,
                               device="cpu")
    want = ref_lp._precedence_from_Y(ref_lp.warm_start_Y0_dense(
        ref.weights, ref.global_lower_bound(), order).astype(np.float64))
    assert got.precedence.tobytes() == want.tobytes()
    assert np.array_equal(np.argsort(-got.precedence.sum(axis=1), kind="stable"), order)


def test_pack_lp_arrays_warm_start_orders_equal_reference():
    refs = [random_instance(num_coflows=m, num_ports=4, seed=s, release_span=9.0)
            for s, m in ((0, 5), (1, 7), (2, 3))]
    orders = [np.arange(5)[::-1].copy(), None, np.array([2, 0, 1])]
    got = lp.pack_lp_arrays([from_reference(r, "cpu") for r in refs], pad_coflows=8,
                            pad_ports=10, warm_start_orders=orders, device="cpu")
    want = ref_lp.pack_lp_arrays(refs, pad_coflows=8, pad_ports=10, warm_start_orders=orders)
    for key, value in want.items():
        assert got[key].numpy().tobytes() == value.tobytes(), key


def _tensor_fields(batch):
    return [f.name for f in dataclasses.fields(eb.EnsembleBatch)
            if isinstance(getattr(batch, f.name), torch.Tensor)]


def _same_batch(got, want):
    for name in _tensor_fields(got):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name in ("flow_pi", "flow_pj"):  # i32 there, i64 here
            b = b.astype(np.int64)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("with_lp_arrays", [True, False])
def test_build_options_equal_reference(with_lp_arrays):
    refs = [random_instance(num_coflows=m, num_ports=n, num_cores=k, seed=s, release_span=5.0)
            for s, (m, n, k) in enumerate([(4, 3, 2), (6, 4, 1), (3, 2, 3)])]
    orders = [np.array([3, 1, 0, 2]), None, np.array([2, 1, 0])]
    kw = dict(pad_coflows=8, pad_ports=10, pad_flows=64, pad_cores=4,
              warm_start_orders=orders, with_lp_arrays=with_lp_arrays)
    got = eb.build_ensemble_batch([from_reference(r, "cpu") for r in refs], "cpu", **kw)
    _same_batch(got, REF_EB.build_ensemble_batch(refs, **kw))
    assert got.pad_flows == 64 and got.pad_cores == 4


# ---------------------------------------------------------------------------
# The resident slot pool, against the reference's after every step
# ---------------------------------------------------------------------------

RATES = np.array([10.0, 20.0])
DELTA = 1.5


def _pools(slots=6, num_ports=5, flow_quantum=8):
    builds = eb.BUILD_COUNT
    got = eb.build_slot_pool_batch(slots, num_ports, RATES, DELTA,
                                   flow_quantum=flow_quantum, device="cpu")
    assert eb.BUILD_COUNT == builds + 1
    want = REF_EB.build_slot_pool_batch(slots, num_ports, RATES, DELTA, flow_quantum=flow_quantum)
    _same_slot_pool(got, want)
    return got, want


def _same_slot_pool(got, want):
    _same_batch(got.batch, want.batch)
    assert got.flow_start.tobytes() == want.flow_start.tobytes()
    assert got.flow_cap.tobytes() == want.flow_cap.tobytes()
    assert got.flow_capacity == want.flow_capacity and got.slots == want.slots


def _update(pools, slots, demands, weights, releases):
    for p, mod in zip(pools, (eb, REF_EB)):
        mod.update_slots(p, np.asarray(slots), demands, weights, releases)
    _same_slot_pool(*pools)


def _free(pools, slots):
    for p, mod in zip(pools, (eb, REF_EB)):
        mod.free_slots(p, np.asarray(slots))
    _same_slot_pool(*pools)


def _inst(M=3, N=5, seed=0):
    return random_instance(num_coflows=M, num_ports=N, num_cores=2, seed=seed)


def test_scatter_fidelity_and_counters():
    pools = _pools()
    inst = _inst(seed=1)
    scatters = eb.SLOT_SCATTER_COUNT
    _update(pools, [0, 2, 5], inst.demands, inst.weights, inst.releases)
    got = pools[0]
    assert got.occupied().tolist() == [True, False, True, False, False, True]
    rho, _ = ref_lp.port_stats(inst.demands)
    glb = got.batch.glb[0, [0, 2, 5]].numpy()
    assert glb.tobytes() == (DELTA + rho.max(axis=1) / RATES.sum()).tobytes()
    for p, mod in zip(pools, (eb, REF_EB)):
        mod.set_slot_releases(p, np.array([2, 5]), np.array([3.5, 7.25]))
    _same_slot_pool(*pools)
    _free(pools, [2])
    assert eb.SLOT_SCATTER_COUNT == scatters + 2
    for kw in ({"slots": 0}, {"flow_quantum": 0}):
        args = dict(slots=6, flow_quantum=8) | kw
        with pytest.raises(ValueError):
            eb.build_slot_pool_batch(args["slots"], 5, RATES, DELTA,
                                     flow_quantum=args["flow_quantum"], device="cpu")


def test_slot_reuse_leaves_no_residue():
    x, y, bystander = _inst(seed=3), _inst(seed=4), _inst(M=1, seed=5)
    pools = _pools()
    _update(pools, [0], bystander.demands, bystander.weights, bystander.releases)
    _update(pools, [2, 3, 4], x.demands, x.weights, x.releases)
    _free(pools, [2, 3, 4])
    _update(pools, [2, 3, 4], y.demands, y.weights, y.releases)
    fresh = eb.build_slot_pool_batch(6, 5, RATES, DELTA, flow_quantum=8, device="cpu")
    eb.update_slots(fresh, np.array([0]), bystander.demands, bystander.weights,
                    bystander.releases)
    eb.update_slots(fresh, np.array([2, 3, 4]), y.demands, y.weights, y.releases)
    for name in _tensor_fields(fresh.batch):
        assert torch.equal(getattr(fresh.batch, name), getattr(pools[0].batch, name)), name


def test_empty_pool_schedules_nothing():
    inst = _inst(seed=7)
    pools = _pools()
    _update(pools, [0, 1, 2], inst.demands, inst.weights, inst.releases)
    _free(pools, [0, 1, 2])
    b = pools[0].batch
    assert not b.coflow_mask.any() and not b.flow_valid.any() and not b.lp_rho.any()
    alloc = allocate_batch_arrays(b, torch.arange(b.pad_coflows)[None, :])
    for engine in ENGINES:
        ((schedules, ccts),) = bc.schedule_batch_arrays(b, alloc, "greedy", engine=engine)
        assert not ccts.any() and all(cs.coflow.size == 0 for cs in schedules)


def test_extent_reused_in_place_for_a_shrinking_residual():
    inst = _inst(M=1, seed=8)
    pools = _pools()
    _update(pools, [2], inst.demands, inst.weights, inst.releases)
    start, cap = int(pools[0].flow_start[2]), int(pools[0].flow_cap[2])
    resid = inst.demands.copy()
    i_idx, j_idx = np.nonzero(resid[0])
    resid[0, i_idx[::2], j_idx[::2]] = 0.0
    grows = eb.SLOT_GROW_COUNT
    _update(pools, [2], resid, inst.weights, inst.releases)
    assert (int(pools[0].flow_start[2]), int(pools[0].flow_cap[2])) == (start, cap)
    assert eb.SLOT_GROW_COUNT == grows


def _flows(n, N=4, size=10.0):
    """One coflow with ``n`` flows of distinct sizes on an N-port fabric."""
    d = np.zeros((1, N, N))
    d.reshape(-1)[:n] = size + np.arange(n)
    return d


def test_first_fit_compaction_over_itself_and_growth():
    pools = _pools(slots=4, num_ports=4, flow_quantum=16)
    one = (np.ones(1), np.zeros(1))
    _update(pools, [0], _flows(2), *one)  # [0, 2)
    _update(pools, [1], _flows(10), *one)  # [2, 12)
    _update(pools, [2], _flows(1), *one)  # [12, 13)
    _free(pools, [0])  # gaps [0, 2) and [13, 16)
    _update(pools, [3], _flows(2), *one)  # first fit: [0, 2)
    assert int(pools[0].flow_start[3]) == 0
    _free(pools, [3, 2])  # gaps [0, 2) and [12, 16): 6 free, none of 5
    grows = eb.SLOT_GROW_COUNT
    _update(pools, [0], _flows(5), *one)  # compaction moves [2, 12) to [0, 10)
    assert pools[0].flow_capacity == 16 and eb.SLOT_GROW_COUNT == grows
    assert (int(pools[0].flow_start[1]), int(pools[0].flow_start[0])) == (0, 10)
    _update(pools, [2], _flows(7), *one)  # 1 free of 7: compact, then grow
    assert eb.SLOT_GROW_COUNT == grows + 1 and pools[0].flow_capacity == 32
    _update(pools, [3], _flows(16), *one)  # 9 free of 16: grow again
    assert pools[0].flow_capacity == 64


@pytest.mark.parametrize("discipline", ["greedy", "reserving"])
def test_slot_space_allocation_and_calendar_equal_dense(discipline):
    ref = random_instance(num_coflows=5, num_ports=4, num_cores=2, seed=12, release_span=6.0)
    inst = from_reference(ref, "cpu")
    pool = eb.build_slot_pool_batch(8, 4, inst.rates, inst.delta, flow_quantum=8, device="cpu")
    slots = np.array([6, 1, 4, 0, 3])  # dense coflow d lives in slot slots[d]
    eb.update_slots(pool, np.array([2, 6, 1, 4, 0, 3, 5]),
                    np.concatenate([inst.demands[:1], inst.demands, inst.demands[:1]]),
                    np.ones(7), np.zeros(7))
    eb.free_slots(pool, np.array([2, 5]))  # free slots' extents sit mid-arena
    eb.set_slot_releases(pool, slots, inst.releases)
    eb.update_slots(pool, slots[:2], inst.demands[:2], inst.weights[:2], inst.releases[:2])
    eb.update_slots(pool, slots[2:], inst.demands[2:], inst.weights[2:], inst.releases[2:])
    dense = eb.build_ensemble_batch([inst], "cpu")
    order = np.array([3, 0, 4, 1, 2])
    order_slots = np.concatenate([slots[order], [2, 5, 7]])
    a = allocate_batch_arrays(dense, torch.from_numpy(order[None]))
    s = allocate_batch_arrays(pool.batch, torch.from_numpy(order_slots[None]))
    F = dense.num_flows[0]
    assert s.valid[0, :F].all() and not s.valid[0, F:].any()
    for f in ("src", "dst", "size", "core"):
        assert torch.equal(getattr(a, f)[0, :F], getattr(s, f)[0, :F]), f
    assert torch.equal(torch.from_numpy(slots[a.coflow[0, :F].numpy()]), s.coflow[0, :F])
    for f in ("rho_ports", "tau_ports"):
        assert torch.equal(getattr(a, f), getattr(s, f)), f
    assert torch.equal(a.prefix_lb[0], s.prefix_lb[0, :5])
    for engine in ENGINES:
        ((ds, dc),) = bc.schedule_batch_arrays(dense, a, discipline, engine=engine)
        ((ss, sc),) = bc.schedule_batch_arrays(pool.batch, s, discipline, engine=engine)
        assert dc.tobytes() == sc[slots].tobytes()
        for x, y in zip(ds, ss):
            assert x.establish.tobytes() == y.establish.tobytes()


# ---------------------------------------------------------------------------
# Committed circuits in the calendar: schedule_batch_arrays(busy=)
# ---------------------------------------------------------------------------


def _tiny(K=1):
    """One coflow, one flow (0 -> 1), unit rate, no delta."""
    demands = np.zeros((1, 2, 2))
    demands[0, 0, 1] = 10.0
    inst = CoflowInstance(demands=demands, weights=np.ones(1), releases=np.zeros(1),
                          rates=np.full(K, 1.0), delta=0.0)
    ens = eb.build_ensemble_batch([inst], "cpu", with_lp_arrays=False)
    pipe = get_pipeline("wspt_order")
    alloc = pipe.allocate_stage.allocate_batch_arrays(ens, pipe.order_stage.order_batch(ens))
    return ens, alloc


def _phantom(src, dst, dur=50.0):
    return dict(src=np.array([src]), dst=np.array([dst]), rel=np.array([0.0]),
                dur=np.array([dur]))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("discipline", ["greedy", "reserving"])
def test_busy_phantom_blocks_its_port_pair(discipline, engine):
    ens, alloc = _tiny()
    ((scheds, _),) = bc.schedule_batch_arrays(ens, alloc, discipline, engine=engine)
    assert scheds[0].establish[0] == 0.0
    ((scheds, ccts),) = bc.schedule_batch_arrays(
        ens, alloc, discipline, engine=engine, busy={(0, 0): _phantom(0, 1)})
    assert scheds[0].establish[0] == 50.0 and ccts[0] == 60.0
    assert len(scheds[0].coflow) == 1


@pytest.mark.parametrize("engine", ENGINES)
def test_busy_on_disjoint_ports_does_not_delay(engine):
    ens, alloc = _tiny()
    ((scheds, _),) = bc.schedule_batch_arrays(
        ens, alloc, "greedy", engine=engine, busy={(0, 0): _phantom(1, 0)})
    assert scheds[0].establish[0] == 0.0


@pytest.mark.parametrize("engine", ENGINES)
def test_busy_on_empty_core_is_ignored(engine):
    ens, alloc = _tiny(K=2)
    k_other = 1 - int(alloc.core[0, 0])
    ((_, ccts),) = bc.schedule_batch_arrays(
        ens, alloc, "greedy", engine=engine, busy={(0, k_other): _phantom(0, 1)})
    assert ccts[0] == 10.0


def _random_busy(rng, ens, now):
    """Port-exclusive phantom tables (a partial matching per core)."""
    busy = {}
    for b in range(ens.num_instances):
        N = ens.num_ports[b]
        for k in range(ens.num_cores[b]):
            n = int(rng.integers(0, N + 1))
            if n:
                busy[b, k] = dict(src=rng.permutation(N)[:n], dst=rng.permutation(N)[:n],
                                  rel=np.full(n, now), dur=rng.uniform(0.0, 40.0, n))
    return busy


def _reference_busy_calendar(ens, alloc, busy, discipline):
    """The reference's host engine on the member tables with the phantoms
    at their head, then the phantoms cut off: {(b, k): (est, comp)}."""
    h = {f: getattr(alloc, f).numpy() for f in ("core", "valid", "src", "dst", "coflow", "size")}
    rel, rates, delta = ens.releases.numpy(), ens.rates.numpy(), ens.delta.numpy()
    members, tabs = [], []
    for b in range(ens.num_instances):
        for k in range(ens.num_cores[b]):
            idx = np.nonzero(h["valid"][b] & (h["core"][b] == k))[0]
            if not idx.size:
                continue
            ph = busy.get((b, k), dict(src=[], dst=[], rel=[], dur=[]))
            nb = len(ph["src"])
            tabs.append(dict(
                src=np.concatenate([np.asarray(ph["src"], np.int64), h["src"][b, idx]]),
                dst=np.concatenate([np.asarray(ph["dst"], np.int64), h["dst"][b, idx]]),
                rel=np.concatenate([np.asarray(ph["rel"], np.float64),
                                    rel[b, h["coflow"][b, idx]]]),
                dur=np.concatenate([np.asarray(ph["dur"], np.float64),
                                    delta[b] + h["size"][b, idx] / rates[b, k]])))
            members.append((b, k, nb, idx.size))
    pad = bc._pad_members(tabs, max(ens.num_ports))
    est, comp = REF_WIDE(pad["src"], pad["dst"], pad["rel"], pad["dur"], pad["pending"],
                         pad["Nmax"], discipline == "reserving",
                         bound=bc.event_bound(pad["Fmax"]) + pad["Fmax"])
    out = {}
    for g, (b, k, nb, F) in enumerate(members):
        assert est[g, :nb].tobytes() == tabs[g]["rel"][:nb].tobytes()
        out[b, k] = (est[g, nb:nb + F], comp[g, nb:nb + F])
    return out


def _busy_case(seed):
    rng = np.random.default_rng(seed)
    refs = [random_instance(num_coflows=m, num_ports=n, num_cores=k, seed=seed * 7 + i,
                            release_span=span)
            for i, (m, n, k, span) in enumerate([(5, 4, 2, 0.0), (7, 3, 3, 12.0),
                                                 (4, 5, 1, 6.0)])]
    insts = [from_reference(r, "cpu") for r in refs]
    now = 0.0
    ens = eb.build_ensemble_batch(insts, "cpu")
    orders = [np.argsort(-r.weights, kind="stable") for r in refs]
    alloc = allocate_batch_arrays(ens, ens.pad_orders(orders))
    return ens, alloc, _random_busy(rng, ens, now)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("discipline", ["greedy", "reserving"])
def test_random_busy_tables_equal_reference_wide(seed, discipline):
    ens, alloc, busy = _busy_case(seed)
    want = _reference_busy_calendar(ens, alloc, busy, discipline)
    plain = bc.schedule_batch_arrays(ens, alloc, discipline, engine="wide")
    for engine in ENGINES:
        got = bc.schedule_batch_arrays(ens, alloc, discipline, engine=engine, busy=busy)
        for b, (schedules, _) in enumerate(got):
            for k, cs in enumerate(schedules):
                if (b, k) in want:
                    est, comp = want[b, k]
                    assert cs.establish.tobytes() == est.tobytes(), (engine, b, k)
                    assert cs.complete.tobytes() == comp.tobytes(), (engine, b, k)
        for none in (None, {}):
            again = bc.schedule_batch_arrays(ens, alloc, discipline, engine=engine, busy=none)
            for (s1, c1), (s2, c2) in zip(again, plain):
                assert c1.tobytes() == c2.tobytes()
                for x, y in zip(s1, s2):
                    assert x.establish.tobytes() == y.establish.tobytes()


def test_phantoms_that_cannot_start_at_rel_are_refused():
    ens, alloc = _tiny()
    clash = dict(src=np.array([0, 0]), dst=np.array([1, 1]), rel=np.zeros(2),
                 dur=np.array([5.0, 5.0]))
    for engine in ENGINES:
        with pytest.raises(AssertionError, match="did not establish at their release"):
            bc.schedule_batch_arrays(ens, alloc, "greedy", engine=engine, busy={(0, 0): clash})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["kernel", "jax"])
@pytest.mark.parametrize("discipline", ["greedy", "reserving"])
def test_busy_card_equals_host(cuda, discipline, engine):
    for seed in range(3):
        ens, alloc, busy = _busy_case(seed)
        host = bc.schedule_batch_arrays(ens, alloc, discipline, engine=engine, busy=busy)
        card_ens = dataclasses.replace(ens, **{
            f: getattr(ens, f).to(cuda) for f in _tensor_fields(ens)})
        card_alloc = dataclasses.replace(alloc, **{
            f.name: getattr(alloc, f.name).to(cuda) for f in dataclasses.fields(alloc)})
        card = bc.schedule_batch_arrays(card_ens, card_alloc, discipline, engine=engine,
                                        busy=busy)
        for (s1, c1), (s2, c2) in zip(card, host):
            assert c1.tobytes() == c2.tobytes()
            for x, y in zip(s1, s2):
                assert x.establish.tobytes() == y.establish.tobytes()
                assert x.complete.tobytes() == y.complete.tobytes()
