"""Candidate-search refinement and ``ours_ls`` in the port, against the
reference.

The reference's `repro.pipeline.refine` does not import under the
installed JAX (its package imports `enable_x64`), so its own definitions
of `_order_crossover`, `generate_candidates`, `_update_elites` and
`refine_sequential` are compiled from `src/repro/pipeline/refine.py`
(read with `ast`) into a namespace that holds NumPy, the reference's
`repro.core.localsearch.select_candidate` and an `as_refine_spec` that
returns the spec it is given.  Nothing in the JAX package changes.
Tolerance: none, throughout.

* (a) `generate_candidates` equals the reference's, order for order and
  cursor for cursor, over random incumbents, elite pools, rounds, cursors.
* (b) `refine_batch_arrays` on the CPU gives the reference's
  `refine_sequential` over `repro.core.localsearch.evaluate_order`: orders,
  objective, base objective, rounds and evaluations, under both
  disciplines, ``stop_after_stale`` None / 1 / 3, every generator, on
  mixed-shape ensembles with releases.
* (c) One ``("adjacent",)`` round with ``candidates = M`` picks
  `refine_round_best`'s winner, with its objectives.
* (d) `repro_torch.core.localsearch` equals the reference's module.
* ``ours_ls`` is never worse than ``ours``, within (8K+1) of the exact LP,
  and equals ``ours`` refined by the reference's oracle; ``stage_cache``
  shares the build and the orders but not the refinement, and refuses a
  second ensemble; `expand_members` is a gather, not a rebuild.
* On the card (``cuda`` marker): ``ours_ls`` bit-identical to the host's.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro.core import localsearch as ref_ls
from repro.core import lp as ref_lp
from repro.core.ordering import wspt_order as ref_wspt_order
from repro.traffic.instances import random_instance, sample_instance
from repro_torch.convert import from_reference
from repro_torch.core import localsearch as ls
from repro_torch.pipeline import (
    SchemeSpec,
    build_ensemble_batch,
    get_pipeline,
    get_scheme,
    register_scheme,
)
from repro_torch.pipeline import refine as rf
from repro_torch.pipeline import spec as spec_mod
from repro_torch.pipeline.batch_alloc import allocate_batch_arrays
from repro_torch.pipeline.batch_circuit import cct_batch_arrays
from repro_torch.pipeline.ensemble_batch import expansion_maps
from repro_torch.pipeline.spec import REFINE_GENERATORS, RefineSpec

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DISCIPLINES = ("greedy", "reserving")
# (M, N, K, seed): mixed shapes, K = 1..4, with and without releases.
MIXED = [(5, 3, 1, 0), (9, 4, 2, 1), (12, 5, 3, 2), (7, 4, 4, 3), (10, 6, 2, 4), (6, 3, 3, 5)]


def _reference_refine():
    """The reference's refinement functions, compiled from its source."""
    path = ROOT / "src" / "repro" / "pipeline" / "refine.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    wanted = {"_order_crossover", "generate_candidates", "_update_elites", "refine_sequential"}
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in wanted]
    assert {d.name for d in defs} == wanted
    future = ast.ImportFrom(module="__future__", names=[ast.alias(name="annotations")], level=0)
    module = ast.fix_missing_locations(ast.Module(body=[future] + defs, type_ignores=[]))
    ns = {"np": np, "select_candidate": ref_ls.select_candidate,
          "as_refine_spec": lambda spec: spec}
    exec(compile(module, str(path), "exec"), ns)
    return ns


REF = _reference_refine()


def _mixed_refs(shapes=MIXED, span=15.0):
    return [
        random_instance(num_coflows=m, num_ports=n, num_cores=k, seed=s,
                        release_span=span * (s % 2))
        for m, n, k, s in shapes
    ]


@pytest.fixture(scope="module")
def mixed():
    refs = _mixed_refs() + [sample_instance(num_ports=5, num_coflows=8, seed=2, release="trace")]
    sols = [ref_lp.solve_exact(r) for r in refs]
    return refs, sols, [from_reference(r, "cpu") for r in refs], [
        from_reference(s, "cpu") for s in sols
    ]


def _orders(ens, sols):
    return ens.pad_orders([s.order() for s in sols])


# ------------------------------------------------------------- (a) generators


@pytest.mark.parametrize("seed", range(6))
def test_generate_candidates_equals_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(12):
        M = int(rng.integers(1, 14))
        order = rng.permutation(M).astype(np.int64)
        gens = tuple(rng.choice(REFINE_GENERATORS, size=int(rng.integers(1, 4))))
        spec = RefineSpec(candidates=int(rng.integers(1, 12)), generators=gens,
                          seed=int(rng.integers(0, 100)), sigma=float(rng.uniform(0.1, 4.0)))
        elites = [(float(rng.uniform(1, 9)), rng.permutation(M).astype(np.int64))
                  for _ in range(int(rng.integers(0, 5)))]
        rnd, cursor = int(rng.integers(0, 5)), int(rng.integers(0, max(M, 1)))
        got, gc = rf.generate_candidates(order, spec, rnd, cursor, elites)
        want, wc = REF["generate_candidates"](order, spec, rnd, cursor, elites)
        assert gc == wc and len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_order_crossover_and_elites_equal_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        M = int(rng.integers(2, 12))
        pa, pb = rng.permutation(M), rng.permutation(M)
        cut = int(rng.integers(1, M))
        assert rf._order_crossover(pa, pb, cut).tobytes() == REF["_order_crossover"](
            pa, pb, cut).tobytes()
        elites = [(float(rng.integers(0, 4)), rng.permutation(M)) for _ in range(3)]
        scored = [(float(rng.integers(0, 4)), rng.permutation(M)) for _ in range(5)]
        scored.append(scored[0])  # a duplicate order
        got = rf._update_elites(elites, scored, 4)
        want = REF["_update_elites"](elites, scored, 4)
        assert [(o, x.tobytes()) for o, x in got] == [(o, x.tobytes()) for o, x in want]


# --------------------------------------------- (b) batched against sequential


def _check_batched_equals_reference(refs, sols, insts, psols, spec, discipline, engine):
    ens = build_ensemble_batch(insts, device="cpu")
    out = rf.refine_batch_arrays(ens, _orders(ens, psols), spec, discipline=discipline,
                                 engine=engine)
    assert out.batched
    rounds = evals = 0
    for b, (ref, sol) in enumerate(zip(refs, sols)):
        order, obj, base, r, e = REF["refine_sequential"](
            sol.order(), spec, lambda o, ref=ref: ref_ls.evaluate_order(ref, o, discipline))
        M = ref.num_coflows
        assert out.orders[b, :M].tobytes() == order.tobytes()
        assert out.objective[b] == obj and out.base_objective[b] == base
        rounds, evals = max(rounds, r), evals + e
    assert (out.rounds, out.evaluations) == (rounds, evals)
    return out


@pytest.mark.parametrize("stale", [None, 1, 3])
@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_batched_equals_reference_sequential(mixed, discipline, stale):
    refs, sols, insts, psols = mixed
    spec = RefineSpec(rounds=4, candidates=6, seed=11, stop_after_stale=stale)
    out = _check_batched_equals_reference(refs, sols, insts, psols, spec, discipline, "kernel")
    assert (out.objective <= out.base_objective).all()


@pytest.mark.parametrize("engine", ["jax", "wide"])
@pytest.mark.parametrize("generator", REFINE_GENERATORS)
def test_batched_equals_reference_per_generator(mixed, generator, engine):
    refs, sols, insts, psols = mixed
    spec = RefineSpec(rounds=3, candidates=5, generators=(generator,), seed=5,
                      stop_after_stale=2)
    _check_batched_equals_reference(refs[:4], sols[:4], insts[:4], psols[:4], spec,
                                    "greedy", engine)


# ------------------------------------------------------- (c) adjacent sweep


@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_full_adjacent_round_equals_refine_round_best(discipline):
    refs = _mixed_refs([(8, 4, 2, 1), (8, 5, 3, 2), (8, 3, 2, 7)], span=20.0)
    orders = [ref_wspt_order(r) for r in refs]
    insts = [from_reference(r, "cpu") for r in refs]
    ens = build_ensemble_batch(insts, device="cpu")
    M = 8
    spec = RefineSpec(rounds=1, candidates=M, generators=("adjacent",))
    out = rf.refine_batch_arrays(ens, ens.pad_orders(orders), spec, discipline=discipline)
    # Every candidate's objective, from one batched pass over the sweep.
    exp, inst_of, cand_of = ens.expand_members(M)
    rows = np.stack([
        np.concatenate([orders[b][:c - 1], orders[b][c:c + 1], orders[b][c - 1:c],
                        orders[b][c + 1:]]) if c else orders[b]
        for b, c in zip(inst_of, cand_of)
    ])
    cct = cct_batch_arrays(exp, allocate_batch_arrays(exp, torch.from_numpy(rows)),
                           discipline=discipline, engine="kernel")
    for b, ref in enumerate(refs):
        w, worder, objs = ref_ls.refine_round_best(ref, orders[b], discipline)
        mine = np.array([float(np.dot(ref.weights, cct[b * M + c])) for c in range(M)])
        assert mine.tobytes() == objs.tobytes()
        assert out.orders[b].tobytes() == worder.tobytes()
        assert out.objective[b] == objs[w] and out.base_objective[b] == objs[0]
    assert out.evaluations == M * len(refs) and out.rounds == 1


# ------------------------------------------------- (d) the host oracle module


@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_localsearch_equals_reference(discipline):
    refs = _mixed_refs(MIXED[:4], span=10.0)
    for ref in refs:
        inst = from_reference(ref, "cpu")
        order = ref_wspt_order(ref)
        assert ls.evaluate_order(inst, order, discipline) == ref_ls.evaluate_order(
            ref, order, discipline)
        got = ls.refine_order(inst, order, max_rounds=2, discipline=discipline)
        want = ref_ls.refine_order(ref, order, max_rounds=2, discipline=discipline)
        assert got[0].tobytes() == want[0].tobytes() and got[1:] == want[1:]
        w, o, objs = ls.refine_round_best(inst, order, discipline)
        rw, ro, robjs = ref_ls.refine_round_best(ref, order, discipline)
        assert (w, o.tobytes(), objs.tobytes()) == (rw, ro.tobytes(), robjs.tobytes())


def test_select_candidate_ties_and_tolerance():
    assert ls.TOL == ref_ls.TOL == 1e-9
    cases = [
        ([5.0, 5.0, 5.0], {}),  # no improvement: keep the incumbent
        ([5.0, 4.0, 4.0, 3.0 + 1e-10, 3.0], {}),  # within tol of the min: lowest index
        ([5.0, 5.0 - 5e-10], {}),  # improvement below tol
        ([5.0, 4.9, 4.8], {"tol": 0.15}),
        ([3.0, 1.0, 2.0], {"incumbent": 1}),
        ([2.0, 7.0, 1.0, 1.0], {"incumbent": 1, "tol": 0.0}),
    ]
    for objs, kw in cases:
        assert ls.select_candidate(np.array(objs), **kw) == ref_ls.select_candidate(
            np.array(objs), **kw)


# --------------------------------------------------- ours_ls and the pipeline


@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_ours_ls_never_worse_within_bound_and_equals_oracle(mixed, discipline):
    refs, sols, insts, psols = mixed
    ours = get_pipeline("ours", discipline=discipline).run_batch(insts, psols, device="cpu")
    ls_pipe = get_pipeline("ours_ls", discipline=discipline)
    got = ls_pipe.run_batch(insts, psols, device="cpu", require_batch=True)
    spec = get_scheme("ours_ls").refine
    for ref, sol, o, r in zip(refs, sols, ours, got):
        assert r.scheme == "OURS+LS"
        assert r.total_weighted_cct <= o.total_weighted_cct
        assert r.total_weighted_cct <= (8 * ref.num_cores + 1) * sol.objective
        order, obj, _, _, _ = REF["refine_sequential"](
            sol.order(), spec, lambda x, ref=ref: ref_ls.evaluate_order(ref, x, discipline))
        assert r.order.tobytes() == order.tobytes() and r.total_weighted_cct == obj
    # refine=False turns the spec's search off; refine=True turns it on for ours.
    off = ls_pipe.run_batch(insts, psols, device="cpu", refine=False)
    on = get_pipeline("ours", discipline=discipline).run_batch(insts, psols, device="cpu",
                                                               refine=True)
    for o, a, b, r in zip(ours, off, on, got):
        assert a.ccts.tobytes() == o.ccts.tobytes()
        assert b.ccts.tobytes() == r.ccts.tobytes()
    # run is a one-member run_batch, refinement included.
    one = ls_pipe.run(insts[2], psols[2], device="cpu")
    assert one.ccts.tobytes() == got[2].ccts.tobytes()


def test_stage_cache_shares_orders_not_refinement(mixed, monkeypatch):
    refs, sols, insts, psols = mixed
    cache: dict = {}
    builds = []
    real = build_ensemble_batch

    def counted(*args, **kwargs):
        builds.append(1)
        return real(*args, **kwargs)

    from repro_torch.pipeline import pipeline as pl

    monkeypatch.setattr(pl, "build_ensemble_batch", counted)
    ours = get_pipeline("ours").run_batch(insts, psols, device="cpu", stage_cache=cache)
    ls_res = get_pipeline("ours_ls").run_batch(insts, psols, device="cpu", stage_cache=cache)
    keys = [k for k in cache if isinstance(k, tuple)]
    assert len(builds) == 1
    assert sum(k[0] == "order" for k in keys) == 1
    assert sum(k[0] == "refine" for k in keys) == 1
    assert sum(k[0] == "alloc" for k in keys) == sum(k[0] == "circuit" for k in keys) == 2
    (outcome,) = [v for k, v in cache.items() if isinstance(k, tuple) and k[0] == "refine"]
    assert outcome.batched and outcome.rounds >= 1
    assert outcome.objective.tolist() == [r.total_weighted_cct for r in ls_res]
    assert outcome.base_objective.tolist() == [r.total_weighted_cct for r in ours]
    # The same pipeline again reads every stage from the cache.
    again = get_pipeline("ours_ls").run_batch(insts, psols, device="cpu", stage_cache=cache)
    assert len(builds) == 1 and [a.ccts.tobytes() for a in again] == [
        r.ccts.tobytes() for r in ls_res]
    with pytest.raises(ValueError, match="stage_cache reuse"):
        get_pipeline("ours").run_batch(insts[:2], psols[:2], device="cpu", stage_cache=cache)


def test_run_batch_takes_a_prebuilt_ensemble(mixed):
    _, _, insts, psols = mixed
    ens = build_ensemble_batch(insts, device="cpu")
    pipe = get_pipeline("ours_ls")
    a = pipe.run_batch(insts, psols, device="cpu", ensemble=ens)
    b = pipe.run_batch(insts, psols, device="cpu")
    assert [x.ccts.tobytes() for x in a] == [x.ccts.tobytes() for x in b]


def test_expand_members_is_a_gather(mixed, monkeypatch):
    _, _, insts, _ = mixed
    ens = build_ensemble_batch(insts[:3], device="cpu")
    from repro_torch.core import lp as lp_mod

    def refuse(*args, **kwargs):
        raise AssertionError("expand_members recomputed port statistics")

    monkeypatch.setattr(lp_mod, "instance_port_stats", refuse)
    exp, inst_of, cand_of = ens.expand_members(4)
    want_i, want_c = expansion_maps(3, 4)
    assert inst_of.tolist() == want_i.tolist() == [0] * 4 + [1] * 4 + [2] * 4
    assert cand_of.tolist() == want_c.tolist() == [0, 1, 2, 3] * 3
    assert exp.num_instances == 12
    assert exp.num_coflows == tuple(m for m in ens.num_coflows for _ in range(4))
    for f in dataclasses.fields(ens):
        v = getattr(ens, f.name)
        if isinstance(v, torch.Tensor):
            assert torch.equal(getattr(exp, f.name), v[torch.from_numpy(inst_of)]), f.name
    with pytest.raises(ValueError, match="reps"):
        ens.expand_members(0)


def test_refine_spec_validation_and_registry():
    assert rf.as_refine_spec(True) == RefineSpec()
    assert rf.as_refine_spec({"rounds": 3}).rounds == 3
    assert RefineSpec() == RefineSpec(rounds=2, candidates=8, generators=REFINE_GENERATORS,
                                      seed=0, sigma=2.0, elites=4, tol=1e-9,
                                      stop_after_stale=None)
    for bad, err in [({"rounds": 0}, ValueError), ({"candidates": 0}, ValueError),
                     ({"elites": 1}, ValueError), ({"generators": ()}, ValueError),
                     ({"generators": ("swap",)}, ValueError),
                     ({"stop_after_stale": 0}, ValueError)]:
        with pytest.raises(err):
            rf.as_refine_spec(bad)
    with pytest.raises(TypeError):
        rf.as_refine_spec(3)
    assert rf.refine_key(RefineSpec()) == rf.refine_key(RefineSpec())
    assert rf.refine_key(RefineSpec(seed=1)) != rf.refine_key(RefineSpec())
    assert get_scheme("OURS_LS").refine == RefineSpec()
    spec = SchemeSpec(key="ours_ls", name="OURS+LS3", refine=RefineSpec(rounds=3))
    with pytest.raises(ValueError, match="already registered"):
        register_scheme(spec)
    old = get_scheme("ours_ls")
    try:
        assert register_scheme(spec, replace=True) is spec
        assert get_scheme("ours_ls").refine.rounds == 3
    finally:
        register_scheme(old, replace=True)
    assert get_scheme("ours_ls") is old and spec_mod.list_schemes()[-1] == "ours_ls"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["kernel", "jax"])
@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_ours_ls_card_equals_host(cuda, mixed, discipline, engine):
    _, _, insts, psols = mixed
    pipe = get_pipeline("ours_ls", discipline=discipline, circuit_engine=engine)
    card = pipe.run_batch(insts, psols, device=cuda, require_batch=True)
    host = pipe.run_batch(insts, psols, device="cpu")
    for a, b in zip(card, host):
        assert a.order.tobytes() == b.order.tobytes()
        assert a.ccts.tobytes() == b.ccts.tobytes()
        for x, y in zip(a.core_schedules, b.core_schedules):
            assert x.establish.tobytes() == y.establish.tobytes()
            assert x.complete.tobytes() == y.complete.tobytes()
