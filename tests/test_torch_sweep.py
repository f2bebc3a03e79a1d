"""The port's `sweep` (`repro_torch.experiments.sweep`) and ensemble
quanta against the JAX package's.

* `bucket_shape` and `build_buckets` equal the reference's (loaded by file
  path) at numeric quanta, at ``None`` (collapse to the ensemble maximum)
  and with a zero-coflow instance, which keeps its own zero bucket.
* `solve_ensemble_lp` objectives within 0.5 % of the reference's at quanta
  8 and ``None`` (f32 Adam on both sides: a tolerance, not bits).
* With ``lp_method="exact"`` every (instance, scheme) cell's weighted CCT
  and CCT vector are bit-identical to
  `repro.core.scheduler._legacy_run(ref, scheme, lp_solution=solve_exact(ref))`.
* ``certify=True``: certificates equal `repro.core.theory.certify` on the
  same inputs; the reserving rerun shares the sweep's one
  `build_ensemble_batch`.
* ``alloc="loop"`` equals ``"batch"`` and ``circuit="loop"`` equals
  ``"batch"``, bit for bit; ``refine`` and ``ours_ls`` rows are at or
  below ours'.
* The port's rows equal, as JSON bytes, those of the reference's own
  `sweep` compiled from source with its `repro.*` names bound to the
  port's CPU counterparts (`torch_fabric_reference`), under ``"exact"``,
  ``"batch"`` and ``"subgradient"``, with and without a cache, and
  ``refine``.
* The reference's argument errors raise here too; without a card,
  `sweep` with no ``device=`` raises (also in `test_torch_isolation.py`).
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

from repro.core import lp as ref_lp
from repro.core import theory as ref_theory
from repro.core.scheduler import _legacy_run
from repro.traffic.instances import random_instance as ref_random_instance
from repro_torch.convert import from_reference
from repro_torch.core.coflow import CoflowInstance
from repro_torch.experiments import (
    DEFAULT_SCHEMES,
    SweepCache,
    bucket_shape,
    build_buckets,
    solve_ensemble_lp,
    sweep,
)
from repro_torch.experiments.ensemble import COLLAPSED
from repro_torch.pipeline import PAPER_SCHEMES, ensemble_batch
from torch_fabric_reference import REF_ENSEMBLE, REF_SWEEP, reference_imports

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

CPU = dict(device="cpu")
SHAPES = [(8, 4, 2, 0.0), (10, 3, 2, 20.0), (12, 5, 3, 0.0), (9, 4, 2, 0.0)]


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path / "results"))
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path / "default_cache"))
    monkeypatch.setenv("HYPOTHESIS_STORAGE_DIRECTORY", str(tmp_path / "hypothesis"))
    for name, mod in reference_imports().items():
        monkeypatch.setitem(sys.modules, name, mod)


def _refs(seed0=60, shapes=SHAPES):
    return [ref_random_instance(num_coflows=m, num_ports=n, num_cores=k, seed=seed0 + i,
                                release_span=span)
            for i, (m, n, k, span) in enumerate(shapes)]


@pytest.fixture(scope="module")
def exact_case():
    refs = _refs()
    return refs, [from_reference(r, "cpu") for r in refs], [ref_lp.solve_exact(r) for r in refs]


def _empty(n=3, k=2):
    return CoflowInstance(demands=np.zeros((0, n, n)), weights=np.zeros(0),
                          releases=np.zeros(0), rates=np.full(k, 10.0), delta=1.0)


def _blob(res):
    return json.dumps(res.rows())


# ---------------------------------------------------------------------------
# Ensemble quanta
# ---------------------------------------------------------------------------

QUANTA = [(8, 8), (1, 1), (4, 16), (None, 8), (8, None), (None, None)]


@pytest.mark.parametrize("mq,pq", QUANTA)
def test_bucket_shape_equals_reference(mq, pq):
    for ref in _refs() + _refs(70, [(23, 7, 2, 0.0), (1, 2, 1, 0.0)]):
        want = REF_ENSEMBLE.bucket_shape(ref, mq, pq)
        assert bucket_shape(from_reference(ref, "cpu"), mq, pq) == want
    assert COLLAPSED == REF_ENSEMBLE.COLLAPSED
    assert bucket_shape(from_reference(_refs()[0], "cpu")) == (8, 8)


@pytest.mark.parametrize("mq,pq", QUANTA)
@pytest.mark.parametrize("with_empty", [False, True])
def test_build_buckets_equals_reference(mq, pq, with_empty):
    refs = _refs() + _refs(70, [(23, 7, 2, 0.0)])
    insts = [from_reference(r, "cpu") for r in refs]
    if with_empty:
        insts.insert(2, _empty())
    got = [dataclasses.astuple(b) for b in build_buckets(insts, mq, pq)]
    want = [dataclasses.astuple(b) for b in REF_ENSEMBLE.build_buckets(insts, mq, pq)]
    assert got == want
    if with_empty and mq is not None:
        assert any(b[0] == 0 and b[2] == (2,) for b in got)  # its own zero bucket
    if mq is None and pq is None:
        assert len(got) == 1
    assert build_buckets([], mq, pq) == []


@pytest.mark.parametrize("mq,pq", [(8, 8), (None, None)])
def test_solve_ensemble_lp_within_half_a_percent_of_reference(mq, pq):
    refs = _refs(80)
    want = REF_ENSEMBLE.solve_ensemble_lp(refs, iters=300, m_quantum=mq, p_quantum=pq)
    got = solve_ensemble_lp([from_reference(r, "cpu") for r in refs], iters=300,
                            m_quantum=mq, p_quantum=pq, **CPU)
    for g, w, ref in zip(got, want, refs):
        assert abs(g.objective - float(w.objective)) <= 0.005 * float(w.objective)
        assert g.completion.shape == (ref.num_coflows,)


# ---------------------------------------------------------------------------
# Cells against _legacy_run and the reference's certificate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("discipline", ["greedy", "reserving"])
def test_exact_cells_equal_legacy_run(exact_case, discipline):
    refs, insts, ref_sols = exact_case
    res = sweep(insts, schemes=PAPER_SCHEMES, lp_method="exact", discipline=discipline, **CPU)
    assert res.lp_method == "exact" and len(res) == len(insts)
    for rec, ref, sol in zip(res.records, refs, ref_sols):
        assert rec.lp.objective == sol.objective
        for s in PAPER_SCHEMES:
            want = _legacy_run(ref, s, lp_solution=sol, discipline=discipline)
            got = rec.results[s]
            assert got.total_weighted_cct == want.total_weighted_cct, (rec.index, s)
            assert got.ccts.dtype == np.float64
            assert got.ccts.tobytes() == np.asarray(want.ccts).tobytes(), (rec.index, s)


def test_certificates_equal_reference(exact_case):
    refs, insts, ref_sols = exact_case
    res = sweep(insts, schemes=("ours", "wspt_order"), lp_method="exact", certify=True, **CPU)
    for rec, ref, sol in zip(res.records, refs, ref_sols):
        ours = rec.results["ours"]
        want_g = ref_theory.certify(ref, ours.order, sol.completion, ours.allocation, ours.ccts)
        assert dataclasses.astuple(rec.cert_greedy) == dataclasses.astuple(want_g)
        res_r = _legacy_run(ref, "ours", lp_solution=sol, discipline="reserving")
        want_r = ref_theory.certify(ref, res_r.order, sol.completion, res_r.allocation,
                                    res_r.ccts)
        assert dataclasses.astuple(rec.cert_reserving) == dataclasses.astuple(want_r)
        assert rec.cert_reserving.ok() and want_r.ok()
    for row in res.rows():
        if row["scheme"] == "ours":
            assert row["approx_ratio"] <= row["bound"] and row["certified_reserving"] is True
            assert type(row["approx_ratio"]) is float
        else:
            assert "approx_ratio" not in row


@pytest.mark.parametrize("schemes", [("ours",), PAPER_SCHEMES])
def test_certify_rerun_shares_one_build(exact_case, schemes):
    _, insts, _ = exact_case
    before = ensemble_batch.BUILD_COUNT
    sweep(insts, schemes=schemes, lp_method="exact", certify=True, **CPU)
    assert ensemble_batch.BUILD_COUNT - before == 1


def test_certify_without_ours_in_the_schemes_runs_ours(exact_case):
    _, insts, _ = exact_case
    res = sweep(insts[:2], schemes=("wspt_order",), lp_method="exact", certify=True, **CPU)
    for rec in res.records:
        assert rec.cert_greedy is not None and rec.cert_reserving.ok()
        assert list(rec.results) == ["wspt_order"]


# ---------------------------------------------------------------------------
# Execution paths agree bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lp_method", ["exact", "batch"])
def test_alloc_and_circuit_loops_equal_batch(exact_case, lp_method):
    _, insts, _ = exact_case
    kw = dict(schemes=PAPER_SCHEMES, lp_method=lp_method, lp_iters=80, **CPU)
    base = _blob(sweep(insts, **kw))
    assert _blob(sweep(insts, alloc="loop", **kw)) == base
    assert _blob(sweep(insts, circuit="loop", **kw)) == base
    for engine in ("kernel", "jax", "wide"):
        assert _blob(sweep(insts, circuit_engine=engine, **kw)) == base, engine


def test_refine_and_ours_ls_at_or_below_ours(exact_case):
    _, insts, _ = exact_case
    res = sweep(insts, schemes=("ours", "ours_ls"), lp_method="exact", **CPU)
    refined = sweep(insts, schemes=("ours",), lp_method="exact",
                    refine={"rounds": 2, "candidates": 4}, **CPU)
    loop = sweep(insts, schemes=("ours", "ours_ls"), lp_method="exact", alloc="loop", **CPU)
    assert _blob(loop) == _blob(res)
    for rec, rrec in zip(res.records, refined.records):
        ours = rec.results["ours"].total_weighted_cct
        assert rec.results["ours_ls"].total_weighted_cct <= ours
        assert rrec.results["ours"].total_weighted_cct <= ours
    for row in res.rows():
        if row["scheme"] == "ours_ls":
            assert row["norm_weighted_cct"] <= 1.0


def test_subgradient_lp_runs_per_instance(exact_case):
    _, insts, _ = exact_case
    res = sweep(insts[:2], schemes=("ours",), lp_method="subgradient", lp_iters=60, **CPU)
    for rec, inst in zip(res.records, insts):
        assert rec.lp.method == "subgradient" and rec.lp.iterations == 60
        assert rec.results["ours"].ccts.shape == (inst.num_coflows,)


def test_rows_shape_and_base():
    insts = [from_reference(r, "cpu") for r in _refs()[:2]]
    res = sweep(insts, schemes=("wspt_order", "load_only"), lp_method="exact",
                metas=[{"seed": 1}, {"seed": 2}], **CPU)
    rows = res.rows()
    assert [(r["instance"], r["seed"], r["scheme"]) for r in rows] == [
        (0, 1, "wspt_order"), (0, 1, "load_only"), (1, 2, "wspt_order"), (1, 2, "load_only")]
    assert rows[0]["norm_weighted_cct"] == 1.0  # no ours: the first scheme is the base
    assert set(rows[0]) >= {"p95_cct", "p99_cct", "norm_p95", "norm_p99", "lp_objective"}
    json_path, csv_path = res.save("sweep_rows")
    with open(json_path) as f:
        assert json.load(f) == json.loads(json.dumps(rows))
    assert DEFAULT_SCHEMES == PAPER_SCHEMES


# ---------------------------------------------------------------------------
# Against the reference's own sweep, compiled from source
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lp_method,schemes,extra", [
    ("exact", PAPER_SCHEMES, {}),
    ("exact", ("ours", "wspt_order"), {"certify": True}),
    ("batch", PAPER_SCHEMES + ("ours_ls",), {"lp_iters": 80}),
    ("batch", ("ours", "load_only"), {"lp_iters": 80, "m_quantum": None, "p_quantum": None}),
    ("subgradient", ("ours",), {"lp_iters": 60}),
    ("exact", ("ours", "sunflow_s"), {"refine": {"rounds": 1, "candidates": 3}}),
    ("exact", ("ours", "bvn_s"), {"alloc": "loop", "discipline": "reserving"}),
], ids=["exact", "certify", "batch", "batch_collapsed", "subgradient", "refine", "loop"])
def test_rows_equal_compiled_reference_sweep(exact_case, tmp_path, lp_method, schemes, extra):
    _, insts, _ = exact_case
    kw = dict(schemes=schemes, lp_method=lp_method, metas=[{"seed": i} for i in range(4)],
              **extra)
    want = _blob(REF_SWEEP.sweep(insts, **kw))
    assert _blob(sweep(insts, **kw, **CPU)) == want
    fresh = sweep(insts, cache=str(tmp_path / "port"), **kw, **CPU)
    replay = sweep(insts, cache=str(tmp_path / "port"), **kw, **CPU)
    assert replay.cache_stats["computed"] == 0
    assert _blob(fresh) == _blob(replay) == want
    ref_cached = REF_SWEEP.sweep(insts, cache=str(tmp_path / "ref"), **kw)
    ref_replay = REF_SWEEP.sweep(insts, cache=str(tmp_path / "ref"), **kw)
    assert ref_replay.cache_stats == replay.cache_stats
    assert _blob(ref_cached) == _blob(ref_replay) == want


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


def test_reference_argument_errors(exact_case, tmp_path):
    _, insts, _ = exact_case
    cases = [
        dict(metas=[{}]),
        dict(lp_method="batch", certify=True),
        dict(lp_method="exact", certify=True, schemes=("wspt_order",),
             cache=str(tmp_path / "c")),
        dict(alloc="vector"),
        dict(circuit="vector"),
        dict(lp_method="simplex"),
    ]
    for kw in cases:
        with pytest.raises(ValueError):
            sweep(insts, **{"lp_method": "exact", **kw}, **CPU)
        with pytest.raises(ValueError):
            REF_SWEEP.sweep(insts, **{"lp_method": "exact", **kw})


def test_sweep_defaults_to_the_card(exact_case, monkeypatch):
    _, insts, _ = exact_case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in (dict(), dict(lp_method="exact"), dict(lp_method="subgradient")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sweep(insts, **kw)


def test_cache_argument_takes_a_store_or_a_path(exact_case, tmp_path):
    _, insts, _ = exact_case
    kw = dict(schemes=("ours",), lp_method="exact", **CPU)
    a = sweep(insts, cache=SweepCache(tmp_path), **kw)
    b = sweep(insts, cache=str(tmp_path), **kw)
    assert a.cache_stats["computed"] == 4 and b.cache_stats["computed"] == 0


def test_stage_cache_device_check_takes_the_current_card(monkeypatch):
    """The sweep shares one `EnsembleBatch` between schemes: its tensors sit
    on ``cuda:0``, the run resolves ``"cuda"``; both name the current card."""
    from repro_torch.pipeline.pipeline import _same_device

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    dev = torch.device
    assert _same_device(dev("cuda:0"), dev("cuda"))
    assert _same_device(dev("cuda"), dev("cuda"))
    assert not _same_device(dev("cuda:1"), dev("cuda"))
    assert not _same_device(dev("cpu"), dev("cuda"))
    assert _same_device(dev("cpu"), dev("cpu"))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "jax"])
def test_card_sweep_equals_host_and_replays_without_kernels(cuda, exact_case, tmp_path, engine):
    """With the exact LP, the card's cells equal the host's, certificates
    included; a cached replay launches no kernel."""
    from repro_torch.kernels import lp_terms, pair_resolve, port_stats
    from repro_torch.kernels import event_resolve

    _, insts, _ = exact_case
    kw = dict(schemes=PAPER_SCHEMES + ("ours_ls",), lp_method="exact", certify=True,
              circuit_engine=engine)
    card = sweep(insts, cache=str(tmp_path), device=cuda, **kw)
    assert _blob(card) == _blob(sweep(insts, **kw, **CPU))
    mods = (lp_terms, pair_resolve, port_stats, event_resolve)
    before = [m.LAUNCHES for m in mods] + [lp_terms.SINGLE_LAUNCHES]
    replay = sweep(insts, cache=str(tmp_path), device=cuda, **kw)
    assert replay.cache_stats["computed"] == 0 and _blob(replay) == _blob(card)
    assert [m.LAUNCHES for m in mods] + [lp_terms.SINGLE_LAUNCHES] == before
