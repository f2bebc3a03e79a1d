"""The paper's baseline schemes and EPS through the port's pipeline.

* Every `PAPER_SCHEMES` entry, under both disciplines and, for list
  circuits, both calendar engines: `run_batch` on the CPU given the
  reference's exact LP solutions gives orders, allocations, establish and
  complete times and CCTs bit-identical to
  `repro.core.scheduler._legacy_run` (tolerance: none), on small random
  instances (zero, arbitrary and trace releases, ties in the WSPT score, a
  coflow released late, an empty core with a zero-duration flow) and on a
  paper-default instance (N = 10, M = 100, K = 3).  ``wspt_order`` records
  ``lp=None`` and reads no LP.  `run` and `run_batch` agree bit for bit.
* A FIFO order stage against the reference's `fifo_order` composed with its
  circuit scheme runner.
* ``eps``: CCTs bit-identical to the reference composed by hand
  (`allocate(include_tau=False)`, `_flow_priorities`,
  `fluid_schedule_core` per core, `eps_ccts`); `run_eps` within its 4H
  (+1) bound of the exact LP; delta > 0 refused.
* `build_pipeline` for every order and circuit kind; unknown kinds raise.
* The host circuit stages run no calendar round; list stages do.
* On the card (``cuda`` marker): every scheme's `run_batch` bit-identical
  to the same call on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import lp as ref_lp
from repro.core.allocation import allocate as ref_allocate
from repro.core.eps import eps_ccts as ref_eps_ccts
from repro.core.eps import fluid_schedule_core as ref_fluid
from repro.core.ordering import fifo_order as ref_fifo_order
from repro.core.scheduler import _flow_priorities as ref_flow_priorities
from repro.core.scheduler import _legacy_run, _run_circuit_scheme
from repro.traffic.instances import paper_default_instance, random_instance, sample_instance
from repro_torch.convert import from_reference
from repro_torch.core.eps import run_eps
from repro_torch.pipeline import (
    PAPER_SCHEMES,
    SchemeSpec,
    batch_circuit,
    build_pipeline,
    get_pipeline,
    get_scheme,
    list_schemes,
    stages,
)

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

DISCIPLINES = ["greedy", "reserving"]
LIST_SCHEMES = ("ours", "wspt_order", "load_only")
HOST_SCHEMES = ("sunflow_s", "bvn_s")
# (scheme, discipline, engine): both engines where a list circuit runs.
COMBOS = [
    (s, d, e) for s in LIST_SCHEMES for d in DISCIPLINES for e in ("kernel", "jax")
] + [(s, d, "kernel") for s in HOST_SCHEMES for d in DISCIPLINES]


def _tie_instance():
    """Equal weights, equal lower bounds: WSPT's score ties in two groups."""
    d = np.zeros((6, 3, 3))
    d[[0, 2, 3, 5]] = np.array([[0, 4.0, 0], [1.0, 0, 0], [0, 0, 2.0]])
    d[[1, 4]] = np.array([[3.0, 0, 0], [0, 0, 3.0], [0, 3.0, 0]])
    base = random_instance(num_coflows=6, num_ports=3, num_cores=2, seed=4)
    return dataclasses.replace(base, demands=d, weights=np.ones(6))


def _late_instance():
    """A coflow released long after the others have finished."""
    base = random_instance(num_coflows=6, num_ports=4, num_cores=2, seed=9)
    rel = np.zeros(6)
    rel[2] = 1e4
    return dataclasses.replace(base, releases=rel)


def _empty_core_zero_flow():
    """delta = 0, K = 3 and two single-flow coflows, one of 5e-324 bytes:
    its duration rounds to 0, and one core gets no flow."""
    d = np.zeros((2, 3, 3))
    d[0, 1, 2] = 5e-324
    d[1, 0, 2] = 7.0
    base = random_instance(num_coflows=2, num_ports=3, num_cores=3, seed=0, delta=0.0)
    return dataclasses.replace(base, demands=d)


def _small_refs():
    refs = [
        random_instance(num_coflows=m, num_ports=n, num_cores=k, seed=s,
                        release_span=15.0 * (s % 2))
        for m, n, k, s in [(5, 3, 2, 0), (8, 4, 3, 1), (6, 5, 3, 2), (10, 6, 1, 3)]
    ]
    refs.append(sample_instance(num_ports=6, num_coflows=12, seed=1, release="trace"))
    return refs + [_tie_instance(), _late_instance(), _empty_core_zero_flow()]


@pytest.fixture(scope="module")
def small():
    refs = _small_refs()
    sols = [ref_lp.solve_exact(r) for r in refs]
    return refs, sols, [from_reference(r, "cpu") for r in refs], [
        from_reference(s, "cpu") for s in sols
    ]


@pytest.fixture(scope="module")
def paper():
    ref = paper_default_instance(seed=1)
    sol = ref_lp.solve_exact(ref)
    return ref, sol, from_reference(ref, "cpu"), from_reference(sol, "cpu")


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _assert_same_result(got, want):
    assert got.scheme == want.scheme
    _same(got.order, want.order, "order")
    for f in ("coflow", "src", "dst", "size", "core", "rho_ports", "tau_ports", "prefix_lb"):
        _same(getattr(got.allocation, f), getattr(want.allocation, f), f)
    if want.core_schedules is None:
        assert got.core_schedules is None
    else:
        assert len(got.core_schedules) == len(want.core_schedules)
        for a, b in zip(got.core_schedules, want.core_schedules):
            for f in ("coflow", "src", "dst", "size", "establish", "complete"):
                _same(getattr(a, f), getattr(b, f), f)
    _same(got.ccts, want.ccts, "ccts")
    assert got.total_weighted_cct == want.total_weighted_cct
    assert (got.lp is None) == (want.lp is None)
    if want.lp is not None:
        _same(got.lp.completion, want.lp.completion, "lp completion")


@pytest.mark.parametrize("scheme,discipline,engine", COMBOS)
def test_run_batch_bit_identical_to_legacy_run(small, scheme, discipline, engine):
    refs, sols, insts, psols = small
    got = get_pipeline(scheme, discipline=discipline, circuit_engine=engine).run_batch(
        insts, psols, device="cpu"
    )
    for ref, sol, res in zip(refs, sols, got):
        want = _legacy_run(ref, scheme, lp_solution=sol, discipline=discipline)
        _assert_same_result(res, want)
        assert res.wall_time_s > 0


@pytest.mark.parametrize("discipline", DISCIPLINES)
@pytest.mark.parametrize("scheme", PAPER_SCHEMES)
def test_paper_default_bit_identical_to_legacy_run(paper, scheme, discipline):
    ref, sol, inst, psol = paper
    pipe = get_pipeline(scheme, discipline=discipline)
    got = pipe.run(inst, psol, device="cpu")
    want = _legacy_run(ref, scheme, lp_solution=sol, discipline=discipline)
    _assert_same_result(got, want)
    _assert_same_result(pipe.run_batch([inst], [psol], device="cpu")[0], got)


def test_paper_default_fig3_ordering(paper):
    """The reference's qualitative Fig. 3 claims on this instance."""
    _, _, inst, psol = paper
    res = {s: get_pipeline(s).run(inst, psol, device="cpu") for s in PAPER_SCHEMES}
    norm = {s: r.normalized_to(res["ours"]) for s, r in res.items()}
    assert norm["bvn_s"] > norm["ours"] == 1.0
    assert norm["sunflow_s"] > 1.0
    assert norm["load_only"] > 0.95
    assert norm["wspt_order"] < 1.3


@pytest.mark.parametrize("scheme", PAPER_SCHEMES)
def test_run_and_run_batch_bit_identical(small, scheme):
    _, _, insts, psols = small
    pipe = get_pipeline(scheme)
    batch = pipe.run_batch(insts, psols, device="cpu")
    for inst, sol, b in zip(insts, psols, batch):
        _assert_same_result(pipe.run(inst, sol, device="cpu"), b)


def test_wspt_reads_no_lp(small, monkeypatch):
    """WSPT solves no LP, ignores given solutions and records ``lp=None``."""
    refs, _, insts, psols = small
    from repro_torch.core import ordering

    def refuse(*args, **kwargs):
        raise AssertionError("WSPT solved an LP")

    monkeypatch.setattr(ordering.lp_mod, "solve_exact", refuse)
    monkeypatch.setattr(ordering.lp_mod, "solve_subgradient", refuse)
    pipe = get_pipeline("wspt_order")
    assert pipe.order_stage.needs_lp is False
    given = pipe.run_batch(insts, psols, device="cpu")
    for sols in (None, [None] * len(insts)):
        for a, b in zip(pipe.run_batch(insts, sols, device="cpu"), given):
            assert a.lp is None and b.lp is None
            _assert_same_result(a, b)
    assert pipe.run(insts[0], device="cpu").lp is None


def test_wspt_ties_keep_index_order(small):
    """Equal weights and equal lower bounds: the batched order (a stable
    torch argsort over the padded bucket) keeps index order like NumPy's."""
    refs, _, insts, _ = small
    ref, inst = refs[5], insts[5]
    score = ref.weights / ref.global_lower_bound()
    assert len(np.unique(score)) == 2
    got = get_pipeline("wspt_order").run_batch(insts, device="cpu")[5]
    assert list(got.order) == [1, 4, 0, 2, 3, 5]
    _same(got.order, np.argsort(-score, kind="stable"))


@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_fifo_order_stage(small, discipline):
    refs, _, insts, _ = small
    pipe = build_pipeline(SchemeSpec(key="fifo", name="FIFO", order="fifo"),
                          discipline=discipline)
    got = pipe.run_batch(insts, device="cpu")
    for ref, res in zip(refs, got):
        want = _run_circuit_scheme(ref, "FIFO", ref_fifo_order(ref), None,
                                   discipline=discipline)
        _assert_same_result(res, want)


def _eps_refs():
    out = [dataclasses.replace(r, delta=0.0) for r in _small_refs()]
    out.append(dataclasses.replace(paper_default_instance(seed=3), delta=0.0))
    return out


@pytest.fixture(scope="module")
def eps_cases():
    refs = _eps_refs()
    return refs, [ref_lp.solve_exact(r) for r in refs]


def _eps_by_hand(ref, sol):
    """The reference's EPS pipeline composed from its `repro.core` parts."""
    order = sol.order()
    alloc = ref_allocate(ref, order, include_tau=False)
    prio = ref_flow_priorities(alloc, order, ref.num_coflows)
    schedules = []
    for h in range(ref.num_cores):
        sel = alloc.core == h
        schedules.append(ref_fluid(
            alloc.coflow[sel], alloc.src[sel], alloc.dst[sel], alloc.size[sel],
            prio[sel], ref.releases, ref.num_ports, float(ref.rates[h])))
    return order, alloc, ref_eps_ccts(ref, schedules)


def test_eps_bit_identical_to_reference_by_hand(eps_cases):
    refs, sols = eps_cases
    insts = [from_reference(r, "cpu") for r in refs]
    got = get_pipeline("eps").run_batch(
        insts, [from_reference(s, "cpu") for s in sols], device="cpu"
    )
    for ref, sol, res in zip(refs, sols, got):
        order, alloc, ccts = _eps_by_hand(ref, sol)
        assert res.scheme == "EPS" and res.core_schedules is None
        _same(res.order, order, "order")
        for f in ("coflow", "src", "dst", "size", "core"):
            _same(getattr(res.allocation, f), getattr(alloc, f), f)
        _same(res.ccts, ccts, "ccts")


def test_run_eps_within_theorem_2_bound(eps_cases):
    refs, sols = eps_cases
    for ref, sol in zip(refs, sols):
        inst = from_reference(ref, "cpu")
        r = run_eps(inst, from_reference(sol, "cpu"), device="cpu")
        _, _, ccts = _eps_by_hand(ref, sol)
        _same(r.ccts, ccts, "ccts")
        H = ref.num_cores
        assert r.bound == 4.0 * H + (1.0 if (ref.releases > 0).any() else 0.0)
        assert r.approx_ratio == r.total_weighted_cct / sol.objective
        assert r.approx_ratio <= r.bound
        assert r.approx_ratio >= 1.0 - 1e-6
    # Without a solution it solves the exact LP itself.
    inst = from_reference(refs[0], "cpu")
    assert run_eps(inst, device="cpu").ccts.tobytes() == run_eps(
        inst, from_reference(sols[0], "cpu"), device="cpu").ccts.tobytes()


def test_eps_refuses_positive_delta(small):
    _, _, insts, psols = small
    inst = insts[0]
    assert inst.delta > 0
    with pytest.raises(ValueError, match="delta == 0"):
        get_pipeline("eps").run(inst, psols[0], device="cpu")
    with pytest.raises(ValueError, match="delta == 0"):
        run_eps(inst, psols[0], device="cpu")
    with pytest.raises(ValueError, match="delta == 0"):
        stages.FluidCircuit().schedule(inst, None, None)


ORDER_KINDS = {"lp": stages.LPOrder, "wspt": stages.WsptOrder, "fifo": stages.FifoOrder}
CIRCUIT_KINDS = {
    "list": stages.ListCircuit, "sequential": stages.SequentialCircuit,
    "bvn": stages.BvnCircuit, "fluid": stages.FluidCircuit,
}


@pytest.mark.parametrize("circuit", list(CIRCUIT_KINDS))
@pytest.mark.parametrize("order", list(ORDER_KINDS))
def test_build_pipeline_every_kind(order, circuit):
    spec = SchemeSpec(key=f"{order}_{circuit}", name="X", order=order,
                      include_tau=order != "fifo", circuit=circuit)
    pipe = build_pipeline(spec, discipline="reserving", lp_method="subgradient",
                          lp_iters=9, circuit_engine="jax")
    assert type(pipe.order_stage) is ORDER_KINDS[order]
    assert type(pipe.circuit_stage) is CIRCUIT_KINDS[circuit]
    assert pipe.order_stage.needs_lp == (order == "lp")
    assert pipe.allocate_stage.include_tau == (order != "fifo")
    if order == "lp":
        assert (pipe.order_stage.method, pipe.order_stage.iters) == ("subgradient", 9)
    if circuit == "list":
        assert (pipe.circuit_stage.discipline, pipe.circuit_stage.engine) == ("reserving", "jax")
    assert hasattr(pipe.circuit_stage, "schedule_batch_arrays") == (circuit == "list")


@pytest.mark.parametrize("field,match", [("order", "order stage kind"),
                                         ("circuit", "circuit stage kind")])
def test_build_pipeline_unknown_kind_raises(field, match):
    spec = dataclasses.replace(get_scheme("ours"), **{field: "nope"})
    with pytest.raises(ValueError, match=match):
        build_pipeline(spec)
    with pytest.raises(ValueError, match="unknown scheme"):
        get_pipeline("ours_ls")


def test_registry():
    assert PAPER_SCHEMES == ("ours", "wspt_order", "load_only", "sunflow_s", "bvn_s")
    assert list_schemes() == PAPER_SCHEMES + ("eps",)
    table = {k: (get_scheme(k).name, get_scheme(k).order, get_scheme(k).include_tau,
                 get_scheme(k).circuit) for k in list_schemes()}
    assert table == {
        "ours": ("OURS", "lp", True, "list"),
        "wspt_order": ("WSPT-ORDER", "wspt", True, "list"),
        "load_only": ("LOAD-ONLY", "lp", False, "list"),
        "sunflow_s": ("SUNFLOW-S", "lp", True, "sequential"),
        "bvn_s": ("BVN-S", "lp", True, "bvn"),
        "eps": ("EPS", "lp", False, "fluid"),
    }


@pytest.mark.parametrize("scheme", PAPER_SCHEMES + ("eps",))
def test_calendar_rounds_only_for_list_circuits(eps_cases, scheme):
    """List circuits run the batched calendar (rounds counted per engine);
    the sequential, BvN and fluid stages schedule on the host and run none."""
    refs, sols = eps_cases
    insts = [from_reference(r, "cpu") for r in refs[:3]]
    psols = [from_reference(s, "cpu") for s in sols[:3]]
    before = dict(batch_circuit.ROUNDS)
    get_pipeline(scheme).run_batch(insts, psols, device="cpu")
    moved = {e: batch_circuit.ROUNDS[e] - before[e] for e in before}
    if scheme in LIST_SCHEMES:
        assert moved["kernel"] > 0 and moved["jax"] == 0
    else:
        assert moved == {"kernel": 0, "jax": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", PAPER_SCHEMES)
def test_card_equals_host(cuda, small, scheme):
    _, _, insts, psols = small
    for d in DISCIPLINES:
        pipe = get_pipeline(scheme, discipline=d)
        for a, b in zip(pipe.run_batch(insts, psols, device=cuda),
                        pipe.run_batch(insts, psols, device="cpu")):
            _assert_same_result(a, b)
