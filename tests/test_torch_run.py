"""The port's per-instance `Pipeline.run` against the JAX package.

* Given the reference's exact LP solution, `run` is bit-identical to
  `repro.core.scheduler._legacy_run` (order, allocation, establish and
  complete times, CCTs) under both disciplines, with zero and trace
  releases, a flow whose duration rounds to 0 and an empty core.  With no
  LP given and ``lp_method="exact"`` it solves the same HiGHS LP, so it
  stays bit-identical.  Tolerance: none.
* `run` and `run_batch` with the same solutions are bit-identical, and
  `run_batch` without solutions equals `run` per instance.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import lp as ref_lp
from repro.core.scheduler import _legacy_run
from repro.traffic.instances import random_instance, sample_instance
from repro_torch.convert import from_reference
from repro_torch.core.validate import validate_schedule
from repro_torch.pipeline import build_pipeline, get_pipeline, get_scheme

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

DISCIPLINES = ["greedy", "reserving"]


def _dur0_empty_core():
    """delta = 0, K = 3 and two single-flow coflows, one of 5e-324 bytes:
    its duration rounds to 0, and one core gets no flow."""
    d = np.zeros((2, 3, 3))
    d[0, 1, 2] = 5e-324
    d[1, 0, 2] = 7.0
    base = random_instance(num_coflows=2, num_ports=3, num_cores=3, seed=0, delta=0.0)
    return dataclasses.replace(base, demands=d)


CASES = {
    "zero": lambda: random_instance(num_coflows=10, num_ports=4, num_cores=3, seed=0),
    "arbitrary": lambda: random_instance(num_coflows=9, num_ports=5, num_cores=2, seed=1, release_span=25.0),
    "trace": lambda: sample_instance(num_ports=6, num_coflows=12, seed=1, release="trace"),
    "dur0_empty_core": _dur0_empty_core,
}


def _assert_same_result(got, want):
    assert got.scheme == want.scheme == "OURS"
    assert np.array_equal(got.order, want.order)
    for f in ("coflow", "src", "dst", "size", "core", "rho_ports", "tau_ports", "prefix_lb"):
        a, b = getattr(got.allocation, f), getattr(want.allocation, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert len(got.core_schedules) == len(want.core_schedules)
    for a, b in zip(got.core_schedules, want.core_schedules):
        for f in ("coflow", "src", "dst", "size", "establish", "complete"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert got.ccts.tobytes() == want.ccts.tobytes()
    assert got.total_weighted_cct == want.total_weighted_cct


@pytest.fixture(scope="module")
def solved():
    out = {}
    for name, make in CASES.items():
        ref = make()
        out[name] = (ref, ref_lp.solve_exact(ref))
    return out


@pytest.mark.parametrize("discipline", DISCIPLINES)
@pytest.mark.parametrize("case", list(CASES))
def test_run_injected_lp_bit_identical_to_legacy_run(solved, case, discipline):
    ref, sol = solved[case]
    got = get_pipeline("ours", discipline=discipline).run(
        from_reference(ref, "cpu"), from_reference(sol, "cpu"), device="cpu"
    )
    want = _legacy_run(ref, "ours", lp_solution=sol, discipline=discipline)
    _assert_same_result(got, want)
    assert got.lp.completion.tobytes() == sol.completion.tobytes()


def test_dur0_case_has_zero_duration_flow_and_empty_core(solved):
    ref, sol = solved["dur0_empty_core"]
    res = get_pipeline("ours").run(from_reference(ref, "cpu"), from_reference(sol, "cpu"), device="cpu")
    durations = np.concatenate([cs.complete - cs.establish for cs in res.core_schedules])
    assert (durations == 0.0).any()
    assert any(cs.coflow.shape[0] == 0 for cs in res.core_schedules)


@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_run_solving_exact_lp_bit_identical_to_legacy_run(solved, discipline):
    ref, _ = solved["arbitrary"]
    got = get_pipeline("ours", discipline=discipline, lp_method="exact").run(
        from_reference(ref, "cpu"), device="cpu"
    )
    want = _legacy_run(ref, "ours", lp_method="exact", discipline=discipline)
    _assert_same_result(got, want)
    assert got.lp.method == "exact"
    assert got.lp.completion.tobytes() == want.lp.completion.tobytes()


@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_run_and_run_batch_bit_identical(solved, discipline):
    refs = [solved[c][0] for c in CASES]
    insts = [from_reference(r, "cpu") for r in refs]
    sols = [from_reference(solved[c][1], "cpu") for c in CASES]
    pipe = get_pipeline("ours", discipline=discipline)
    batch = pipe.run_batch(insts, sols, device="cpu")
    for inst, sol, b in zip(insts, sols, batch):
        _assert_same_result(pipe.run(inst, sol, device="cpu"), b)


@pytest.mark.parametrize("lp_method", ["exact", "subgradient"])
def test_run_batch_without_solutions_equals_run(solved, lp_method):
    insts = [from_reference(solved[c][0], "cpu") for c in ("zero", "trace")]
    pipe = get_pipeline("ours", lp_method=lp_method, lp_iters=120)
    for sols in (None, [None, None]):
        batch = pipe.run_batch(insts, sols, device="cpu")
        for inst, b in zip(insts, batch):
            one = pipe.run(inst, device="cpu")
            _assert_same_result(one, b)
            assert b.lp.method == lp_method
            assert b.lp.objective == one.lp.objective
            assert b.lp.completion.tobytes() == one.lp.completion.tobytes()


def test_own_subgradient_lp_valid_and_within_bound(solved):
    for name in ("zero", "arbitrary", "trace"):
        ref, exact = solved[name]
        inst = from_reference(ref, "cpu")
        for discipline in DISCIPLINES:
            res = get_pipeline("ours", discipline=discipline, lp_method="subgradient",
                               lp_iters=600).run(inst, validate=False, device="cpu")
            validate_schedule(inst, res.core_schedules)
            assert res.lp.iterations == 600
            assert exact.objective - 1e-6 <= res.total_weighted_cct
            assert res.total_weighted_cct <= (8 * inst.num_cores + 1) * exact.objective


def test_build_pipeline_configures_lp_stage():
    pipe = build_pipeline(get_scheme("ours"), lp_method="subgradient", lp_iters=7)
    assert (pipe.order_stage.method, pipe.order_stage.iters) == ("subgradient", 7)
    default = get_pipeline("ours")
    assert (default.order_stage.method, default.order_stage.iters) == ("exact", 3000)
    assert default.circuit_stage.discipline == "greedy"


def test_unported_run_options_are_refused(solved):
    """`run` takes no ``mesh``, as the reference's does; ``mesh`` on
    `run_batch` is ported (`tests/test_torch_mesh_sharding.py`), and so
    are ``refine`` and ``stage_cache``, which run."""
    ref, sol = solved["zero"]
    inst, s = from_reference(ref, "cpu"), from_reference(sol, "cpu")
    pipe = get_pipeline("ours")
    with pytest.raises(TypeError, match="mesh"):
        pipe.run(inst, s, mesh=None, device="cpu")
    assert pipe.run_batch([inst], [s], mesh=None, device="cpu")[0].ccts.tobytes() == (
        pipe.run(inst, s, device="cpu").ccts.tobytes())
    refined = pipe.run(inst, s, refine=True, device="cpu")
    assert refined.total_weighted_cct <= pipe.run(inst, s, device="cpu").total_weighted_cct
    assert pipe.run_batch([inst], [s], stage_cache={}, device="cpu")[0].ccts.tobytes() == (
        pipe.run(inst, s, device="cpu").ccts.tobytes())
