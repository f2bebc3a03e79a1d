"""The port's `ours` pipeline end to end against the JAX package.

* With the reference's exact LP solutions injected, `run_batch` gives
  CCTs (and orders, allocations, schedules) bit-identical to
  `repro.core.scheduler._legacy_run` -- the oracle the reference's own
  `run_batch` is held to -- under both disciplines and both calendar
  engines (``"kernel"``, ``"jax"``).  Tolerance: none.
* With the port's own LP, every schedule validates and every weighted CCT
  is within (8K+1) x the exact LP optimum (the paper's bound).
"""

import numpy as np
import pytest
import torch

from repro.core import lp as ref_lp
from repro.core.scheduler import _legacy_run
from repro.traffic.instances import random_instance, sample_instance
from repro_torch.convert import from_reference
from repro_torch.core.validate import validate_schedule
from repro_torch.experiments import solve_ensemble_lp
from repro_torch.pipeline import PAPER_SCHEMES, get_pipeline, list_schemes

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

DISCIPLINES = ["greedy", "reserving"]


@pytest.fixture(scope="module")
def ensemble():
    refs = [
        random_instance(num_coflows=m, num_ports=n, num_cores=k, seed=s,
                        release_span=15.0 * (s % 2))
        for m, n, k, s in [(5, 3, 2, 0), (8, 4, 3, 1), (6, 5, 3, 2), (10, 6, 1, 3)]
    ]
    refs.append(sample_instance(num_ports=6, num_coflows=12, seed=1, release="trace"))
    return refs, [ref_lp.solve_exact(r) for r in refs]


@pytest.mark.parametrize("engine", ["kernel", "jax"])
@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_injected_lp_bit_identical_to_legacy_run(ensemble, discipline, engine):
    refs, sols = ensemble
    insts = [from_reference(r, "cpu") for r in refs]
    got = get_pipeline("ours", discipline=discipline, circuit_engine=engine).run_batch(
        insts, [from_reference(s, "cpu") for s in sols], device="cpu"
    )
    for inst, sol, res in zip(refs, sols, got):
        want = _legacy_run(inst, "ours", lp_solution=sol, discipline=discipline)
        assert res.scheme == want.scheme == "OURS"
        assert res.ccts.tobytes() == want.ccts.tobytes()
        assert res.total_weighted_cct == want.total_weighted_cct
        assert np.array_equal(res.order, want.order)
        for f in ("coflow", "core", "prefix_lb"):
            assert getattr(res.allocation, f).tobytes() == getattr(want.allocation, f).tobytes()
        for a, b in zip(res.core_schedules, want.core_schedules):
            assert a.establish.tobytes() == b.establish.tobytes()
            assert a.complete.tobytes() == b.complete.tobytes()


@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_own_lp_valid_and_within_bound(ensemble, discipline):
    refs, exact = ensemble
    insts = [from_reference(r, "cpu") for r in refs]
    sols = solve_ensemble_lp(insts, iters=600, device="cpu")
    results = get_pipeline("ours", discipline=discipline).run_batch(
        insts, sols, validate=False, device="cpu"
    )
    for inst, ex, res in zip(insts, exact, results):
        validate_schedule(inst, res.core_schedules)
        assert res.total_weighted_cct <= (8 * inst.num_cores + 1) * ex.objective
        assert res.total_weighted_cct >= ex.objective - 1e-6


def test_run_batch_needs_lp_solutions(ensemble):
    """`run_batch` needs one LP solution slot per instance: a list of
    another length is refused."""
    refs, sols = ensemble
    insts = [from_reference(r, "cpu") for r in refs]
    pipe = get_pipeline("ours")
    with pytest.raises(ValueError, match="length mismatch"):
        pipe.run_batch(insts, [], device="cpu")
    with pytest.raises(ValueError, match="length mismatch"):
        pipe.run_batch(insts, [from_reference(s, "cpu") for s in sols[:-1]], device="cpu")
    assert pipe.run_batch([], [], device="cpu") == []
    assert list_schemes() == PAPER_SCHEMES + ("eps",)


def test_run_batch_solves_missing_lp_solutions(ensemble):
    """A missing solution is solved per instance by the order stage (here
    the exact LP, so the results equal those with the solutions given)."""
    refs, sols = ensemble
    insts = [from_reference(r, "cpu") for r in refs]
    pipe = get_pipeline("ours")
    given = pipe.run_batch(insts, [from_reference(s, "cpu") for s in sols], device="cpu")
    solved = pipe.run_batch(insts, [None] * len(insts), device="cpu")
    for a, b in zip(solved, given):
        assert a.lp.method == "exact"
        assert a.ccts.tobytes() == b.ccts.tobytes()
