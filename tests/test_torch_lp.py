"""The port's batched ordering LP against the JAX package's.

Both solvers run f32 projected Adam from the same packed arrays and warm
start ``Y0``; their trajectories part by f32 rounding, so the contract is
a tolerance, stated per test:
  * objective within 0.5 % of `repro.core.lp.solve_subgradient_batch`;
  * <= 1.02 x the exact LP optimum (`solve_exact`) with zero releases and
    <= 1.03 x with releases (the reference's own bounds, tests/test_lp.py);
  * >= the exact optimum - 1e-4 relative (a feasible point, up to f32).
"""

import numpy as np
import pytest
import torch

from repro.core import lp as ref_lp
from repro.traffic.instances import random_instance
from repro_torch.convert import from_reference
from repro_torch.core import lp as port_lp
from repro_torch.experiments import solve_ensemble_lp

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

ITERS = 1500


def _ensemble(seed, release_span):
    shapes = [(10, 4, 3), (12, 5, 2), (7, 3, 3)]
    return [
        random_instance(num_coflows=m, num_ports=n, num_cores=k, seed=seed * 10 + i,
                        release_span=release_span)
        for i, (m, n, k) in enumerate(shapes)
    ]


@pytest.fixture(scope="module", params=[(0, 0.0), (1, 40.0)], ids=["zero", "releases"])
def solved(request):
    seed, span = request.param
    refs = _ensemble(seed, span)
    insts = [from_reference(r, "cpu") for r in refs]
    ref = ref_lp.solve_subgradient_batch(refs, iters=ITERS)
    port = port_lp.solve_subgradient_batch(insts, iters=ITERS, device="cpu")
    exact = [ref_lp.solve_exact(r) for r in refs]
    return refs, ref, port, exact, span


def test_objective_close_to_reference(solved):
    refs, ref, port, _, _ = solved
    for r, p in zip(ref, port):
        assert abs(p.objective - r.objective) <= 0.005 * r.objective


def test_objective_brackets_exact_lp(solved):
    refs, _, port, exact, span = solved
    factor = 1.03 if span else 1.02
    for p, e in zip(port, exact):
        assert p.objective <= factor * e.objective
        assert p.objective >= e.objective * (1 - 1e-4)


def test_solution_is_feasible_and_ordered(solved):
    refs, _, port, _, _ = solved
    for inst, p in zip(refs, port):
        M = inst.num_coflows
        assert p.completion.shape == (M,) and p.precedence.shape == (M, M)
        x = p.precedence
        off = ~np.eye(M, dtype=bool)
        np.testing.assert_allclose((x + x.T)[off], 1.0, atol=1e-6)
        assert (x >= 0).all() and (x <= 1).all()
        assert (p.completion >= inst.releases - 1e-4).all()
        obj = float(np.dot(inst.weights, p.completion))
        np.testing.assert_allclose(obj, p.objective, rtol=1e-5)
        assert np.array_equal(p.order(), np.argsort(p.completion, kind="stable"))


def test_arrays_form_orders_match_unpacked_solutions():
    refs = _ensemble(2, 10.0)
    insts = [from_reference(r, "cpu") for r in refs]
    arrays = port_lp.pack_lp_arrays(insts, pad_coflows=16, pad_ports=16, device="cpu")
    batch = port_lp.solve_subgradient_batch_arrays(arrays, iters=200)
    sols = batch.unpack([i.num_coflows for i in insts])
    orders = batch.order_batch(arrays["coflow_mask"]).numpy()
    for b, sol in enumerate(sols):
        M = insts[b].num_coflows
        assert np.array_equal(orders[b, :M], sol.order())
        assert sorted(orders[b, M:].tolist()) == list(range(M, 16))


def test_solve_ensemble_lp_buckets_match_one_batch():
    """Bucketing changes padding only: each bucket member's objective stays
    within the f32 tolerance of an unbucketed batch solve."""
    refs = _ensemble(3, 0.0)
    insts = [from_reference(r, "cpu") for r in refs]
    bucketed = solve_ensemble_lp(insts, iters=400, device="cpu")
    whole = port_lp.solve_subgradient_batch(insts, iters=400, device="cpu")
    for a, b in zip(bucketed, whole):
        assert abs(a.objective - b.objective) <= 0.005 * b.objective


def test_degenerate_bucket_is_zero():
    arrays = port_lp.pack_lp_arrays([], pad_coflows=0, pad_ports=0, device="cpu")
    batch = port_lp.solve_subgradient_batch_arrays(arrays, iters=5)
    assert batch.completion.shape == (0, 0)
    assert port_lp.solve_subgradient_batch([], device="cpu") == []
