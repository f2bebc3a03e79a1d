"""The port's single-instance ordering LP against the JAX package's.

* `lp_terms_plain` (the `lp_terms` kernel's CPU twin) against
  `lp_terms_ref` and the interpret-mode `lp_terms_pallas`, within
  `lp_terms.rtol(M)` (every summand >= 0), wider than 128 ports too.
* `solve_exact`: bit-identical completion, precedence and objective (the
  same HiGHS call on the same arrays).
* `solve_subgradient(device="cpu")`: f32 projected Adam from the same warm
  start as `repro.core.lp.solve_subgradient`; the trajectories part by f32
  rounding, so the contract is the objective within 0.5 % of the
  reference's at the same ``iters``, and at least the exact optimum minus
  1e-4 relative (a feasible point, up to f32).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lp as ref_lp
from repro.core.ordering import lp_guided_order as ref_lp_guided_order
from repro.kernels.lp_terms.kernel import lp_terms_pallas
from repro.kernels.lp_terms.ref import lp_terms_ref
from repro.traffic.instances import random_instance, sample_instance
from repro_torch.convert import from_reference
from repro_torch.core import lp as port_lp
from repro_torch.core.ordering import lp_guided_order
from repro_torch.kernels import lp_terms as lt

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)


def _single_inputs(M, P, seed):
    rng = np.random.default_rng(seed)
    Y = np.triu(rng.random((M, M)), 1)
    X = Y + np.tril(1 - Y.T, -1) + np.eye(M)
    return (
        X.astype(np.float32),
        rng.uniform(0, 50, (M, P)).astype(np.float32),
        rng.integers(0, 10, (M, P)).astype(np.float32),
        float(rng.uniform(0.01, 0.1)),
        float(rng.uniform(0.0, 3.0)),
    )


# ------------------------------------------------------------------- lp_terms
@pytest.mark.parametrize("M,P", [(1, 1), (10, 8), (37, 6), (20, 130), (33, 300)])
def test_lp_terms_plain_matches_oracles(M, P):
    x, rho, tau, inv_R, dok = _single_inputs(M, P, M * 1000 + P)
    got = lt.lp_terms(torch.from_numpy(x), torch.from_numpy(rho), torch.from_numpy(tau), inv_R, dok)
    assert all(g.dtype == torch.float32 and g.shape == (M,) for g in got)
    jargs = (jnp.asarray(x), jnp.asarray(rho), jnp.asarray(tau))
    refs = (
        lp_terms_ref(*jargs, inv_R, dok),
        lp_terms_pallas(*jargs, inv_R=inv_R, delta_over_K=dok, interpret=True),
    )
    for ref in refs:
        for a, r in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=lt.rtol(M), atol=0)


def test_lp_terms_counts_only_launches_and_validates():
    x, rho, tau, inv_R, dok = map(
        lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a,
        _single_inputs(5, 4, 0),
    )
    before = (lt.SINGLE_LAUNCHES, lt.LAUNCHES)
    lt.lp_terms(x, rho, tau, inv_R, dok)
    assert (lt.SINGLE_LAUNCHES, lt.LAUNCHES) == before
    with pytest.raises(ValueError, match=r"\(M, M\)"):
        lt.lp_terms(x[:, :4], rho, tau, inv_R, dok)
    with pytest.raises(ValueError, match="p_tau must match"):
        lt.lp_terms(x, rho, tau[:, :3], inv_R, dok)
    with pytest.raises(TypeError, match="float32"):
        lt.lp_terms(x.double(), rho, tau, inv_R, dok)
    with pytest.raises(ValueError, match="P >= 1"):
        lt.lp_terms(x, rho[:, :0], tau[:, :0], inv_R, dok)


def test_hard_and_smooth_completion_match_reference():
    """`_completion_from_Y` (hard through `lp_terms`, smooth through the
    logsumexp) against the reference's on the same f32 inputs."""
    from repro.core.coflow import port_stats

    inst = random_instance(num_coflows=14, num_ports=5, seed=4, release_span=20.0)
    rho, tau = port_stats(inst.demands)
    rng = np.random.default_rng(0)
    Y = np.triu(rng.random((14, 14)), 1).astype(np.float32)
    ops = [a.astype(np.float32) for a in (rho, tau, inst.releases)]
    scales = (1.0 / inst.aggregate_rate, inst.delta / inst.num_cores)
    for temp in (None, 3.0):
        want = ref_lp._completion_from_Y(
            jnp.asarray(Y), *map(jnp.asarray, ops), *scales,
            temp=None if temp is None else jnp.float32(temp),
        )
        got = port_lp._completion_from_Y(
            torch.from_numpy(Y), *map(torch.from_numpy, ops), *scales,
            temp=None if temp is None else torch.tensor(temp, dtype=torch.float32),
        )
        # Hard: rtol(M) from the product; smooth: a few more f32 roundings
        # through exp/log, all relative to values of the same sign.
        rtol = lt.rtol(14) if temp is None else 1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=0)


# ---------------------------------------------------------------- solve_exact
def _dur0_instance():
    """delta = 0 and one 5e-324 demand: a flow whose duration rounds to 0."""
    base = random_instance(num_coflows=6, num_ports=4, num_cores=3, seed=3, delta=0.0)
    d = base.demands.copy()
    d[2] = 0.0
    d[2, 1, 3] = 5e-324
    return dataclasses.replace(base, demands=d)


EXACT_CASES = {
    "zero": lambda: random_instance(num_coflows=10, num_ports=4, seed=0),
    "releases": lambda: random_instance(num_coflows=12, num_ports=5, num_cores=4, seed=1, release_span=30.0),
    "trace": lambda: sample_instance(num_ports=6, num_coflows=14, seed=2, release="trace"),
    "dur0": _dur0_instance,
    "single": lambda: random_instance(num_coflows=1, num_ports=4, seed=2),
}


@pytest.mark.parametrize("case", list(EXACT_CASES))
def test_solve_exact_bit_identical(case):
    ref = EXACT_CASES[case]()
    want = ref_lp.solve_exact(ref)
    got = port_lp.solve_exact(from_reference(ref, "cpu"))
    assert got.completion.tobytes() == want.completion.tobytes()
    assert got.precedence.tobytes() == want.precedence.tobytes()
    assert got.objective == want.objective
    assert (got.method, got.iterations) == (want.method, want.iterations)
    assert np.array_equal(got.order(), want.order())


# ---------------------------------------------------------- solve_subgradient
SUB_CASES = [
    (12, 4, 3, 0.0, 0),
    (20, 5, 2, 30.0, 1),
    (40, 6, 3, 0.0, 2),
]


@pytest.fixture(scope="module", params=SUB_CASES, ids=lambda c: f"M{c[0]}-span{c[3]:g}")
def subgradient_pair(request):
    M, N, K, span, seed = request.param
    ref = random_instance(num_coflows=M, num_ports=N, num_cores=K, seed=seed, release_span=span)
    iters = 1500
    want = ref_lp.solve_subgradient(ref, iters=iters)
    got = port_lp.solve_subgradient(from_reference(ref, "cpu"), iters=iters, device="cpu")
    return ref, want, got, ref_lp.solve_exact(ref)


def test_subgradient_objective_close_to_reference(subgradient_pair):
    _, want, got, _ = subgradient_pair
    assert abs(got.objective - want.objective) <= 0.005 * want.objective


def test_subgradient_brackets_exact_lp(subgradient_pair):
    ref, _, got, exact = subgradient_pair
    assert got.objective >= exact.objective * (1 - 1e-4)
    # The reference's own bounds (tests/test_lp.py): 2 % with zero
    # releases, 3 % with releases.
    assert got.objective <= (1.03 if ref.releases.any() else 1.02) * exact.objective


def test_subgradient_solution_is_feasible(subgradient_pair):
    ref, _, got, _ = subgradient_pair
    M = ref.num_coflows
    assert got.method == "subgradient" and got.iterations == 1500
    assert got.completion.dtype == np.float64 and got.completion.shape == (M,)
    x = got.precedence
    off = ~np.eye(M, dtype=bool)
    np.testing.assert_allclose((x + x.T)[off], 1.0, atol=1e-6)
    assert (x >= 0).all() and (x <= 1).all() and (np.diag(x) == 0).all()
    assert (got.completion >= ref.releases.astype(np.float32) - 1e-4).all()
    np.testing.assert_allclose(float(np.dot(ref.weights, got.completion)), got.objective, rtol=1e-5)


def test_warm_start_matches_reference():
    """The weighted lower-bound warm start: the same Y0 bits as the
    reference's."""
    ref = random_instance(num_coflows=15, num_ports=5, seed=8, release_span=10.0)
    inst = from_reference(ref, "cpu")
    ((rho, _),) = port_lp.instance_port_stats([inst], torch.device("cpu"))
    w = torch.from_numpy(inst.weights)
    Y0 = port_lp._warm_start_Y0(w, port_lp.global_lower_bound(inst, rho))
    assert Y0.numpy().tobytes() == ref_lp._warm_start_Y0(ref, None).tobytes()


def test_lp_guided_order_methods():
    ref = random_instance(num_coflows=9, num_ports=4, seed=6, release_span=12.0)
    inst = from_reference(ref, "cpu")
    order, sol = lp_guided_order(inst, device="cpu")
    ref_order, ref_sol = ref_lp_guided_order(ref)
    assert np.array_equal(order, ref_order)
    assert sol.completion.tobytes() == ref_sol.completion.tobytes()
    order, sol = lp_guided_order(inst, method="subgradient", device="cpu", iters=50)
    assert sol.method == "subgradient" and sol.iterations == 50
    assert np.array_equal(order, sol.order())
    with pytest.raises(ValueError, match="unknown LP method"):
        lp_guided_order(inst, method="simplex", device="cpu")
