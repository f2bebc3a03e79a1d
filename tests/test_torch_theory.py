"""The port's certificate (`repro_torch.core.theory`) against the JAX
package's.

`certify` is a NumPy copy, so on the same inputs its `CertificateReport`
equals the reference's field by field, bit for bit; the inputs come from
the reference's own `_legacy_run` with the exact LP, and from the port's
`Pipeline.run` (bit-identical to it) for the end-to-end case.  Tolerance:
none.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import lp as ref_lp
from repro.core import theory as ref_theory
from repro.core.lower_bounds import prefix_port_stats as ref_prefix_port_stats
from repro.core.scheduler import _legacy_run
from repro.traffic.instances import random_instance, sample_instance
from repro_torch.convert import from_reference
from repro_torch.core import theory
from repro_torch.core.lower_bounds import prefix_port_stats
from repro_torch.pipeline import get_pipeline

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

CASES = {
    "zero_K3": lambda: random_instance(num_coflows=10, num_ports=5, num_cores=3, seed=0),
    "release_K4": lambda: random_instance(num_coflows=10, num_ports=5, num_cores=4, seed=1, release_span=50.0),
    "K1": lambda: random_instance(num_coflows=8, num_ports=4, num_cores=1, seed=11),
    "trace": lambda: sample_instance(num_ports=6, num_coflows=14, seed=3, release="trace"),
    "delta0": lambda: random_instance(num_coflows=7, num_ports=4, num_cores=2, seed=5, delta=0.0),
}


def _fields(rep):
    return dataclasses.astuple(rep)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, make in CASES.items():
        ref = make()
        sol = ref_lp.solve_exact(ref)
        out[name] = (ref, sol, {
            d: _legacy_run(ref, "ours", lp_solution=sol, discipline=d)
            for d in ("greedy", "reserving")
        })
    return out


@pytest.mark.parametrize("discipline", ["greedy", "reserving"])
@pytest.mark.parametrize("case", list(CASES))
def test_certify_equals_reference(runs, case, discipline):
    ref, sol, res = runs[case]
    r = res[discipline]
    want = ref_theory.certify(ref, r.order, sol.completion, r.allocation, r.ccts)
    got = theory.certify(
        from_reference(ref, "cpu"), r.order.copy(), sol.completion.copy(),
        from_reference(r.allocation, "cpu"), r.ccts.copy(),
    )
    assert type(got).__name__ == "CertificateReport"
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert np.array(_fields(got)).tobytes() == np.array(_fields(want)).tobytes()
    assert got.ok() == want.ok() and got.lemma5_ok() == want.lemma5_ok()
    if discipline == "reserving":
        assert got.ok(), got


@pytest.mark.parametrize("case", ["zero_K3", "trace"])
def test_certify_of_port_run_equals_reference(runs, case):
    """End to end: the port's run (exact LP solved inside it) certified by
    the port equals the reference's certificate of `_legacy_run`."""
    ref, sol, res = runs[case]
    inst = from_reference(ref, "cpu")
    mine = get_pipeline("ours", discipline="reserving").run(inst, device="cpu")
    got = theory.certify(inst, mine.order, mine.lp.completion, mine.allocation, mine.ccts)
    r = res["reserving"]
    want = ref_theory.certify(ref, r.order, sol.completion, r.allocation, r.ccts)
    assert np.array(_fields(got)).tobytes() == np.array(_fields(want)).tobytes()


@pytest.mark.parametrize("case", list(CASES))
def test_prefix_stats_and_per_core_bound_equal_reference(runs, case):
    ref, sol, res = runs[case]
    r = res["greedy"]
    inst = from_reference(ref, "cpu")
    for a, b in zip(prefix_port_stats(inst, r.order), ref_prefix_port_stats(ref, r.order)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    got = theory._per_core_prefix_lb(inst, from_reference(r.allocation, "cpu"), r.order)
    want = ref_theory._per_core_prefix_lb(ref, r.allocation, r.order)
    assert got.tobytes() == want.tobytes()


def test_report_checks():
    rep = theory.CertificateReport(0.0, 0.0, 0.0, 1.0, 3.0, 0.0, 2.0, 25.0)
    assert rep.ok() and not rep.lemma5_ok()
    assert not dataclasses.replace(rep, approx_ratio=26.0).ok()
    assert not dataclasses.replace(rep, lemma2_violation=1e-3).ok()
    assert rep.ok(tol=1e-6) and dataclasses.replace(rep, lemma4_violation=5e-7).ok()
