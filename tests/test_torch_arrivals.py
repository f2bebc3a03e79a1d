"""The port's arrival generators and instance samplers against the
reference's (`repro.traffic`, which imports under the installed JAX).

The same seeds must give the same arrays, byte for byte: every arrival
process (`poisson_arrivals`, `onoff_arrivals`, `diurnal_arrivals`,
`periodic_waves`) over sizes and parameters, `with_releases`, and the
samplers the streaming tests build their instances with
(`random_instance`, `scaled_trace_instance`).  Tolerance: none.
"""

import numpy as np
import pytest
import torch

from repro import traffic as ref
from repro.traffic import instances as ref_instances
from repro_torch import traffic as port

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

# (generator, keyword arguments)
ARRIVALS = [
    ("poisson_arrivals", {}),
    ("poisson_arrivals", {"mean_interarrival_ms": 4.0}),
    ("onoff_arrivals", {}),
    ("onoff_arrivals", {"mean_on_ms": 50.0, "mean_off_ms": 10.0,
                        "mean_interarrival_on_ms": 3.0}),
    ("diurnal_arrivals", {}),
    ("diurnal_arrivals", {"period_ms": 500.0, "depth": 0.3}),
    ("periodic_waves", {}),
    ("periodic_waves", {"wave_size": 3, "jitter_ms": 0.0}),
]


@pytest.mark.parametrize("num", [0, 1, 17, 200])
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name,kw", ARRIVALS, ids=lambda x: str(x))
def test_arrivals_equal_reference(name, kw, num, seed):
    got = getattr(port, name)(num, seed=seed, **kw)
    want = getattr(ref, name)(num, seed=seed, **kw)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name,kw", [
    ("diurnal_arrivals", {"depth": 1.0}),
    ("periodic_waves", {"wave_size": 0}),
])
def test_arrivals_refuse_what_the_reference_refuses(name, kw):
    for mod in (ref, port):
        with pytest.raises(ValueError):
            getattr(mod, name)(4, **kw)


def test_with_releases_equals_reference():
    inst = port.random_instance(num_coflows=6, num_ports=3, seed=2)
    arr = port.poisson_arrivals(6, mean_interarrival_ms=3.0, seed=1)
    got = port.with_releases(inst, arr[::-1])
    want = ref.with_releases(ref_instances.random_instance(num_coflows=6, num_ports=3, seed=2),
                             arr[::-1])
    assert got.releases.tobytes() == want.releases.tobytes()
    assert got.demands.tobytes() == want.demands.tobytes()
    with pytest.raises(ValueError):
        port.with_releases(inst, arr[:5])


@pytest.mark.parametrize("kw", [
    {},
    {"num_coflows": 9, "num_ports": 5, "num_cores": 4, "release_span": 30.0},
    {"num_coflows": 3, "num_ports": 2, "num_cores": 1, "density": 0.05, "seed": 7},
    {"num_coflows": 8, "num_ports": 4, "heterogeneous": False, "seed": 3},
])
def test_random_instance_equals_reference(kw):
    got = port.random_instance(**kw)
    want = ref_instances.random_instance(**kw)
    for f in ("demands", "weights", "releases", "rates"):
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f
    assert got.delta == want.delta


@pytest.mark.parametrize("kw", [
    {"num_coflows": 20, "num_ports": 8},
    {"num_coflows": 12, "num_ports": 6, "rates": (10.0, 20.0, 30.0, 40.0), "release": "zero",
     "seed": 3},
    {"num_coflows": 16, "num_ports": 10, "mean_interarrival_ms": 250.0, "seed": 1},
])
def test_scaled_trace_instance_equals_reference(kw):
    got = port.scaled_trace_instance(**kw)
    want = ref_instances.scaled_trace_instance(**kw)
    for f in ("demands", "weights", "releases", "rates"):
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f
    with pytest.raises(ValueError):
        port.scaled_trace_instance(4, 4, release="never")
