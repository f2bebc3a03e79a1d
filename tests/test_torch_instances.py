"""The port's instance sampler and trace parser against the JAX package's.

`repro_torch.traffic` is a NumPy copy of `repro.traffic`: the same seeds
must give byte-identical instances (tolerance: none).
"""

import pathlib

import numpy as np
import pytest

from repro.traffic import facebook as ref_fb
from repro.traffic import instances as ref_inst
from repro_torch.traffic import facebook as port_fb
from repro_torch.traffic import instances as port_inst

FIXTURE = pathlib.Path(__file__).parent / "data" / "tiny.fbt"
FIELDS = ("demands", "weights", "releases", "rates")


def _assert_same_instance(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert a.delta == b.delta


@pytest.mark.parametrize("release", ["zero", "trace"])
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_sample_instance_byte_identical(seed, release):
    kw = dict(num_ports=6, num_coflows=12, seed=seed, release=release)
    _assert_same_instance(
        port_inst.sample_instance(**kw), ref_inst.sample_instance(**kw)
    )


def test_paper_default_instance_byte_identical():
    _assert_same_instance(
        port_inst.paper_default_instance(3), ref_inst.paper_default_instance(3)
    )


@pytest.mark.parametrize("seed", [0, 4])
def test_trace_file_instances_byte_identical(seed):
    kw = dict(
        num_ports=8, num_coflows=3, rates=(10.0, 20.0), seed=seed,
        trace_path=str(FIXTURE), release="trace",
    )
    _assert_same_instance(
        port_inst.sample_instance(**kw), ref_inst.sample_instance(**kw)
    )


def test_fbt_parser_and_demands_match():
    ref = ref_fb.load_fbt(str(FIXTURE))
    got = port_fb.load_fbt(str(FIXTURE))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.coflow_id == b.coflow_id and a.arrival_ms == b.arrival_ms
        for f in ("mappers", "reducers", "reducer_mb"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    port_map = {m: m for m in range(10)}
    d_ref = ref_fb.to_demands(ref, port_map, 10, np.random.default_rng(0))
    d_got = port_fb.to_demands(got, port_map, 10, np.random.default_rng(0))
    assert d_got.tobytes() == d_ref.tobytes()


def test_synthetic_trace_matches():
    ref = ref_fb.synthesize_facebook_like(num_coflows=20, num_machines=12, seed=4)
    got = port_fb.synthesize_facebook_like(num_coflows=20, num_machines=12, seed=4)
    for a, b in zip(got, ref):
        assert a.arrival_ms == b.arrival_ms
        for f in ("mappers", "reducers", "reducer_mb"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
