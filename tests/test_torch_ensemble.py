"""The port's `EnsembleBatch` against the JAX package's packing.

LP arrays must equal `repro.core.lp.pack_lp_arrays` exactly (the port's
`port_stats` twin sums in NumPy's order, and the warm start comes from the
same f64 global lower bounds), and the canonical flow table must hold
`repro.core.coflow.flow_table`'s flows, largest-first within each coflow
as `flows_of` lists them.  Tolerance: none.
"""

import numpy as np
import pytest
import torch

from repro.core import coflow as ref_coflow
from repro.core import lp as ref_lp
from repro.core.coflow import flow_table, flows_of
from repro.traffic.instances import random_instance
from repro_torch.convert import from_reference
from repro_torch.core import coflow as port_coflow
from repro_torch.core import lp as port_lp
from repro_torch.experiments import bucket_shape, build_buckets
from repro_torch.pipeline.ensemble_batch import PAD_LB, build_ensemble_batch

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

SHAPES = [(5, 3, 2), (8, 4, 3), (12, 6, 1), (3, 2, 3)]


def _ensemble(seed, release_span=0.0):
    return [
        random_instance(num_coflows=m, num_ports=n, num_cores=k, seed=seed * 10 + i,
                        release_span=release_span * (i % 2))
        for i, (m, n, k) in enumerate(SHAPES)
    ]


@pytest.mark.parametrize("seed,span", [(0, 0.0), (1, 20.0), (2, 5.0)])
def test_lp_arrays_equal_reference(seed, span):
    refs = _ensemble(seed, span)
    insts = [from_reference(r, "cpu") for r in refs]
    want = ref_lp.pack_lp_arrays(refs, pad_coflows=16, pad_ports=16)
    got = port_lp.pack_lp_arrays(insts, pad_coflows=16, pad_ports=16, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype, k
        assert np.array_equal(got[k].numpy(), want[k]), k
    # The ensemble batch pads to the ensemble maxima.
    want = ref_lp.pack_lp_arrays(refs)
    ens = build_ensemble_batch(insts, device="cpu")
    for k, v in ens.lp_arrays().items():
        assert np.array_equal(v.numpy(), want[k]), k
    glb = np.zeros((4, 12))
    for b, inst in enumerate(refs):
        glb[b, : inst.num_coflows] = inst.global_lower_bound()
    assert ens.glb.numpy().tobytes() == glb.tobytes()


@pytest.mark.parametrize("seed", [3, 8])
def test_host_coflow_copies_equal_reference(seed):
    """The port's NumPy copies of `port_stats`, `flows_of` and `flow_table`
    give the reference's arrays, bit for bit."""
    for ref in _ensemble(seed):
        inst = from_reference(ref, "cpu")
        for a, b in zip(port_coflow.port_stats(inst.demands), ref_coflow.port_stats(ref.demands)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        got, want = port_coflow.flow_table(inst), flow_table(ref)
        for f in ("coflow", "src", "dst", "size"):
            x, y = getattr(got, f), getattr(want, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
        for m in range(inst.num_coflows):
            for x, y in zip(port_coflow.flows_of(inst.demands[m]), flows_of(ref.demands[m])):
                assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("seed", [0, 4])
def test_flow_table_matches_reference(seed):
    refs = _ensemble(seed)
    ens = build_ensemble_batch([from_reference(r, "cpu") for r in refs], device="cpu")
    for b, inst in enumerate(refs):
        F = ens.num_flows[b]
        ft = flow_table(inst)
        assert F == len(ft)
        co = ens.flow_coflow[b, :F].numpy()
        src = ens.flow_src[b, :F].numpy()
        dst = ens.flow_dst[b, :F].numpy()
        size = ens.flow_size[b, :F].numpy()
        # Same flows as flow_table ...
        key = np.lexsort((dst, src, co))
        assert np.array_equal(co[key], ft.coflow)
        assert np.array_equal(src[key], ft.src) and np.array_equal(dst[key], ft.dst)
        assert size[key].tobytes() == ft.size.tobytes()
        # ... in the canonical order: coflow ascending, largest-first.
        for m in range(inst.num_coflows):
            i, j, d = flows_of(inst.demands[m], largest_first=True)
            sel = co == m
            assert np.array_equal(src[sel], i) and np.array_equal(dst[sel], j)
            assert np.array_equal(size[sel], d)
        assert np.array_equal(ens.flow_pj[b, :F].numpy(), inst.num_ports + dst)
        assert ens.flow_valid[b].sum() == F
        assert np.array_equal(
            ens.flow_counts[b, : inst.num_coflows].numpy(), np.bincount(co, minlength=inst.num_coflows)
        )


def test_permute_flows_and_prefix_ends_follow_order():
    refs = _ensemble(5)
    ens = build_ensemble_batch([from_reference(r, "cpu") for r in refs], device="cpu")
    orders = [np.random.default_rng(b).permutation(r.num_coflows) for b, r in enumerate(refs)]
    padded = ens.pad_orders(orders)
    perm = ens.permute_flows(padded)
    ends = ens.prefix_ends(padded).numpy()
    for b, (inst, order) in enumerate(zip(refs, orders)):
        F = ens.num_flows[b]
        co = torch.gather(ens.flow_coflow, 1, perm)[b, :F].numpy()
        size = torch.gather(ens.flow_size, 1, perm)[b, :F].numpy()
        want_co = np.concatenate([np.full(len(flows_of(inst.demands[m])[2]), m) for m in order])
        want_size = np.concatenate([flows_of(inst.demands[m])[2] for m in order])
        assert np.array_equal(co, want_co) and np.array_equal(size, want_size)
        counts = np.array([len(flows_of(inst.demands[m])[2]) for m in order])
        assert np.array_equal(ends[b, : inst.num_coflows], np.cumsum(counts))


def test_buckets_group_by_quantized_shape():
    insts = [from_reference(r, "cpu") for r in _ensemble(6)]
    assert [bucket_shape(i) for i in insts] == [(8, 8), (8, 8), (16, 16), (8, 8)]
    buckets = build_buckets(insts)
    assert [(b.num_coflows, b.num_flat_ports, b.indices) for b in buckets] == [
        (8, 8, (0, 1, 3)), (16, 16, (2,))
    ]
    assert build_buckets([]) == []


def test_masks_and_per_core_arrays_follow_sizes():
    insts = [from_reference(r, "cpu") for r in _ensemble(7)]
    ens = build_ensemble_batch(insts, device="cpu")
    assert ens.lp_Y0.shape == (4, 12, 12) and ens.flow_size.dtype == torch.float64
    assert ens.core_mask.sum(dim=1).tolist() == [k for _, _, k in SHAPES]
    for b, inst in enumerate(insts):
        K = inst.num_cores
        assert ens.rates[b, :K].numpy().tobytes() == inst.rates.tobytes()
        assert (ens.inv_rates[b, K:] == PAD_LB).all()
    assert ens.coflow_mask.sum(dim=1).tolist() == [m for m, _, _ in SHAPES]
    assert ens.port_mask.sum(dim=1).tolist() == [2 * n for _, n, _ in SHAPES]
