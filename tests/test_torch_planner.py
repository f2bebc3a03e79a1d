"""The port's collective planner against the reference's.

* `buckets_from_params` on the same tree (NumPy leaves in nested dicts and
  lists, and the port's own per-layer gemma3 tree) equals the reference's
  bucket for bucket: name, bytes and ``layer_frac``.  Tensors on the
  ``meta`` device serve as shapes.
* `_ring_demand` and `_a2a_demand` equal the reference's.
* `plan(device="cpu")` gives every `CollectivePlan` field bit for bit
  (order, plane_of_flow, both CCTs, both totals, chosen, the instance's
  arrays) against the reference's own `plan`, compiled from its source
  with its one pipeline call served by the reference's importable parts:
  `_legacy_run(inst, "ours", lp_solution=...)` (after the reference's
  `refine_sequential` over `evaluate_order` when ``refine`` is on).
  `repro.pipeline` does not import under the installed JAX, and nothing
  in the JAX package changes.  The cases are the reference's three
  (`tests/test_planner.py`) plus one with ``refine=True``.
* ``train --plan-collectives`` on a reduced gemma3 on the CPU plans what
  `plan(buckets_from_params(params, 16 MB))` plans on the trainer's
  initial parameters.  (It buckets the port's per-layer tree, where the
  reference buckets its stacked tree: a known divergence.)
* On the card (``cuda`` marker): the plan equals the host's.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro.collectives import planner as ref_planner
from repro.core import localsearch as ref_ls
from repro.core.scheduler import _legacy_run, _run_circuit_scheme
from repro_torch import tree
from repro_torch.collectives import planner
from repro_torch.collectives.planner import GradientBucket
from repro_torch.pipeline import RefineSpec

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _compile_reference(relpath, names, ns, drop_import=None):
    """The reference's own definitions of ``names`` from ``relpath``,
    compiled into ``ns``; imports from ``drop_import`` inside them are
    removed (``ns`` serves those names instead)."""
    path = ROOT / "src" / "repro" / relpath
    src_tree = ast.parse(path.read_text(), filename=str(path))
    defs = [n for n in src_tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {d.name for d in defs} == set(names)

    class Drop(ast.NodeTransformer):
        def visit_ImportFrom(self, node):
            return None if node.module == drop_import else node

    future = ast.ImportFrom(module="__future__", names=[ast.alias(name="annotations")], level=0)
    module = Drop().visit(ast.Module(body=[future] + defs, type_ignores=[]))
    exec(compile(ast.fix_missing_locations(module), str(path), "exec"), ns)
    return ns


REF_REFINE = _compile_reference(
    "pipeline/refine.py",
    ["_order_crossover", "generate_candidates", "_update_elites", "refine_sequential"],
    {"np": np, "select_candidate": ref_ls.select_candidate,
     "as_refine_spec": lambda spec: RefineSpec() if spec is True else spec},
)


class _ReferenceOurs:
    """``get_pipeline("ours")`` for the reference's `plan`, from its
    importable parts: the exact LP's order (refined by the reference's
    `refine_sequential` over `evaluate_order` when asked), then
    `_run_circuit_scheme`, as `_legacy_run` runs ``ours``."""

    def run_batch(self, insts, lp_solutions, refine=None):
        (inst,), (sol,) = insts, lp_solutions
        if not refine:
            return [_legacy_run(inst, "ours", lp_solution=sol)]
        order, *_ = REF_REFINE["refine_sequential"](
            sol.order(), refine, lambda o: ref_ls.evaluate_order(inst, o, "greedy"))
        return [_run_circuit_scheme(inst, "OURS", order, sol, discipline="greedy")]


REF_PLAN = _compile_reference(
    "collectives/planner.py", ["plan"],
    dict(vars(ref_planner), get_pipeline=lambda scheme: _ReferenceOurs()),
    drop_import="repro.pipeline",
)["plan"]


def _tree(rng):
    return {
        "embed": rng.standard_normal((7, 5)),
        "layers": [
            {"attn": {"q": np.zeros((5, 8)), "k": np.zeros((5, 4))}, "norm": np.ones(5)},
            {"attn": {"q": np.zeros((5, 8)), "k": np.zeros((5, 4))}, "norm": np.ones(5)},
        ],
        "head": np.zeros((5, 7)),
        "bias": [np.zeros(3), [np.zeros((2, 2, 2))]],
    }


def _same_buckets(a, b):
    assert [(x.name, x.bytes, x.layer_frac) for x in a] == [
        (y.name, y.bytes, y.layer_frac) for y in b]


@pytest.mark.parametrize("bucket_bytes,dtype_bytes", [(64, 2), (200, 4), (1, 2), (1 << 20, 2)])
def test_buckets_from_params_equal_reference(bucket_bytes, dtype_bytes):
    params = _tree(np.random.default_rng(0))
    got = planner.buckets_from_params(params, bucket_bytes, dtype_bytes)
    _same_buckets(got, ref_planner.buckets_from_params(params, bucket_bytes, dtype_bytes))
    meta = tree.map_leaves(lambda a: torch.empty(a.shape, device="meta"), params)
    _same_buckets(planner.buckets_from_params(meta, bucket_bytes, dtype_bytes), got)


def test_buckets_of_the_port_tree_equal_reference():
    """The port's per-layer gemma3 tree, as tensors, buckets as the
    reference buckets the same tree as NumPy arrays."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model

    params = build_model(get_arch("gemma3-1b").reduced(), "cpu").init(
        torch.Generator().manual_seed(0), masters=True)
    as_np = tree.map_leaves(lambda t: t.numpy(), params)
    for bucket_bytes in (64 << 10, 16 << 20):
        got = planner.buckets_from_params(params, bucket_bytes)
        _same_buckets(got, ref_planner.buckets_from_params(as_np, bucket_bytes))
        assert sum(b.bytes for b in got) == 2 * sum(t.numel() for t in tree.leaves(params))


@pytest.mark.parametrize("pods", [2, 3, 4, 8])
def test_demands_equal_reference(pods):
    for nbytes in (100.0, 7.5e6):
        for fn in ("_ring_demand", "_a2a_demand"):
            got = getattr(planner, fn)(pods, nbytes)
            assert got.tobytes() == getattr(ref_planner, fn)(pods, nbytes).tobytes()


def _reference_cases():
    return {
        "fifo_vs_ours": (
            [GradientBucket(f"b{i}", (8 + 24 * (i % 3)) << 20, i / 11) for i in range(12)],
            dict(num_pods=4, plane_rates_gbps=(25.0, 50.0, 100.0)),
        ),
        "a2a": (
            [GradientBucket(f"b{i}", 32 << 20, i / 3) for i in range(4)],
            dict(num_pods=4, a2a_buckets=[GradientBucket(f"a2a{i}", 16 << 20, i / 3)
                                          for i in range(2)]),
        ),
        "releases": (
            [GradientBucket(f"b{i}", 64 << 20, i / 4) for i in range(5)],
            dict(num_pods=2, backward_ms=50.0),
        ),
        "refined": (
            [GradientBucket(f"b{i}", (8 + 24 * (i % 3)) << 20, i / 11) for i in range(12)],
            dict(num_pods=4, plane_rates_gbps=(25.0, 50.0, 100.0), refine=True),
        ),
    }


def _to_reference_buckets(buckets):
    return [ref_planner.GradientBucket(b.name, b.bytes, b.layer_frac) for b in buckets]


def _assert_same_plan(got, want):
    assert got.order == want.order
    assert got.plane_of_flow == want.plane_of_flow
    for f in ("cct_ours", "cct_fifo", "total_weighted_ours", "total_weighted_fifo", "chosen"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.speedup == want.speedup and got.chosen_weighted == want.chosen_weighted
    for f in ("demands", "weights", "releases", "rates"):
        assert getattr(got.instance, f).tobytes() == getattr(want.instance, f).tobytes(), f
    assert got.instance.delta == want.instance.delta


@pytest.mark.parametrize("case", list(_reference_cases()))
def test_plan_equals_reference(case):
    buckets, kw = _reference_cases()[case]
    got = planner.plan(buckets, device="cpu", **kw)
    ref_kw = {k: (_to_reference_buckets(v) if k == "a2a_buckets" else v) for k, v in kw.items()}
    want = REF_PLAN(_to_reference_buckets(buckets), **ref_kw)
    _assert_same_plan(got, want)
    # The reference's own checks of these cases.
    n_flows = sum(len(v) for v in got.plane_of_flow.values())
    assert n_flows == int((got.instance.demands > 0).sum())
    assert got.chosen_weighted <= got.total_weighted_fifo
    names = {b.name for b in buckets} | {b.name for b in kw.get("a2a_buckets", [])}
    assert set(got.order) == names


def test_refined_plan_never_worse():
    buckets, kw = _reference_cases()["fifo_vs_ours"]
    base = planner.plan(buckets, device="cpu", **kw)
    refined = planner.plan(buckets, device="cpu", refine=RefineSpec(rounds=3), **kw)
    assert refined.total_weighted_ours <= base.total_weighted_ours


def test_train_plan_collectives_on_the_host(capsys):
    from repro_torch.launch import train

    argv = ["--arch", "gemma3-1b", "--steps", "1", "--batch", "2", "--seq", "16",
            "--layers", "2", "--plan-collectives", "--device", "cpu"]
    res = train.main(argv)
    out = capsys.readouterr().out
    params = train.build_model(train.config_for("gemma3-1b", layers=2), "cpu").init(
        torch.Generator().manual_seed(0), masters=True)
    buckets = planner.buckets_from_params(params, bucket_bytes=16 << 20)
    want = planner.plan(buckets, num_pods=2, device="cpu")
    _assert_same_plan(res.plan, want)
    assert f"[planner] {len(buckets)} gradient buckets -> CCT ours" in out
    assert set(res.plan.order) == {b.name for b in buckets}
    assert len(res.losses) == 1 and np.isfinite(res.losses).all()
    assert train.main(argv[:-3] + ["--device", "cpu"]).plan is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_reference_cases()))
def test_plan_card_equals_host(cuda, case):
    buckets, kw = _reference_cases()[case]
    _assert_same_plan(planner.plan(buckets, device=cuda, **kw),
                      planner.plan(buckets, device="cpu", **kw))
