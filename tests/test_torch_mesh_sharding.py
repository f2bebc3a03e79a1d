"""The ensemble sharded over a mesh's ``data`` axis, the int8 exchange
across ranks and restore onto a mesh, on the host.

The reference checks its sharding on forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``) against its
single-device run, bit for bit.  The port's counterpart is a `Mesh` that
lists ``cpu`` several times (`host_mesh`): every sharded stage runs a
shard a device, and here every shard is the host.

* `place` / `gather` / `NamedSharding` on 1-, 2-, 3-, 4- and 8-shard host
  meshes; a mesh naming a card the host lacks raises.
* The kernel launch helper makes the operands' card the current device
  (a stand-in library and a recording device context).
* `pack_lp_arrays(pad_members=)` equals the reference's bit for bit.
* Sharded against single, bit for bit, on 2, 3, 4 and 8 shards:
  `solve_ensemble_lp` (buckets of 3 and 2, as the reference's test),
  `build_ensemble_batch` and `expand_members`, `run_batch` of every
  `PAPER_SCHEMES` entry under the exact LP against the reference's
  `_legacy_run` (under the ``kernel``, ``jax`` and ``wide`` calendars)
  and ``ours_ls`` against the unsharded run, `build_slot_pool_batch`
  with `update_slots`, and a `sweep` whose JSON and CSV rows are
  byte-identical.  `run_batch` with a stage cache built under another
  mesh raises.
* `Checkpointer.restore(shardings=)` onto 1-, 2- and 3-shard meshes, and
  the reference's reshard case.
* `compressed_allreduce(axis_name="data")` over two spawned gloo ranks
  equals the reference's `compress_tree` per rank, an int8 wrapping sum
  of the codes and `decompress_tree` on the flat triples, with a leaf
  whose sum wraps; with no process group it raises.

Tolerance: none anywhere.
"""

import contextlib
import multiprocessing
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lp as ref_lp
from repro.core.scheduler import _legacy_run
from repro.runtime import compression as ref_comp
from repro.traffic.instances import random_instance
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.convert import from_reference
from repro_torch.core import lp as port_lp
from repro_torch.experiments import build_buckets, solve_ensemble_lp, sweep
from repro_torch.kernels import common
from repro_torch.kernels import quant as qt
from repro_torch.launch.mesh import (
    Mesh,
    NamedSharding,
    Sharded,
    data_sharding,
    drive,
    gather,
    place,
)
from repro_torch.pipeline import PAPER_SCHEMES, get_pipeline
from repro_torch.pipeline import ensemble_batch as eb
from repro_torch.runtime import compression as comp

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
SHARDS = (2, 3, 4, 8)
LP_ITERS = 60


def host_mesh(n: int) -> Mesh:
    """The host listed ``n`` times on ``data``: the port's forced host
    devices."""
    return Mesh(("data", "model"), (n, 1), (CPU,) * n)


def _same(a, b, what=""):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def _refs():
    """The reference test's ensemble: buckets of 3 and 2 under quantum 8,
    neither a divisor of most shard counts."""
    return [random_instance(num_coflows=8, num_ports=4, seed=s) for s in range(3)] + [
        random_instance(num_coflows=10, num_ports=3, seed=9 + s) for s in range(2)
    ]


@pytest.fixture(scope="module")
def ensemble():
    refs = _refs()
    sols = [ref_lp.solve_exact(r) for r in refs]
    insts = [from_reference(r, "cpu") for r in refs]
    return refs, sols, insts, [from_reference(s, "cpu") for s in sols]


# ------------------------------------------------------------ placement
@pytest.mark.parametrize("n", (1, 2, 3, 4, 8))
def test_place_splits_rows_and_gathers(n):
    """Shard i holds rows [i Bp / n, (i + 1) Bp / n); the gather is the
    tensor; a replicated spec gives a plain tensor."""
    mesh = host_mesh(n)
    sh = data_sharding(mesh)
    assert sh == NamedSharding(mesh, ("data",)) and sh.num_shards == n
    x = torch.arange(24 * 5, dtype=torch.float64).reshape(24, 5)
    p = place(x, sh)
    if n == 1:
        assert isinstance(p, torch.Tensor)
        _same(p, x)
    else:
        assert isinstance(p, Sharded) and p.sharding == sh and p.shape == (24, 5)
        rows = 24 // n
        for i, s in enumerate(p.shards):
            _same(s, x[i * rows:(i + 1) * rows])
            assert s.data_ptr() != x.data_ptr()  # each shard its own copy
        _same(gather(p), x)
    rep = place(x, NamedSharding(mesh, ()))
    assert isinstance(rep, torch.Tensor)
    _same(rep, x)
    assert sh != data_sharding(host_mesh(n + 1))


def test_place_refuses_what_does_not_split():
    with pytest.raises(ValueError, match="does not split"):
        place(torch.zeros(5), data_sharding(host_mesh(2)))
    with pytest.raises(ValueError, match="no such axis"):
        NamedSharding(host_mesh(2), ("pod",))
    with pytest.raises(ValueError, match="once"):
        NamedSharding(host_mesh(2), ("data", "data"))
    with pytest.raises(ValueError, match="no devices"):
        data_sharding(Mesh(("data", "model"), (16, 16))).devices()


def test_a_card_mesh_without_a_card_raises(monkeypatch):
    """No fallback: a mesh naming ``cuda`` devices raises on a host with
    no card, at placement and at the build."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = Mesh(("data", "model"), (2, 1), (torch.device("cuda", 0),) * 2)
    inst = from_reference(random_instance(num_coflows=3, num_ports=2, seed=0), "cpu")
    for call in (
        lambda: place(torch.zeros(4), data_sharding(mesh)),
        lambda: eb.build_ensemble_batch([inst], "cpu", mesh=mesh),
        lambda: solve_ensemble_lp([inst], iters=2, device="cpu", mesh=mesh),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_drive_runs_every_generator_in_turns():
    trace = []

    def steps(i, n):
        for k in range(n):
            trace.append((i, k))
            yield
        return i * 10

    assert drive([steps(0, 2), steps(1, 3), steps(2, 0)]) == [0, 10, 20]
    assert trace == [(0, 0), (1, 0), (0, 1), (1, 1), (1, 2)]


# ------------------------------------------------------- launch device
def test_launch_makes_the_operands_card_current(monkeypatch):
    """The C side launches on the current device: `launch` enters the
    operands' card first (a stand-in library records the device current
    during the call), and every kernel wrapper passes its operand's."""
    entered, seen = [], []

    class FakeLib:
        def fake_entry(self, *args):
            seen.append((list(entered), args))
            return 0

    @contextlib.contextmanager
    def device_ctx(dev):
        entered.append(dev)
        try:
            yield
        finally:
            entered.pop()

    monkeypatch.setattr(common, "library", lambda: FakeLib())
    monkeypatch.setattr(common.torch.cuda, "device", device_ctx)
    common.launch("fake_entry", 1, 2, device=torch.device("cuda", 3))
    assert seen == [([torch.device("cuda", 3)], (1, 2))]
    with pytest.raises(TypeError):
        common.launch("fake_entry", 1)  # the device is not optional
    import ast
    import pathlib

    kernels = pathlib.Path(common.__file__).parent
    calls = 0
    for path in kernels.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "launch":
                calls += 1
                assert any(k.arg == "device" for k in node.keywords), (path.name, node.lineno)
    assert calls >= 10


# ------------------------------------------------------------------- LP
@pytest.mark.parametrize("pad_members", (None, 5, 6, 8, 16))
def test_pack_lp_arrays_pad_members_equals_reference(pad_members):
    refs = _refs()
    want = ref_lp.pack_lp_arrays(refs, pad_coflows=16, pad_ports=8, pad_members=pad_members)
    got = port_lp.pack_lp_arrays(
        [from_reference(r, "cpu") for r in refs], pad_coflows=16, pad_ports=8,
        pad_members=pad_members, device="cpu",
    )
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k], k)


@pytest.mark.parametrize("n", SHARDS)
def test_solve_ensemble_lp_sharded_bit_identical(ensemble, n):
    refs, _, insts, _ = ensemble
    assert sorted(len(b) for b in build_buckets(insts)) == [2, 3]
    single = solve_ensemble_lp(insts, iters=LP_ITERS, device="cpu")
    sharded = solve_ensemble_lp(insts, iters=LP_ITERS, device="cpu", mesh=host_mesh(n))
    for a, b in zip(single, sharded):
        assert a.objective == b.objective
        _same(a.completion, b.completion)
        _same(a.precedence, b.precedence)


def test_sharded_batch_solve_keeps_its_shards(ensemble):
    """`solve_subgradient_batch_arrays(sharding=)` leaves `Sharded`
    fields; `device_gather` brings them to the host."""
    from repro_torch.experiments.results import device_gather

    _, _, insts, _ = ensemble
    arrays = port_lp.pack_lp_arrays(insts[:3], pad_members=4, device="cpu")
    mesh = host_mesh(2)
    batch = port_lp.solve_subgradient_batch_arrays(arrays, iters=5, sharding=data_sharding(mesh))
    assert isinstance(batch.completion, Sharded) and batch.completion.shape[0] == 4
    host = device_gather(batch)
    assert isinstance(host.completion, np.ndarray) and host.method == batch.method
    single = port_lp.solve_subgradient_batch_arrays(arrays, iters=5)
    _same(host.completion, single.completion)
    _same(host.y, single.y)
    # Padded members stay all zero.
    assert not host.completion[3].any()
    orders = batch.order_batch(arrays["coflow_mask"])
    _same(orders, single.order_batch(arrays["coflow_mask"]))


@pytest.mark.parametrize("run", (4, 32))
def test_member_product_is_bmm_in_fixed_runs(monkeypatch, run):
    """`member_product` (the batched LP's smooth products on a card) in
    runs of `PRODUCT_MEMBERS`: equal to `torch.bmm` and its autograd
    gradient bit for bit, whatever the number of runs; other member
    counts refused."""
    monkeypatch.setattr(port_lp, "PRODUCT_MEMBERS", run)
    g = torch.Generator().manual_seed(1)
    a = torch.rand((2 * 32, 12, 12), generator=g).transpose(-1, -2)
    b = torch.rand((2 * 32, 12, 9), generator=g)
    w = torch.rand((2 * 32, 12, 9), generator=g)
    x = a.detach().requires_grad_(True)
    y = x.detach().requires_grad_(True)
    got = port_lp.member_product(x, b)
    want = torch.bmm(y, b)
    _same(got.detach(), want.detach())
    (gx,) = torch.autograd.grad((got * w).sum(), x)
    (gy,) = torch.autograd.grad((want * w).sum(), y)
    _same(gx, gy)
    for lo, hi in ((0, run), (run, 3 * run), (32, 64)):
        _same(port_lp.member_product(a[lo:hi], b[lo:hi]), want[lo:hi].detach(), (lo, hi))
    with pytest.raises(ValueError, match="not a multiple"):
        port_lp.member_product(a[: run + 1], b[: run + 1])


def test_batch_solve_in_fixed_runs_on_the_host(ensemble, monkeypatch):
    """The card's route of the batched solve (members padded to a multiple
    of `PRODUCT_MEMBERS`, products through `member_product`) taken on the
    host: the same bits as the host's own route, sharded or not."""
    _, _, insts, _ = ensemble
    plain = solve_ensemble_lp(insts, iters=LP_ITERS, device="cpu")
    monkeypatch.setattr(port_lp, "PRODUCT_MEMBERS", 4)
    monkeypatch.setattr(port_lp, "_fixed_runs", lambda t: True)
    for mesh in (None, host_mesh(3)):
        got = solve_ensemble_lp(insts, iters=LP_ITERS, device="cpu", mesh=mesh)
        for a, b in zip(plain, got):
            assert a.objective == b.objective
            _same(a.completion, b.completion)


# ------------------------------------------------------------ the build
@pytest.mark.parametrize("n", SHARDS)
def test_build_and_expand_sharded(ensemble, n):
    _, _, insts, _ = ensemble
    B = len(insts)
    single = eb.build_ensemble_batch(insts, "cpu")
    sharded = eb.build_ensemble_batch(insts, "cpu", mesh=host_mesh(n))
    Bp = sharded.pad_members
    assert Bp % n == 0 and Bp >= B and Bp - B < n
    assert sharded.sharding == data_sharding(host_mesh(n)) and single.sharding is None
    for name, t in sharded._tensor_fields().items():
        _same(t[:B], getattr(single, name), name)
    # Padding rows never claim a coflow, a flow, a port or a core.
    for name in ("coflow_mask", "port_mask", "flow_valid", "core_mask"):
        assert not getattr(sharded, name)[B:].any(), name
    assert not sharded.lp_weights[B:].any() and not sharded.inv_R[B:].any()
    parts = sharded.shards()
    assert len(parts) == n and sum(p.num_instances for p in parts) == B
    assert all(p.pad_members == Bp // n and p.sharding is None for p in parts)
    # The member expansion keeps the sharding and clones row Bp - 1.
    for reps in (1, 3, 4):
        exp, inst_of, cand_of = sharded.expand_members(reps)
        ref_exp, ref_inst, ref_cand = single.expand_members(reps)
        _same(inst_of, ref_inst)
        _same(cand_of, ref_cand)
        assert exp.sharding == sharded.sharding and exp.pad_members % n == 0
        assert exp.num_instances == B * reps
        for name, t in exp._tensor_fields().items():
            _same(t[:B * reps], getattr(ref_exp, name), name)
            for row in range(B * reps, exp.pad_members):
                _same(t[row], getattr(sharded, name)[Bp - 1], name)


# ------------------------------------------------------ the whole stage
def _assert_same_result(got, want, what):
    _same(got.order, want.order, what)
    for f in ("coflow", "src", "dst", "size", "core", "rho_ports", "tau_ports", "prefix_lb"):
        _same(getattr(got.allocation, f), getattr(want.allocation, f), (what, f))
    if want.core_schedules is None:
        assert got.core_schedules is None
    else:
        for a, b in zip(got.core_schedules, want.core_schedules):
            for f in ("coflow", "src", "dst", "size", "establish", "complete"):
                _same(getattr(a, f), getattr(b, f), (what, f))
    _same(got.ccts, want.ccts, what)
    assert got.total_weighted_cct == want.total_weighted_cct, what


@pytest.mark.parametrize("engine", ("kernel", "jax", "wide"))
@pytest.mark.parametrize("scheme", PAPER_SCHEMES)
def test_run_batch_sharded_equals_legacy_run(ensemble, scheme, engine):
    """Under injected exact LP solutions, each shard count's schedules
    equal the reference's per-instance oracle bit for bit."""
    refs, sols, insts, psols = ensemble
    wants = [_legacy_run(r, scheme, lp_solution=s, discipline="greedy")
             for r, s in zip(refs, sols)]
    for n in SHARDS:
        pipe = get_pipeline(scheme, circuit_engine=engine)
        got = pipe.run_batch(insts, psols, device="cpu", mesh=host_mesh(n))
        for b, (g, w) in enumerate(zip(got, wants)):
            _assert_same_result(g, w, (scheme, engine, n, b))


@pytest.mark.parametrize("engine", ("kernel", "jax", "wide"))
def test_ours_ls_sharded_equals_unsharded(ensemble, engine):
    """Refinement on the sharded member-expanded batch: the same orders,
    rounds and schedules as the unsharded search."""
    _, _, insts, psols = ensemble
    pipe = get_pipeline("ours_ls", circuit_engine=engine)
    single = pipe.run_batch(insts, psols, device="cpu", require_batch=True)
    for n in SHARDS:
        cache = {}
        got = pipe.run_batch(insts, psols, device="cpu", require_batch=True,
                             mesh=host_mesh(n), stage_cache=cache)
        outcome = next(v for k, v in cache.items() if isinstance(k, tuple) and k[0] == "refine")
        assert outcome.batched
        for b, (g, w) in enumerate(zip(got, single)):
            _assert_same_result(g, w, ("ours_ls", engine, n, b))


def test_reserving_calendar_sharded(ensemble):
    refs, sols, insts, psols = ensemble
    for engine in ("kernel", "jax"):
        pipe = get_pipeline("ours", discipline="reserving", circuit_engine=engine)
        got = pipe.run_batch(insts, psols, device="cpu", mesh=host_mesh(3))
        for r, s, g in zip(refs, sols, got):
            _assert_same_result(
                g, _legacy_run(r, "ours", lp_solution=s, discipline="reserving"), engine)


def test_stage_cache_under_another_mesh_raises(ensemble):
    _, _, insts, psols = ensemble
    cache = {}
    get_pipeline("ours").run_batch(insts, psols, device="cpu", mesh=host_mesh(2),
                                   stage_cache=cache)
    # mesh=None inherits the cached batch's sharding.
    get_pipeline("load_only").run_batch(insts, psols, device="cpu", stage_cache=cache)
    for other in (host_mesh(3), host_mesh(1)):
        with pytest.raises(ValueError, match="does not match the sharding"):
            get_pipeline("wspt_order").run_batch(insts, psols, device="cpu", mesh=other,
                                                 stage_cache=cache)
    unsharded = {}
    get_pipeline("ours").run_batch(insts, psols, device="cpu", stage_cache=unsharded)
    with pytest.raises(ValueError, match="does not match the sharding"):
        get_pipeline("ours").run_batch(insts, psols, device="cpu", mesh=host_mesh(2),
                                       stage_cache=unsharded)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", (3, 4))
def test_card_mesh_bit_identical(ensemble, cuda, n):
    """On a mesh of ``cuda:0`` listed ``n`` times: the batched LP (members
    padded for `member_product`) and every card calendar, bit for bit
    against the unsharded run on the card."""
    _, _, insts, psols = ensemble
    mesh = Mesh(("data", "model"), (n, 1), (torch.device("cuda", 0),) * n)
    single = solve_ensemble_lp(insts, iters=LP_ITERS)
    for a, b in zip(single, solve_ensemble_lp(insts, iters=LP_ITERS, mesh=mesh)):
        assert a.objective == b.objective
        _same(a.completion, b.completion)
    for engine in ("kernel", "jax"):
        pipe = get_pipeline("ours", circuit_engine=engine)
        want = pipe.run_batch(insts, psols)
        for b, (g, w) in enumerate(zip(pipe.run_batch(insts, psols, mesh=mesh), want)):
            _assert_same_result(g, w, (engine, n, b))


# ------------------------------------------------------------ slot pool
@pytest.mark.parametrize("n", SHARDS)
def test_slot_pool_sharded_matches_single(n):
    """The reference's sharded slot-pool case: the live member's rows
    equal the single-device pool's, padding rows stay masked."""
    insts = [random_instance(num_coflows=3, num_ports=5, num_cores=2, seed=s) for s in (0, 1)]
    rates = np.array([10.0, 20.0])

    def fill(pool):
        eb.update_slots(pool, np.array([0, 2, 4]), insts[0].demands,
                        insts[0].weights, insts[0].releases)
        eb.free_slots(pool, np.array([2]))
        eb.update_slots(pool, np.array([2, 3, 5]), insts[1].demands,
                        insts[1].weights, insts[1].releases)
        return pool

    single = fill(eb.build_slot_pool_batch(6, 5, rates, 1.5, flow_quantum=8, device="cpu"))
    sharded = fill(eb.build_slot_pool_batch(6, 5, rates, 1.5, flow_quantum=8, device="cpu",
                                            mesh=host_mesh(n)))
    assert sharded.batch.sharding is not None and sharded.batch.pad_members % n == 0
    for name, t in sharded.batch._tensor_fields().items():
        _same(t[0], getattr(single.batch, name)[0], name)
    assert not sharded.batch.coflow_mask[1:].any()
    assert not sharded.batch.flow_valid[1:].any()
    _same(single.flow_start, sharded.flow_start)
    _same(single.flow_cap, sharded.flow_cap)
    # The pool's batch schedules as the single pool's, shard by shard.
    pipe = get_pipeline("wspt_order", circuit_engine="kernel")
    a = [pipe.allocate_stage.allocate_batch_arrays(p.batch, pipe.order_stage.order_batch(p.batch))
         for p in (single, sharded)]
    for f in ("order", "perm", "coflow", "core", "prefix_lb"):
        _same(getattr(a[1], f)[:1], getattr(a[0], f), f)
    c = [pipe.circuit_stage.schedule_batch_arrays(p.batch, al) for p, al in zip((single, sharded), a)]
    _same(c[1][0][1], c[0][0][1])


# ----------------------------------------------------------------- sweep
def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_sweep_sharded_rows_byte_identical(ensemble, tmp_path, monkeypatch):
    """The reference's sharded-sweep case: the batch LP, every paper
    scheme, rows byte for byte across shard counts."""
    monkeypatch.setenv("REPRO_RESULTS", str(tmp_path))
    _, _, insts, _ = ensemble
    metas = [{"seed": i} for i in range(len(insts))]
    single = sweep(insts, lp_iters=LP_ITERS, metas=metas, device="cpu")
    j0, c0 = single.save("parity_single")
    for n in SHARDS:
        sharded = sweep(insts, lp_iters=LP_ITERS, metas=metas, device="cpu", mesh=host_mesh(n))
        for a, b in zip(single.records, sharded.records):
            assert a.lp.objective == b.lp.objective
            _same(a.lp.completion, b.lp.completion)
            for s in a.results:
                _same(a.results[s].ccts, b.results[s].ccts, s)
        j1, c1 = sharded.save(f"parity_sharded_{n}")
        assert _read(j0) == _read(j1), "JSON rows diverged"
        assert _read(c0) == _read(c1), "CSV rows diverged"


# --------------------------------------------------------------- restore
def _state():
    g = torch.Generator().manual_seed(3)
    return {"params": {"w": torch.randn((12, 5), generator=g),
                       "b": torch.randn((6,), generator=g, dtype=torch.float64)},
            "opt": {"m": [torch.randn((12, 5), generator=g)], "count": 7},
            "table": np.arange(6.0)}


@pytest.mark.parametrize("n", (1, 2, 3))
def test_restore_onto_a_mesh(tmp_path, n):
    ck = Checkpointer(str(tmp_path), async_save=False)
    state = _state()
    ck.save(4, state)
    mesh = host_mesh(n)
    sh = {"params": {"w": data_sharding(mesh), "b": NamedSharding(mesh, ())},
          "opt": {"m": [data_sharding(mesh)]}}
    got = ck.restore(4, like=state, shardings=sh)
    for leaf, ref in ((got["params"]["w"], state["params"]["w"]),
                      (got["opt"]["m"][0], state["opt"]["m"][0])):
        if n == 1:
            assert isinstance(leaf, torch.Tensor)
        else:
            assert isinstance(leaf, Sharded) and leaf.sharding == sh["params"]["w"]
            assert len(leaf.shards) == n
        _same(gather(leaf), ref)
    assert isinstance(got["params"]["b"], torch.Tensor)
    _same(got["params"]["b"], state["params"]["b"])
    assert got["opt"]["count"] == 7 and isinstance(got["opt"]["count"], int)
    _same(got["table"], state["table"])
    with pytest.raises(ValueError, match="not both"):
        ck.restore(4, like=state, device="cpu", shardings=sh)
    with pytest.raises(ValueError, match="does not split"):
        ck.restore(4, like=state, shardings={"params": {"b": data_sharding(host_mesh(4))}})


def test_checkpoint_reshard_restore(tmp_path):
    """The reference's case: a replicated `NamedSharding` on the local
    mesh; the leaf lands on the mesh's device, equal to the saved one."""
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh("cpu")
    ck = Checkpointer(str(tmp_path), async_save=False)
    state = {"w": torch.arange(8.0)}
    ck.save(1, state)
    sh = {"w": NamedSharding(mesh, ())}
    restored = ck.restore(1, like=state, shardings=sh)
    assert restored["w"].device == mesh.devices[0]
    _same(restored["w"], state["w"])


# ------------------------------------------------------------ the exchange
def test_exchange_without_a_process_group_raises():
    assert not torch.distributed.is_initialized()
    g = [torch.ones(4)]
    with pytest.raises(RuntimeError, match="no process group"):
        comp.compressed_allreduce(g, comp.init_error_feedback(g), torch.Generator(),
                                  axis_name="data")


def _rank_grads(rank):
    """Rank ``rank``'s leaves: a random one, and one whose largest codes
    are 127 on both ranks (so their int8 sum wraps)."""
    rng = np.random.default_rng(100 + rank)
    grads = [(rng.standard_normal((3, 700)) * 1e-2).astype(np.float32),
             np.linspace(-1.0, 1.0, 1024, dtype=np.float32) * (1.0 + rank)]
    errors = [(rng.standard_normal(g.shape) * 1e-4).astype(np.float32) for g in grads]
    return grads, errors


def _rank_noise(rank, grads):
    key = jax.random.fold_in(jax.random.PRNGKey(5), rank)
    return key, [np.array(jax.random.uniform(
        jax.random.fold_in(key, i), (qt.flat_rows(g.size), qt.CHUNK), jnp.float32))
        for i, g in enumerate(grads)]


def _exchange_worker(rank, world, rdv, out_dir, noise):
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{rdv}", world_size=world, rank=rank)
    grads, errors = _rank_grads(rank)
    restored, new_err = comp.compressed_allreduce(
        [torch.from_numpy(g) for g in grads], [torch.from_numpy(e) for e in errors],
        [torch.from_numpy(z) for z in noise], axis_name="data",
    )
    for i, (r, e) in enumerate(zip(restored, new_err)):
        np.save(os.path.join(out_dir, f"r{rank}_{i}.npy"), r.numpy())
        np.save(os.path.join(out_dir, f"e{rank}_{i}.npy"), e.numpy())
    torch.distributed.destroy_process_group()


def test_exchange_over_two_gloo_ranks(tmp_path):
    world = 2
    keys, noises, payloads, errs = [], [], [], []
    for rank in range(world):
        grads, errors = _rank_grads(rank)
        key, noise = _rank_noise(rank, grads)
        p, e = ref_comp.compress_tree([jnp.asarray(g) for g in grads],
                                      [jnp.asarray(x) for x in errors], key, use_kernel=False)
        noises.append(noise)
        payloads.append(p)
        errs.append(e)
    # The reference's psum of the int8 leaves, as a wrapping int8 sum.
    summed = [np.asarray(payloads[0][i][0]).copy() for i in range(2)]
    for p in payloads[1:]:
        for i in range(2):
            summed[i] = (summed[i] + np.asarray(p[i][0])).astype(np.int8)
    wide = np.asarray(payloads[0][1][0], np.int16) + np.asarray(payloads[1][1][0], np.int16)
    assert np.abs(wide).max() > 127  # the second leaf's sum wraps

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_exchange_worker,
                         args=(r, world, str(tmp_path / "rdv"), str(tmp_path), noises[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 240
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    assert not alive, "a gloo rank hung"
    assert [p.exitcode for p in procs] == [0, 0]
    for rank in range(world):
        grads, _ = _rank_grads(rank)
        flat = [(jnp.asarray(summed[i]), payloads[rank][i][1], payloads[rank][i][2])
                for i in range(2)]
        want = ref_comp.decompress_tree(flat, [jnp.asarray(g) for g in grads], use_kernel=False)
        for i in range(2):
            _same(np.load(tmp_path / f"r{rank}_{i}.npy"), np.asarray(want[i]), (rank, i))
            _same(np.load(tmp_path / f"e{rank}_{i}.npy"), np.asarray(errs[rank][i]), (rank, i))
