"""Partitioning over a mesh on the host: placement under any partition
spec, DTensor placements and `constrain`, the dry-run's per-device count
and its collective bytes, and the sharded forward run for real over four
gloo ranks.

Contracts:
  * `place` / `gather` / `placements` for specs of rank 1-3 on host
    meshes (2, 2), (2, 4) and (2, 2, 2) of ``cpu`` listed n times: each
    mesh device's block is the slice DTensor assigns to that rank
    (`compute_local_shape_and_global_offset` on a fake group of the
    mesh's size, rank by rank), and the gather is the tensor, bit for bit;
  * every arch's reduced parameters under `param_sharding` in ``tp`` and
    ``fsdp`` on a (2, 2) host mesh: block shapes equal to the spec's
    `SDS.shard_shape`, gathers and `Checkpointer.restore(shardings=)` bit
    for bit;
  * a Megatron MLP on a fake (data 2, model 4) mesh over ``meta``: per-
    device product FLOPs exactly the whole over 8, one all-reduce of twice
    the local output's bytes; those bytes, and an all-gather, a
    reduce-scatter and an all-to-all of stated shapes, equal to what the
    reference's HLO analyzer (`repro.launch.hlo_cost.analyze`) gives for a
    hand-written HLO module holding the same collectives (exact);
  * four spawned gloo ranks on a (data 2, model 2) mesh of ``cpu``: the
    reduced f32 gemma3's logits and loss and the reduced qwen3-moe's
    logits within 2e-5 (absolute) of the unsharded port, xLSTM's within
    1e-4 of their largest magnitude (see the test); every arch's logits
    within 1e-6 of the unsharded port run with each row-parallel product
    summed in the mesh's order (`RowParallelOrder`); gemma3's gradients
    within 1e-4 of each leaf's largest magnitude;
  * `constrain` redistributes a DTensor to the active rules' spec and
    returns a plain tensor as it is.
"""

import dataclasses
import math
import multiprocessing
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode

from repro.launch.hlo_cost import analyze
from repro_torch import tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.dryrun import partitioned
from repro_torch.launch.mesh import Mesh, NamedSharding, Sharded, gather, place, placements
from repro_torch.launch.op_cost import OpCounter
from repro_torch.launch.sharding import ShardingRules, activate, constrain, param_sharding
from repro_torch.launch.specs import SDS
from repro_torch.models.model import build_model

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
HOST_MESHES = {
    "2x2": (("data", "model"), (2, 2)),
    "2x4": (("data", "model"), (2, 4)),
    "2x2x2": (("pod", "data", "model"), (2, 2, 2)),
}


def host_mesh(name: str) -> Mesh:
    names, shape = HOST_MESHES[name]
    return Mesh(names, shape, (CPU,) * math.prod(shape))


def _same(a, b, what=""):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a.view(-1).view(torch.uint8) if a.dtype == torch.bool else a, b), what


def _specs(names):
    """Partition specs of rank 1 to 3 over ``names``: single axes, tuples
    in mesh order, replicated entries."""
    a, b = names[0], names[-1]
    out = [(a,), (b,), (None, a), (a, b), (b, a), ((a, b),), (None, None, b), (a, None, b)]
    if len(names) == 3:
        out += [((names[0], names[1]), None, names[2]), (names[1], (names[0], names[2])),
                ((names[0], names[1], names[2]),)]
    return out


@pytest.mark.parametrize("mesh_name", list(HOST_MESHES))
def test_place_gather_and_placements_under_any_spec(mesh_name):
    """Each mesh device's block is DTensor's shard of that rank (exact)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = host_mesh(mesh_name)
    x = torch.arange(8 * 8 * 8, dtype=torch.float64).reshape(8, 8, 8)
    want = {}
    for spec in _specs(mesh.axis_names):
        sh = NamedSharding(mesh, spec)
        p = place(x, sh)
        assert isinstance(p, Sharded) and len(p.blocks) == mesh.size and p.shape == (8, 8, 8)
        _same(gather(p), x, spec)
        assert len(p.shards) == sh.num_shards
        want[spec] = p
    with pytest.raises(ValueError, match="once"):
        NamedSharding(mesh, (mesh.axis_names[0], mesh.axis_names[0]))
    with pytest.raises(ValueError, match="does not split"):
        place(torch.zeros(3, 4), NamedSharding(mesh, (mesh.axis_names[0],)))
    rep = place(x, NamedSharding(mesh, ()))
    assert isinstance(rep, torch.Tensor)
    _same(rep, x)
    # The blocks against DTensor's layout, one fake rank at a time.
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import DeviceMesh

    for rank in range(mesh.size):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=mesh.size)
        try:
            dm = DeviceMesh("cpu", torch.arange(mesh.size).reshape(mesh.shape),
                            mesh_dim_names=mesh.axis_names)
            for spec, p in want.items():
                shape, offset = compute_local_shape_and_global_offset(
                    x.shape, dm, placements(spec, mesh))
                block = x[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
                _same(p.blocks[rank], block, (spec, rank))
        finally:
            dist.destroy_process_group()
    if len(mesh.axis_names) == 3:
        with pytest.raises(ValueError, match="order"):
            placements(((mesh.axis_names[1], mesh.axis_names[0]),), mesh)


def _reduced_params(arch):
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, "cpu")
    return model, model.init(torch.Generator().manual_seed(0), masters=True)


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_placement_every_arch(arch, mode, tmp_path):
    """Reduced parameters placed by `param_sharding`: each block the spec's
    shard shape, the gather and a sharded restore the source, bit for
    bit."""
    mesh = host_mesh("2x2")
    rules = ShardingRules(mesh)
    model, params = _reduced_params(arch)
    specs = param_sharding(params, rules, mode=mode, cfg=model.cfg)
    shardings = tree.map_leaves(lambda s: NamedSharding(mesh, s), specs)
    sharded = 0
    for leaf, spec, sh in zip(tree.leaves(params), tree.leaves(specs),
                              tree.leaves(shardings)):
        placed = place(leaf, sh)
        want = SDS(leaf, spec).shard_shape(rules.sizes)
        blocks = placed.blocks if isinstance(placed, Sharded) else (placed,)
        assert all(tuple(b.shape) == want for b in blocks), (spec, want)
        sharded += isinstance(placed, Sharded)
        _same(gather(placed), leaf, spec)
    assert sharded > 0
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, params)
    got = ck.restore(1, like=params, shardings=shardings)
    for a, b in zip(tree.leaves(got), tree.leaves(params)):
        _same(gather(a), b)


# ------------------------------------------------------- the count by hand
B, S, D, F = 8, 16, 64, 128
HLO = """HloModule collectives

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}

ENTRY %main (p0: f32[4,16,64], p1: f32[4,16,64], p2: f32[8,16,64], p3: f32[4,16,16]) -> f32[4,16,16] {
  %p0 = f32[4,16,64]{2,1,0} parameter(0)
  %p1 = f32[4,16,64]{2,1,0} parameter(1)
  %p2 = f32[8,16,64]{2,1,0} parameter(2)
  %p3 = f32[4,16,16]{2,1,0} parameter(3)
  %ar = f32[4,16,64]{2,1,0} all-reduce(f32[4,16,64]{2,1,0} %p0), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[8,16,64]{2,1,0} all-gather(f32[4,16,64]{2,1,0} %p1), replica_groups={{0,1}}, dimensions={0}
  %rs = f32[4,16,64]{2,1,0} reduce-scatter(f32[8,16,64]{2,1,0} %p2), replica_groups={{0,1}}, dimensions={0}, to_apply=%add
  ROOT %a2a = f32[4,16,16]{2,1,0} all-to-all(f32[4,16,16]{2,1,0} %p3), replica_groups={{0,1,2,3}}, dimensions={2}
}
"""


def test_megatron_mlp_count_and_the_reference_convention():
    """Column-parallel then row-parallel products on a (data 2, model 4)
    fake mesh: exact per-device product FLOPs, one all-reduce of twice its
    local output's bytes; then an all-gather over data, a reduce-scatter
    over data and an all-to-all over model.  The bytes by kind equal the
    reference analyzer's on the same collectives."""
    mesh = Mesh(("data", "model"), (2, 4))
    with partitioned(mesh) as dm:
        def dt(shape, pl):
            local = [*shape]
            for i, p in enumerate(pl):
                if isinstance(p, Shard):
                    local[p.dim] //= dm.size(i)
            return DTensor.from_local(torch.empty(local, device="meta"), dm, pl,
                                      run_check=False, shape=torch.Size(shape),
                                      stride=torch.empty(shape, device="meta").stride())

        x = dt((B, S, D), [Shard(0), Replicate()])
        w1 = dt((D, F), [Replicate(), Shard(1)])
        w2 = dt((F, D), [Replicate(), Shard(0)])
        with OpCounter() as counter:
            y = torch.nn.functional.gelu(x @ w1) @ w2
            assert tuple(y.placements) == (Shard(0), Partial())
            y = y.redistribute(dm, [Shard(0), Replicate()])
            z = y.redistribute(dm, [Replicate(), Replicate()])  # all-gather over data
            assert tuple(z.to_local().shape) == (B, S, D)
            part = DTensor.from_local(torch.empty(B, S, D, device="meta"), dm,
                                      [Partial(), Replicate()], run_check=False)
            part.redistribute(dm, [Shard(0), Replicate()])  # reduce-scatter over data
            t = dt((B, S, D), [Shard(0), Shard(1)])
            t.redistribute(dm, [Shard(0), Shard(2)])  # all-to-all over model
    cost = counter.cost
    whole = 2 * B * S * D * F * 2
    assert cost.matmul_flops == whole / 8
    local_out = (B // 2) * S * D * 4
    got = {k: v for k, v in cost.collective_bytes.items() if v}
    assert got == {"all-reduce": 2 * local_out, "all-gather": 2 * local_out,
                   "reduce-scatter": local_out, "all-to-all": local_out // 4}, got
    assert got == {k: v for k, v in analyze(HLO).collective_bytes.items() if v}


def test_constrain_redistributes_dtensors_only():
    mesh = Mesh(("data", "model"), (2, 4))
    rules = ShardingRules(mesh)
    x = torch.ones(8, 16, 64)
    with partitioned(mesh) as dm, activate(rules, dm):
        assert constrain(x, "batch", "seq", "embed") is x
        d = DTensor.from_local(torch.empty(8, 16, 64, device="meta"), dm,
                               [Replicate(), Replicate()], run_check=False)
        c = constrain(d, "batch", "seq", "embed")
        assert tuple(c.placements) == (Shard(0), Shard(1))
        assert tuple(c.to_local().shape) == (4, 4, 64)
        assert constrain(c, "batch", "seq", "embed") is c
    assert not dist.is_initialized()
    d2 = torch.ones(3)
    assert constrain(d2, "batch") is d2


# ------------------------------------------------ four gloo ranks for real
RANK_ARCHS = ("gemma3-1b", "qwen3-moe-235b-a22b", "xlstm-1.3b")


class RowParallelOrder(TorchDispatchMode):
    """Each product ``x @ w`` of a weight in ``weights`` (by storage) as
    the sum of ``ways`` products over consecutive blocks of its contracted
    dim: the order in which a row-parallel product, ``w`` split over a
    model axis of ``ways``, sums its partial results."""

    def __init__(self, weights, ways: int):
        super().__init__()
        self.keys = {id(w.untyped_storage()) for w in weights}
        self.ways = ways

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is not torch.ops.aten.mm.default or id(args[1].untyped_storage()) not in self.keys:
            return func(*args, **(kwargs or {}))
        x, w = args
        k = w.shape[0] // self.ways
        out = torch.mm(x[:, :k], w[:k])
        for i in range(1, self.ways):
            out = out + torch.mm(x[:, i * k:(i + 1) * k], w[i * k:(i + 1) * k])
        return out


def _f32(arch):
    return dataclasses.replace(get_arch(arch).reduced(), compute_dtype="float32")


def _forward_worker(rank, world, rdv, out_dir):
    """One rank of a (data 2, model 2) mesh of ``cpu``: each arch's reduced
    f32 model forward on DTensors placed by `param_sharding`, against the
    same model unsharded; gemma3's loss and gradients too.  Writes the
    largest gaps."""
    import json

    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import device_mesh
    from repro_torch.launch.steps import loss_and_grad

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world, rank=rank)
    try:
        mesh = Mesh(("data", "model"), (2, 2), (CPU,) * 4)
        dm = device_mesh(mesh)
        rules = ShardingRules(mesh)
        gaps = {}
        for arch in RANK_ARCHS:
            cfg = _f32(arch)
            model = build_model(cfg, "cpu")
            params = model.init(torch.Generator().manual_seed(0), masters=True)
            rng = np.random.default_rng(1)
            tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
            labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
            want = model.forward(params, {"tokens": tokens})[0]
            specs = param_sharding(params, rules, cfg=cfg)
            rows = [t for t, s in zip(tree.leaves(params), tree.leaves(specs))
                    if t.dim() == 2 and s[:1] == ("model",)]
            with RowParallelOrder(rows, mesh.shape[mesh.axis_names.index("model")]):
                ordered = model.forward(params, {"tokens": tokens})[0]
            dparams = tree.map_leaves(
                lambda t, s: distribute_tensor(t, dm, placements(s, mesh)), params, specs)
            bspec = placements((rules.mesh_axes_for("batch", 4), None), mesh)
            dbatch = {"tokens": distribute_tensor(tokens, dm, bspec),
                      "labels": distribute_tensor(labels, dm, bspec)}
            with activate(rules, dm), implicit_replication():
                got = model.forward(dparams, {"tokens": dbatch["tokens"]})[0].full_tensor()
                gaps[arch] = {"logits": float((got - want).abs().max()),
                              "ordered": float((got - ordered).abs().max()),
                              "order_alone": float((ordered - want).abs().max()),
                              "row_parallel": len(rows), "scale": float(want.abs().max())}
                if arch == "gemma3-1b":
                    loss, grads = loss_and_grad(model, dparams, dbatch)
                    want_loss, want_grads = loss_and_grad(
                        model, params, {"tokens": tokens, "labels": labels})
                    gaps[arch]["loss"] = float((loss.full_tensor() - want_loss).abs())
                    gaps[arch]["grads"] = max(
                        float((g.full_tensor() - w).abs().max() / w.abs().max().clamp_min(1e-30))
                        for g, w in zip(tree.leaves(grads), tree.leaves(want_grads)))
        with open(os.path.join(out_dir, f"gaps{rank}.json"), "w") as f:
            json.dump(gaps, f)
    finally:
        dist.destroy_process_group()


def test_sharded_forward_over_four_gloo_ranks(tmp_path):
    """Logits and loss against the unsharded port (bounds in the module
    doc); the gaps are printed (``-s``)."""
    import json

    world = 4
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_forward_worker,
                         args=(r, world, str(tmp_path / "rdv"), str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 60
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    assert not alive, "a gloo rank hung"
    assert [p.exitcode for p in procs] == [0] * world
    for r in range(world):
        gaps = json.loads((tmp_path / f"gaps{r}.json").read_text())
        print("rank", r, gaps)
        for arch in ("gemma3-1b", "qwen3-moe-235b-a22b"):
            assert gaps[arch]["logits"] <= 2e-5, (arch, gaps[arch])
        # Against the unsharded port with its row-parallel products summed
        # in the mesh's order, every arch within a few f32 ulps (1.5e-7
        # measured on xLSTM's logits of magnitude 0.73): a wrong split on
        # the model axis would not hide under this bound.
        for arch in RANK_ARCHS:
            assert gaps[arch]["row_parallel"] > 0 and gaps[arch]["ordered"] <= 1e-6, (
                arch, gaps[arch])
        # xLSTM: that order alone moves the unsharded logits by 3.2e-5 (the
        # exponential gates carry it through the 8 layers), as much as the
        # partition does, so the plain gap is held at 1e-4 of the logits.
        xl = gaps["xlstm-1.3b"]
        assert xl["logits"] <= 1e-4 * xl["scale"], xl
        assert gaps["gemma3-1b"]["loss"] <= 2e-5 and gaps["gemma3-1b"]["grads"] <= 1e-4
