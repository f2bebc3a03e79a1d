"""The port's launch tooling (`repro_torch.launch`: mesh, sharding, specs,
op_cost, roofline, steps, dryrun, perf, report) against the JAX package's
(`repro.launch`), on the host.

The reference's `ShardingRules` reads ``mesh.devices``, which jax 0.9's
`AbstractMesh` lacks: its rules are built over a stand-in with the axis
names and an empty device array of the mesh's shape, then given the
`AbstractMesh` itself, so its specs come at the production meshes with no
device, no XLA flag and no subprocess.  Leaves are paired by
`convert.params_from_reference`'s layer mapping (layer i of a unit of u
kinds repeated reps times is row i // u of ``units[i % u]`` for i < reps
x u, else ``rem[i - reps x u]``); a stacked leaf's spec loses its leading
entry, which must be ``None``.

Contracts (all exact unless stated):
  * partition specs of every parameter leaf, all ten archs, meshes (16,
    16), (2, 16, 16) and (1, 1), modes tp and fsdp, with no override and
    with ``param_tp=off``, ``mlstm_state_shard=off`` and ``seq=none``;
  * batch, decode-batch, bf16 parameter, optimizer (zero-1 and master
    weights) and cache specs (``long_500k`` included): shapes, dtypes and
    specs leaf for leaf, and per-device bytes equal to the sum of the
    reference's ``NamedSharding.shard_shape``.  One difference by design:
    where zero-1 meets a reference stack whose length the data axis
    divides, the reference shards the stack axis and the port its layer's
    first such dim (same bytes a device);
  * `auto_mode` at 16 GiB, `model_flops` within 1e-12 relative, the
    roofline formulas given the same hardware, the perf CLI's override
    parsers;
  * `OpCounter`: identical operations and bytes on ``meta`` and on the
    host for reduced gemma3, xLSTM and MLA steps (train, prefill,
    decode); the sLSTM loop on ``meta``, one step counted by its trip
    count, equal to every step run on the host, the high-water mark
    included; the ``mm`` FLOPs of reduced dense gemma3 (every product but
    attention's, whose twin's backward runs ``bmm``) equal to the count
    from the parameter shapes;
  * `run_cell`'s keys are the reference's, with the renames listed in its
    docstring, and `report` prints its three tables; on a production mesh
    the step is partitioned (``spmd``) and the per-device products are at
    least the whole count's even share.
"""

import ast
import dataclasses
import functools
import json
import math
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.launch import perf as ref_perf
from repro.launch import roofline as ref_roofline
from repro.launch import sharding as ref_sharding
from repro.launch import specs as ref_specs
from repro.models import model as ref_model_module
from repro.models.model import build_model as ref_build_model
from repro_torch import tree
from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mlstm_chunk as mc
from repro_torch.launch import dryrun, perf, report
from repro_torch.launch.mesh import (
    Mesh, data_axis_size, data_sharding, make_local_mesh, make_production_mesh,
    mesh_axis_sizes, place,
)
from repro_torch.launch.op_cost import OpCounter
from repro_torch.launch.roofline import HW, Hardware, model_flops, roofline_fraction, roofline_terms
from repro_torch.launch.sharding import ShardingRules, activate, constrain, param_sharding
from repro_torch.launch.specs import (
    SDS, auto_mode, batch_specs, cache_specs, decode_batch_specs, device_bytes, opt_specs,
    param_specs, spec_leaves,
)
from repro_torch.launch.steps import (
    default_optimizer, make_prefill_step, make_serve_step, make_train_step,
)
from repro_torch.models.model import build_model

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
OVERRIDES = [None, {"param_tp": "off"}, {"mlstm_state_shard": "off"}, {"seq": ((),)}]
_DTYPES = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.int32): torch.int32}


class _Devices:
    """What the reference's `ShardingRules` reads of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, object)


def ref_rules(mesh: str, overrides=None):
    shape, names = MESHES[mesh]
    rules = ref_sharding.ShardingRules(_Devices(shape, names), overrides)
    rules.mesh = AbstractMesh(shape, names)
    return rules


def port_rules(mesh: str, overrides=None) -> ShardingRules:
    shape, names = MESHES[mesh]
    return ShardingRules(Mesh(names, shape), overrides)


@functools.lru_cache(maxsize=None)
def ref_model(arch):
    return ref_build_model(REF_ARCHS[arch])


@functools.lru_cache(maxsize=None)
def ref_param_shapes(arch):
    return jax.eval_shape(ref_model(arch).init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def port_model(arch):
    return build_model(get_arch(arch), "meta")


@functools.lru_cache(maxsize=None)
def port_param_shapes(arch):
    return port_model(arch).abstract_params(masters=True)


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def ref_leaves(ref_tree) -> dict:
    """The reference tree's leaves by ``/``-joined path."""
    return {"/".join(_key(k) for k in kp): leaf
            for kp, leaf in jax.tree_util.tree_flatten_with_path(ref_tree)[0]}


def ref_path(cfg, path: str) -> tuple[str, bool]:
    """The reference's path of the port's leaf ``path``, and whether it is
    stacked (a leading reps axis)."""
    parts = path.split("/")
    if parts[0] != "layers":
        return path, False
    i, rest = int(parts[1]), parts[2:]
    u = len(tuple(cfg.layer_unit))
    reps = cfg.num_layers // u
    if i < reps * u:
        return "/".join(["units", str(i % u), *rest]), True
    return "/".join(["rem", str(i - reps * u), *rest]), False


def ref_spec(leaf) -> tuple:
    return tuple(leaf.spec if hasattr(leaf, "spec") else leaf.sharding.spec)


def ref_device_bytes(ref_tree) -> int:
    return sum(math.prod(leaf.sharding.shard_shape(leaf.shape)) * jnp.dtype(leaf.dtype).itemsize
               for leaf in jax.tree.leaves(ref_tree))


def assert_port_tree(cfg, port_tree, ref_tree, zero1_data: int | None = None):
    """Leaf for leaf: shape, dtype, spec (stacked leaves less their leading
    ``None``).  With ``zero1_data``, a stacked leaf whose stack the
    reference put on ``data`` holds it on its first replicated dim that the
    data axis divides instead (if any)."""
    want = ref_leaves(ref_tree)
    covered = set()
    moved = 0
    for path, got in zip(tree.paths(port_tree), tree.leaves(port_tree)):
        rpath, stacked = ref_path(cfg, path)
        ref = want[rpath]
        covered.add(rpath)
        spec = ref_spec(ref)
        shape = tuple(ref.shape)
        if stacked:
            shape = shape[1:]
            lead, spec = spec[0], spec[1:]
            if zero1_data is not None and lead == "data":
                assert "data" not in spec
                first = next((i for i, d in enumerate(shape)
                              if spec[i] is None and d % zero1_data == 0 and d >= zero1_data),
                             None)
                spec = tuple("data" if i == first else a for i, a in enumerate(spec))
                moved += 1
            else:
                assert lead is None, (path, ref_spec(ref))
        assert got.shape == shape, path
        assert got.dtype == _DTYPES[jnp.dtype(ref.dtype)], path
        assert got.spec == spec, (path, got.spec, spec)
    assert covered == set(want)
    return moved


# ------------------------------------------------------------------- meshes
def test_meshes():
    """The production meshes (no cards), the host's local mesh, the axis
    helpers, the data spec and placement."""
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.shape, single.devices) == (("data", "model"), (16, 16), ())
    assert (multi.axis_names, multi.shape, multi.size) == (("pod", "data", "model"),
                                                            (2, 16, 16), 512)
    local = make_local_mesh("cpu")
    assert (local.axis_names, local.shape, local.devices) == (
        ("data", "model"), (1, 1), (torch.device("cpu"),))
    assert mesh_axis_sizes(multi) == {"pod": 2, "data": 16, "model": 16}
    assert data_axis_size(single) == 16 and data_axis_size(local) == 1
    assert data_sharding(single).spec == ("data",) and data_sharding(single).mesh is single
    x = place(np.arange(6.0).reshape(3, 2), data_sharding(local), device="cpu")
    assert x.device.type == "cpu" and x.shape == (3, 2)
    with pytest.raises(ValueError, match="rank"):
        place(np.float32(1.0), ("data",), device="cpu")
    with pytest.raises(ValueError, match="devices"):
        Mesh(("data", "model"), (2, 1), (torch.device("cpu"),))


def test_rules_and_constrain():
    """Logical-axis rules as the reference's, `constrain` the identity on
    one card, `activate` scoped."""
    for mesh in MESHES:
        ref, port = ref_rules(mesh), port_rules(mesh)
        for logical in (*ref_sharding.DEFAULT_RULES, None, "unknown"):
            for dim in (1, 4, 16, 32, 48, 96, 100):
                assert port.mesh_axes_for(logical, dim) == ref.mesh_axes_for(logical, dim)
        axes, shape = ("batch", "seq", "embed"), (32, 4096, 1152)
        assert port.spec(axes, shape) == tuple(ref.spec(axes, shape))
        assert port.spec(("heads", "kv_heads"), (16, 16)) == tuple(
            ref.spec(("heads", "kv_heads"), (16, 16)))
    x = torch.ones(2, 3)
    rules = port_rules("16x16")
    with activate(rules):
        assert constrain(x, "batch", "embed") is x


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_sharding_matches_reference(arch, mesh, mode):
    cfg = get_arch(arch)
    for overrides in OVERRIDES:
        want = ref_sharding.param_sharding(ref_param_shapes(arch), ref_rules(mesh, overrides),
                                           mode=mode)
        got = param_sharding(port_param_shapes(arch), port_rules(mesh, overrides), mode=mode,
                             cfg=cfg)
        shapes = port_param_shapes(arch)
        specs = [SDS(t, s) for t, s in zip(tree.leaves(shapes), tree.leaves(got))]
        named = jax.tree.map(lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
                             ref_param_shapes(arch), want)
        assert_port_tree(cfg, tree.unflatten(shapes, specs), named)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_other_specs_match_reference(arch, mesh):
    """Batch specs of each applicable shape, bf16 parameters, the optimizer
    state (zero-1 on and off, master weights) and the decode caches."""
    cfg, ref_cfg = get_arch(arch), REF_ARCHS[arch]
    port, ref = port_rules(mesh), ref_rules(mesh)
    model, rmodel = port_model(arch), ref_model(arch)
    for name in applicable_shapes(cfg):
        shape, rshape = SHAPES[name], REF_SHAPES[name]
        if shape.kind == "decode":
            got, want = decode_batch_specs(cfg, shape, port), ref_specs.decode_batch_specs(
                ref_cfg, rshape, ref)
            caches = (cache_specs(model, port, shape.global_batch, shape.seq_len),
                      ref_specs.cache_specs(rmodel, ref, shape.global_batch, shape.seq_len))
            assert_cache(cfg, *caches)
            assert device_bytes(caches[0], port) == ref_device_bytes(caches[1])
        else:
            with_labels = shape.kind == "train"
            got = batch_specs(cfg, shape, port, with_labels)
            want = ref_specs.batch_specs(ref_cfg, rshape, ref, with_labels)
        assert set(got) == set(want)
        for k in got:
            assert got[k].shape == want[k].shape and got[k].spec == ref_spec(want[k])
            assert got[k].dtype == _DTYPES[jnp.dtype(want[k].dtype)]
        assert device_bytes(got, port) == ref_device_bytes(want)

    got = param_specs(model, port, dtype=torch.bfloat16)
    want = ref_specs.param_specs(rmodel, ref, dtype=jnp.bfloat16)
    assert_port_tree(cfg, got, want)
    assert device_bytes(got, port) == ref_device_bytes(want)

    opt = dataclasses.replace(default_optimizer(), master_weights=True)
    data = port.sizes["data"]
    for zero1 in (False, True):
        got = opt_specs(model, port, opt, zero1=zero1)
        want = ref_specs.opt_specs(rmodel, ref, opt, zero1=zero1)
        assert set(got) == set(want) == {"m", "v", "master", "count"}
        assert got["count"].spec == () and got["count"].dtype == torch.int32
        for k in ("m", "v", "master"):
            moved = assert_port_tree(cfg, got[k], want[k], zero1_data=data if zero1 else None)
            u = len(cfg.layer_unit)
            reps = cfg.num_layers // u
            # The stack axis goes on data only where it divides: musicgen's
            # 48 at 16 ways, every stack on a data axis of 1.
            assert bool(moved) == (zero1 and reps % data == 0 and reps >= data)
        assert device_bytes(got, port) == ref_device_bytes(want)


def assert_cache(cfg, got, want):
    """Per-layer cache specs against the reference's stacked caches; tuples
    flatten as the reference's do (index keys)."""
    want_by_path = ref_leaves(want)
    u = len(tuple(cfg.layer_unit))
    reps = cfg.num_layers // u
    n = 0
    for i, layer in enumerate(got):
        for kp, leaf in jax.tree_util.tree_flatten_with_path(
                layer, is_leaf=lambda x: isinstance(x, SDS))[0]:
            rest = [_key(k) for k in kp]
            stacked = i < reps * u
            rpath = "/".join((["units", str(i % u)] if stacked else
                              ["rem", str(i - reps * u)]) + rest)
            ref = want_by_path[rpath]
            spec, shape = ref_spec(ref), tuple(ref.shape)
            if stacked:
                assert spec[0] is None
                spec, shape = spec[1:], shape[1:]
            assert leaf.shape == shape and leaf.spec == spec, (rpath, leaf.spec, spec)
            assert leaf.dtype == _DTYPES[jnp.dtype(ref.dtype)]
            n += 1
    assert n == sum(reps if p.startswith("units") else 1 for p in want_by_path)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_auto_mode_and_model_flops_match_reference(arch, monkeypatch):
    """`auto_mode` at the reference's 16 GiB on every mesh and kind, and
    at the card's 80 GB by default; `model_flops` on every applicable
    shape (the reference's models built once, so that jax reuses their
    traced shapes)."""
    monkeypatch.setattr(ref_model_module, "build_model",
                        lambda cfg: ref_model(cfg.name) if cfg == REF_ARCHS[cfg.name]
                        else ref_build_model(cfg))
    for mesh in MESHES:
        for kind in ("train", "serve"):
            want = ref_specs.auto_mode(ref_model(arch), ref_rules(mesh), kind)
            got = auto_mode(port_model(arch), port_rules(mesh), kind, hbm_bytes=16 * 2**30)
            assert got == want
        n = sum(t.numel() for t in tree.leaves(port_param_shapes(arch)))
        tp = port_rules(mesh).sizes["model"]
        assert auto_mode(port_model(arch), port_rules(mesh), "train") == (
            "fsdp" if n * 12.0 / tp > HW.hbm_bytes / 2 else "tp")
    for name in applicable_shapes(get_arch(arch)):
        want = ref_roofline.model_flops(REF_ARCHS[arch], REF_SHAPES[name])
        got = model_flops(get_arch(arch), SHAPES[name])
        assert abs(got - want) <= 1e-12 * abs(want)


def test_roofline_formulas_match_reference():
    ref_hw = ref_roofline.Hardware(peak_flops=HW.peak_flops, hbm_bw=HW.hbm_bw,
                                   ici_bw=HW.link_bw)
    for args in [(1e12, 1e9, 0.0), (1e9, 5e12, 2e10), (0.0, 0.0, 9e11), (3e15, 1e3, 1.0)]:
        assert roofline_terms(*args) == ref_roofline.roofline_terms(*args, hw=ref_hw)
    other = Hardware(peak_flops=1e12, hbm_bw=1e9, link_bw=1e8)
    assert roofline_terms(1e12, 1e9, 1e8, hw=other) == ref_roofline.roofline_terms(
        1e12, 1e9, 1e8, hw=ref_roofline.Hardware(1e12, 1e9, 1e8))
    for bound, measured in [(1.0, 2.0), (0.5, 0.0), (3e-6, 1e-3), (1.0, -1.0)]:
        assert roofline_fraction(bound, measured) == ref_roofline.roofline_fraction(
            bound, measured)


def test_perf_override_parsers_match_reference(monkeypatch, tmp_path):
    """The reference's ``perf.main`` parses the same ``--override`` and
    ``--rules-override`` flags into the dicts it hands `run_cell` (caught
    by a stand-in; its dry-run module's XLA flag is restored after)."""
    jax.devices()  # the backend is up before the reference's module sets its flag
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    import repro.launch.dryrun as ref_dryrun

    overrides = ["mlstm_chunk=128", "capacity_factor=1.5", "moe_combine_reshard=true",
                 "attention_impl=flash", "q_chunk=-3", "flag=False", "ratio=1e-3"]
    rules = ["seq=none", "seq_kv=model", "param_tp=off", "batch=data"]
    seen = {}

    def fake_run_cell(arch, shape, multi_pod, **kw):
        seen.update(kw)
        return {"roofline": dict.fromkeys(("compute_s", "memory_s", "collective_s",
                                           "bound_s"), 1.0) | {"dominant": "memory_s"},
                "memory": {"peak_estimate_bytes": 0}}

    monkeypatch.setattr(ref_dryrun, "run_cell", fake_run_cell)
    argv = ["perf", "--arch", "gemma3-1b", "--shape", "train_4k", "--out", str(tmp_path),
            "--baseline-dir", str(tmp_path / "none")]
    argv += [f"--override={o}" for o in overrides] + [f"--rules-override={r}" for r in rules]
    monkeypatch.setattr(sys, "argv", argv)
    ref_perf.main()
    assert perf.parse_overrides(overrides) == seen["cfg_overrides"]
    assert perf.parse_rules_overrides(rules) == seen["rules_overrides"]


# ---------------------------------------------------------------- op_cost
def _reduced(arch):
    cfg = get_arch(arch).reduced()
    return dataclasses.replace(cfg, mlstm_chunk=12) if arch == "xlstm-1.3b" else cfg


def _count(cfg, kind, device, B=2, S=40):
    """The step's `OpCost` on ``device`` (random values on the host, none
    on meta)."""
    model = build_model(cfg, device)
    if device == "meta":
        params = model.abstract_params(masters=kind == "train")
    else:
        params = model.init(torch.Generator().manual_seed(0), masters=kind == "train")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen).to(device)
    if kind == "train":
        opt = default_optimizer()
        state = opt.init(params)
        args = (params, state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        step = make_train_step(model, opt)
    elif kind == "prefill":
        args, step = (params, {"tokens": toks[:, :-1]}), make_prefill_step(model)
    else:
        cache = model.init_cache(B, S)
        args, step = (params, cache, {"tokens": toks[:, :1]}, S - 1), make_serve_step(model)
    with OpCounter() as counter:
        step(*args)
    return counter.cost


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "xlstm-1.3b", "minicpm3-4b"])
def test_op_count_is_the_same_on_meta_and_host(arch, kind):
    """Operations, bytes, ATen ops and kernel shares identical: the
    kernels' meta routes and host twins add their `cost` and hide their
    own operations, and the host twin writes in q's layout as the kernel
    does."""
    cfg = _reduced(arch)
    meta, host = _count(cfg, kind, "meta"), _count(cfg, kind, "cpu")
    assert (meta.flops, meta.bytes, meta.ops) == (host.flops, host.bytes, host.ops)
    assert meta.matmul_flops == host.matmul_flops > 0
    assert dict(meta.kernels) == dict(host.kernels)
    kernel = {"gemma3-1b": "flash_attention", "xlstm-1.3b": "mlstm_chunk"}.get(arch)
    assert set(meta.kernels) == ({kernel} if kernel else set())
    assert meta.peak_bytes > 0 and meta.collective_total == 0.0


@pytest.mark.parametrize("unit,kind", [
    (None, "train"), (("slstm",), "train"), (("slstm",), "prefill"), (("slstm",), "decode"),
])
def test_time_loop_counts_every_step(unit, kind, monkeypatch):
    """On meta the sLSTM's loop runs one step counted by its trip count
    (`op_cost.time_loop`), forward and backward; on the host every step
    runs.  Operations, products, transcendentals, bytes and ATen ops are
    equal, and so is the high-water mark: the steps' input states and
    outputs go to buffers made before the loop.  The reduced model with
    its published unit (7 mLSTM, 1 sLSTM) trains; a model of two sLSTM
    layers also prefills and decodes (the mLSTM's host twin holds more at
    the prefill's peak than its meta route, whatever the sLSTM does)."""
    import repro_torch.models.xlstm as X

    cfg = _reduced("xlstm-1.3b")
    if unit:
        cfg = dataclasses.replace(cfg, num_layers=2, layer_unit=unit)
    calls = {"fwd": 0, "back": 0}

    def spy(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(X, "_slstm_step", spy("fwd", X._slstm_step))
    monkeypatch.setattr(X, "_slstm_step_back", spy("back", X._slstm_step_back))
    meta = _count(cfg, kind, "meta")
    once = dict(calls)
    host = _count(cfg, kind, "cpu")
    every = {k: v - once[k] for k, v in calls.items()}
    S = 1 if kind == "decode" else 40
    layers = cfg.layer_kinds.count("slstm")
    # Training: the forward, the unit's recompute, the backward.
    assert every == {"fwd": 2 * S * layers if kind == "train" else S * layers,
                     "back": S * layers if kind == "train" else 0}
    assert once == {k: v if S == 1 else v // S for k, v in every.items()}
    assert (meta.flops, meta.matmul_flops, meta.transcendentals, meta.bytes, meta.ops) == (
        host.flops, host.matmul_flops, host.transcendentals, host.bytes, host.ops)
    assert meta.peak_bytes == host.peak_bytes > 0


def test_matmul_flops_equal_the_count_from_shapes():
    """Reduced dense gemma3 with two whole units and one layer more, 2 x
    40 tokens.  A layer's products per token: 2 x (D Hq Dh + 2 D Hkv Dh +
    Hq Dh D + 3 D F); the head's 2 D V.  Decode: every layer and the head
    on B tokens.  Prefill: every layer on B S tokens, the head on the last
    position only.  Training: the forward; the units recomputed in the
    backward, each but its last product (`torch.utils.checkpoint` stops a
    recompute once every tensor the backward saved is back, and the last
    layer's ``w_down`` output is none); the backward's two products for
    each; the head forward, recomputed (the loss chunk) and backward."""
    cfg = dataclasses.replace(get_arch("gemma3-1b").reduced(), num_layers=13)
    D, H, Hkv, Dh, F, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                           cfg.d_ff, cfg.vocab_size)
    per_token = 2 * (D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D + 3 * D * F)
    head = 2 * D * V
    B, S, L, units = 2, 40, 13, 12
    want = {
        "decode": B * (L * per_token + head),
        "prefill": B * S * L * per_token + B * head,
        "train": B * S * (per_token * (L + units + 2 * L) - 2 * 2 * F * D + head * 4),
    }
    for kind, flops in want.items():
        cost = _count(cfg, kind, "meta", B, S)
        assert cost.by_op["mm"][1] == flops, kind
        assert cost.matmul_flops >= flops


def test_repeat_scales_the_count():
    x = torch.ones(4, 4)
    with OpCounter() as once:
        (x @ x).exp()
    with OpCounter() as thrice:
        with thrice.repeat(3):
            (x @ x).exp()
    assert thrice.cost.flops == 3 * once.cost.flops and thrice.cost.ops == 3 * once.cost.ops
    assert thrice.cost.peak_bytes == once.cost.peak_bytes


# ------------------------------------------------- the meta device, kernels
def test_meta_device_is_taken_only_where_named():
    with pytest.raises(ValueError, match="needs values"):
        resolve_device("meta")
    assert resolve_device("meta", meta=True).type == "meta"
    model = build_model(_reduced("gemma3-1b"), "meta")
    assert model.device.type == "meta"


@pytest.mark.parametrize("arch", ["gemma3-1b", "xlstm-1.3b", "recurrentgemma-2b",
                                  "qwen3-moe-235b-a22b", "musicgen-medium"])
def test_abstract_params_are_inits_shapes(arch):
    """Shapes and dtypes of `init` (and `cast`), served and trained; caches
    made on a meta model."""
    cfg = _reduced(arch)
    host = build_model(cfg, "cpu")
    for masters in (False, True):
        got = build_model(cfg, "meta").abstract_params(masters)
        want = host.init(torch.Generator().manual_seed(0), masters)
        assert tree.paths(got) == tree.paths(want)
        for g, w in zip(tree.leaves(got), tree.leaves(want)):
            assert g.device.type == "meta" and (g.shape, g.dtype) == (w.shape, w.dtype)
    cache = build_model(cfg, "meta").init_cache(2, 8)
    flat = jax.tree_util.tree_leaves(cache)  # tuples of recurrent state included
    assert flat and all(t.device.type == "meta" for t in flat)


def test_kernel_meta_routes_and_costs():
    """Meta calls run the kernels' checks and return empty outputs of the
    right shapes; `cost` counts 4 D per live pair and the live band's rows
    (attention), the chunk products and state (mLSTM)."""
    q = torch.empty(2, 4, 5, 16, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 2, 9, 16, device="meta", dtype=torch.bfloat16)
    out = fa.flash_attention(q, k, k, True, 3, 4)
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype
    with pytest.raises(ValueError, match="head dim"):
        bad = torch.empty(1, 1, 1, 24, device="meta")
        fa.flash_attention(bad, bad, bad)
    qi = 4 + torch.arange(5)[:, None]
    kj = torch.arange(9)[None, :]
    mask = (qi >= kj) & (qi - kj < 3)
    flops, nbytes = fa.cost(q, k, k, True, 3, 4)
    live = int(mask.any(dim=0).sum())
    assert flops == 4 * 16 * int(mask.sum()) * 2 * 4
    assert nbytes == 2 * (2 * 2 * 4 * 5 * 16 + 2 * 2 * 2 * live * 16)
    assert fa.live_pairs(5, 9, False, None, 0) == 45

    BH, S, Dh, C = 3, 24, 16, 8
    args = [torch.empty(BH, S, Dh, device="meta") for _ in range(3)]
    gates = [torch.empty(BH, S, device="meta") for _ in range(2)]
    h, (s, n) = mc.mlstm_chunk(*args, *gates, chunk=C)
    assert (h.shape, s.shape, n.shape) == ((BH, S, Dh), (BH, Dh, Dh), (BH, Dh))
    assert s.dtype == n.dtype == torch.float32 and h.device.type == "meta"
    flops, nbytes = mc.cost(*args, *gates, None, C)
    pairs = C * (C + 1) // 2
    assert flops == BH * (S // C) * (4 * pairs * Dh + 4 * C * Dh * Dh)
    assert nbytes == 4 * BH * S * Dh * 4 + 8 * BH * S + 4 * BH * (Dh * Dh + Dh)


# ----------------------------------------------------------------- dry-run
def _reference_result_keys():
    """The keys of the reference's `run_cell` result, read from its source
    (``result = {...}``): top level, ``memory`` and ``cost``."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "result"
                and isinstance(node.value, ast.Dict)):
            top = {k.value: v for k, v in zip(node.value.keys, node.value.values)}
            return ({k for k in top}, {k.value for k in top["memory"].keys},
                    {k.value for k in top["cost"].keys})
    raise AssertionError("no result dict in the reference's dryrun.py")


def _reduced_overrides(arch):
    """The reduced config as overrides, less ``moe_groups``, which
    `run_cell` aligns with the mesh's data ways."""
    red = _reduced(arch)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if f.name != "moe_groups"}


def test_run_cell_keys_and_report(tmp_path, capsys):
    """Reduced gemma3 train, prefill and decode cells on both production
    meshes (and xLSTM's decode): the reference's keys with the renames,
    the step partitioned (``spmd``): per-device products at least the
    whole count's even share, collective bytes on the train cells, a
    useful-FLOPs ratio no higher than the even split's; and `report`'s
    three tables."""
    top, memory, cost = _reference_result_keys()
    renamed = (top - {"compile_s"}) | {"trace_s", "partition"}
    shapes = [ShapeSpec("train_64", 64, 32, "train"), ShapeSpec("prefill_64", 64, 32, "prefill"),
              ShapeSpec("decode_64", 64, 32, "decode")]
    results = []
    wholes = {s.name: dryrun.run_cell("gemma3-1b", s, "local", device="cpu",
                                      cfg_overrides=_reduced_overrides("gemma3-1b"))
              for s in shapes}
    for mesh in ("single", "multi"):
        for shape in shapes:
            res = dryrun.run_cell("gemma3-1b", shape, mesh,
                                  cfg_overrides=_reduced_overrides("gemma3-1b"))
            results.append(res)
            whole = wholes[shape.name]
            assert whole["partition"] == "whole" and whole["chips"] == 1
            assert res["cost"]["matmul_flops"] >= whole["cost"]["matmul_flops"] / res["chips"]
            assert res["useful_flops_ratio"] <= whole["useful_flops_ratio"]
            if shape.kind == "train":
                assert res["collectives"]["total"] > 0
                assert res["roofline"]["collective_s"] > 0
    results.append(dryrun.run_cell("xlstm-1.3b", shapes[2], "single",
                                   cfg_overrides=_reduced_overrides("xlstm-1.3b")))
    for res in results:
        assert set(res) == renamed
        assert set(res["memory"]) == (memory - {"fits_hbm_16g"}) | {"fits_hbm", "hbm_bytes"}
        assert set(res["cost"]) >= cost - {"xla_flops", "xla_bytes_accessed"}
        assert res["partition"] == "spmd" and res["remat"] == "unit"
        assert res["collectives"]["total"] == sum(
            v for k, v in res["collectives"].items() if k != "total")
        assert res["memory"]["argument_bytes"] > 0 and res["memory"]["fits_hbm"]
        assert res["cost"]["device_flops"] > 0
        path = tmp_path / f"{res['arch']}__{res['shape']}__{res['mesh']}.json"
        path.write_text(json.dumps(res))
    train_single, train_multi = results[0], results[3]
    assert train_single["mesh"] == "pod16x16" and train_multi["mesh"] == "pod2x16x16"
    assert train_single["num_microbatches"] == 1
    assert results[2]["cost"]["kernels"]["flash_attention"]["calls"] == 6
    assert results[-1]["cost"]["kernels"]["mlstm_chunk"]["calls"] == 7
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("| arch | shape |") == 4  # dry-run, two rooflines, bottlenecks
    assert "### Roofline -- pod16x16 (256 chips)" in out and "fits 80 GB" in out
    assert "### Bottlenecks" in out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_run_cell_every_arch(arch):
    """Every family's reduced train, prefill and decode cells run on meta
    (no value read, no bounds check, no count off a tensor) on both
    production meshes, partitioned over them (``spmd``: DTensors on a fake
    process group, torn down after each cell); the experts' dispatch
    groups follow the data ways."""
    for mesh in ("single", "multi"):
        for shape in (ShapeSpec("t", 32, 32, "train"), ShapeSpec("p", 32, 32, "prefill"),
                      ShapeSpec("d", 32, 32, "decode")):
            res = dryrun.run_cell(arch, shape, mesh, cfg_overrides=_reduced_overrides(arch))
            assert res["partition"] == "spmd" and not torch.distributed.is_initialized()
            assert res["cost"]["device_flops"] > 0 and res["memory"]["argument_bytes"] > 0
            assert res["model_flops"] > 0 and res["roofline"]["bound_s"] > 0


def test_run_cell_local_mesh_on_the_host():
    """The host's (1, 1) mesh: one chip, nothing split; microbatches
    bound the live tokens (4 x 64 tokens, 1 microbatch)."""
    res = dryrun.run_cell("gemma3-1b", ShapeSpec("t", 64, 4, "train"), "local",
                          cfg_overrides=_reduced_overrides("gemma3-1b"), device="cpu")
    assert (res["mesh"], res["chips"], res["partition"]) == ("local1x1", 1, "whole")
    assert res["num_microbatches"] == 1 and res["param_mode"] == "tp"


def test_dryrun_and_perf_main(tmp_path, capsys):
    """The CLIs: a cached cell is skipped; perf prints the baseline and the
    change's bound."""
    out = tmp_path / "dry"
    argv = ["--arch", "gemma3-1b", "--shape", "decode_32k", "--mesh", "single", "--out",
            str(out)]
    dryrun.main(argv)
    dryrun.main(argv)
    text = capsys.readouterr().out
    assert "All dry-run cells ran." in text and "[skip] gemma3-1b__decode_32k__single" in text
    res = json.loads((out / "gemma3-1b__decode_32k__single.json").read_text())
    assert res["model_flops"] == model_flops(get_arch("gemma3-1b"), SHAPES["decode_32k"])
    perf.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--baseline-dir", str(out),
               "--out", str(tmp_path / "perf"), "--override", "window_size=256",
               "--tag", "w256"])
    text = capsys.readouterr().out
    assert "baseline:" in text and "bound delta:" in text
    saved = json.loads((tmp_path / "perf" / "gemma3-1b__decode_32k__single__w256.json")
                       .read_text())
    assert saved["overrides"] == {"window_size": 256}


def test_measured_roofline():
    x = torch.ones(64, 64)
    with OpCounter() as counter:
        x @ x
    terms = perf.measured_roofline(counter.cost, 1e-3)
    assert terms["flops"] == 2 * 64**3 and terms["bytes"] == 3 * 64 * 64 * 4
    assert terms["roofline_frac"] == terms["bound_s"] / 1e-3
    assert terms["dominant"] == "memory_s" and terms["collective_bytes"] == 0.0
