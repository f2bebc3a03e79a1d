"""Logical-axis sharding rules with divisibility fallbacks (port of
`repro.launch.sharding`, MaxText-style).

  * `ShardingRules` -- maps logical activation axes and parameter names to
    mesh axes (`repro_torch.launch.mesh.Mesh`), checking divisibility and
    falling back to replication (gemma3's 4 attention heads cannot shard
    over a 16-way ``model`` axis, so attention falls back while its
    6912-wide FFN still shards).
  * `param_sharding(params, rules, mode)` -- name-based parameter
    partitioning of the port's per-layer tree: column-parallel projections
    shard their output dim on ``model``, row-parallel (wo / w_down / w_out)
    their input dim, MoE expert stacks the expert dim, embeddings the vocab
    dim.
  * `constrain(x, *axes)` -- the reference's activation sharding hint
    (``with_sharding_constraint``), called by the port's models at the
    reference's sites: under `activate` with a `DeviceMesh`, a DTensor
    ``x`` is redistributed to the rules' spec of its shape (the
    collectives that takes are issued, and counted by the dry-run); a
    plain tensor, or no active rules, is returned as it is, so every
    unsharded path keeps its bits;
  * `fit_view(x, *shape)` / `fit_reshape` -- ``x.view(shape)`` for a
    DTensor whose sharded dimension the view splits unevenly (gemma3's 4
    heads out of a 16-way sharded ``H * Dh``) or merges into strided
    blocks: the dimensions the view merges or splits are gathered first,
    as GSPMD reshards before such a reshape; `like` lays a DTensor out as
    the cache it is written into;
  * under `activate` with a `DeviceMesh`, a product of a DTensor and a
    matrix is partitioned by hand (`_local_product`: rows, columns or
    contraction split, as GSPMD partitions a dot), and
    `register_missing_rules` gives DTensor the rules it lacks.

A partition spec is a tuple, one entry per leading dimension: ``None``, a
mesh axis name, or a tuple of names (`repro_torch.launch.mesh`).  The
dry-run reads the specs (`repro_torch.launch.specs`) and places its
inputs as DTensors by them; `repro_torch.launch.mesh.place` places
tensors by them across devices.
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Any, Sequence

import torch

from repro_torch import tree
from repro_torch.kernels.common import is_dtensor
from repro_torch.launch.mesh import Mesh, mesh_axis_sizes

__all__ = [
    "DEFAULT_RULES",
    "ShardingRules",
    "activate",
    "constrain",
    "param_sharding",
    "batch_axes",
    "logical_to_spec",
    "active",
    "fit_view",
    "fit_reshape",
    "like",
    "register_missing_rules",
    "checkpoint_contexts",
]

# Logical axis -> preferred mesh axes (joined), in priority order.
DEFAULT_RULES: dict[str, Sequence[Sequence[str]]] = {
    "batch": (("pod", "data"), ("data",), ("pod",)),
    # Megatron-SP-style: the residual stream sequence-sharded over 'model'
    # at block boundaries; unsharded when seq is not divisible (decode S=1).
    "seq": (("model",), ()),
    "seq_kv": ((),),
    "embed": ((),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "ffn": (("model",),),
    "vocab": (("model",),),
    "expert": (("model",),),
    "expert_group": (("pod", "data"), ("data",)),
    "lru": (("model",),),
    "head_dim": ((),),
    "state": (("model",),),
}

# Parameter name (regex on the path) -> partition kind.
_COL = r"(wq|wk|wv|w_gate|w_up|w_in|w_if|skip_gate|q_down|q_up|kv_down|k_up|v_up|w_r|w_i)$"
_ROW = r"(wo|w_down|w_out)$"
_EMBED = r"(embed|embed_\d+)$"

# FSDP leaves a leaf (or a unit position's stack of leaves) below this many
# elements replicated.
FSDP_MIN_SIZE = 1 << 20


class ShardingRules:
    def __init__(self, mesh: Mesh, overrides: dict | None = None):
        self.mesh = mesh
        self.sizes = mesh_axis_sizes(mesh)
        self.rules = dict(DEFAULT_RULES)
        if overrides:
            self.rules.update(overrides)

    def _axes_size(self, axes: Sequence[str]) -> int:
        s = 1
        for a in axes:
            s *= self.sizes.get(a, 1)
        return s

    def mesh_axes_for(self, logical: str | None, dim_size: int):
        """First preference whose mesh axes exist and divide dim_size."""
        if logical is None:
            return None
        for pref in self.rules.get(logical, ((),)):
            pref = tuple(a for a in pref if a in self.sizes)
            if not pref:
                continue
            if dim_size % self._axes_size(pref) == 0:
                return pref if len(pref) > 1 else pref[0]
        return None

    def spec(self, logical_axes: Sequence[str | None], shape) -> tuple:
        used: set[str] = set()
        out = []
        for name, dim in zip(logical_axes, shape):
            ax = self.mesh_axes_for(name, dim)
            flat = ax if isinstance(ax, tuple) else (ax,) if ax else ()
            if any(a in used for a in flat):
                ax = None  # a mesh axis may appear once per spec
            used.update(flat)
            out.append(ax)
        return tuple(out)


_ACTIVE: list[tuple[ShardingRules, Any]] = []


def _local_product(x, w):
    """``x @ w`` of a DTensor ``x`` (..., D) and a matrix DTensor ``w`` (D,
    F), partitioned on each mesh axis as GSPMD partitions a dot, and run
    on each device's blocks (`local_map`, so the backward is local too):

      * ``x`` split on its batch (first) dim: it stays split and ``w`` is
        gathered whole (FSDP's gather of a data-sharded weight);
      * else ``w`` split by columns: ``x``'s rows are gathered (Megatron-
        SP's gather of the sequence before a column-parallel product),
        the result split by columns;
      * else ``w`` split by rows, or ``x`` on its contraction dim: both
        split on it, the result a pending sum (row-parallel);
      * else ``x`` split on another row dim (the sequence) beside a
        replicated ``w``: the rows compute apart.

    Gradients come back as the placements dictate: a replicated operand
    beside a split one gets a pending sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    last = x.dim() - 1
    if not is_dtensor(w):
        w = DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim, run_check=False)
    x_pl, w_pl, out_pl, gx_pl, gw_pl = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if xp == Shard(0):
            x_pl.append(xp), w_pl.append(Replicate()), out_pl.append(xp)
            gx_pl.append(xp), gw_pl.append(Partial())
        elif wp == Shard(1):
            x_pl.append(Replicate()), w_pl.append(wp), out_pl.append(Shard(last))
            gx_pl.append(Partial()), gw_pl.append(wp)
        elif wp == Shard(0) or xp == Shard(last):
            x_pl.append(Shard(last)), w_pl.append(Shard(0)), out_pl.append(Partial())
            gx_pl.append(Shard(last)), gw_pl.append(Shard(0))
        elif isinstance(xp, Shard):
            x_pl.append(xp), w_pl.append(Replicate()), out_pl.append(xp)
            gx_pl.append(xp), gw_pl.append(Partial())
        else:
            x_pl.append(Replicate()), w_pl.append(Replicate()), out_pl.append(Replicate())
            gx_pl.append(Replicate()), gw_pl.append(Replicate())
    return local_map(torch.matmul, out_placements=(tuple(out_pl),),
                     in_placements=(tuple(x_pl), tuple(w_pl)),
                     in_grad_placements=(tuple(gx_pl), tuple(gw_pl)), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


class _PartitionedProducts(torch.overrides.TorchFunctionMode):
    """Inside, a product (``@``, `torch.matmul`) of a DTensor of rank 3 or
    more and a matrix runs as `_local_product`, partitioned as GSPMD
    partitions a dot: the product folds the leading dimensions into rows,
    which DTensor cannot always carry a split inner dimension through."""

    _PRODUCTS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func in self._PRODUCTS and len(args) == 2 and not kwargs and is_dtensor(args[0])
                and args[0].dim() >= 3 and args[1].dim() == 2):
            return _local_product(*args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def activate(rules: ShardingRules, device_mesh=None):
    """Make ``rules`` the active rules inside (the innermost wins), with
    the `torch.distributed.DeviceMesh` that DTensors are laid out on
    (`repro_torch.launch.mesh.device_mesh`; None: `constrain` does
    nothing).  With a device mesh, a product of a DTensor and a matrix is
    partitioned by hand (`_PartitionedProducts`)."""
    _ACTIVE.append((rules, device_mesh))
    try:
        if device_mesh is None:
            yield rules
        else:
            with _PartitionedProducts():
                yield rules
    finally:
        _ACTIVE.pop()


def checkpoint_contexts():
    """`torch.utils.checkpoint`'s ``context_fn``: the recompute (run by the
    backward, outside `activate`'s own context) partitions products as the
    forward did, under an active device mesh; nothing otherwise."""
    recompute = _PartitionedProducts() if active()[1] is not None else contextlib.nullcontext()
    return contextlib.nullcontext(), recompute


def active() -> tuple[ShardingRules | None, Any]:
    """The innermost active (rules, device mesh), or (None, None)."""
    return _ACTIVE[-1] if _ACTIVE else (None, None)


def constrain(x, *logical_axes):
    """The reference's sharding hint by logical axes: a DTensor ``x``
    redistributed to the active rules' spec of its shape (dimensions past
    the axes given replicated); anything else, or no active device mesh,
    ``x`` itself."""
    rules, mesh = active()
    if mesh is None or not is_dtensor(x):
        return x
    from repro_torch.launch.mesh import placements

    want = placements(rules.spec(logical_axes, x.shape), rules.mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def _kept_dims(old: tuple, new: tuple) -> set[int]:
    """The dimensions of ``old`` that a view to ``new`` keeps whole (each
    alone in its group of equal products, of the same size as one new
    dimension), size-1 dimensions aside."""
    kept, i, j = set(), 0, 0
    while i < len(old) and j < len(new):
        gi, gj, a, b = [i], [j], old[i], new[j]
        while a != b:
            if a < b:
                i += 1
                gi.append(i)
                a *= old[i]
            else:
                j += 1
                gj.append(j)
                b *= new[j]
        real_i = [d for d in gi if old[d] != 1]
        real_j = [d for d in gj if new[d] != 1]
        if len(real_i) == 1 and len(real_j) == 1:
            kept.add(real_i[0])
        i, j = i + 1, j + 1
    return kept


def _strided(placements) -> bool:
    """Whether a placement splits a dimension into strided blocks (what
    DTensor makes of a merge whose inner dimension is split), which no
    partition spec names and whose redistribution DTensor plans by search."""
    return any(type(p).__name__ == "_StridedShard" for p in placements)


def _fit_once(x, shape: tuple, method: str):
    from torch.distributed.tensor import Replicate, Shard

    try:
        out = getattr(x, method)(*shape)
        if not _strided(out.placements):
            return out
    except RuntimeError:
        out = None
    known = math.prod(n for n in shape if n != -1)
    new = tuple(x.numel() // known if n == -1 else n for n in shape)
    kept = _kept_dims(tuple(x.shape), new)
    fixed = tuple(Replicate() if isinstance(p, Shard) and p.dim not in kept else p
                  for p in x.placements)
    if fixed == tuple(x.placements):
        if out is None:
            raise RuntimeError(f"fit_view: {tuple(x.shape)} {x.placements} -> {shape}")
        return out
    return getattr(x.redistribute(x.device_mesh, fixed), method)(*shape)


class _FitView(torch.autograd.Function):
    """A DTensor view whose backward views the gradient back the same way
    (its placements may differ from the forward's)."""

    @staticmethod
    def forward(ctx, x, shape, method):
        ctx.shape = tuple(x.shape)
        return _fit_once(x, shape, method)

    @staticmethod
    def backward(ctx, grad):
        return _fit_once(grad, ctx.shape, "reshape"), None, None


def _fit(x, shape: tuple, method: str):
    if not is_dtensor(x):
        return getattr(x, method)(*shape)
    return _FitView.apply(x, shape, method)


def fit_view(x, *shape):
    """``x.view(*shape)``; for a DTensor whose placements DTensor cannot
    carry through the view (a sharded dimension split unevenly), or only
    as strided blocks (a merge whose inner dimension is split), the view
    of ``x`` with every mesh axis that shards a dimension the view does
    not keep whole made ``Replicate`` first."""
    return _fit(x, shape, "view")


def fit_reshape(x, *shape):
    """``x.reshape(*shape)``, DTensors as `fit_view`."""
    return _fit(x, shape, "reshape")


def like(x, ref):
    """``x`` laid out as ``ref`` where both are DTensors (before an
    in-place write of ``x`` into ``ref``); else ``x``."""
    if is_dtensor(x) and is_dtensor(ref) and tuple(x.placements) != tuple(ref.placements):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


_REGISTERED: list[bool] = []


def register_missing_rules() -> None:
    """Give DTensor the sharding rules the port's models need that it
    lacks or gets wrong (once a process): ``log_sigmoid_backward`` (the
    mLSTM forget gate's backward), elementwise -- any dimension split
    alike on every operand, or all replicated -- and ``log_sigmoid_forward``
    as elementwise with its scratch buffer marked replicated and never
    moved (its global shape differs by device: empty on a card and in
    DTensor's shape propagation, whole on the host), so each device's
    backward reads its own."""
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten

    @register_sharding(aten.log_sigmoid_forward.default)
    def _log_sigmoid_forward(x):
        out = [([Replicate(), Replicate()], [Replicate()])]
        for d in range(len(x.shape)):
            out.append(([Shard(d), Replicate()], [Shard(d)]))
        return out

    @register_sharding(aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad, x, buffer):
        out = [([Replicate()], [Replicate(), Replicate(), Replicate()])]
        for d in range(len(x.shape)):
            out.append(([Shard(d)], [Shard(d), Shard(d), Replicate()]))
        return out

    _REGISTERED.append(True)


def logical_to_spec(rules: ShardingRules, logical_axes, shape) -> tuple:
    return rules.spec(logical_axes, shape)


def _stack_sizes(cfg, num_layers: int) -> list[int]:
    """Per layer, how many layers the reference's scan stacks with it: the
    number of whole units for a layer of one, 1 for a remainder layer."""
    if cfg is None:
        return [1] * num_layers
    u = len(tuple(cfg.layer_unit))
    reps = cfg.num_layers // u
    return [reps if i < reps * u else 1 for i in range(num_layers)]


def param_sharding(params: dict[str, Any], rules: ShardingRules, mode: str = "tp",
                   cfg=None) -> dict[str, Any]:
    """Partition specs for the port's parameter tree by name-based rules, a
    tree of tuples shaped like ``params`` (any leaves with a ``shape``:
    tensors, meta tensors, `specs.SDS`).

    mode="tp"   -- model-axis-only sharding (column/row parallel, EP).
    mode="fsdp" -- additionally shards each large leaf's biggest free dim
                   over 'data' (ZeRO-3 semantics).

    The reference stacks a unit position's layers for its scan and gives
    the stack the layer's spec behind a leading ``None``; the port's
    per-layer leaf takes the layer's spec.  Given ``cfg``, FSDP's size
    threshold reads the stack's size as the reference's does (the stack is
    gathered at once); without it, the leaf's own.  Rules overrides:
    ``param_tp="off"`` replicates block parameters (embeddings stay
    vocab-sharded), ``mlstm_state_shard="off"`` column-shards mLSTM's q/k
    projections and gates as any other.
    """
    if mode not in ("tp", "fsdp"):
        raise ValueError(mode)
    tp = rules.sizes.get("model", 1)
    replicate_blocks = rules.rules.get("param_tp") == "off"
    data_sz = rules.sizes.get("data", 1)

    def spec_for(path: str, shape: tuple) -> tuple:
        ndim = len(shape)
        if ndim == 0:
            return ()
        if re.search(_EMBED, path):
            if shape[0] % tp == 0:
                return ("model", None)
            return (None,) * ndim
        if replicate_blocks:
            return (None,) * ndim
        if "mix/" in path and re.search(r"(wq|wk|w_if)$", path) and not (
            rules.rules.get("mlstm_state_shard") == "off"
        ):
            # mLSTM v-dim state sharding: q/k (and gates) computed
            # redundantly from replicated projections, wv/skip_gate
            # column-sharded and wo row-sharded.
            return (None,) * ndim
        if ndim == 3 and re.search(r"(w_gate|w_up|w_down)$", path):
            # MoE expert stack (E, D, F): expert parallelism.
            if shape[0] % tp == 0:
                return ("model", None, None)
            return (None, None, None)
        if ndim == 3 and path.endswith("r"):
            # sLSTM recurrent kernel (H, Dh, 4Dh).
            if shape[2] % tp == 0:
                return (None, None, "model")
            return (None, None, None)
        if re.search(_COL, path) and ndim == 2:
            if shape[1] % tp == 0:
                return (None, "model")
            return (None, None)
        if re.search(_ROW, path) and ndim == 2:
            if shape[0] % tp == 0:
                return ("model", None)
            return (None, None)
        if ndim == 2 and path.endswith("conv"):
            if shape[1] % tp == 0:
                return (None, "model")
            return (None, None)
        if ndim == 1 and path.endswith("lambda") and shape[0] % tp == 0:
            return ("model",)
        return (None,) * ndim

    def fsdp_extend(spec: tuple, shape: tuple, size: int, path: str) -> tuple:
        if size < FSDP_MIN_SIZE or data_sz == 1:
            return spec
        if re.search(_EMBED, path):
            # Embeddings stay vocab-sharded only (the logits head would
            # gather a data-sharded feature dim whole).
            return spec
        axes = list(spec) + [None] * (len(shape) - len(spec))
        # Largest unsharded dim divisible by the data axis.
        best, best_dim = -1, -1
        for i, (ax, dim) in enumerate(zip(axes, shape)):
            if ax is None and dim % data_sz == 0 and dim > best:
                best, best_dim = dim, i
        if best_dim >= 0:
            axes[best_dim] = "data"
        return tuple(axes)

    stacks = _stack_sizes(cfg, len(params.get("layers", [])))
    specs = []
    for path, leaf in zip(tree.paths(params), tree.leaves(params)):
        shape = tuple(leaf.shape)
        spec = spec_for(path, shape)
        if mode == "fsdp":
            parts = path.split("/")
            stack = stacks[int(parts[1])] if parts[0] == "layers" else 1
            spec = fsdp_extend(spec, shape, stack * math.prod(shape), path)
        specs.append(spec)
    return tree.unflatten(params, specs)


def batch_axes(rules: ShardingRules, global_batch: int):
    """Mesh axes to shard the batch dim over, honoring divisibility."""
    return rules.mesh_axes_for("batch", global_batch)
