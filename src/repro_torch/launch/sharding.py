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
  * `constrain(x, *axes)` -- the reference's activation sharding hint.  On
    one card there is no partitioner behind it: it returns ``x``, and the
    port's models do not call it.

A partition spec is a tuple, one entry per leading dimension: ``None``, a
mesh axis name, or a tuple of names (`repro_torch.launch.mesh`).  The
dry-run reads the specs (`repro_torch.launch.specs`); placing tensors by
them across cards is ROADMAP item 10b (c).
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Any, Sequence

from repro_torch import tree
from repro_torch.launch.mesh import Mesh, mesh_axis_sizes

__all__ = [
    "DEFAULT_RULES",
    "ShardingRules",
    "activate",
    "constrain",
    "param_sharding",
    "batch_axes",
    "logical_to_spec",
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


_ACTIVE: list[ShardingRules] = []


@contextlib.contextmanager
def activate(rules: ShardingRules):
    """Make ``rules`` the active rules inside (the innermost wins)."""
    _ACTIVE.append(rules)
    try:
        yield rules
    finally:
        _ACTIVE.pop()


def constrain(x, *logical_axes):
    """The reference's sharding hint by logical axes; ``x`` itself on one
    card."""
    return x


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
