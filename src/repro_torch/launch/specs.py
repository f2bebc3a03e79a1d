"""Meta-tensor input specs per (architecture x shape) cell (port of
`repro.launch.specs`).

The dry-run (`repro_torch.launch.dryrun`) runs the step functions on these
stand-ins: ``meta`` tensors of the exact shapes and dtypes (no values, no
allocation), each paired with its partition spec (`SDS`).  Per-device
bytes follow from the spec's shard shape (`device_bytes`).  Modality
frontends are stubs, as in the reference: [audio] gets EnCodec token
streams, [vlm] and [audio] precomputed encoder embeddings.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.roofline import HW
from repro_torch.launch.sharding import ShardingRules, param_sharding
from repro_torch.models.model import Model, on_meta

__all__ = [
    "SDS",
    "sds",
    "values",
    "spec_leaves",
    "device_bytes",
    "batch_specs",
    "decode_batch_specs",
    "param_specs",
    "auto_mode",
    "opt_specs",
    "cache_specs",
    "dtensors",
]


@dataclasses.dataclass(frozen=True)
class SDS:
    """A ``meta`` tensor and its partition spec."""

    value: torch.Tensor
    spec: tuple

    @property
    def shape(self) -> tuple:
        return tuple(self.value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype

    def shard_shape(self, sizes: dict[str, int]) -> tuple:
        """One device's block of the tensor on a mesh of axis ``sizes``."""
        out = list(self.shape)
        for i, ax in enumerate(self.spec):
            for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                if out[i] % sizes[a]:
                    raise ValueError(f"dim {i} of {self.shape} does not split over {ax}")
                out[i] //= sizes[a]
        return tuple(out)


def sds(shape, dtype: torch.dtype, spec: tuple = ()) -> SDS:
    return SDS(torch.empty(tuple(shape), dtype=dtype, device="meta"), tuple(spec))


def _map(fn, node):
    """``fn`` over the `SDS` leaves of dicts, lists and tuples."""
    if isinstance(node, dict):
        return {k: _map(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map(fn, v) for v in node)
    return fn(node)


def spec_leaves(node) -> list[SDS]:
    """The `SDS` leaves of dicts, lists and tuples, in order."""
    if isinstance(node, dict):
        return [s for v in node.values() for s in spec_leaves(v)]
    if isinstance(node, (list, tuple)):
        return [s for v in node for s in spec_leaves(v)]
    return [node] if isinstance(node, SDS) else []


def dtensors(specs, device_mesh, device: str | torch.device = "meta"):
    """A tree of `SDS` as DTensors on ``device_mesh`` (dicts, lists and
    tuples kept): each the global shape and dtype of its `SDS`, placed by
    its spec (`repro_torch.launch.mesh.placements`), its local tensor of
    the spec's shard shape -- on ``meta`` (nothing allocated), or zeros on
    ``device``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import Mesh, placements

    mesh = Mesh(tuple(device_mesh.mesh_dim_names), tuple(device_mesh.mesh.shape))
    sizes = dict(zip(mesh.axis_names, mesh.shape))

    def one(s):
        if not isinstance(s, SDS):
            return s
        local = torch.zeros(s.shard_shape(sizes), dtype=s.dtype, device=device)
        return DTensor.from_local(local, device_mesh, placements(s.spec, mesh),
                                  run_check=False, shape=s.value.shape,
                                  stride=s.value.stride())

    return _map(one, specs)


def values(specs):
    """The meta tensors of a tree of `SDS` (dicts, lists and tuples kept)."""
    return _map(lambda s: s.value if isinstance(s, SDS) else s, specs)


def device_bytes(specs, rules: ShardingRules) -> int:
    """Bytes one device holds of a tree of `SDS`, by their shard shapes."""
    return sum(math.prod(s.shard_shape(rules.sizes)) * s.value.element_size()
               for s in spec_leaves(specs))


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, rules: ShardingRules, with_labels: bool):
    """Token/label/frontend specs for a train or prefill batch."""
    GB, S = shape.global_batch, shape.seq_len
    baxes = rules.mesh_axes_for("batch", GB)
    tshape = (GB, S, cfg.num_codebooks) if cfg.num_codebooks else (GB, S)
    tspec = (baxes, *([None] * (len(tshape) - 1)))
    batch = {"tokens": sds(tshape, torch.int32, tspec)}
    if with_labels:
        batch["labels"] = sds(tshape, torch.int32, tspec)
    if cfg.encoder_dim:
        batch["encoder"] = sds((GB, cfg.encoder_len, cfg.encoder_dim), torch.bfloat16,
                               (baxes, None, None))
    return batch


def decode_batch_specs(cfg: ModelConfig, shape: ShapeSpec, rules: ShardingRules):
    GB = shape.global_batch
    baxes = rules.mesh_axes_for("batch", GB)
    tshape = (GB, 1, cfg.num_codebooks) if cfg.num_codebooks else (GB, 1)
    batch = {"tokens": sds(tshape, torch.int32, (baxes, *([None] * (len(tshape) - 1))))}
    if cfg.encoder_dim:
        batch["encoder"] = sds((GB, cfg.encoder_len, cfg.encoder_dim), torch.bfloat16,
                               (baxes, None, None))
    return batch


def param_specs(model: Model, rules: ShardingRules, mode: str = "tp", dtype=None):
    """Parameter specs shaped like the port's tree, in the trainer's f32
    (the reference's ``param_dtype``).  ``dtype`` overrides every leaf's
    storage dtype (serving casts weights to bf16); ``mode`` picks tp vs
    fsdp partitioning (`sharding.param_sharding`)."""
    shapes = model.abstract_params(masters=True)
    shards = param_sharding(shapes, rules, mode=mode, cfg=model.cfg)
    return tree.map_leaves(lambda s, sh: sds(s.shape, dtype or s.dtype, sh), shapes, shards)


def auto_mode(model: Model, rules: ShardingRules, kind: str,
              hbm_bytes: float = HW.hbm_bytes) -> str:
    """tp vs fsdp: fsdp when the per-device state would not fit half of
    ``hbm_bytes`` (the card's memory by default; the reference's is a 16
    GiB v5e's) under model-axis-only sharding (train state = 12 bytes a
    parameter, f32 parameters and moments; serve state = 2 bytes a
    parameter, bf16)."""
    n = sum(t.numel() for t in tree.leaves(model.abstract_params()))
    tp = rules.sizes.get("model", 1)
    bytes_per = 12.0 if kind == "train" else 2.0
    return "fsdp" if n * bytes_per / tp > hbm_bytes / 2 else "tp"


def opt_specs(model: Model, rules: ShardingRules, optimizer, zero1: bool = False,
              mode: str = "tp"):
    """Optimizer-state specs: f32 ``m`` and ``v`` (and ``master`` where
    the optimizer keeps master weights) shaped like the parameters, and the
    step ``count``.  ``zero1=True`` additionally shards each moment on its
    first replicated dim that the data axis divides.  (The reference
    searches its stacked leaves, whose stack axis comes first: where the
    stack divides the data axis it shards whole layers, the port its
    leaf's first such dim, the same bytes a device.)"""
    p_specs = param_specs(model, rules, mode=mode)
    data_sz = rules.sizes.get("data", 1)

    def moment_spec(ps: SDS) -> SDS:
        spec = list(ps.spec) + [None] * (len(ps.shape) - len(ps.spec))
        if zero1:
            for i, (ax, dim) in enumerate(zip(spec, ps.shape)):
                if ax is None and dim % data_sz == 0 and dim >= data_sz:
                    spec[i] = "data"
                    break
        return sds(ps.shape, torch.float32, tuple(spec) if zero1 else ps.spec)

    out = {
        "m": tree.map_leaves(moment_spec, p_specs),
        "v": tree.map_leaves(moment_spec, p_specs),
        "count": sds((), torch.int32, ()),
    }
    if getattr(optimizer, "master_weights", False):
        out["master"] = tree.map_leaves(moment_spec, p_specs)
    return out


_SEQ_LEAVES = re.compile(r"(k|v|c_kv|k_rope)$")


def cache_specs(model: Model, rules: ShardingRules, batch: int, max_len: int):
    """Decode-cache specs, shaped like `Model.init_cache`.

    Per-leaf policy: shard the batch dim over the batch axes when divisible;
    otherwise (long_500k: batch 1) shard the sequence dim of KV/latent
    caches over 'data' (context parallelism).  The trailing feature dim
    (heads / latent rank / state width) shards over 'model' when divisible.
    """
    with on_meta():
        shapes = model.init_cache(batch, max_len)
    baxes = rules.mesh_axes_for("batch", batch)
    bsize = rules._axes_size(baxes if isinstance(baxes, tuple) else (baxes,)) if baxes else 1
    data_sz = rules.sizes.get("data", 1)
    model_sz = rules.sizes.get("model", 1)

    def spec_for(name: str, leaf: torch.Tensor) -> SDS:
        spec = [None] * leaf.dim()
        seq_leaf = bool(_SEQ_LEAVES.search(name))
        if leaf.dim() > 0 and baxes is not None and leaf.shape[0] % max(bsize, 1) == 0:
            spec[0] = baxes
        elif leaf.dim() > 1 and seq_leaf and leaf.shape[1] % data_sz == 0:
            spec[1] = "data"  # context parallelism for batch=1 decode
        if seq_leaf and leaf.dim() == 4 and leaf.shape[2] % model_sz == 0:
            spec[2] = "model"  # kv heads of (B, S, Hkv, Dh)
        elif leaf.dim() >= 2 and leaf.shape[-1] % model_sz == 0:
            spec[-1] = "model"
        return SDS(leaf, tuple(spec))

    def walk(node, name: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, str(i)) for i, v in enumerate(node))
        return spec_for(name, node)

    return walk(shapes, "")
