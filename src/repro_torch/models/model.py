"""Model assembly (port of `repro.models.model`: every layer kind of the
reference's architectures).

A model is a stack of residual blocks described by ``cfg.layer_kinds``
(gemma3 = 5 x "local" + 1 x "attn" repeating; xlstm = 7 x "mlstm" + 1 x
"slstm"; recurrentgemma = "rglru", "rglru", "local"; llama-3.2-vision =
"cross" + 4 x "attn").  The reference groups layers into repeating units
and runs ``lax.scan`` over stacked parameters to keep its compiled program
small; the port runs eagerly, so layers are a Python loop over a per-layer
parameter list (``params["layers"]``), and the cache is a per-layer list of
each layer's own state: ``{"k", "v"}`` for attention and for a cross
layer's self-attention, ``{"c_kv", "k_rope"}`` for MLA (written in place),
``(S, n)`` for mLSTM, ``(c, n, h)`` for sLSTM and ``(h, conv window)`` for
RG-LRU (replaced by the new state at every call).

Kinds: "attn" (global) and "local" (sliding window) attention, "mla"
(latent attention), "cross" (self-attention, then cross-attention over
``batch["encoder"]``) and "rglru", each followed by the FFN -- the gated
FFN, or the mixture of experts (`repro_torch.models.moe`) where
``cfg.num_experts`` is set; "mlstm" and "slstm" carry their own
projections and have no FFN (``d_ff = 0`` is accepted for them only).
With ``cfg.num_codebooks`` (audio) the tokens are (B, S, C): the
embedding sums one table per codebook (``embed_{c}``), the head gives (B,
S, C, V) logits and the loss averages over (B, S, C) labels.

Training (`Model.loss`) runs every kind: a trainer holds f32 masters
(``init(..., masters=True)``), cast to the compute dtype at every use as
the reference casts them, and autograd differentiates through the casts,
through the flash and mLSTM kernels' backwards (each recomputes through
its plain twin, as the reference's jnp routes do), through
`layers.chunked_attention`'s backward, the experts' router and gates, the
sLSTM loop and the RG-LRU scan.  Where autograd records, each unit of
``cfg.layer_unit`` (the reference's scanned units: layers ``r * u`` to
``r * u + u - 1`` for ``r < num_layers // u``) runs under
`torch.utils.checkpoint` and is recomputed in the backward, as the
reference's ``jax.checkpoint(unit_body)``: autograd holds the residual
stream at each unit boundary and one unit's internals at a time; the
layers after the last whole unit run unwrapped, as the reference's loop
after its scan.

The reference's sharding hints (`repro_torch.launch.sharding.constrain`)
sit at its sites: the embedding, each block's input, the head's logits,
the loss chunk's input and one-hot labels.  They act on DTensors only
(parameters and inputs placed on a `DeviceMesh`, the dry-run's partition);
plain tensors pass through them untouched.

On the ``meta`` device (`build_model(cfg, "meta")`) the model runs with
no values: `abstract_params` gives its parameters' shapes and dtypes, and
every step runs as on the card, each kernel's meta route giving outputs
of the right shape (the launch tooling's dry-run, `repro_torch.launch`).
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.common import is_dtensor
from repro_torch.launch.sharding import checkpoint_contexts, constrain
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import xlstm as X

__all__ = ["Model", "build_model", "on_meta", "param_count", "param_bytes"]

# Layer kinds the port runs (every kind of the reference's); xLSTM's have
# no FFN.
_PORTED_KINDS = ("attn", "local", "mla", "cross", "rglru", "mlstm", "slstm")
_NO_FFN_KINDS = ("mlstm", "slstm")
# Matrices read in f32, so held in f32 for serving too.
_F32_MATRICES = ("r",) + R.F32_WEIGHTS


class on_meta(TorchDispatchMode):
    """Inside, every operation that makes or copies a tensor onto a device
    makes it on ``meta``, and every draw takes no generator: code written
    for a real device runs with shapes and dtypes only."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        if kwargs.get("generator") is not None:
            kwargs["generator"] = None
        return func(*args, **kwargs)


class Model:
    """A decoder of any of the reference's families on one device.  Built
    by `build_model`."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.dtype = getattr(torch, cfg.compute_dtype)
        # The reference scales embeddings by a Python float in the compute
        # dtype: the factor is rounded to that dtype first.
        self._embed_scale = float(torch.tensor(cfg.d_model**0.5, dtype=self.dtype))

    # ---------------------------------------------------------------- init
    def abstract_params(self, masters: bool = False) -> dict[str, Any]:
        """The parameters `init` and `cast` give, as ``meta`` tensors of the
        same shapes and dtypes, with no draw: `init` runs with every
        factory and copy sent to the meta device (`on_meta`)."""
        with on_meta():
            return Model(self.cfg, torch.device("cpu")).init(torch.Generator(), masters)

    def init(self, generator: torch.Generator, masters: bool = False) -> dict[str, Any]:
        """Random parameters from ``generator``, which must be on the
        model's device: the reference's distributions (matrices N(0,
        1/fan_in), expert stacks likewise, sLSTM's ``r`` N(0, 1/head_dim),
        RG-LRU's as `rglru.rglru_init` draws them, embeddings N(0,
        0.02^2), norms zero), drawn in f32 and held as `cast` holds them.
        A server's layers are cast one by one as they are drawn (and the
        expert stacks one by one), so the f32 draw of one layer is all
        that is ever held beside the model."""
        if generator.device.type != self.device.type:
            raise ValueError(
                f"init: generator on {generator.device}, model on {self.device}"
            )
        cfg = self.cfg
        stacks = torch.float32 if masters else self.dtype
        layers = []
        for kind in cfg.layer_kinds:
            if kind == "mlstm":
                layer = {"mix": X.mlstm_init(generator, cfg)}
            elif kind == "slstm":
                layer = {"mix": X.slstm_init(generator, cfg)}
            elif kind == "rglru":
                layer = {"mix": R.rglru_init(generator, cfg)}
            elif kind == "mla":
                layer = {"attn": L.mla_init(generator, cfg)}
            else:
                layer = {"attn": L.attn_init(generator, cfg)}
            if kind == "cross":
                layer["cross"] = L.cross_init(generator, cfg)
            if kind not in _NO_FFN_KINDS:
                layer["ffn"] = (M.moe_init(generator, cfg, stacks) if cfg.num_experts
                                else L.ffn_init(generator, cfg))
            layers.append(self._cast_layer(layer, masters))
        params = {"layers": layers, "final_norm": torch.zeros(cfg.d_model, device=self.device)}
        for name in self._embed_names():
            params[name] = L.embed_init(generator, cfg.vocab_size, cfg.d_model) * 0.02
        return self.cast(params, masters)

    def _embed_names(self) -> list[str]:
        """``embed``, or ``embed_0`` .. ``embed_{C-1}`` with C codebooks."""
        C = self.cfg.num_codebooks
        return [f"embed_{c}" for c in range(C)] if C else ["embed"]

    def _hold(self, t: torch.Tensor, name: str, masters: bool) -> torch.Tensor:
        keep = masters or t.dim() == 1 or name in _F32_MATRICES
        return t.to(device=self.device, dtype=torch.float32 if keep else self.dtype)

    def _cast_layer(self, layer: dict, masters: bool) -> dict:
        return {blk: {name: self._hold(t, name, masters) for name, t in p.items()}
                for blk, p in layer.items()}

    def cast(self, params: dict[str, Any], masters: bool = False) -> dict[str, Any]:
        """All on the model's device.  For serving (``masters=False``):
        matrices, expert stacks, the router and the embeddings in the
        compute dtype; vectors (norm weights, RG-LRU's Lambda), sLSTM's
        recurrent kernel ``r`` and RG-LRU's ``w_r`` and ``w_i`` in f32, as
        the reference reads them.  For training (``masters=True``): every
        leaf in f32, the reference's ``param_dtype``, cast at each use."""
        return {
            name: ([self._cast_layer(layer, masters) for layer in value] if name == "layers"
                   else self._hold(value, name, masters))
            for name, value in params.items()
        }

    # ------------------------------------------------------------ backbone
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S), or (B, S, C) with codebooks: the sum of each
        codebook's lookup, added in the compute dtype in codebook order."""
        lookup = _lookup if is_dtensor(tokens) else (lambda table, t: table[t])
        if self.cfg.num_codebooks:
            x = lookup(params["embed_0"].to(self.dtype), tokens[..., 0])
            for c in range(1, self.cfg.num_codebooks):
                x = x + lookup(params[f"embed_{c}"].to(self.dtype), tokens[..., c])
        else:
            x = lookup(params["embed"].to(self.dtype), tokens)
        return x * self._embed_scale

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        """Logits in the compute dtype against the tied embedding: (B, S,
        V), or (B, S, C, V) with codebooks."""
        x = L.rms_norm(x, params["final_norm"])
        if self.cfg.num_codebooks:
            logits = torch.stack(
                [x @ params[n].to(self.dtype).T for n in self._embed_names()], dim=2)
        else:
            logits = x @ params["embed"].to(self.dtype).T
        return constrain(logits, "batch", "seq", *([None] * (logits.dim() - 3)), "vocab")

    def _head_params(self, params) -> dict:
        return {n: params[n] for n in ("final_norm", *self._embed_names())}

    def forward(self, params, batch, cache=None, pos: int = 0):
        """batch['tokens']: (B, S) int, (B, S, C) with codebooks;
        batch['encoder']: (B, T, encoder_dim) where the config has cross
        layers.  Returns (logits, cache); with a cache, K/V (or MLA's
        latents) of positions pos .. pos + S - 1 are written into it in
        place, and each recurrent layer's entry is replaced by its state
        after position pos + S - 1."""
        x = self._hidden(params, batch, cache, pos)
        return self._head(params, x), cache

    def _hidden(self, params, batch, cache=None, pos: int = 0) -> torch.Tensor:
        """The residual stream after the last layer, (B, S, D).  Where
        autograd records (a parameter requires grad) and there is no cache,
        each whole unit of ``cfg.layer_unit`` runs under `checkpoint`."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        B, S = tokens.shape[:2]
        enc = batch.get("encoder")
        if enc is not None:
            enc = torch.as_tensor(enc, device=self.device)
        x = constrain(self._embed(params, tokens), "batch", "seq", "embed")
        positions = (pos + torch.arange(S, device=self.device))[None, :].expand(B, S)
        u = len(tuple(cfg.layer_unit))
        remat = cache is None and torch.is_grad_enabled() and any(
            t.requires_grad for t in tree.leaves(params["layers"]))
        rest = cfg.num_layers // u * u if remat else 0
        for lo in range(0, rest, u):
            x = checkpoint(self._layers, params["layers"][lo : lo + u], x, positions, enc, lo,
                           use_reentrant=False, context_fn=checkpoint_contexts)
        return self._layers(params["layers"][rest:], x, positions, enc, rest, cache, pos)

    def _layers(self, layers: list, x: torch.Tensor, positions: torch.Tensor, enc,
                first: int, cache=None, pos: int = 0) -> torch.Tensor:
        """Layers ``first``, ``first + 1``, ... (their parameters ``layers``)
        over the residual stream ``x``."""
        cfg = self.cfg
        ffn = M.moe_apply if cfg.num_experts else L.ffn_apply
        for i, p in enumerate(layers, start=first):
            kind = cfg.layer_kinds[i]
            x = constrain(x, "batch", "seq", "embed")
            state = None if cache is None else cache[i]
            if kind == "mlstm":
                delta, state = X.mlstm_apply(p["mix"], x, cfg, state=state, chunk=cfg.mlstm_chunk)
            elif kind == "slstm":
                delta, state = X.slstm_apply(p["mix"], x, cfg, state=state)
            elif kind == "rglru":
                delta, state = R.rglru_apply(p["mix"], x, cfg, state=state)
            else:
                window = cfg.window_size if kind == "local" else None
                apply = L.mla_apply if kind == "mla" else L.attn_apply
                delta, state = apply(
                    p["attn"], x, cfg, positions=positions, cache=state, pos=pos, window=window,
                )
            if cache is not None:
                cache[i] = state
            x = x + delta
            if kind == "cross":
                x = x + L.cross_apply(p["cross"], x, enc, cfg)
            if "ffn" in p:
                x = x + ffn(p["ffn"], x, cfg)
        return x

    # ---------------------------------------------------------------- loss
    def _xent(self, head, x_c, y_c) -> torch.Tensor:
        """Summed token cross entropy of one chunk: logits in the compute
        dtype, their logsumexp in f32, the label's logit read in the
        compute dtype and then widened (the reference's one-hot sum)."""
        logits = self._head(head, x_c)
        lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
        ll = logits.gather(-1, y_c[..., None])[..., 0].to(torch.float32)
        return (lse - ll).sum()

    def loss(self, params, batch, seq_chunk: int = 512) -> torch.Tensor:
        """Mean token cross entropy (f32 scalar) of batch['tokens'] against
        batch['labels'], both (B, S) ((B, S, C) with codebooks).

        As the reference: chunks of ``seq_chunk`` positions, each
        recomputed in the backward (`torch.utils.checkpoint`, the
        reference's ``jax.checkpoint``), so the (B, S, vocab) logits are
        never held whole; the whole sequence in one chunk when ``S`` is not
        a multiple of the chunk; the sum divided by the label count.
        """
        x = self._hidden(params, batch)
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        S = labels.shape[1]
        c = min(S, seq_chunk)
        head = self._head_params(params)
        if S % c:
            return self._xent(head, x, labels) / labels.numel()
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(0, S, c):
            total = total + checkpoint(
                self._xent, head, x[:, i : i + c], labels[:, i : i + c],
                use_reentrant=False, context_fn=checkpoint_contexts,
            )
        return total / labels.numel()

    def init_cache(self, batch: int, max_len: int) -> list:
        """Per layer: zero K/V of ``max_len`` positions for attention (a
        cross layer's self-attention), zero latents for MLA, the zero
        recurrent state for mLSTM, sLSTM and RG-LRU (f32, any length)."""
        def one(kind: str):
            if kind == "mla":
                return L.mla_init_cache(self.cfg, batch, max_len, self.dtype, self.device)
            if kind == "mlstm":
                return X.mlstm_init_state(self.cfg, batch, self.device)
            if kind == "slstm":
                return X.slstm_init_state(self.cfg, batch, self.device)
            if kind == "rglru":
                return R.rglru_init_state(self.cfg, batch, self.device)
            return L.attn_init_cache(self.cfg, batch, max_len, self.dtype, self.device)

        return [one(kind) for kind in self.cfg.layer_kinds]

    def _sharded_cache(self, device_mesh, batch: int, max_len: int) -> list:
        """`init_cache` as DTensors on ``device_mesh``, placed by the
        cache's partition specs under the active rules (`launch.specs.
        cache_specs`; the mesh's default rules when none are active)."""
        from repro_torch.launch.mesh import Mesh
        from repro_torch.launch.sharding import ShardingRules, active
        from repro_torch.launch.specs import cache_specs, dtensors

        rules = active()[0] or ShardingRules(
            Mesh(tuple(device_mesh.mesh_dim_names), tuple(device_mesh.mesh.shape)))
        return dtensors(cache_specs(self, rules, batch, max_len), device_mesh, self.device)

    def prefill(self, params, batch):
        """(the last position's logits, the cache of the whole prompt): the
        head runs on the last position only."""
        tokens = batch["tokens"]
        if is_dtensor(tokens):
            B, S = tokens.shape[:2]
            cache = self._sharded_cache(tokens.device_mesh, B, S)
        else:
            cache = self.init_cache(len(tokens), len(tokens[0]))
        x = self._hidden(params, batch, cache, 0)
        return self._head(params, x[:, -1:])[:, 0], cache

    def decode_step(self, params, cache, batch, pos: int):
        """batch['tokens']: (B, 1) ((B, 1, C) with codebooks); pos: the new
        token's position."""
        logits, cache = self.forward(params, batch, cache=cache, pos=pos)
        return logits[:, 0], cache


def _lookup(table, tokens):
    """``table[tokens]`` of DTensors, as the reference's partitioner runs a
    vocab-sharded lookup (Megatron's vocab-parallel embedding, through
    `local_map`): each device looks up the tokens of its batch block that
    fall in its rows of the table, zeros elsewhere, and the result is a
    pending sum over the mesh axes that split the vocabulary; the batch
    stays split as the tokens are."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = tokens.device_mesh
    rep = [Replicate()] * mesh.ndim
    if not is_dtensor(table):
        table = DTensor.from_local(table, mesh, rep, run_check=False)
    t_pl = tuple(p if p == Shard(0) else Replicate() for p in tokens.placements)
    w_pl = tuple(Shard(0) if p == Shard(0) and t_pl[i] != Shard(0) else Replicate()
                 for i, p in enumerate(table.placements))
    out_pl = tuple(t_pl[i] if t_pl[i] == Shard(0) else Partial() if w_pl[i] == Shard(0)
                   else Replicate() for i in range(mesh.ndim))
    splits = [mesh.size(i) for i in range(mesh.ndim) if w_pl[i] == Shard(0)]

    def local(w, t):
        if not splits:
            return w[t]
        rows = w.shape[0]
        lo = _vocab_block(mesh, w_pl) * rows
        inside = (t >= lo) & (t < lo + rows)
        got = w[(t - lo).clamp(0, rows - 1)]
        return torch.where(inside[..., None], got, torch.zeros((), dtype=w.dtype,
                                                               device=w.device))

    # The table's gradient sums over the batch blocks it was replicated to.
    w_grad = tuple(Partial() if t_pl[i] == Shard(0) else w_pl[i] for i in range(mesh.ndim))
    return local_map(local, out_placements=(out_pl,), in_placements=(w_pl, t_pl),
                     in_grad_placements=(w_grad, t_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def _vocab_block(mesh, w_pl) -> int:
    """This rank's block of a table split over the mesh axes marked
    ``Shard(0)`` in ``w_pl`` (the first of them major)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate() or [0] * mesh.ndim
    idx = 0
    for i, p in enumerate(w_pl):
        if p == Shard(0):
            idx = idx * mesh.size(i) + coord[i]
    return idx


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda") -> Model:
    """The port's model for ``cfg`` on ``device`` (the card by default;
    ``"meta"`` for a model that runs with no values)."""
    device = resolve_device(device, meta=True)
    unknown = sorted(set(cfg.layer_kinds) - set(_PORTED_KINDS))
    if unknown:
        raise ValueError(f"{cfg.name}: unknown layer kinds {unknown}")
    if cfg.d_ff <= 0 and set(cfg.layer_kinds) - set(_NO_FFN_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: attention or RG-LRU blocks without an FFN are not ported"
        )
    return Model(cfg, device)


def param_count(params) -> int:
    return sum(t.numel() for t in tree.leaves(params))


def param_bytes(params) -> int:
    """Bytes as held: a server keeps matrices in the compute dtype (about
    half the f32 figure under bf16), a trainer f32 masters."""
    return sum(t.numel() * t.element_size() for t in tree.leaves(params))
