"""Model assembly (port of `repro.models.model` for dense decoders, xLSTM
and RG-LRU hybrids).

A model is a stack of residual blocks described by ``cfg.layer_kinds``
(gemma3 = 5 x "local" + 1 x "attn" repeating; xlstm = 7 x "mlstm" + 1 x
"slstm"; recurrentgemma = "rglru", "rglru", "local").  The reference
groups layers into repeating units and runs ``lax.scan`` over stacked
parameters to keep its compiled program small;
the port runs eagerly, so layers are a Python loop over a per-layer
parameter list (``params["layers"]``), and the cache is a per-layer list of
each layer's own state: ``{"k", "v"}`` for attention (written in place),
``(S, n)`` for mLSTM, ``(c, n, h)`` for sLSTM and ``(h, conv window)`` for
RG-LRU (replaced by the new state at every call).

The port runs the kinds "attn" (global) and "local" (sliding window), each
followed by the dense gated FFN; "rglru", followed by the FFN as well; and
"mlstm" and "slstm", which carry their own projections and have no FFN
(``d_ff = 0`` is accepted for them only).  Other kinds (MLA, cross
attention) and mixtures of experts are not ported yet (ROADMAP.md, Queue
1): `build_model` raises for them.

Training (`Model.loss`) runs every ported kind: a trainer holds f32
masters (``init(..., masters=True)``), cast to the compute dtype at every
use as the reference casts them, and autograd differentiates through the
casts, through the flash and mLSTM kernels' backwards (each recomputes
through its plain twin, as the reference's jnp routes do), and through the
sLSTM loop and the RG-LRU scan.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import xlstm as X

__all__ = ["Model", "build_model", "param_count", "param_bytes"]

# Layer kinds the port runs; xLSTM's have no FFN.
_PORTED_KINDS = ("attn", "local", "rglru", "mlstm", "slstm")
_NO_FFN_KINDS = ("mlstm", "slstm")
# Matrices read in f32, so held in f32 for serving too.
_F32_MATRICES = ("r",) + R.F32_WEIGHTS


class Model:
    """A decoder (dense, xLSTM or RG-LRU hybrid) on one device.  Built by
    `build_model`."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.dtype = getattr(torch, cfg.compute_dtype)
        # The reference scales embeddings by a Python float in the compute
        # dtype: the factor is rounded to that dtype first.
        self._embed_scale = float(torch.tensor(cfg.d_model**0.5, dtype=self.dtype))

    # ---------------------------------------------------------------- init
    def init(self, generator: torch.Generator, masters: bool = False) -> dict[str, Any]:
        """Random parameters from ``generator``, which must be on the
        model's device: the reference's distributions (matrices N(0,
        1/fan_in), sLSTM's ``r`` N(0, 1/head_dim), RG-LRU's as
        `rglru.rglru_init` draws them, embedding N(0, 0.02^2), norms zero),
        drawn in f32 and held as `cast` holds them."""
        if generator.device.type != self.device.type:
            raise ValueError(
                f"init: generator on {generator.device}, model on {self.device}"
            )
        cfg = self.cfg
        layers = []
        for kind in cfg.layer_kinds:
            if kind == "mlstm":
                layers.append({"mix": X.mlstm_init(generator, cfg)})
            elif kind == "slstm":
                layers.append({"mix": X.slstm_init(generator, cfg)})
            elif kind == "rglru":
                layers.append({"mix": R.rglru_init(generator, cfg), "ffn": L.ffn_init(generator, cfg)})
            else:
                layers.append({"attn": L.attn_init(generator, cfg), "ffn": L.ffn_init(generator, cfg)})
        params = {
            "layers": layers,
            "final_norm": torch.zeros(cfg.d_model, device=self.device),
            "embed": L.embed_init(generator, cfg.vocab_size, cfg.d_model) * 0.02,
        }
        return self.cast(params, masters)

    def cast(self, params: dict[str, Any], masters: bool = False) -> dict[str, Any]:
        """All on the model's device.  For serving (``masters=False``):
        matrices and the embedding in the compute dtype; vectors (norm
        weights, RG-LRU's Lambda), sLSTM's recurrent kernel ``r`` and
        RG-LRU's ``w_r`` and ``w_i`` in f32, as the reference reads them.
        For training (``masters=True``): every leaf in f32, the reference's
        ``param_dtype``, cast at each use."""

        def one(t: torch.Tensor, name: str = "") -> torch.Tensor:
            keep = masters or t.dim() == 1 or name in _F32_MATRICES
            return t.to(device=self.device, dtype=torch.float32 if keep else self.dtype)

        return {
            "layers": [
                {blk: {name: one(t, name) for name, t in p.items()} for blk, p in layer.items()}
                for layer in params["layers"]
            ],
            "final_norm": one(params["final_norm"]),
            "embed": one(params["embed"]),
        }

    # ------------------------------------------------------------ backbone
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"].to(self.dtype)[tokens] * self._embed_scale

    def _head(self, final_norm, embed, x: torch.Tensor) -> torch.Tensor:
        """Logits in the compute dtype, against the tied embedding."""
        x = L.rms_norm(x, final_norm)
        return x @ embed.to(self.dtype).T

    def forward(self, params, batch, cache=None, pos: int = 0):
        """batch['tokens']: (B, S) int.  Returns (logits (B, S, V), cache);
        with a cache, K/V of positions pos .. pos + S - 1 are written into
        it in place, and each recurrent layer's entry is replaced by its
        state after position pos + S - 1."""
        x = self._hidden(params, batch, cache, pos)
        return self._head(params["final_norm"], params["embed"], x), cache

    def _hidden(self, params, batch, cache=None, pos: int = 0) -> torch.Tensor:
        """The residual stream after the last layer, (B, S, D)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        B, S = tokens.shape
        x = self._embed(params, tokens)
        positions = (pos + torch.arange(S, device=self.device))[None, :].expand(B, S)
        for i, (kind, p) in enumerate(zip(cfg.layer_kinds, params["layers"])):
            state = None if cache is None else cache[i]
            if kind == "mlstm":
                delta, state = X.mlstm_apply(p["mix"], x, cfg, state=state, chunk=cfg.mlstm_chunk)
            elif kind == "slstm":
                delta, state = X.slstm_apply(p["mix"], x, cfg, state=state)
            elif kind == "rglru":
                delta, state = R.rglru_apply(p["mix"], x, cfg, state=state)
            else:
                window = cfg.window_size if kind == "local" else None
                delta, state = L.attn_apply(
                    p["attn"], x, cfg, positions=positions, cache=state, pos=pos, window=window,
                )
            if cache is not None:
                cache[i] = state
            x = x + delta
            if "ffn" in p:
                x = x + L.ffn_apply(p["ffn"], x, cfg)
        return x

    # ---------------------------------------------------------------- loss
    def _xent(self, final_norm, embed, x_c, y_c) -> torch.Tensor:
        """Summed token cross entropy of one chunk: logits in the compute
        dtype, their logsumexp in f32, the label's logit read in the
        compute dtype and then widened (the reference's one-hot sum)."""
        logits = self._head(final_norm, embed, x_c)
        lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
        ll = logits.gather(-1, y_c[..., None])[..., 0].to(torch.float32)
        return (lse - ll).sum()

    def loss(self, params, batch, seq_chunk: int = 512) -> torch.Tensor:
        """Mean token cross entropy (f32 scalar) of batch['tokens'] against
        batch['labels'], both (B, S).

        As the reference: chunks of ``seq_chunk`` positions, each
        recomputed in the backward (`torch.utils.checkpoint`, the
        reference's ``jax.checkpoint``), so the (B, S, vocab) logits are
        never held whole; the whole sequence in one chunk when ``S`` is not
        a multiple of the chunk; the sum divided by the label count.
        """
        x = self._hidden(params, batch)
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        B, S = labels.shape
        c = min(S, seq_chunk)
        norm, embed = params["final_norm"], params["embed"]
        if S % c:
            return self._xent(norm, embed, x, labels) / labels.numel()
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(0, S, c):
            total = total + checkpoint(
                self._xent, norm, embed, x[:, i : i + c], labels[:, i : i + c],
                use_reentrant=False,
            )
        return total / labels.numel()

    def init_cache(self, batch: int, max_len: int) -> list:
        """Per layer: zero K/V of ``max_len`` positions for attention, the
        zero recurrent state for mLSTM, sLSTM and RG-LRU (f32, any length)."""
        def one(kind: str):
            if kind == "mlstm":
                return X.mlstm_init_state(self.cfg, batch, self.device)
            if kind == "slstm":
                return X.slstm_init_state(self.cfg, batch, self.device)
            if kind == "rglru":
                return R.rglru_init_state(self.cfg, batch, self.device)
            return L.attn_init_cache(self.cfg, batch, max_len, self.dtype, self.device)

        return [one(kind) for kind in self.cfg.layer_kinds]

    def prefill(self, params, batch):
        tokens = batch["tokens"]
        cache = self.init_cache(len(tokens), len(tokens[0]))
        logits, cache = self.forward(params, batch, cache=cache, pos=0)
        return logits[:, -1], cache

    def decode_step(self, params, cache, batch, pos: int):
        """batch['tokens']: (B, 1); pos: the new token's position."""
        logits, cache = self.forward(params, batch, cache=cache, pos=pos)
        return logits[:, 0], cache


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda") -> Model:
    """The port's model for ``cfg`` on ``device`` (the card by default)."""
    device = resolve_device(device)
    unported = sorted(set(cfg.layer_kinds) - set(_PORTED_KINDS))
    if unported or cfg.num_experts or cfg.encoder_dim or cfg.num_codebooks:
        what = ", ".join(
            unported
            + (["mixture of experts"] if cfg.num_experts else [])
            + (["cross-attention conditioning"] if cfg.encoder_dim else [])
            + (["audio codebooks"] if cfg.num_codebooks else [])
        )
        raise NotImplementedError(
            f"{cfg.name}: {what} not ported yet (ROADMAP.md, Queue 1: the "
            f"remaining model families)"
        )
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
