"""The port's decoders (`repro_torch.models`: dense, xLSTM, MLA, mixtures
of experts, cross-attention and audio codebooks) against the JAX package's
(`repro.models`), on the host, given the same weights
(`repro_torch.convert.params_from_reference`).  Configs with cross layers
take encoder inputs of N(0, 1) f32; audio configs take (B, S, 4) tokens.

Tolerances:
  * f32 (``reduced(compute_dtype="float32")``): 2e-4, as the reference's
    own flash-vs-chunked check (`tests/test_integration.py`); decode
    against teacher-forced forward 5e-4, as `tests/test_models.py`;
  * bf16 (the reference's compute dtype): 3e-2 absolute and relative, a few
    bf16 units (2**-8 relative) at logits of order 1 -- the two frameworks
    round the residual stream and the products' outputs at different
    places.

The reference runs both of its attention routes: ``attention_impl =
"chunked"`` (pure jnp) and ``"flash"`` (the Pallas kernel in interpret
mode), 40 tokens against the reduced window of 16; its MLA and
cross-attention layers run its chunked route under either.

xLSTM runs with ``mlstm_chunk = 12``: every prompt length used here (40,
23, 13, 20) then spans several chunks and ends in a padded one (40 is a
multiple of 8).  In bf16 it is held against the reference run op by op
(``jax.disable_jit()``), where every operation rounds to bf16 as the
port's do: under jit, XLA on the host keeps some intermediates between
fused operations in f32, and on the reduced xLSTM (eight recurrent layers
whose gates amplify the residual stream's differences) the reference's
own two modes then differ by up to about 0.2 at logits of order 0.5.

The mixtures of experts (dbrx-132b, qwen3-moe-235b-a22b) in bf16 are held
against the reference run op by op too: its router computes the logits in
the compute dtype and then widens them to f32, and under jit XLA on the
host fuses the two casts away and keeps the f32 logits, so its top k sees
other values than the source's (and the port's) bf16 logits.  Op by op, a
token whose K-th and (K+1)-th bf16 logits lie within 2 bf16 units of each
other at some layer (a near tie, read from the port's router,
`near_tied_rows`) can still reach another expert in the two frameworks,
since their residual streams differ by roundings: such rows (2 of the 80
here) are left out of the bound, and at most 5 % of the rows may be near
ties; every other row agrees within 3e-2 (measured within one bf16 unit).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import applicable_shapes as ref_applicable_shapes
from repro.models.model import build_model as ref_build_model
from repro.models.model import param_count as ref_param_count
from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_reference
from repro_torch.models.model import build_model, param_bytes, param_count

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

DENSE = ["gemma3-1b", "phi3-medium-14b", "stablelm-1.6b"]
FAMILIES = ["minicpm3-4b", "dbrx-132b", "qwen3-moe-235b-a22b", "llama-3.2-vision-11b",
            "musicgen-medium"]
ALL = DENSE + ["xlstm-1.3b"] + FAMILIES
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
XLSTM_CHUNK = 12


@contextlib.contextmanager
def near_tied_rows(B, S):
    """Collects, over every MoE layer the port runs inside, which of the
    (B, S) rows had its K-th and (K+1)-th router logits within 2 bf16
    units of each other; yields the (B, S) bool array, filled on exit."""
    from repro_torch.models import moe

    route, flags, out = moe.route, [], np.zeros((B, S), bool)

    def spy(h, w, cfg, C):
        top = (h @ w.to(h.dtype)).to(torch.float32).sort(dim=-1, descending=True).values
        a, b = top[..., cfg.top_k - 1], top[..., cfg.top_k]
        big = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
        flags.append(((a - b) <= 2 * torch.exp2(torch.floor(torch.log2(big)) - 7)).reshape(B, S))
        return route(h, w, cfg, C)

    moe.route = spy
    try:
        yield out
    finally:
        moe.route = route
    if flags:
        out[...] = torch.stack(flags).any(dim=0).numpy()


def _reduced(archs, name, **kw):
    """``archs[name].reduced(**kw)``; xLSTM with the tests' chunk."""
    if name == "xlstm-1.3b":
        kw.setdefault("mlstm_chunk", XLSTM_CHUNK)
    return archs[name].reduced(**kw)


def _pair(cfg: ModelConfig, seed: int = 0):
    """Reference model and params; the port's model and the same params."""
    ref = ref_build_model(cfg)
    ref_params = ref.init(jax.random.PRNGKey(seed))
    port_cfg = ModelConfig(**dataclasses.asdict(cfg))
    port = build_model(port_cfg, "cpu")
    return ref, ref_params, port, params_from_reference(ref_params, port_cfg, "cpu")


def _tokens(cfg, B, S, seed=1):
    tail = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S, *tail)).astype(np.int32)


def _batch(cfg, B, S, seed=1):
    """Tokens, and encoder inputs (B, encoder_len, encoder_dim) of N(0, 1)
    f32 where the config has cross layers."""
    batch = {"tokens": _tokens(cfg, B, S, seed)}
    if cfg.encoder_dim:
        batch["encoder"] = np.random.default_rng(seed + 100).standard_normal(
            (B, cfg.encoder_len, cfg.encoder_dim)).astype(np.float32)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pt(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", ALL)
def test_configs_match_reference(name):
    assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(REF_ARCHS[name])
    assert dataclasses.asdict(get_arch(name).reduced(vocab_size=512)) == dataclasses.asdict(
        REF_ARCHS[name].reduced(vocab_size=512)
    )
    assert get_arch(name).layer_kinds == REF_ARCHS[name].layer_kinds
    assert applicable_shapes(get_arch(name)) == ref_applicable_shapes(REF_ARCHS[name])


def test_registry_and_shapes():
    assert sorted(ARCHS) == sorted(ALL + ["recurrentgemma-2b"])  # RG-LRU: test_torch_rglru
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()
    }
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("llama-3.2-vision-90b")  # a published model the reference lacks


def test_build_model_raises_for_unported_kinds():
    base = get_arch("gemma3-1b").reduced()
    with pytest.raises(ValueError, match="unknown layer kinds"):
        build_model(dataclasses.replace(base, layer_unit=("conv",)), "cpu")
    # Recurrent blocks carry their own projections: d_ff = 0 is accepted
    # for them, and still refused where an attention block needs its FFN.
    build_model(get_arch("xlstm-1.3b").reduced(), "cpu")
    with pytest.raises(NotImplementedError, match="without an FFN"):
        build_model(dataclasses.replace(base, d_ff=0), "cpu")
    with pytest.raises(NotImplementedError, match="without an FFN"):
        build_model(dataclasses.replace(base, d_ff=0, layer_unit=("mlstm", "attn")), "cpu")


# ------------------------------------------------------------------ forward
# xLSTM has no attention, so ``attention_impl`` does not reach it: one impl.
@pytest.mark.parametrize(
    "name,dtype,impl",
    [
        (name, dtype, impl)
        for name in ("gemma3-1b", "stablelm-1.6b", "xlstm-1.3b", *FAMILIES)
        for dtype in ("float32", "bfloat16")
        for impl in ("chunked", "flash")
        if not (name == "xlstm-1.3b" and impl == "flash")
    ],
)
def test_forward_matches_reference(name, dtype, impl):
    cfg = dataclasses.replace(
        _reduced(REF_ARCHS, name, compute_dtype=dtype), attention_impl=impl
    )
    ref, ref_params, port, params = _pair(cfg)
    batch = _batch(cfg, 2, 40)
    op_by_op = dtype == "bfloat16" and (name == "xlstm-1.3b" or cfg.num_experts)
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
        want, _ = ref.forward(ref_params, _jnp(batch))
    with near_tied_rows(2, 40) as near:
        got, cache = port.forward(params, batch)
    assert cache is None
    tail = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 40, *tail, cfg.vocab_size)
    if dtype == "float32":
        near[...] = False
    assert near.mean() <= 0.05
    np.testing.assert_allclose(
        got.to(torch.float32).numpy()[~near], np.asarray(want, np.float32)[~near],
        rtol=TOL[dtype], atol=TOL[dtype],
    )


def test_forward_matches_reference_with_remainder_layers():
    """8 layers of a 6-kind unit: one stacked unit plus two ``rem`` layers
    in the reference's tree, eight list entries in the port's."""
    cfg = REF_ARCHS["gemma3-1b"].reduced(compute_dtype="float32", num_layers=8)
    ref, ref_params, port, params = _pair(cfg, seed=3)
    assert len(ref_params["rem"]) == 2 and len(params["layers"]) == 8
    tokens = _tokens(cfg, 1, 40, seed=4)
    want, _ = ref.forward(ref_params, {"tokens": jnp.asarray(tokens)})
    got, _ = port.forward(params, {"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ALL)
def test_params_from_reference(name):
    """Same count as the reference; matrices, expert stacks and embeddings
    in the compute dtype, norms f32 (and sLSTM's recurrent kernel ``r``,
    equal to the reference's)."""
    cfg = REF_ARCHS[name].reduced()
    _, ref_params, _, params = _pair(cfg)
    assert param_count(params) == ref_param_count(ref_params)
    layer = params["layers"][0]
    mixer, norms = ("attn", "ffn") if "attn" in layer else ("mix", "mix")
    first = "q_down" if cfg.layer_kinds[0] == "mla" else "wq"
    assert layer[mixer][first].dtype == torch.bfloat16
    assert layer[norms]["norm"].dtype == torch.float32
    if name == "xlstm-1.3b":
        i = cfg.layer_kinds.index("slstm")
        r = params["layers"][i]["mix"]["r"]
        assert r.dtype == torch.float32
        np.testing.assert_array_equal(r.numpy(), np.asarray(ref_params["units"][i]["mix"]["r"])[0])
    if cfg.num_experts:  # (E, D, F) per layer, row i // u of the reference's (reps, E, D, F)
        u = len(cfg.layer_unit)
        for i in range(cfg.num_layers):
            ffn = params["layers"][i]["ffn"]
            assert ffn["w_gate"].shape == (cfg.num_experts, cfg.d_model, cfg.d_ff)
            assert ffn["w_gate"].dtype == ffn["w_router"].dtype == torch.bfloat16
            want = jnp.asarray(ref_params["units"][i % u]["ffn"]["w_down"])[i // u]
            np.testing.assert_array_equal(ffn["w_down"].to(torch.float32).numpy(),
                                          np.asarray(want.astype(jnp.bfloat16), np.float32))
    if "cross" in cfg.layer_kinds:
        i = cfg.layer_kinds.index("cross")
        assert params["layers"][i]["cross"]["wk"].shape == (
            cfg.encoder_dim, cfg.num_heads * cfg.head_dim)
    names = [f"embed_{c}" for c in range(cfg.num_codebooks)] or ["embed"]
    assert sorted(params) == sorted(["layers", "final_norm", *names])
    for e in names:
        assert params[e].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            params[e].to(torch.float32).numpy(),
            np.asarray(jnp.asarray(ref_params[e]).astype(jnp.bfloat16), np.float32),
        )
    # bf16 matrices and embedding, f32 norms: about half the f32 bytes.
    assert param_bytes(params) < 0.6 * 4 * param_count(params)


@pytest.mark.parametrize("name", ALL)
def test_init_matches_reference_distributions(name):
    """The port's own init: the reference's shapes and scales (not its
    numbers: another generator)."""
    cfg = ModelConfig(**dataclasses.asdict(REF_ARCHS[name].reduced(compute_dtype="float32")))
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    ref_params = ref_build_model(REF_ARCHS[name].reduced()).init(jax.random.PRNGKey(0))
    assert param_count(params) == ref_param_count(ref_params)
    layer = params["layers"][0]
    if cfg.layer_kinds[0] == "mla":
        wq = layer["attn"]["q_down"]
        assert wq.shape == (cfg.d_model, cfg.q_lora_rank)
    else:
        wq = layer["attn" if "attn" in layer else "mix"]["wq"]
        assert wq.shape == (cfg.d_model, cfg.num_heads * cfg.head_dim)
    assert abs(float(wq.std()) * cfg.d_model**0.5 - 1.0) < 0.1
    if cfg.num_experts:
        w_up = layer["ffn"]["w_up"]
        assert w_up.shape == (cfg.num_experts, cfg.d_model, cfg.d_ff)
        assert abs(float(w_up.std()) * cfg.d_model**0.5 - 1.0) < 0.1
    if "slstm" in cfg.layer_kinds:
        r = params["layers"][cfg.layer_kinds.index("slstm")]["mix"]["r"]
        assert r.shape == (cfg.num_heads, cfg.head_dim, 4 * cfg.head_dim)
        assert r.dtype == torch.float32
        assert abs(float(r.std()) * cfg.head_dim**0.5 - 1.0) < 0.1
    for e in [f"embed_{c}" for c in range(cfg.num_codebooks)] or ["embed"]:
        assert abs(float(params[e].std()) / 0.02 - 1.0) < 0.1
    assert not params["final_norm"].any()


# ------------------------------------------------------------------- decode
@pytest.mark.parametrize("name", ALL)
def test_decode_matches_full_forward(name):
    """prefill(S-1) + decode_step == forward(S)[:, -1] (cache and offset;
    for xLSTM the carried state; the encoder at every step)."""
    cfg = _reduced(ARCHS, name, compute_dtype="float32")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    B, S = 2, 24
    batch = _pt(_batch(cfg, B, S))
    tokens = batch["tokens"]
    full, _ = model.forward(params, batch)
    cache = model.init_cache(B, S)
    _, cache = model.forward(params, {**batch, "tokens": tokens[:, : S - 1]}, cache=cache, pos=0)
    got, _ = model.decode_step(params, cache, {**batch, "tokens": tokens[:, S - 1 :]}, S - 1)
    torch.testing.assert_close(got, full[:, -1], atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("name", ALL)
def test_multi_step_decode(name):
    """Three sequential decode steps equal the teacher-forced forward."""
    cfg = _reduced(ARCHS, name, compute_dtype="float32")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(1))
    B, S = 1, 16
    batch = _pt(_batch(cfg, B, S, seed=2))
    tokens = batch["tokens"]
    full, _ = model.forward(params, batch)
    cache = model.init_cache(B, S)
    _, cache = model.forward(params, {**batch, "tokens": tokens[:, : S - 3]}, cache=cache, pos=0)
    for t in range(S - 3, S):
        got, cache = model.decode_step(params, cache, {**batch, "tokens": tokens[:, t : t + 1]}, t)
        torch.testing.assert_close(got, full[:, t], atol=5e-4, rtol=5e-4)


def test_prefill_matches_reference_decode_past_window():
    """Prefill 20 tokens (past the reduced window of 16), then decode 3 on
    both packages from the same weights: each step's logits agree."""
    cfg = REF_ARCHS["gemma3-1b"].reduced(compute_dtype="float32")
    ref, ref_params, port, params = _pair(cfg, seed=5)
    tokens = _tokens(cfg, 2, 23, seed=6)
    last, ref_cache = ref.prefill(ref_params, {"tokens": jnp.asarray(tokens[:, :20])})
    got, cache = port.prefill(params, {"tokens": tokens[:, :20]})
    np.testing.assert_allclose(got.numpy(), np.asarray(last), rtol=2e-4, atol=2e-4)
    # Decode needs room: both caches sized for all 23 positions.
    ref_cache = ref.init_cache(2, 23)
    _, ref_cache = ref.forward(
        ref_params, {"tokens": jnp.asarray(tokens[:, :20])}, cache=ref_cache, pos=0
    )
    cache = port.init_cache(2, 23)
    _, cache = port.forward(params, {"tokens": tokens[:, :20]}, cache=cache, pos=0)
    for t in range(20, 23):
        want, ref_cache = ref.decode_step(
            ref_params, ref_cache, {"tokens": jnp.asarray(tokens[:, t : t + 1])}, t
        )
        got, cache = port.decode_step(params, cache, {"tokens": tokens[:, t : t + 1]}, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_then_decode_matches_reference(name):
    """The new families on both packages from the same weights: a prefill of
    20 tokens, then 3 decode steps (MLA's latent cache, cross-attention over
    the encoder at every step, the experts, the codebooks): each step's
    logits within 2e-4 in f32."""
    cfg = REF_ARCHS[name].reduced(compute_dtype="float32")
    ref, ref_params, port, params = _pair(cfg, seed=5)
    batch = _batch(cfg, 2, 23, seed=6)
    toks = batch["tokens"]
    ref_cache = ref.init_cache(2, 23)
    _, ref_cache = ref.forward(ref_params, _jnp({**batch, "tokens": toks[:, :20]}),
                               cache=ref_cache, pos=0)
    cache = port.init_cache(2, 23)
    _, cache = port.forward(params, {**batch, "tokens": toks[:, :20]}, cache=cache, pos=0)
    for t in range(20, 23):
        step = {**batch, "tokens": toks[:, t : t + 1]}
        want, ref_cache = ref.decode_step(ref_params, ref_cache, _jnp(step), t)
        got, cache = port.decode_step(params, cache, step, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
