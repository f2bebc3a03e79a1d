"""The RG-LRU family (`repro_torch.models.rglru`, recurrentgemma-2b)
against the JAX package's, on the host, given the same weights
(`repro_torch.convert.params_from_reference`).

Tolerances:
  * `rglru_apply` alone: 2e-5 in f32 (the log-depth scan sums in another
    tree than ``jax.lax.associative_scan``); in bf16 2e-2 absolute and
    relative (the block's output is rounded to bf16, whose unit at values
    of order 1 is 2**-8, after products rounded at other places);
  * reduced recurrentgemma logits: 2e-4 in f32, 3e-2 in bf16, the dense
    decoders' bounds (`tests/test_torch_models.py`);
  * decode after a prefill against the teacher-forced forward: 5e-4 (f32);
  * `serve`: the reference wave loop's greedy tokens in f32, logits 2e-4;
  * loss 2e-4, gradients 1e-4 (f32) and 0.1 (bf16) of each leaf's largest
    reference value (`tests/test_torch_train.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import rglru as ref_rglru
from repro.models.model import build_model as ref_build_model
from repro.models.model import param_count as ref_param_count
from repro_torch import tree
from repro_torch.configs import applicable_shapes, get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_reference
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import loss_and_grad
from repro_torch.models import rglru as R
from repro_torch.models.model import build_model, param_count
from test_torch_serve import _reference_waves

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

NAME = "recurrentgemma-2b"
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
BLOCK_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 0.1}


def _cfg(dtype="float32", **kw):
    return REF_ARCHS[NAME].reduced(compute_dtype=dtype, **kw)


def _pair(cfg, seed=0, masters=False):
    ref = ref_build_model(cfg)
    ref_params = ref.init(jax.random.PRNGKey(seed))
    port_cfg = ModelConfig(**dataclasses.asdict(cfg))
    port = build_model(port_cfg, "cpu")
    params = params_from_reference(ref_params, port_cfg, "cpu", masters=masters)
    return port_cfg, ref, ref_params, port, params


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# ------------------------------------------------------------------ configs
def test_config_matches_reference():
    assert dataclasses.asdict(get_arch(NAME)) == dataclasses.asdict(REF_ARCHS[NAME])
    assert dataclasses.asdict(get_arch(NAME).reduced(vocab_size=512)) == dataclasses.asdict(
        REF_ARCHS[NAME].reduced(vocab_size=512))
    cfg = get_arch(NAME)
    assert cfg.layer_kinds.count("rglru") == 18 and cfg.layer_kinds.count("local") == 8
    assert "long_500k" in applicable_shapes(cfg)


def test_params_from_reference_maps_units_and_remainder():
    """26 layers: a unit of 3 kinds stacked 8 times, 2 left over; the
    count equals the reference's, recurrent matrices in the compute dtype
    except ``w_r`` and ``w_i`` (read in f32), each equal to the reference's."""
    cfg = _cfg("bfloat16", num_layers=26)
    _, _, ref_params, _, params = _pair(cfg)
    assert len(ref_params["rem"]) == 2 and len(params["layers"]) == 26
    assert param_count(params) == ref_param_count(ref_params)
    for i in (0, 4, 24, 25):  # unit rows 0 and 1, both remainder layers
        mix = params["layers"][i]["mix"]
        src = (ref_params["units"][i % 3] if i < 24 else ref_params["rem"][i - 24])["mix"]
        pick = (lambda a: np.asarray(a)[i // 3]) if i < 24 else np.asarray
        assert mix["w_in"].dtype == torch.bfloat16 and mix["conv"].dtype == torch.bfloat16
        for name in ("w_r", "w_i", "lambda", "norm"):
            assert mix[name].dtype == torch.float32
            np.testing.assert_array_equal(mix[name].numpy(), pick(src[name]))
        assert "ffn" in params["layers"][i]
    assert "attn" in params["layers"][2] and "attn" not in params["layers"][24]


def test_init_matches_reference_distributions():
    cfg = ModelConfig(**dataclasses.asdict(_cfg()))
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    ref_params = ref_build_model(_cfg()).init(jax.random.PRNGKey(0))
    assert param_count(params) == ref_param_count(ref_params)
    mix = params["layers"][0]["mix"]
    a = torch.exp(-8.0 * torch.nn.functional.softplus(mix["lambda"]))
    assert 0.9 <= float(a.min()) and float(a.max()) <= 0.999 + 1e-6
    assert abs(float(mix["w_r"].std()) * cfg.lru_width**0.5 - 1.0) < 0.15
    assert abs(float(mix["conv"].std()) * cfg.conv1d_width**0.5 - 1.0) < 0.15


# -------------------------------------------------------------------- block
def _block(dtype, seed=0):
    cfg = _cfg(dtype)
    ref_p = ref_rglru.rglru_init(jax.random.PRNGKey(seed), cfg)
    port_p = {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}
    return cfg, ref_p, port_p


@pytest.mark.parametrize("S", [1, 7, 24])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_apply_matches_reference(dtype, carried, S):
    """The block alone on f32 weights, from a zero state or a carried one
    (h and a conv window in the compute dtype, as a previous call leaves
    it): output, new h (f32) and new conv window (compute dtype)."""
    cfg, ref_p, port_p = _block(dtype)
    rng = np.random.default_rng(S + 10 * carried)
    B, W = 2, cfg.lru_width
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    state = None
    if carried:
        h0 = rng.standard_normal((B, W)).astype(np.float32)
        conv = rng.standard_normal((B, cfg.conv1d_width - 1, W)).astype(np.float32)
        state = (h0, conv)
    ref_state = None if state is None else (jnp.asarray(state[0]), jnp.asarray(state[1]).astype(jdt))
    port_state = None if state is None else (torch.from_numpy(state[0]),
                                             torch.from_numpy(state[1]).to(tdt))
    want, (want_h, want_conv) = ref_rglru.rglru_apply(
        ref_p, jnp.asarray(x).astype(jdt), cfg, state=ref_state)
    got, (got_h, got_conv) = R.rglru_apply(port_p, torch.from_numpy(x).to(tdt), cfg,
                                           state=port_state)
    tol = BLOCK_TOL[dtype]
    assert got.dtype == tdt and got.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)
    assert got_h.dtype == torch.float32
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=tol, atol=tol)
    assert got_conv.dtype == tdt and jnp.dtype(want_conv.dtype) == jdt
    np.testing.assert_allclose(got_conv.float().numpy(), np.asarray(want_conv, np.float32),
                               rtol=tol, atol=tol)


def test_conv_state_becomes_the_compute_dtype():
    """`rglru_init_state` gives an f32 window; one call returns it in bf16
    under bf16, as the reference's conv does."""
    cfg, _, port_p = _block("bfloat16")
    h0, conv = R.rglru_init_state(cfg, 2, "cpu")
    assert h0.dtype == conv.dtype == torch.float32
    assert conv.shape == (2, cfg.conv1d_width - 1, cfg.lru_width)
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(0))
    _, (h, conv) = R.rglru_apply(port_p, x.to(torch.bfloat16), cfg)
    assert h.dtype == torch.float32 and conv.dtype == torch.bfloat16


def test_scan_equals_the_sequential_recurrence():
    """The log-depth scan against h_t = a_t h_{t-1} + b_t, step by step."""
    g = torch.Generator().manual_seed(3)
    a = torch.rand((2, 37, 5), generator=g, dtype=torch.float64)
    b = torch.randn((2, 37, 5), generator=g, dtype=torch.float64)
    h, want = b[:, 0], [b[:, 0]]
    for t in range(1, 37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(R._scan(a, b), torch.stack(want, dim=1), rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype, impl):
    """Reduced recurrentgemma (rglru, rglru, local; window 16) over 40
    tokens, under both of the reference's attention routes."""
    cfg = dataclasses.replace(_cfg(dtype), attention_impl=impl)
    _, ref, ref_params, port, params = _pair(cfg)
    tokens = _tokens(cfg, 2, 40)
    want, _ = ref.forward(ref_params, {"tokens": jnp.asarray(tokens)})
    got, _ = port.forward(params, {"tokens": tokens})
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_decode_matches_full_forward():
    """prefill(S - 1) + decode steps == the teacher-forced forward, over
    the remainder layers too (5 layers: one unit and two rglru)."""
    cfg = ModelConfig(**dataclasses.asdict(_cfg(num_layers=5)))
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    B, S = 2, 24
    tokens = torch.from_numpy(_tokens(cfg, B, S))
    full, _ = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(B, S)
    _, cache = model.forward(params, {"tokens": tokens[:, : S - 3]}, cache=cache, pos=0)
    for t in range(S - 3, S):
        got, cache = model.decode_step(params, cache, {"tokens": tokens[:, t : t + 1]}, t)
        torch.testing.assert_close(got, full[:, t], atol=5e-4, rtol=5e-4)
    h, conv = cache[0]
    assert h.shape == (B, cfg.lru_width) and conv.shape == (B, cfg.conv1d_width - 1, cfg.lru_width)


def test_serve_matches_reference_wave_loop():
    cfg = REF_ARCHS[NAME].reduced(vocab_size=512, compute_dtype="float32")
    ref_params = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    kw = dict(slots=2, requests=3, prompt_len=20, max_new=4, seed=7)
    want, want_logits, _ = _reference_waves(cfg, ref_params, **kw)
    port_cfg = ModelConfig(**dataclasses.asdict(cfg))
    res = serve(port_cfg, params_from_reference(ref_params, port_cfg, "cpu"), device="cpu", **kw)
    assert res.produced == want
    assert (res.waves, res.ticks, res.tokens) == (2, 8, 12)
    for got_wave, want_wave in zip(res.logits, want_logits, strict=True):
        for got, w in zip(got_wave, want_wave, strict=True):
            np.testing.assert_allclose(got.numpy(), w, rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------------ training
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(dtype):
    """Loss and every gradient leaf against ``jax.value_and_grad(ref.loss)``
    on f32 masters, 40 positions in two loss chunks of 20."""
    cfg = _cfg(dtype)
    port_cfg, ref, ref_params, port, params = _pair(cfg, masters=True)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 41)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, ref_grads = jax.value_and_grad(ref.loss)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()}, 20)
    got, grads = loss_and_grad(port, params, batch)
    assert abs(float(got) - float(want)) <= 2e-4
    ref_leaves = tree.leaves(params_from_reference(
        jax.tree.map(np.array, ref_grads), port_cfg, "cpu", masters=True))
    grads = tree.leaves(grads)
    assert len(grads) == len(ref_leaves) == len(tree.leaves(params))
    for g, r in zip(grads, ref_leaves):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert float((g - r).abs().max()) <= GRAD_TOL[dtype] * float(r.abs().max())
        assert bool(g.any())
