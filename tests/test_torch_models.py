"""The port's decoders (`repro_torch.models`: dense and xLSTM) against the
JAX package's (`repro.models`), on the host, given the same weights
(`repro_torch.convert.params_from_reference`).

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
mode), 40 tokens against the reduced window of 16.

xLSTM runs with ``mlstm_chunk = 12``: every prompt length used here (40,
23, 13, 20) then spans several chunks and ends in a padded one (40 is a
multiple of 8).  In bf16 it is held against the reference run op by op
(``jax.disable_jit()``), where every operation rounds to bf16 as the
port's do: under jit, XLA on the host keeps some intermediates between
fused operations in f32, and on the reduced xLSTM (eight recurrent layers
whose gates amplify the residual stream's differences) the reference's
own two modes then differ by up to about 0.2 at logits of order 0.5.
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
ALL = DENSE + ["xlstm-1.3b"]
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
XLSTM_CHUNK = 12


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
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


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
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()
    }
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("dbrx-132b")  # a reference arch whose kinds are not ported


def test_build_model_raises_for_unported_kinds():
    base = get_arch("gemma3-1b").reduced()
    for over in (
        dict(layer_unit=("mla",)),
        dict(num_experts=4, top_k=2),
        dict(layer_unit=("cross",), encoder_dim=32, encoder_len=8),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(dataclasses.replace(base, **over), "cpu")
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
        for name in ("gemma3-1b", "stablelm-1.6b", "xlstm-1.3b")
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
    tokens = _tokens(cfg, 2, 40)
    op_by_op = name == "xlstm-1.3b" and dtype == "bfloat16"
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
        want, _ = ref.forward(ref_params, {"tokens": jnp.asarray(tokens)})
    got, cache = port.forward(params, {"tokens": tokens})
    assert cache is None
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), np.asarray(want, np.float32),
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
    """Same count as the reference; matrices in the compute dtype, norms f32
    (and sLSTM's recurrent kernel ``r``, equal to the reference's)."""
    cfg = REF_ARCHS[name].reduced()
    _, ref_params, _, params = _pair(cfg)
    assert param_count(params) == ref_param_count(ref_params)
    layer = params["layers"][0]
    mixer, norms = ("attn", "ffn") if "attn" in layer else ("mix", "mix")
    assert layer[mixer]["wq"].dtype == torch.bfloat16
    assert layer[norms]["norm"].dtype == torch.float32
    if name == "xlstm-1.3b":
        i = cfg.layer_kinds.index("slstm")
        r = params["layers"][i]["mix"]["r"]
        assert r.dtype == torch.float32
        np.testing.assert_array_equal(r.numpy(), np.asarray(ref_params["units"][i]["mix"]["r"])[0])
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["embed"].to(torch.float32).numpy(),
        np.asarray(jnp.asarray(ref_params["embed"]).astype(jnp.bfloat16), np.float32),
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
    wq = layer["attn" if "attn" in layer else "mix"]["wq"]
    assert wq.shape == (cfg.d_model, cfg.num_heads * cfg.head_dim)
    assert abs(float(wq.std()) * cfg.d_model**0.5 - 1.0) < 0.1
    if "slstm" in cfg.layer_kinds:
        r = params["layers"][cfg.layer_kinds.index("slstm")]["mix"]["r"]
        assert r.shape == (cfg.num_heads, cfg.head_dim, 4 * cfg.head_dim)
        assert r.dtype == torch.float32
        assert abs(float(r.std()) * cfg.head_dim**0.5 - 1.0) < 0.1
    assert abs(float(params["embed"].std()) / 0.02 - 1.0) < 0.1
    assert not params["final_norm"].any()


# ------------------------------------------------------------------- decode
@pytest.mark.parametrize("name", ALL)
def test_decode_matches_full_forward(name):
    """prefill(S-1) + decode_step == forward(S)[:, -1] (cache and offset;
    for xLSTM the carried state)."""
    cfg = _reduced(ARCHS, name, compute_dtype="float32")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    B, S = 2, 24
    tokens = torch.from_numpy(_tokens(cfg, B, S))
    full, _ = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(B, S)
    _, cache = model.forward(params, {"tokens": tokens[:, : S - 1]}, cache=cache, pos=0)
    got, _ = model.decode_step(params, cache, {"tokens": tokens[:, S - 1 :]}, S - 1)
    torch.testing.assert_close(got, full[:, -1], atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("name", ALL)
def test_multi_step_decode(name):
    """Three sequential decode steps equal the teacher-forced forward."""
    cfg = _reduced(ARCHS, name, compute_dtype="float32")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(1))
    B, S = 1, 16
    tokens = torch.from_numpy(_tokens(cfg, B, S, seed=2))
    full, _ = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(B, S)
    _, cache = model.forward(params, {"tokens": tokens[:, : S - 3]}, cache=cache, pos=0)
    for t in range(S - 3, S):
        got, cache = model.decode_step(params, cache, {"tokens": tokens[:, t : t + 1]}, t)
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
