"""`repro_torch.kernels.flash_attention` on the host: the plain twin (which
the wrapper takes for CPU tensors) against the reference's oracle
``attention_ref`` and its interpret-mode Pallas kernel, over the
reference's own sweep (`tests/test_kernels.py` ``ATTN_CASES``) plus a
gemma3-shaped case (D = 256, one KV head for four query heads, sliding
window, decode offset).  The kernel against the twin on the card is in
`tests/test_torch_kernels.py` (marked ``cuda``).

Tolerances, as in the reference's sweep: 2e-5 in f32 (summation order);
3e-2 in bf16 (both sides round the f32 result to bf16, and the Pallas
kernel's online softmax sums in another order).
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as ref_flash_attention
from repro_torch.kernels import flash_attention as fa

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

ATTN_CASES = [
    # B, Hq, Hkv, Sq, Skv, D, causal, window, off  (the reference's sweep)
    (2, 4, 2, 256, 256, 64, True, None, 0),
    (1, 8, 1, 128, 128, 64, True, None, 0),
    (1, 4, 4, 200, 200, 64, True, None, 0),
    (1, 2, 2, 384, 384, 64, True, 128, 0),
    (1, 2, 2, 256, 256, 64, True, 100, 0),
    (1, 2, 1, 8, 512, 64, True, None, 504),
    (1, 2, 2, 128, 128, 128, False, None, 0),
    (1, 3, 1, 64, 320, 32, True, None, 256),
    # gemma3's attention: D = 256, GQA group 4, window, queries mid-cache.
    (2, 4, 1, 24, 80, 256, True, 32, 40),
    (2, 4, 1, 1, 80, 256, True, 32, 70),
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(case, dtype):
    B, Hq, Hkv, Sq, Skv, D = case[:6]
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    return (
        rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
        rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
        rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
    )


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_and_pallas(case, dtype):
    causal, window, off = case[6:]
    q, k, v = _inputs(case, dtype)
    got = fa.flash_attention(
        *(_torch(a, dtype) for a in (q, k, v)), causal, window, off
    )
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == q.shape
    got = got.to(torch.float32).numpy()
    tol = TOL[dtype]
    ins = [_jax(a, dtype) for a in (q, k, v)]
    for want in (
        attention_ref(*ins, causal, window, off),
        ref_flash_attention(*ins, causal, window, off),  # Pallas, interpret mode
    ):
        np.testing.assert_allclose(
            got, np.asarray(want, np.float32), rtol=tol, atol=tol
        )


def test_plain_takes_strided_views():
    """The model hands the wrapper (B, S, H, D) tensors viewed as
    (B, H, S, D): same result as contiguous copies."""
    case = (2, 4, 1, 12, 30, 16, True, 8, 18)
    q, k, v = (torch.from_numpy(a) for a in _inputs(case, "float32"))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    want = fa.flash_attention(q, k, v, True, 8, 18)
    got = fa.flash_attention(*views, True, 8, 18)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_validates():
    q = torch.zeros(1, 4, 2, 16)
    k = torch.zeros(1, 3, 5, 16)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="q must be"):
        fa.flash_attention(q[0], k, k)
    k = torch.zeros(1, 2, 5, 16)
    with pytest.raises(TypeError, match="dtypes differ"):
        fa.flash_attention(q, k.double(), k)
    before = fa.LAUNCHES
    fa.flash_attention(q, k, k)
    assert fa.LAUNCHES == before  # CPU calls take the twin, uncounted


# The wrapper's route choice and split plan (pure Python; the kernels they
# pick are held to the twin on the card in `tests/test_torch_kernels.py`).
PLAN_CASES = [
    # B, Hq, Hkv, Sq, Skv, causal, window, q_offset
    (4, 4, 1, 1, 617, True, None, 600),   # gemma3 decode, global layer
    (4, 4, 1, 1, 617, True, 512, 600),    # gemma3 decode, local layer
    (4, 4, 1, 1, 80, True, None, 10),     # decode early in the cache
    (2, 8, 1, 1, 300, True, None, 299),   # group 8
    (2, 1, 1, 1, 300, True, 40, 299),     # group 1, window
    (1, 1, 1, 16, 616, True, 64, 600),    # 16 rows: runs empty for row 0
    (1, 2, 1, 8, 64, False, 2, 60),       # rows whose keys all lie past Skv
    (1, 2, 1, 1, 64, True, 0, 10),        # window 0: no key visible
    (200, 1, 1, 1, 5000, True, None, 4999),  # more (b, kv head) than SMs
    (1, 1, 1, 1, 200000, True, None, 199999),  # more tiles than SMs
]


def _visible(Sq, Skv, causal, window, off):
    qi = off + np.arange(Sq)[:, None]
    kj = np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= qi >= kj
    if window is not None:
        mask &= qi - kj < window
    return mask


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_plan_covers_the_live_band_once(case, dtype):
    B, Hq, Hkv, Sq, Skv, causal, window, off = case
    p = fa.plan(dtype, B, Hq, Hkv, Sq, Skv, causal, window, off, num_sms=132)
    assert p.route == "split"
    assert 1 <= p.n_split <= 132 and p.length % fa.SPLIT_KEYS == 0
    lo, hi = fa.live_band(Sq, Skv, causal, window, off)
    # The kernel clips each run to the band [lo, hi).
    runs = np.zeros(Skv, int)
    for s in range(p.n_split):
        a, b = p.begin + s * p.length, p.begin + (s + 1) * p.length
        assert a >= lo and (a < hi or hi == lo)  # no run wholly past the band
        runs[a:min(b, hi)] += 1
    assert (runs <= 1).all()
    assert np.flatnonzero(runs).tolist() == list(range(lo, hi))
    live = _visible(Sq, Skv, causal, window, off).any(axis=0)
    assert (runs[live] == 1).all()  # every live key in exactly one run
    if hi > lo:  # runs as short as B * Hkv * n_split <= 132 SMs allows
        tiles = -(-(hi - lo) // fa.SPLIT_KEYS)
        most = min(-(-132 // (B * Hkv)), tiles)
        assert p.n_split <= most
        assert (p.length // fa.SPLIT_KEYS - 1) * most < tiles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_choice(dtype):
    def route(B, Hq, Hkv, Sq, Skv, window=None, off=0):
        return fa.plan(dtype, B, Hq, Hkv, Sq, Skv, True, window, off, 132).route

    bf16 = dtype == torch.bfloat16
    # The serving shapes: decode splits, prefill takes the tensor cores in
    # bf16; training's shape too.
    assert route(4, 4, 1, 1, 617, None, 600) == "split"
    assert route(4, 4, 1, 1, 617, 512, 600) == "split"
    assert route(4, 4, 1, 600, 617, None) == ("mma" if bf16 else "simt")
    assert route(4, 4, 1, 600, 617, 512) == ("mma" if bf16 else "simt")
    assert route(4, 4, 1, 1024, 1024) == ("mma" if bf16 else "simt")
    # Route boundaries in rows per (b, kv head), group * Sq.
    assert route(1, 4, 1, 4, 64) == "split"  # 16 rows
    assert route(1, 1, 1, 17, 64) == ("mma" if bf16 else "simt")
    assert route(1, 1, 1, 63, 64) == ("mma" if bf16 else "simt")
    assert route(1, 1, 1, 64, 64) == ("mma" if bf16 else "simt")
    assert route(1, 8, 2, 16, 64) == ("mma" if bf16 else "simt")  # 4 x 16 rows
    assert route(1, 1, 1, 65, 64) == ("mma" if bf16 else "simt")


# ------------------------------------------------------- chunked attention
# `repro_torch.models.layers.chunked_attention` (plain PyTorch, MLA's
# route) against the reference's `repro.models.layers.chunked_attention`,
# forward and VJP: f32 within 2e-5, bf16 within 3e-2 (the bounds above).
CHUNKED_CASES = [
    # B, Sq, Hq, Hkv, Skv, D, Dv, causal, window, kv_valid, kv_chunk, q_offset
    (2, 24, 4, 2, 24, 16, 16, True, None, None, 8, 0),  # chunks divide Skv
    (2, 10, 4, 4, 37, 16, 16, False, None, None, 16, 0),  # padded last chunk
    (1, 20, 2, 1, 40, 16, 16, True, 7, None, 16, 20),  # window, queries mid-cache
    (2, 1, 4, 1, 30, 24, 16, True, None, (17, 25), 8, 16),  # decode, Dv != D
    (2, 6, 4, 1, 33, 24, 16, False, None, (0, 5), 32, 0),  # a row sees no key
    (1, 12, 4, 1, 12, 24, 16, True, None, None, 1024, 0),  # one chunk (MLA's shapes)
]


def _chunked_inputs(case, dtype):
    B, Sq, Hq, Hkv, Skv, D, Dv = case[:7]
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, Dv), (B, Sq, Hq, Dv))]
    kv_valid = Skv if case[9] is None else np.array(case[9], np.int32)
    positions = np.broadcast_to(case[11] + np.arange(Sq, dtype=np.int32), (B, Sq))
    return arrays, kv_valid, positions


@pytest.mark.parametrize("case", CHUNKED_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_reference(case, dtype):
    import jax

    from repro.models.layers import chunked_attention as ref_chunked
    from repro_torch.models.layers import chunked_attention

    causal, window, _, chunk = case[7:11]
    (q, k, v, dout), kv_valid, positions = _chunked_inputs(case, dtype)

    def ref(q, k, v):
        return ref_chunked(q, k, v, jnp.asarray(positions), jnp.asarray(kv_valid),
                           causal=causal, window=window, kv_chunk=chunk)

    want, vjp = jax.vjp(ref, *(_jax(a, dtype) for a in (q, k, v)))
    want_grads = vjp(_jax(dout, dtype))
    leaves = [_torch(a, dtype).requires_grad_() for a in (q, k, v)]
    got = chunked_attention(*leaves, torch.from_numpy(positions.copy()),
                            torch.as_tensor(kv_valid), causal, window, chunk)
    grads = torch.autograd.grad(got, leaves, _torch(dout, dtype))
    tol = TOL[dtype]
    assert got.dtype == getattr(torch, dtype) and got.shape == dout.shape
    for g, w in zip((got, *grads), (want, *want_grads)):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.detach().to(torch.float32).numpy(),
                                   np.asarray(w, np.float32), rtol=tol, atol=tol)
    if case[9] is not None and 0 in case[9]:  # no key visible: zeros
        assert not got[0].any()


# ---------------------------------------------------- MLA, cross-attention
# The layers on the reduced configs against the reference's, same weights:
# f32 within 2e-4 (`tests/test_torch_models.py`), bf16 within 3e-2.
LAYER_TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _layer_cfg(name, dtype):
    from repro.configs import ARCHS

    return ARCHS[name].reduced(compute_dtype=dtype)


def _layer_x(cfg, B, S, seed):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    xr = jnp.asarray(x).astype(getattr(jnp, cfg.compute_dtype))
    return xr, torch.from_numpy(np.array(xr.astype(jnp.float32))).to(
        getattr(torch, cfg.compute_dtype))


def _close_layer(got, want, dtype):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(want).astype(jnp.float32)),
                               rtol=LAYER_TOL[dtype], atol=LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_matches_reference(dtype):
    """Without a cache over 20 positions; with a cache of 24: a prefill of
    20, then one decode step at 20 (the cache's latents and the step's
    output)."""
    import jax

    from repro.models import layers as RL
    from repro_torch.models import layers as PL

    cfg = _layer_cfg("minicpm3-4b", dtype)
    p = RL.mla_init(jax.random.PRNGKey(0), cfg)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    xr, xp = _layer_x(cfg, 2, 21, seed=1)
    pos_r = jnp.broadcast_to(jnp.arange(20, dtype=jnp.int32), (2, 20))
    pos_p = torch.arange(20)[None].expand(2, 20)
    want, _ = RL.mla_apply(p, xr[:, :20], cfg, positions=pos_r)
    got, cache = PL.mla_apply(pp, xp[:, :20], cfg, positions=pos_p)
    assert cache is None
    _close_layer(got, want, dtype)

    cdt = getattr(jnp, dtype)
    rc = RL.mla_init_cache(cfg, 2, 24, cdt)
    pc = PL.mla_init_cache(cfg, 2, 24, getattr(torch, dtype), "cpu")
    _, rc = RL.mla_apply(p, xr[:, :20], cfg, positions=pos_r, cache=rc, pos=0)
    _, pc = PL.mla_apply(pp, xp[:, :20], cfg, positions=pos_p, cache=pc, pos=0)
    want, rc = RL.mla_apply(p, xr[:, 20:], cfg, positions=jnp.full((2, 1), 20, jnp.int32),
                            cache=rc, pos=20)
    got, pc = PL.mla_apply(pp, xp[:, 20:], cfg, positions=torch.full((2, 1), 20),
                           cache=pc, pos=20)
    _close_layer(got, want, dtype)
    assert set(pc) == {"c_kv", "k_rope"}
    for name in pc:
        assert pc[name].shape == rc[name].shape and pc[name].dtype == getattr(torch, dtype)
        _close_layer(pc[name], rc[name], dtype)


@pytest.mark.parametrize("name", ["llama-3.2-vision-11b", "musicgen-medium"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_apply_matches_reference(name, dtype):
    """Over the encoder's 8 tokens, 20 queries and one (decode's shape)."""
    import jax

    from repro.models import layers as RL
    from repro_torch.models import layers as PL

    cfg = _layer_cfg(name, dtype)
    p = RL.cross_init(jax.random.PRNGKey(2), cfg)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    enc = np.random.default_rng(3).standard_normal(
        (2, cfg.encoder_len, cfg.encoder_dim)).astype(np.float32)
    xr, xp = _layer_x(cfg, 2, 20, seed=4)
    for S in (20, 1):
        want = RL.cross_apply(p, xr[:, :S], jnp.asarray(enc), cfg)
        got = PL.cross_apply(pp, xp[:, :S], torch.from_numpy(enc), cfg)
        assert got.dtype == getattr(torch, dtype) and got.shape == (2, S, cfg.d_model)
        _close_layer(got, want, dtype)
