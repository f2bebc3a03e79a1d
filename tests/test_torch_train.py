"""The port's training path (`repro_torch.launch.train` and what it runs)
against the JAX package's, on the host, given the same weights, batches
and gradients.

Tolerances (f32 unless stated):
  * synthetic batches: byte-identical (the same NumPy stream), also for a
    consumer slower than the prefetch thread's wait;
  * `cosine_schedule`: 1e-6 relative (both compute in f32; ``cos`` may
    differ by an ulp between libraries); `constant_schedule` exact;
  * `AdamW.update`: 1e-6 relative plus 1e-9 absolute on the new
    parameters, masters and moments (elementwise f32 with the same
    roundings; the global norm sums in another order, ``b ** count`` and
    ``sqrt`` may differ by an ulp);
  * `Model.loss`: 2e-4 absolute (measured about 5e-7 in f32, 1e-5 in
    bf16) on a reduced gemma3 (window 16) over 40 positions: two loss
    chunks of 20, and one chunk of 40 when the chunk (16) does not divide
    it; under both of the reference's ``attention_impl``; likewise on
    reduced stablelm-1.6b (group 2, D = 16), phi3-medium-14b and
    xlstm-1.3b (``mlstm_chunk`` 12: several chunks and a padded one);
  * gradients, leaf by leaf through `convert.params_from_reference`:
    1e-4 of the leaf's largest reference value in f32 (measured 2.5e-6);
    in bf16 0.1 of it (measured 0.043: every gradient that flows through
    a cast is rounded to bf16 once, at other places in the two
    frameworks).  xLSTM in bf16 is held against the reference run op by
    op (``jax.disable_jit()``), as its forward is (`test_torch_models`):
    under jit XLA keeps some bf16 intermediates in f32;
  * `make_train_step` with 2 microbatches: loss 2e-4, parameters after
    the step 1e-7 absolute.  The step's AdamW takes eps = 1, so that its
    update is about lr x g, linear in the accumulated gradients (with the
    default eps = 1e-8 it is about lr x sign(g), and a gradient as small
    as the frameworks' difference may take either sign);
  * `flash_attention`'s and `mlstm_chunk`'s gradients: identical to
    autograd through their plain twins (the backward is that recompute),
    on the host and, for `mlstm_chunk`, on the card (marked ``cuda``);
  * a run recovered from an injected failure: bit-identical to the same
    steps replayed by hand (the checkpoint round trip is exact);
  * each unit of layers under `torch.utils.checkpoint` (the reference's
    ``jax.checkpoint(unit_body)``): loss and every gradient bit-identical
    to the same step without it, and the bytes autograd saves bounded by
    the residual stream at each unit boundary plus one unit's internals
    plus the loss chunk's.
"""

import contextlib
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.kernels.mlstm_chunk import mlstm_ref
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models.model import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_reference
from repro_torch.data.pipeline import SyntheticTokens, make_batch_iterator
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mlstm_chunk as mc
from repro_torch.kernels import quant as qt
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import loss_and_grad, make_compressed_step, make_train_step
from repro_torch.models import model as model_mod
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamW, constant_schedule, cosine_schedule
from test_torch_models import near_tied_rows

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

LOSS_TOL = 2e-4
GRAD_TOL = {"float32": 1e-4, "bfloat16": 0.1}


def _np_tree(jtree):
    return jax.tree.map(lambda a: np.array(a), jtree)


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_tokens_byte_identical(seed):
    ref = RefTokens(512, 24, 3, seed=seed)
    port = SyntheticTokens(512, 24, 3, seed=seed)
    for _ in range(3):
        a, b = ref.next_batch(), port.next_batch()
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    it = make_batch_iterator(SyntheticTokens(512, 24, 3, seed=seed))
    first = RefTokens(512, 24, 3, seed=seed).next_batch()
    assert next(it)["tokens"].tobytes() == first["tokens"].tobytes()
    it.close()


def test_batch_iterator_keeps_every_batch_for_a_slow_consumer():
    """A consumer slower than the worker's 0.5 s wait on a full queue still
    gets the source's batches in order (the reference's worker would drop
    the batch it holds each time the wait runs out)."""
    it = make_batch_iterator(SyntheticTokens(64, 8, 2, seed=5), prefetch=1)
    want = SyntheticTokens(64, 8, 2, seed=5)
    time.sleep(1.2)  # the worker's wait runs out twice on a full queue
    for _ in range(3):
        got, exp = next(it), want.next_batch()
        assert all(got[k].tobytes() == exp[k].tobytes() for k in exp)
    it.close()


# ---------------------------------------------------------------- optimizer
def test_schedules_match_reference():
    ref = ref_adamw.cosine_schedule(3e-3, 11, 100)
    port = cosine_schedule(3e-3, 11, 100)
    for step in [0, 1, 5, 10, 11, 12, 50, 99, 100, 130]:
        want = float(ref(jnp.asarray(step, jnp.int32)))
        assert port(step) == pytest.approx(want, rel=1e-6, abs=0)
    assert constant_schedule(3e-4)(7) == float(ref_adamw.constant_schedule(3e-4)(7))


def _opt_case(seed, grad_scale):
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 16), "b": (16,), "emb": (32, 8), "layers": (3, 4, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [
        {k: (rng.standard_normal(s) * grad_scale).astype(np.float32) for k, s in shapes.items()}
        for _ in range(2)
    ]
    return params, grads


def _close(got: torch.Tensor, want, rtol=1e-6, atol=1e-9):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("master_weights", [False, True])
@pytest.mark.parametrize("grad_scale", [0.01, 1.0])  # clip idle / clip active
def test_adamw_update_matches_reference(master_weights, grad_scale):
    """Two updates (bias correction at counts 1 and 2), matrices decayed,
    vectors not; with f32 masters the parameters are held in bf16."""
    params, grads = _opt_case(int(grad_scale * 100) + master_weights, grad_scale)
    pdt = (jnp.bfloat16, torch.bfloat16) if master_weights else (jnp.float32, torch.float32)
    ref_opt = ref_adamw.AdamW(ref_adamw.cosine_schedule(1e-2, 1, 10), master_weights=master_weights)
    port_opt = AdamW(cosine_schedule(1e-2, 1, 10), master_weights=master_weights)
    rp = {k: jnp.asarray(v).astype(pdt[0]) for k, v in params.items()}
    pp = {k: torch.from_numpy(v).to(pdt[1]) for k, v in params.items()}
    rs, ps = ref_opt.init(rp), port_opt.init(pp)
    for g in grads:
        rp, rs, rstats = ref_opt.update(rp, {k: jnp.asarray(v) for k, v in g.items()}, rs)
        pp, ps, pstats = port_opt.update(pp, {k: torch.from_numpy(v) for k, v in g.items()}, ps)
        assert ps["count"] == int(rs["count"])
        assert pstats["lr"] == pytest.approx(float(rstats["lr"]), rel=1e-6)
        _close(pstats["grad_norm"], rstats["grad_norm"])
        for k in params:
            if master_weights:
                _close(ps["master"][k], rs["master"][k])
                _close(pp[k], rp[k].astype(jnp.float32), rtol=2**-8, atol=0)
            else:
                _close(pp[k], rp[k])
            _close(ps["m"][k], rs["m"][k])
            _close(ps["v"][k], rs["v"][k])


# ----------------------------------------------------------- loss and grads
def _pair(dtype="float32", impl="chunked", seed=0, arch="gemma3-1b", **kw):
    if arch == "xlstm-1.3b":
        kw.setdefault("mlstm_chunk", 12)
    cfg = dataclasses.replace(
        REF_ARCHS[arch].reduced(compute_dtype=dtype, **kw), attention_impl=impl
    )
    ref = ref_build_model(cfg)
    ref_params = ref.init(jax.random.PRNGKey(seed))
    port_cfg = ModelConfig(**dataclasses.asdict(cfg))
    port = build_model(port_cfg, "cpu")
    params = params_from_reference(ref_params, port_cfg, "cpu", masters=True)
    return cfg, port_cfg, ref, ref_params, port, params


def _batch(cfg, B=2, S=40, seed=1):
    """Tokens and labels ((B, S, C) with codebooks), and N(0, 1) encoder
    inputs where the config has cross layers."""
    tail = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1, *tail)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encoder_dim:
        batch["encoder"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.encoder_dim)).astype(np.float32)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize(
    "dtype,impl",
    [("float32", "chunked"), ("float32", "flash"), ("bfloat16", "chunked"), ("bfloat16", "flash")],
)
def test_loss_and_grads_match_reference(dtype, impl):
    """40 positions past the reduced window of 16, two loss chunks of 20;
    every gradient leaf (the reference's stacked tree mapped per layer)."""
    cfg, port_cfg, ref, ref_params, port, params = _pair(dtype, impl)
    assert cfg.window_size == 16
    batch = _batch(cfg)
    want, ref_grads = jax.value_and_grad(ref.loss)(ref_params, _jnp(batch), 20)
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    got = port.loss(params, batch, 20)
    grads = torch.autograd.grad(got, leaves)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got.detach()) - float(want)) <= LOSS_TOL
    ref_leaves = tree.leaves(params_from_reference(_np_tree(ref_grads), port_cfg, "cpu",
                                                   masters=True))
    assert len(ref_leaves) == len(grads) == 6 * 9 + 2
    for g, r in zip(grads, ref_leaves):
        assert g.shape == r.shape and g.dtype == torch.float32
        bound = GRAD_TOL[dtype] * float(r.abs().max())
        assert float((g - r).abs().max()) <= bound
        assert bool(g.any())


def test_loss_in_one_chunk_when_the_chunk_does_not_divide():
    """S = 40, seq_chunk = 16: the whole sequence in one chunk, as the
    reference; equal to the two-chunk loss within summation order."""
    cfg, _, ref, ref_params, port, params = _pair(seed=2)
    batch = _batch(cfg, seed=3)
    got = port.loss(params, batch, 16)
    assert abs(float(got) - float(ref.loss(ref_params, _jnp(batch), 16))) <= LOSS_TOL
    assert abs(float(got) - float(port.loss(params, batch, 20))) <= 1e-5
    assert abs(float(got) - float(port.loss(params, batch))) <= 1e-5  # S < 512


def test_train_step_with_microbatches_matches_reference():
    """`make_train_step` with 2 microbatches of a batch of 4: the loss and
    the parameters after one step."""
    cfg, port_cfg, ref, ref_params, port, params = _pair(num_layers=8, seed=4)
    batch = _batch(cfg, B=4, S=32, seed=5)
    ref_opt = ref_adamw.AdamW(ref_adamw.constant_schedule(1e-2), eps=1.0)
    step = ref_make_train_step(ref, ref_opt, num_microbatches=2)
    new_ref, _, ref_stats = step(ref_params, ref_opt.init(ref_params), _jnp(batch))
    opt = AdamW(constant_schedule(1e-2), eps=1.0)
    port_step = make_train_step(port, opt, num_microbatches=2)
    new, state, stats = port_step(params, opt.init(params), batch)
    assert state["count"] == 1
    assert abs(float(stats["loss"]) - float(ref_stats["loss"])) <= LOSS_TOL
    want = tree.leaves(params_from_reference(_np_tree(new_ref), port_cfg, "cpu", masters=True))
    for g, w in zip(tree.leaves(new), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-7)
    # One microbatch of the whole batch is the plain step.
    _, _, _, _, _, fresh = _pair(num_layers=8, seed=4)
    loss_all, _ = loss_and_grad(port, fresh, batch)
    assert abs(float(loss_all) - float(stats["loss"])) <= 1e-5


MOE = ("dbrx-132b", "qwen3-moe-235b-a22b")


@pytest.mark.parametrize("arch,dtype", [
    (arch, dtype)
    for arch in ("stablelm-1.6b", "phi3-medium-14b", "xlstm-1.3b", "minicpm3-4b", *MOE,
                 "llama-3.2-vision-11b", "musicgen-medium")
    for dtype in ("float32", "bfloat16")
    if not (arch in MOE and dtype == "bfloat16")  # test_moe_bf16_... below
])
def test_loss_and_grads_match_reference_other_archs(arch, dtype):
    """The other trainable decoders: stablelm (the trainer's default arch)
    and phi3 reach attention groups and head dims gemma3 does not; xLSTM
    trains through `mlstm_chunk`'s backward and the sLSTM loop; minicpm3
    through `chunked_attention`'s backward, dbrx and qwen3-moe through the
    router and the experts, llama-3.2-vision and musicgen through
    cross-attention (and four codebooks' embeddings and heads).  Every
    gradient leaf against ``jax.value_and_grad(ref.loss)``.  In bf16 the
    configs with cross layers are held against the reference run op by op,
    as xLSTM is: under jit XLA keeps some bf16 intermediates in f32, and
    the reference's two modes differ by 1.3e-4 in the loss of the reduced
    llama-3.2-vision (the port lies 8.4e-5 from the op-by-op run, 2.1e-4
    from the jitted one)."""
    cfg, port_cfg, ref, ref_params, port, params = _pair(dtype, arch=arch)
    batch = _batch(cfg)
    op_by_op = dtype == "bfloat16" and (arch == "xlstm-1.3b" or cfg.encoder_dim)
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
        want, ref_grads = jax.value_and_grad(ref.loss)(ref_params, _jnp(batch), 20)
    got, grads = loss_and_grad(port, params, batch)
    assert abs(float(got) - float(want)) <= LOSS_TOL
    ref_leaves = tree.leaves(params_from_reference(_np_tree(ref_grads), port_cfg, "cpu",
                                                   masters=True))
    grads = tree.leaves(grads)
    assert len(ref_leaves) == len(grads) == len(tree.leaves(params))
    for g, r in zip(grads, ref_leaves):
        assert g.shape == r.shape and g.dtype == torch.float32
        bound = GRAD_TOL[dtype] * float(r.abs().max())
        assert float((g - r).abs().max()) <= bound
        assert bool(g.any())


def _token_xent(logits, labels, xp):
    """Per-token cross entropy as the reference's ``_xent`` reads it: the
    f32 logsumexp of the compute-dtype logits, less the label's logit
    widened to f32."""
    if xp is torch:
        lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
        return lse - logits.gather(-1, labels[..., None])[..., 0].to(torch.float32)
    lse = jax.nn.logsumexp(logits.astype(jnp.float32), axis=-1)
    return lse - jnp.take_along_axis(logits, labels[..., None], axis=-1)[..., 0].astype(
        jnp.float32)


@pytest.mark.parametrize("arch", MOE)
def test_moe_bf16_loss_and_grads_match_reference_off_near_ties(arch):
    """The mixtures of experts in bf16: a token whose K-th and (K+1)-th
    router logits lie within 2 bf16 units at some layer may reach another
    expert in the two frameworks (`tests/test_torch_models.py`), and its
    loss then differs by about 0.1 (the loss of the whole batch by 1.2e-3
    here).  So the mean token cross entropy over the other tokens (those
    near ties, read from the port's router, get weight zero; at most 5 %)
    is held, with its gradient on every leaf, against the same function of
    the reference's forward run op by op (its router's bf16 logits, which
    jit fuses away): gradients within 0.1 of each leaf's largest value, the
    dense decoders' bound; the loss within 5e-4 (measured 2.5e-4 on dbrx:
    the tokens after a near tie attend to its changed state, and differ by
    up to 3e-3 each, where the dense decoders' differ by about 1e-5 in
    all)."""
    cfg, port_cfg, ref, ref_params, port, params = _pair("bfloat16", arch=arch)
    batch = _batch(cfg)
    with torch.no_grad(), near_tied_rows(2, 40) as near:
        port.forward(params, batch)
    assert near.mean() <= 0.05
    keep = (~near).astype(np.float32)

    def ref_obj(p):
        logits, _ = ref.forward(p, {"tokens": jnp.asarray(batch["tokens"])})
        per = _token_xent(logits, jnp.asarray(batch["labels"]), jnp)
        return (per * keep).sum() / keep.sum()

    with jax.disable_jit():
        want, ref_grads = jax.value_and_grad(ref_obj)(ref_params)
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    logits, _ = port.forward(params, {"tokens": batch["tokens"]})
    per = _token_xent(logits, torch.from_numpy(batch["labels"]).long(), torch)
    got = (per * torch.from_numpy(keep)).sum() / float(keep.sum())
    grads = torch.autograd.grad(got, leaves)
    assert abs(float(got.detach()) - float(want)) <= 5e-4
    ref_leaves = tree.leaves(params_from_reference(_np_tree(ref_grads), port_cfg, "cpu",
                                                   masters=True))
    assert len(ref_leaves) == len(grads)
    for g, r in zip(grads, ref_leaves):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert float((g - r).abs().max()) <= GRAD_TOL["bfloat16"] * float(r.abs().max())
        assert bool(g.any())


# ------------------------------------------------------------------ kernels
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 5])
def test_flash_attention_gradients_equal_plain_autograd(dtype, window):
    """On the host the wrapper's forward is the twin and its backward the
    twin's recompute: gradients identical to autograd through the twin."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).to(dtype) for s in
               ((2, 4, 12, 16), (2, 2, 12, 16), (2, 2, 12, 16)))
    dout = torch.randn((2, 4, 12, 16), generator=g).to(dtype)
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, True, window, 0)
        grads.append((out, torch.autograd.grad(out, leaves, dout)))
    (out, got), (out_p, want) = grads
    assert torch.equal(out, out_p)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
    assert fa.LAUNCHES == 0


def _mlstm_grads(fn, args, state, dout, chunk):
    leaves = [t.clone().requires_grad_() for t in args]
    st = None if state is None else tuple(t.clone().requires_grad_() for t in state)
    h, (S, n) = fn(*leaves, state=st, chunk=chunk)
    inputs = leaves + list(st or ())
    return (h, S, n), torch.autograd.grad((h, S, n), inputs, dout)


def _mlstm_case(BH, S, Dh, dtype, carried, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    args = [rnd(BH, S, Dh).to(dtype), (rnd(BH, S, Dh) / Dh**0.5).to(dtype),
            rnd(BH, S, Dh).to(dtype),
            torch.nn.functional.logsigmoid(rnd(BH, S) + 2.0), rnd(BH, S).clamp(-2, 1)]
    state = (rnd(BH, Dh, Dh) * 0.1, rnd(BH, Dh)) if carried else None
    dout = (rnd(BH, S, Dh).to(dtype), rnd(BH, Dh, Dh), rnd(BH, Dh))
    move = lambda ts: None if ts is None else [t.to(device) for t in ts]  # noqa: E731
    return move(args), move(state), tuple(move(dout))


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_chunk_gradients_equal_plain_autograd(dtype, carried):
    """On the host the wrapper's forward is the twin and its backward the
    twin's recompute: h, the final state and every gradient (q, k, v, both
    log gates, the initial state) identical to autograd through the twin,
    over three chunks."""
    args, state, dout = _mlstm_case(3, 24, 16, dtype, carried)
    (out, got), (out_p, want) = (_mlstm_grads(fn, args, state, dout, 8)
                                 for fn in (mc.mlstm_chunk, mc.mlstm_chunk_plain))
    assert len(got) == len(want) == (7 if carried else 5)
    for a, b in zip(out + got, out_p + want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert mc.LAUNCHES == 0


def test_mlstm_chunk_gradients_finite_where_masked_gates_overflow():
    """Forget gates of log -60 a position: the masked pairs' gates reach
    60 x 15 and their exponentials overflow.  The twin masks before the
    exponential, so the gradients stay finite (the reference's jnp scan,
    which masks after it, gives non-finite log_f gradients here: its exp
    backward multiplies a zero cotangent by inf), and h is the reference
    oracle's."""
    args, _, _ = _mlstm_case(2, 32, 16, torch.float32, False, seed=4)
    args[3] = torch.full_like(args[3], -60.0)
    leaves = [t.clone().requires_grad_() for t in args]
    h, _ = mc.mlstm_chunk(*leaves, chunk=16)
    grads = torch.autograd.grad(h.sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    want, _ = mlstm_ref(*(jnp.asarray(t.numpy()) for t in args))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_chunk_gradients_on_the_card(dtype, carried):
    """On the card the forward is the kernel (one launch; h and the state
    within the kernel tests' bounds of the twin's) and the gradients are
    bit for bit autograd through the twin on the same card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, state, dout = _mlstm_case(4, 96, 64, dtype, carried, "cuda")
    before = mc.LAUNCHES
    (out, got) = _mlstm_grads(mc.mlstm_chunk, args, state, dout, 32)
    assert mc.LAUNCHES == before + 1
    (out_p, want) = _mlstm_grads(mc.mlstm_chunk_plain, args, state, dout, 32)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    torch.testing.assert_close(out[1], out_p[1], rtol=2e-4, atol=2e-4)
    err = (out[0].float() - out_p[0].float()).abs()
    assert bool((err <= 2**-7 * out_p[0].float().abs() + 2e-4).all())


# ------------------------------------------------- per-unit checkpointing
REMAT = ("gemma3-1b", "minicpm3-4b", "llama-3.2-vision-11b", "qwen3-moe-235b-a22b",
         "xlstm-1.3b", "recurrentgemma-2b")


def _remat_case(arch, units=2, seed=0):
    """A reduced config of ``units`` whole units of its layer kinds and one
    layer more (unwrapped, as the reference's loop after its scan, where
    the unit has more than one layer),
    f32 masters drawn on the host, and a batch of 2 x 40."""
    base = get_arch(arch)
    u = len(base.layer_unit)
    cfg = base.reduced(num_layers=units * u + 1)
    if arch == "xlstm-1.3b":
        cfg = dataclasses.replace(cfg, mlstm_chunk=12)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(seed), masters=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=seed + 1).items()}
    return cfg, model, params, batch


def _direct(fn, *args, **kwargs):
    return fn(*args)


def _loss_and_grads(model, params, batch):
    """The loss in two chunks of 20 positions and its gradient tree."""
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch, 20)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", REMAT)
def test_unit_checkpoint_keeps_loss_and_grads_bit_identical(arch, monkeypatch):
    """Each whole unit runs under `checkpoint` (counted: the units and the
    loss chunks), and the loss and every gradient leaf are bit-identical
    to the same step with `checkpoint` calling the function directly: the
    recompute (through the kernels' autograd Functions, the experts'
    sort, the sLSTM loop, the RG-LRU scan) gives the same bits."""
    cfg, model, params, batch = _remat_case(arch)
    calls = []

    def counted(fn, *args, **kwargs):
        calls.append(fn.__name__)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kwargs)

    monkeypatch.setattr(model_mod, "checkpoint", counted)
    loss, grads = _loss_and_grads(model, params, batch)
    units = cfg.num_layers // len(cfg.layer_unit)
    assert calls.count("_layers") == units and calls.count("_xent") == 2
    monkeypatch.setattr(model_mod, "checkpoint", _direct)
    want, want_grads = _loss_and_grads(model, params, batch)
    assert torch.equal(loss, want)
    for g, w in zip(grads, want_grads):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _saved_bytes(fn) -> int:
    """Bytes of the distinct storages autograd saves while ``fn`` runs."""
    seen = {}

    def pack(t):
        seen[id(t.untyped_storage())] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


@pytest.mark.parametrize("arch", ["gemma3-1b", "xlstm-1.3b"])
def test_unit_checkpoint_bounds_saved_bytes(arch, monkeypatch):
    """Four whole units and one layer more, the loss in two chunks of 20.
    The bound, from the shapes: the residual stream (B, S, D) in the
    compute dtype at each of the 4 unit boundaries, plus one unit's
    internals (what its u layers save when run alone without the
    checkpoint), plus the loss chunk's logits (B, 20, V) in the compute
    dtype and in f32.  Without the checkpoint the same loss saves every
    layer's internals, past the bound."""
    cfg, model, params, batch = _remat_case(arch, units=4)
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    B, S = batch["tokens"].shape[:2]
    u = len(cfg.layer_unit)
    item = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)).element_size()
    x = torch.zeros((B, S, cfg.d_model), dtype=getattr(torch, cfg.compute_dtype))
    positions = torch.arange(S)[None, :].expand(B, S)
    with torch.enable_grad():
        unit = _saved_bytes(lambda: model._layers(params["layers"][:u], x, positions, None, 0))
        bound = 4 * B * S * cfg.d_model * item + unit + B * 20 * cfg.vocab_size * (item + 4)
        saved = _saved_bytes(lambda: model.loss(params, batch, 20))
        monkeypatch.setattr(model_mod, "checkpoint", _direct)
        whole = _saved_bytes(lambda: model.loss(params, batch, 20))
    assert saved <= bound < whole, (saved, bound, whole)


# ------------------------------------------------------------------ trainer
@pytest.mark.parametrize("compress", [False, True])
def test_train_main_runs_on_the_host(compress, capsys):
    """A reduced gemma3 for 3 steps, with and without --compress-grads:
    finite losses, the reference's log lines, the exchange timed, the
    plain twins only (no launches)."""
    argv = ["--arch", "gemma3-1b", "--steps", "3", "--batch", "2", "--seq", "24",
            "--log-every", "1", "--device", "cpu"]
    seen = []
    res = train_mod.main(argv + (["--compress-grads"] if compress else []),
                         inspect=lambda step, g, e, e_new: seen.append(step))
    out = capsys.readouterr().out
    assert "training gemma3-1b-smoke" in out and out.rstrip().endswith("done.")
    assert [line.split()[1] for line in out.splitlines() if line.startswith("step")] == \
        ["0", "1", "2"]
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert len(res.exchange_s) == (3 if compress else 0)
    assert seen == ([0, 1, 2] if compress else [])
    if compress:
        for p, e in zip(tree.leaves(res.params), tree.leaves(res.error_feedback)):
            assert e.shape == p.shape and e.dtype == torch.float32
    assert qt.LAUNCHES_QUANTIZE == 0 and fa.LAUNCHES == 0


def test_train_compressed_step_is_reproducible():
    """The noise stream is seeded from (7, step): two runs from the same
    weights give the same losses, parameters and error feedback."""
    cfg = train_mod.config_for("gemma3-1b", layers=2)
    runs = [
        train_mod.train(cfg, steps=2, batch=2, seq=16, compress_grads=True, device="cpu",
                        log_every=10)
        for _ in range(2)
    ]
    assert runs[0].losses == runs[1].losses
    for a, b in zip(tree.leaves(runs[0].error_feedback), tree.leaves(runs[1].error_feedback)):
        assert torch.equal(a, b)
    assert train_mod.noise_seed(1) != train_mod.noise_seed(2)


def test_compressed_step_is_the_trainers_step():
    """`make_compressed_step` driven by hand, with noise from host
    generators seeded from (7, step), reproduces `train`'s compressed run
    exactly: losses, parameters and error feedback.  Its hook sees each
    step's gradients and both error feedbacks."""
    cfg = train_mod.config_for("gemma3-1b", layers=2)
    res = train_mod.train(cfg, steps=2, batch=2, seq=16, compress_grads=True, device="cpu",
                          log_every=10)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0), masters=True)
    opt = AdamW(schedule=cosine_schedule(3e-3, 1, 2))
    step_fn, opt_state, errors = make_compressed_step(model, opt), opt.init(params), None
    data = make_batch_iterator(SyntheticTokens(cfg.vocab_size, 16, 2))
    seen, losses = [], []
    for step in range(2):
        gen = torch.Generator().manual_seed(train_mod.noise_seed(step))
        params, opt_state, errors, stats = step_fn(
            params, opt_state, errors, next(data), gen,
            lambda g, e, e_new: seen.append(len(tree.leaves(g))))
        losses.append(float(stats["loss"]))
        assert stats["exchange_s"] >= 0 and stats["inspect_s"] >= 0
    data.close()
    assert losses == res.losses
    assert seen == [len(tree.leaves(params))] * 2
    for a, b in zip(tree.leaves(params) + tree.leaves(errors),
                    tree.leaves(res.params) + tree.leaves(res.error_feedback)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["musicgen-medium", "llama-3.2-vision-11b"])
def test_train_main_takes_codebooks_and_encoder_inputs(arch, capsys):
    """The reduced audio and vision configs train through `train.main` on
    the host: the synthetic source draws (B, S, 4) tokens or encoder
    inputs, as the reference's trainer asks it to."""
    res = train_mod.main(["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16",
                          "--device", "cpu", "--compress-grads"])
    out = capsys.readouterr().out
    assert f"training {arch}-smoke" in out and out.rstrip().endswith("done.")
    assert res.steps == [0, 1] and all(np.isfinite(res.losses))
    cfg = train_mod.config_for(arch)
    data = SyntheticTokens(cfg.vocab_size, 16, 2, num_codebooks=cfg.num_codebooks,
                           encoder_shape=(cfg.encoder_len, cfg.encoder_dim)
                           if cfg.encoder_dim else None)
    ref = RefTokens(cfg.vocab_size, 16, 2, num_codebooks=cfg.num_codebooks,
                    encoder_shape=(cfg.encoder_len, cfg.encoder_dim) if cfg.encoder_dim else None)
    a, b = data.next_batch(), ref.next_batch()
    assert set(a) == set(b) == ({"tokens", "labels", "encoder"} if cfg.encoder_dim
                                else {"tokens", "labels"})
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    assert a["tokens"].shape == ((2, 16, 4) if cfg.num_codebooks else (2, 16))


def test_train_main_default_arch_on_the_host(capsys):
    """No ``--arch``: the reference's default, stablelm-1.6b, reduced."""
    res = train_mod.main(["--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "training stablelm-1.6b-smoke" in out and out.rstrip().endswith("done.")
    assert res.steps == [0, 1] and all(np.isfinite(res.losses))
    assert res.restarts == 0 and res.stragglers == [] and res.save_s == []


@pytest.mark.parametrize("extra", [[], ["--plan-collectives"]])
def test_inject_failure_without_a_directory_exits(extra, capsys):
    """The reference's message, after the steps before the failure ran."""
    with pytest.raises(SystemExit, match="injected node failure at step 2 — rerun with "
                                         "--checkpoint-dir for automatic recovery"):
        train_mod.main(["--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
                        "--inject-failure", "2", "--log-every", "1", *extra])
    out = capsys.readouterr().out
    assert [line.split()[1] for line in out.splitlines() if line.startswith("step")] == \
        ["0", "1"]
    assert ("[planner]" in out) == bool(extra)


@pytest.mark.parametrize("compress", [False, True])
def test_recovered_run_equals_its_replay_by_hand(tmp_path, compress, capsys):
    """xLSTM through ``train.main --checkpoint-dir --inject-failure 4
    --checkpoint-every 2``: steps 0-3 run, step 4 fails, the save of step 2
    is restored and steps 3-5 run on batches 4-6 (the iterator is not
    rewound), the error feedback carried over.  The same steps replayed by
    hand from an in-memory copy of the state after step 2 give the same
    losses, parameters, moments and error feedback, bit for bit."""
    argv = ["--arch", "xlstm-1.3b", "--steps", "6", "--batch", "2", "--seq", "16",
            "--checkpoint-every", "2", "--inject-failure", "4", "--checkpoint-dir",
            str(tmp_path), "--device", "cpu", "--log-every", "1"]
    res = train_mod.main(argv + (["--compress-grads"] if compress else []))
    out = capsys.readouterr().out
    assert "recovered from 1 failure(s) via checkpoint restore" in out
    assert res.restarts == 1 and res.steps == [0, 1, 2, 3, 3, 4, 5]
    assert len(res.save_s) == len(res.write_s) == 2 and len(res.restore_s) == 1

    cfg = train_mod.config_for("xlstm-1.3b")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0), masters=True)
    opt = AdamW(schedule=cosine_schedule(3e-3, 6 // 10 + 1, 6))
    step_fn = make_compressed_step(model, opt) if compress else make_train_step(model, opt)
    opt_state, errors, losses, saved = opt.init(params), None, [], None
    data = make_batch_iterator(SyntheticTokens(cfg.vocab_size, 16, 2))
    for i, step in enumerate([0, 1, 2, 3, 3, 4, 5]):
        if i == 4:  # the failure: back to the state after step 2
            params, opt_state = saved
        if compress:
            gen = torch.Generator().manual_seed(train_mod.noise_seed(step))
            params, opt_state, errors, stats = step_fn(params, opt_state, errors, next(data), gen)
        else:
            params, opt_state, stats = step_fn(params, opt_state, next(data))
        losses.append(float(stats["loss"]))
        if i == 2:
            saved = (tree.map_leaves(torch.clone, params),
                     {**tree.map_leaves(torch.clone, {k: opt_state[k] for k in ("m", "v")}),
                      "count": opt_state["count"]})
    data.close()
    assert losses == res.losses
    assert res.opt_state["count"] == opt_state["count"] == 6
    got = tree.leaves(res.params) + tree.leaves(res.opt_state["m"]) + tree.leaves(res.opt_state["v"])
    want = tree.leaves(params) + tree.leaves(opt_state["m"]) + tree.leaves(opt_state["v"])
    if compress:
        got += tree.leaves(res.error_feedback)
        want += tree.leaves(errors)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_config_for_reduces_as_the_reference():
    full = get_arch("gemma3-1b")
    assert train_mod.config_for("gemma3-1b", full_config=True) == full
    cfg = train_mod.config_for("gemma3-1b", d_model=96, layers=3)
    assert (cfg.d_model, cfg.head_dim, cfg.num_layers, cfg.vocab_size) == (96, 24, 3, 4096)
    assert train_mod.config_for("stablelm-1.6b").vocab_size == 4096
