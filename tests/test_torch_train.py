"""The port's training path (`repro_torch.launch.train` and what it runs)
against the JAX package's, on the host, given the same weights, batches
and gradients.

Tolerances (f32 unless stated):
  * synthetic batches: byte-identical (the same NumPy stream);
  * `cosine_schedule`: 1e-6 relative (both compute in f32; ``cos`` may
    differ by an ulp between libraries); `constant_schedule` exact;
  * `AdamW.update`: 1e-6 relative plus 1e-9 absolute on the new
    parameters, masters and moments (elementwise f32 with the same
    roundings; the global norm sums in another order, ``b ** count`` and
    ``sqrt`` may differ by an ulp);
  * `Model.loss`: 2e-4 absolute (measured about 5e-7 in f32, 1e-5 in
    bf16) on a reduced gemma3 (window 16) over 40 positions: two loss
    chunks of 20, and one chunk of 40 when the chunk (16) does not divide
    it; under both of the reference's ``attention_impl``;
  * gradients, leaf by leaf through `convert.params_from_reference`:
    1e-4 of the leaf's largest reference value in f32 (measured 2.5e-6);
    in bf16 0.1 of it (measured 0.043: every gradient that flows through
    a cast is rounded to bf16 once, at other places in the two
    frameworks);
  * `make_train_step` with 2 microbatches: loss 2e-4, parameters after
    the step 1e-7 absolute.  The step's AdamW takes eps = 1, so that its
    update is about lr x g, linear in the accumulated gradients (with the
    default eps = 1e-8 it is about lr x sign(g), and a gradient as small
    as the frameworks' difference may take either sign);
  * `flash_attention`'s gradients on the host: identical to autograd
    through `flash_attention_plain` (the backward is that recompute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.data.pipeline import SyntheticTokens as RefTokens
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models.model import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_reference
from repro_torch.data.pipeline import SyntheticTokens, make_batch_iterator
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quant as qt
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import loss_and_grad, make_compressed_step, make_train_step
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamW, constant_schedule, cosine_schedule

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
def _pair(dtype="float32", impl="chunked", seed=0, **kw):
    cfg = dataclasses.replace(
        REF_ARCHS["gemma3-1b"].reduced(compute_dtype=dtype, **kw), attention_impl=impl
    )
    ref = ref_build_model(cfg)
    ref_params = ref.init(jax.random.PRNGKey(seed))
    port_cfg = ModelConfig(**dataclasses.asdict(cfg))
    port = build_model(port_cfg, "cpu")
    params = params_from_reference(ref_params, port_cfg, "cpu", masters=True)
    return cfg, port_cfg, ref, ref_params, port, params


def _batch(cfg, B=2, S=40, seed=1):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


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


def test_training_refuses_recurrent_kinds():
    """xLSTM is served, not trained: `mlstm_chunk` has no backward."""
    cfg = get_arch("xlstm-1.3b").reduced()
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="mlstm_chunk has no backward"):
        model.loss(params, {"tokens": np.zeros((1, 4), np.int32),
                            "labels": np.zeros((1, 4), np.int32)})
    with pytest.raises(NotImplementedError, match="mlstm_chunk has no backward"):
        model.init(torch.Generator().manual_seed(0), masters=True)


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


@pytest.mark.parametrize("flag", [["--checkpoint-dir", "ckpt"], ["--inject-failure", "2"],
                                  ["--inject-failure", "2", "--plan-collectives"]])
def test_train_unported_flags_raise(flag):
    """Checkpointing and failure injection are refused before anything
    runs, the collective planner (ported) included."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 10"):
        train_mod.main(["--device", "cpu", "--steps", "1", *flag])


def test_config_for_reduces_as_the_reference():
    full = get_arch("gemma3-1b")
    assert train_mod.config_for("gemma3-1b", full_config=True) == full
    cfg = train_mod.config_for("gemma3-1b", d_model=96, layers=3)
    assert (cfg.d_model, cfg.head_dim, cfg.num_layers, cfg.vocab_size) == (96, 24, 3, 4096)
    assert train_mod.config_for("stablelm-1.6b").vocab_size == 4096
