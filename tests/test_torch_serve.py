"""`repro_torch.launch.serve` on the host against the reference's wave loop
(`repro.launch.serve.main`'s loop over ``build_model(cfg).forward`` and a
jitted ``decode_step``), on the same weights and the same prompts, in f32:
the same greedy tokens, and logits within 2e-4 (as
`tests/test_integration.py`) at every greedy choice.  xLSTM serves with
``mlstm_chunk = 12``, so each 20-token prompt is a full chunk and a padded
one, and every decode tick carries the recurrent state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models.model import build_model as ref_build_model
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_reference
from repro_torch.launch.serve import main, serve

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)


def _reference_waves(cfg, params, *, slots, requests, prompt_len, max_new, seed):
    """The reference's serving loop (`repro.launch.serve.main`), returning
    the produced tokens and the logits of every greedy choice."""
    model = ref_build_model(cfg)
    rng = np.random.default_rng(seed)
    P = prompt_len
    L = P + max_new + 1
    decode = jax.jit(model.decode_step)
    queue = [
        (i, rng.integers(0, cfg.vocab_size, (P,)).astype(np.int32))
        for i in range(requests)
    ]
    produced = {i: [] for i in range(requests)}
    logits_out = []
    while queue:
        wave = [queue.pop(0) for _ in range(min(slots, len(queue)))]
        n = len(wave)
        batch = {"tokens": jnp.asarray(np.stack([p for _, p in wave]))}
        cache = model.init_cache(n, L)
        logits, cache = model.forward(params, batch, cache=cache, pos=0)
        steps = [np.asarray(logits[:, -1])]
        cur = np.asarray(jnp.argmax(logits[:, -1], axis=-1), np.int32)
        for t in range(max_new):
            for s, (rid, _) in enumerate(wave):
                produced[rid].append(int(cur[s]))
            step = {"tokens": jnp.asarray(cur.reshape(n, 1))}
            logits, cache = decode(params, cache, step, P + t)
            steps.append(np.asarray(logits))
            cur = np.asarray(jnp.argmax(logits, axis=-1), np.int32)
        logits_out.append(steps)
    return produced, logits_out


@pytest.mark.parametrize("name", ["gemma3-1b", "stablelm-1.6b", "xlstm-1.3b"])
def test_serve_matches_reference_wave_loop(name):
    extra = dict(mlstm_chunk=12) if name == "xlstm-1.3b" else {}
    cfg = REF_ARCHS[name].reduced(vocab_size=512, compute_dtype="float32", **extra)
    ref_params = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    kw = dict(slots=2, requests=3, prompt_len=20, max_new=4, seed=7)
    want, want_logits = _reference_waves(cfg, ref_params, **kw)
    port_cfg = ModelConfig(**dataclasses.asdict(cfg))
    params = params_from_reference(ref_params, port_cfg, "cpu")
    res = serve(port_cfg, params, device="cpu", **kw)
    assert res.produced == want
    assert (res.waves, res.ticks, res.tokens) == (2, 8, 12)
    assert len(res.prefill_s) == 2 and len(res.tick_s) == 8
    for got_wave, want_wave in zip(res.logits, want_logits, strict=True):
        assert len(got_wave) == 1 + kw["max_new"]
        for got, w in zip(got_wave, want_wave, strict=True):
            np.testing.assert_allclose(got.numpy(), w, rtol=2e-4, atol=2e-4)


def test_main_runs_on_the_host(capsys):
    produced = main([
        "--device", "cpu", "--requests", "3", "--slots", "2",
        "--prompt-len", "20", "--max-new", "3",
    ])
    assert sorted(produced) == [0, 1, 2]
    assert all(len(v) == 3 and all(0 <= t < 512 for t in v) for v in produced.values())
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out


def test_serve_raises_for_unported_inputs():
    cfg = REF_ARCHS["gemma3-1b"].reduced()
    port_cfg = ModelConfig(**dataclasses.asdict(cfg))
    for over in (dict(encoder_dim=32, encoder_len=8), dict(num_codebooks=4)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            serve(
                dataclasses.replace(port_cfg, **over), None, slots=1, requests=1,
                prompt_len=4, max_new=1, seed=0, device="cpu",
            )
