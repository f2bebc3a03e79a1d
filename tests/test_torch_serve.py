"""`repro_torch.launch.serve` on the host against the reference's wave loop
(`repro.launch.serve.main`'s loop over ``build_model(cfg).forward`` and a
jitted ``decode_step``), on the same weights and the same prompts, in f32:
the same greedy tokens, and logits within 2e-4 (as
`tests/test_integration.py`) at every greedy choice.  xLSTM serves with
``mlstm_chunk = 12``, so each 20-token prompt is a full chunk and a padded
one, and every decode tick carries the recurrent state.  The remaining
families serve too: MLA (minicpm3-4b), the experts (dbrx-132b,
qwen3-moe-235b-a22b), cross-attention over each wave's encoder inputs
(llama-3.2-vision-11b) and audio codebooks besides (musicgen-medium); the
encoder inputs the port draws are the reference's, bit for bit in bf16.
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
    the produced tokens, the logits of every greedy choice and each wave's
    encoder inputs."""
    model = ref_build_model(cfg)
    rng = np.random.default_rng(seed)
    P = prompt_len
    L = P + max_new + 1
    decode = jax.jit(model.decode_step)
    tok_tail = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    queue = [
        (i, rng.integers(0, cfg.vocab_size, (P, *tok_tail)).astype(np.int32))
        for i in range(requests)
    ]
    produced = {i: [] for i in range(requests)}
    logits_out, encoders = [], []
    while queue:
        wave = [queue.pop(0) for _ in range(min(slots, len(queue)))]
        n = len(wave)
        batch = {"tokens": jnp.asarray(np.stack([p for _, p in wave]))}
        enc = None
        if cfg.encoder_dim:
            enc = jnp.asarray(
                rng.standard_normal((n, cfg.encoder_len, cfg.encoder_dim)), jnp.bfloat16)
            batch["encoder"] = enc
            encoders.append(enc)
        cache = model.init_cache(n, L)
        logits, cache = model.forward(params, batch, cache=cache, pos=0)
        steps = [np.asarray(logits[:, -1])]
        cur = np.asarray(jnp.argmax(logits[:, -1], axis=-1), np.int32)
        for t in range(max_new):
            for s, (rid, _) in enumerate(wave):
                produced[rid].append(int(np.ravel(cur[s])[0]))
            step = {"tokens": jnp.asarray(cur.reshape(n, 1, *tok_tail))}
            if enc is not None:
                step["encoder"] = enc
            logits, cache = decode(params, cache, step, P + t)
            steps.append(np.asarray(logits))
            cur = np.asarray(jnp.argmax(logits, axis=-1), np.int32)
        logits_out.append(steps)
    return produced, logits_out, encoders


@pytest.mark.parametrize("name", [
    "gemma3-1b", "stablelm-1.6b", "xlstm-1.3b", "minicpm3-4b", "dbrx-132b",
    "qwen3-moe-235b-a22b", "llama-3.2-vision-11b", "musicgen-medium",
])
def test_serve_matches_reference_wave_loop(name):
    extra = dict(mlstm_chunk=12) if name == "xlstm-1.3b" else {}
    cfg = REF_ARCHS[name].reduced(vocab_size=512, compute_dtype="float32", **extra)
    ref_params = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    kw = dict(slots=2, requests=3, prompt_len=20, max_new=4, seed=7)
    want, want_logits, want_enc = _reference_waves(cfg, ref_params, **kw)
    port_cfg = ModelConfig(**dataclasses.asdict(cfg))
    params = params_from_reference(ref_params, port_cfg, "cpu")
    res = serve(port_cfg, params, device="cpu", **kw)
    assert res.produced == want
    assert (res.waves, res.ticks, res.tokens) == (2, 8, 12)
    assert len(res.prefill_s) == 2 and len(res.tick_s) == 8
    for got_wave, want_wave in zip(res.logits, want_logits, strict=True):
        assert len(got_wave) == 1 + kw["max_new"]
        for got, w in zip(got_wave, want_wave, strict=True):
            assert got.shape == w.shape
            np.testing.assert_allclose(got.numpy(), w, rtol=2e-4, atol=2e-4)
    assert len(res.encoder) == len(want_enc) == (2 if cfg.encoder_dim else 0)
    for got, w in zip(res.encoder, want_enc):  # bit for bit in bf16
        assert got.dtype == torch.bfloat16
        assert got.view(torch.int16).numpy().tobytes() == np.asarray(w).view(np.int16).tobytes()


def test_encoder_inputs_round_as_the_reference():
    """The serve's bf16 encoder inputs at llama-3.2-vision's published
    shape: torch's f64 -> bf16 conversion on the host gives the bits of
    ``jnp.asarray(x, jnp.bfloat16)``, which rounds through f32 (one
    rounding straight from f64 differs in about 1e-5 of the values here)."""
    x = np.random.default_rng(0).standard_normal((1, 1601, 7680))
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    want = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.int16)
    assert got.tobytes() == want.tobytes()
    via_f32 = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).view(torch.int16)
    assert via_f32.numpy().tobytes() == want.tobytes()


def test_main_runs_on_the_host(capsys):
    produced = main([
        "--device", "cpu", "--requests", "3", "--slots", "2",
        "--prompt-len", "20", "--max-new", "3",
    ])
    assert sorted(produced) == [0, 1, 2]
    assert all(len(v) == 3 and all(0 <= t < 512 for t in v) for v in produced.values())
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["minicpm3-4b", "qwen3-moe-235b-a22b",
                                  "llama-3.2-vision-11b", "musicgen-medium"])
def test_main_serves_every_family_on_the_host(arch, capsys):
    produced = main(["--arch", arch, "--device", "cpu", "--requests", "3", "--slots", "2",
                     "--prompt-len", "12", "--max-new", "2"])
    assert sorted(produced) == [0, 1, 2]
    assert all(len(v) == 2 and all(0 <= t < 512 for t in v) for v in produced.values())
    assert "served 3 requests / 6 tokens" in capsys.readouterr().out
