"""Batched serving: wave-based batched decode (port of
`repro.launch.serve`).

Serves a model from a request queue: up to ``slots`` requests are packed
into a batch per wave, prefilled together at position 0, then decoded in
lockstep, one `Model.decode_step` per tick, for ``max_new`` ticks; the next
wave refills the batch.  Each wave starts from a fresh cache: K/V for
attention layers, latents for MLA layers, zero recurrent state for mLSTM,
sLSTM and RG-LRU layers, which the prefill leaves for the first tick and
each tick for the next.  Greedy sampling (argmax of the compute-dtype
logits).  Prompts come from ``np.random.default_rng(seed)`` in the
reference's order, so both packages serve the same requests: first every
prompt of the queue ((P,) tokens, (P, C) with C audio codebooks), then, for
a config with cross layers, each wave's encoder inputs (n, encoder_len,
encoder_dim) from the same generator as the wave starts, f64 standard
normals converted to bf16 on the host, and passed to the prefill and to
every decode tick.  The conversion rounds through f32 (to nearest, ties to
even, twice), as the reference's ``jnp.asarray(x, jnp.bfloat16)`` does, so
both packages hold the same bits.  With codebooks each tick feeds back (n,
1, C) tokens and a request records its first codebook's.  The CLI serves
the reduced config of ``--arch`` with a vocabulary of 512, as the
reference's does; `serve` takes any config, full widths included.

Usage:
  python -m repro_torch.launch.serve --arch gemma3-1b --requests 16 --max-new 32
  python -m repro_torch.launch.serve --arch xlstm-1.3b
  python -m repro_torch.launch.serve --arch recurrentgemma-2b
  python -m repro_torch.launch.serve --arch minicpm3-4b   # also qwen3-moe-235b-a22b,
      # dbrx-132b, llama-3.2-vision-11b, musicgen-medium
  python -m repro_torch.launch.serve --device cpu     # the host, plain twins
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model

__all__ = ["ServeResult", "serve", "main"]


@dataclasses.dataclass
class ServeResult:
    """What `serve` returns.

    ``produced`` maps request id to its generated tokens (the first
    codebook's, with codebooks); ``logits`` holds, per wave, the (n, V)
    ((n, C, V) with codebooks) compute-dtype logits of each greedy choice
    (the prefill's last position, then each decode tick) on the serving
    device; ``encoder`` holds each wave's encoder inputs (bf16, on the
    device) where the config has cross layers;
    ``prefill_s`` and ``tick_s`` are host-clock seconds of each prefill and
    each decode tick, each ending with the argmax copied to the host.
    """

    produced: dict[int, list[int]]
    waves: int
    ticks: int
    tokens: int
    seconds: float
    prefill_s: list[float]
    tick_s: list[float]
    logits: list[list[torch.Tensor]]
    encoder: list[torch.Tensor] = dataclasses.field(default_factory=list)


def serve(
    cfg: ModelConfig,
    params,
    *,
    slots: int,
    requests: int,
    prompt_len: int,
    max_new: int,
    seed: int,
    device: str | torch.device = "cuda",
) -> ServeResult:
    """Serve ``requests`` random prompts of ``prompt_len`` tokens,
    ``max_new`` greedy tokens each, ``slots`` at a time, on ``device``."""
    model = build_model(cfg, resolve_device(device))
    rng = np.random.default_rng(seed)
    P = prompt_len
    L = P + max_new + 1
    tail = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    queue = [
        (i, rng.integers(0, cfg.vocab_size, (P, *tail)).astype(np.int32))
        for i in range(requests)
    ]
    produced: dict[int, list[int]] = {i: [] for i in range(requests)}
    prefill_s, tick_s, logits_out, encoders = [], [], [], []

    t0 = time.perf_counter()
    with torch.inference_mode():
        while queue:
            wave = [queue.pop(0) for _ in range(min(slots, len(queue)))]
            n = len(wave)
            extra = {}
            if cfg.encoder_dim:
                enc = rng.standard_normal((n, cfg.encoder_len, cfg.encoder_dim))
                extra["encoder"] = torch.from_numpy(enc).to(torch.bfloat16).to(model.device)
                encoders.append(extra["encoder"])
            t = time.perf_counter()
            tokens = torch.from_numpy(np.stack([p for _, p in wave])).to(model.device)
            cache = model.init_cache(n, L)
            logits, cache = model.forward(params, {"tokens": tokens, **extra}, cache=cache, pos=0)
            step_logits = [logits[:, -1].clone()]  # not a view of all (n, P, V)
            cur = step_logits[-1].argmax(dim=-1).cpu().numpy().astype(np.int32)
            prefill_s.append(time.perf_counter() - t)
            for k in range(max_new):
                t = time.perf_counter()
                for s, (rid, _) in enumerate(wave):
                    produced[rid].append(int(np.ravel(cur[s])[0]))
                step = torch.from_numpy(cur.reshape(n, 1, *tail)).to(model.device)
                logits, cache = model.decode_step(
                    params, cache, {"tokens": step, **extra}, P + k)
                step_logits.append(logits)
                cur = logits.argmax(dim=-1).cpu().numpy().astype(np.int32)
                tick_s.append(time.perf_counter() - t)
            logits_out.append(step_logits)
    seconds = time.perf_counter() - t0
    return ServeResult(
        produced=produced, waves=len(prefill_s), ticks=len(tick_s),
        tokens=sum(len(v) for v in produced.values()), seconds=seconds,
        prefill_s=prefill_s, tick_s=tick_s, logits=logits_out, encoder=encoders,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced(vocab_size=512)
    model = build_model(cfg, args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init(gen)
    res = serve(
        cfg, params, slots=args.slots, requests=args.requests,
        prompt_len=args.prompt_len, max_new=args.max_new, seed=args.seed,
        device=model.device,
    )
    print(
        f"served {args.requests} requests / {res.tokens} tokens in "
        f"{res.seconds:.2f}s ({res.tokens / max(res.seconds, 1e-9):.1f} tok/s, "
        f"{res.waves} waves, {res.ticks} ticks, {args.slots} slots)"
    )
    return res.produced


if __name__ == "__main__":
    main()
