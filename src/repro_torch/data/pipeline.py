"""Deterministic synthetic token pipeline (a NumPy copy of
`repro.data.pipeline`: the same seed gives byte-identical batches).

Produces reproducible (tokens, labels) batches for training runs and
examples.  The stream is a seeded Markov-ish token process (cheap, but with
learnable low-order structure so loss curves actually descend),
double-buffered via a background thread.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["SyntheticTokens", "make_batch_iterator"]


class SyntheticTokens:
    """Seeded synthetic LM data with learnable bigram structure."""

    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        batch_size: int,
        seed: int = 0,
        num_codebooks: int = 0,
        encoder_shape: tuple | None = None,
    ):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_size
        self.codebooks = num_codebooks
        self.encoder_shape = encoder_shape
        self._rng = np.random.default_rng(seed)
        # Fixed sparse bigram transition: next ~ (cur * A + noise) mod V.
        self._mult = int(self._rng.integers(3, 17)) * 2 + 1

    def _tokens(self, n):
        shape = (
            (self.batch, n, self.codebooks) if self.codebooks else (self.batch, n)
        )
        x = np.empty(shape, dtype=np.int32)
        cur = self._rng.integers(0, self.vocab, shape[:1] + shape[2:])
        for t in range(n):
            noise = self._rng.integers(0, max(self.vocab // 64, 2), cur.shape)
            cur = (cur * self._mult + noise) % self.vocab
            x[:, t] = cur
        return x

    def next_batch(self) -> dict:
        toks = self._tokens(self.seq + 1)
        batch = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }
        if self.encoder_shape is not None:
            batch["encoder"] = self._rng.standard_normal(
                (self.batch, *self.encoder_shape), dtype=np.float32
            ).astype(np.float32)
        return batch


def make_batch_iterator(source: SyntheticTokens, prefetch: int = 2):
    """Background-thread double buffering (host-side input pipeline).

    The consumer gets ``source``'s batches in order, however slowly it
    reads.  The reference's worker drops the batch it holds whenever the
    queue stays full for 0.5 s (a step slower than that), so its stream
    depends on the steps' timing; the port keeps offering the batch."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        batch = None
        while not stop.is_set():
            if batch is None:
                batch = source.next_batch()
            try:
                q.put(batch, timeout=0.5)
                batch = None
            except queue.Full:  # a slow consumer: offer the same batch again
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    class _Iter:
        def __next__(self):
            return q.get()

        def __iter__(self):
            return self

        def close(self):
            stop.set()

    return _Iter()
