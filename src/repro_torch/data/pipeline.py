"""Sharded synthetic token pipeline with deterministic resume.

The port's own copy of the JAX package's ``data/pipeline.py`` (numpy
only): the same calls in the same order, so ``batch_at`` gives the
reference's bits for every ``(seed, step, host_index, n_hosts)``.

Each global step's batch is a pure function of (seed, step): a restart at
step k reproduces the exact stream without replaying k-1 steps (the
checkpoint stores only the step counter).  A host materializes only its
``(host_index, n_hosts)`` slice of the global batch.  A background
prefetch thread keeps ``buffer_size`` batches ready.

Tokens follow a fixed random first-order Markov (bigram) chain derived
from the seed, not uniform noise: uniform tokens pin the loss to the
ln(vocab) floor, so a training run would have no signal to descend.  A
peaked bigram table gives the stream a skewed unigram distribution and
low conditional entropy.  The table is capped at ``_MAX_BIGRAM`` active
tokens so that a real model's vocabulary does not materialize a vocab^2
table: such streams use the first ``_MAX_BIGRAM`` ids.
"""
from __future__ import annotations

import functools
import queue
import threading
from typing import Iterator

import numpy as np

_MAX_BIGRAM = 1024     # active-token cap: bigram table is at most this wide
_BIGRAM_PEAK = 6.0     # logit scale: cond. entropy ~1 nat, unigram ~4.1 vs ln(256)=5.5


@functools.lru_cache(maxsize=8)
def _bigram_cdf(seed: int, vocab: int) -> np.ndarray:
    """(v_eff, v_eff) per-row transition CDF, a pure function of the seed."""
    v_eff = min(vocab, _MAX_BIGRAM)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xB16A]))
    logits = rng.standard_normal((v_eff, v_eff)) * _BIGRAM_PEAK
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    return np.cumsum(p, axis=1)


class TokenPipeline:
    """Seeded synthetic token stream with per-host sharding and prefetch."""

    def __init__(self, vocab: int, global_batch: int, seq_len: int,
                 seed: int = 0, host_index: int = 0, n_hosts: int = 1,
                 buffer_size: int = 2):
        if global_batch % n_hosts:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {n_hosts} hosts")
        self.vocab = vocab
        self.global_batch = global_batch
        self.local_batch = global_batch // n_hosts
        self.seq = seq_len
        self.seed = seed
        self.host_index = host_index
        self.n_hosts = n_hosts
        self.buffer_size = buffer_size

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a global step (host-local slice)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index]))
        cdf = _bigram_cdf(self.seed, self.vocab)
        v_eff = cdf.shape[0]
        b, s = self.local_batch, self.seq + 1
        tokens = np.zeros((b, s), np.int32)
        tokens[:, 0] = rng.integers(0, v_eff, b)
        u = rng.random((b, s - 1))
        for t in range(s - 1):
            rows = cdf[tokens[:, t]]                       # (b, v_eff)
            # clamp: float cumsum can leave cdf[-1] a hair under 1.0, and a
            # draw above it would index past the table
            nxt = (rows < u[:, [t]]).sum(axis=1)
            tokens[:, t + 1] = np.minimum(nxt, v_eff - 1)
        return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}

    def iterate(self, start_step: int = 0) -> Iterator[tuple[int, dict]]:
        """Prefetching iterator of ``(step, batch)`` resuming at
        ``start_step``.  Closing it (or dropping it) stops the producer
        thread."""
        q: queue.Queue = queue.Queue(maxsize=self.buffer_size)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                item = (step, self.batch_at(step))
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            t.join(timeout=5)
