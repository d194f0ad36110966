"""Synthetic LM token streams for the assigned-architecture examples/smokes.

A tiny order-2 Markov chain over the vocabulary gives the stream enough
structure that a decoder's loss visibly drops within a few hundred steps
(the end-to-end ~100M-model training driver in examples/train_lm.py needs a
learnable signal, not uniform noise).
"""
from __future__ import annotations

import numpy as np


def synthetic_lm_stream(n_tokens: int, vocab_size: int, seed: int = 0,
                        branch: int = 4) -> np.ndarray:
    """Markov stream: each (prev token) allows only ``branch`` successors."""
    rng = np.random.RandomState(seed)
    succ = rng.randint(0, vocab_size, size=(vocab_size, branch))
    out = np.empty(n_tokens, np.int32)
    t = rng.randint(vocab_size)
    for i in range(n_tokens):
        out[i] = t
        t = succ[t, rng.randint(branch)]
    return out


def lm_batch_iterator(stream: np.ndarray, batch: int, seq_len: int, seed: int = 0):
    """Yields {"tokens": (B,S), "labels": (B,S)} forever (next-token shift)."""
    rng = np.random.RandomState(seed)
    n = len(stream) - seq_len - 1
    assert n > 0, "stream too short"
    while True:
        starts = rng.randint(0, n, size=batch)
        toks = np.stack([stream[s : s + seq_len] for s in starts])
        labs = np.stack([stream[s + 1 : s + seq_len + 1] for s in starts])
        yield {"tokens": toks, "labels": labs}
