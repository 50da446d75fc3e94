"""The benchmark's LM tokens: a frozen copy of the port's synthetic token
stream (a Zipf unigram base with copied motifs, so that the loss is
learnable and not degenerate), numpy only, and the pool of batches a
training run draws its steps from.

No corpus is in the repository; every sequence is ``seq_len + 1`` tokens
in ``[1, vocab_size)``, split by the entry into inputs and next-token
labels.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sample_tokens", "make_pool"]


def sample_tokens(rng: np.random.Generator, batch: int, seq_len: int,
                  vocab_size: int, zipf_a: float = 1.2, motif_len: int = 16,
                  motif_prob: float = 0.25) -> np.ndarray:
    """(batch, seq_len + 1) int32 tokens: Zipf-distributed ids folded into
    ``[1, vocab_size)`` (0 is kept free as pad / bos), then, in each row,
    spans of ``motif_len`` copied forward from earlier in the row."""
    L = seq_len + 1
    toks = rng.zipf(zipf_a, size=(batch, L)).astype(np.int64)
    toks = 1 + (toks - 1) % (vocab_size - 1)
    n_motifs = max(1, int(motif_prob * L / motif_len))
    for b in range(batch):
        for _ in range(n_motifs):
            if L <= 2 * motif_len:
                break
            src = rng.integers(0, L - 2 * motif_len)
            dst = rng.integers(src + motif_len, L - motif_len)
            toks[b, dst:dst + motif_len] = toks[b, src:src + motif_len]
    return toks.astype(np.int32)


def make_pool(traffic: dict, vocab_size: int, seed: int) -> np.ndarray:
    """The run's ``pool_batches`` batches, ``(pool_batches, batch,
    seq_len + 1)`` int32, drawn from the seed with the traffic's token
    statistics."""
    rng = np.random.default_rng([int(seed), 3])
    kw = traffic.get("tokens", {})
    return np.stack([
        sample_tokens(rng, int(traffic["batch"]), int(traffic["seq_len"]),
                      vocab_size, **kw)
        for _ in range(int(traffic["pool_batches"]))])
