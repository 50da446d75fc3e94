"""Synthetic LM token pipeline.

Offline container ⇒ no corpora; the LM-family architectures train/serve on a
synthetic-but-structured token stream: a Zipf-distributed unigram base with
injected copy/recall structure (random motif repetition) so the loss is
learnable and non-degenerate, which is what the end-to-end driver and the
dry-runs need.  Deterministic per (seed, host_id) and cheap enough to
generate on the fly inside the input pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["TokenStreamConfig", "token_batches", "sample_tokens"]


@dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    zipf_a: float = 1.2
    motif_len: int = 16
    motif_prob: float = 0.25
    seed: int = 0


def sample_tokens(cfg: TokenStreamConfig, rng: np.random.Generator,
                  batch: int) -> np.ndarray:
    """(batch, seq_len+1) int32 tokens — +1 so inputs/labels can be split."""
    L = cfg.seq_len + 1
    # Zipf base (clipped to vocab; reserve 0 as pad/bos).
    toks = rng.zipf(cfg.zipf_a, size=(batch, L)).astype(np.int64)
    toks = 1 + (toks - 1) % (cfg.vocab_size - 1)
    # Inject motif repetitions: copy an earlier span forward.
    n_motifs = max(1, int(cfg.motif_prob * L / cfg.motif_len))
    for b in range(batch):
        for _ in range(n_motifs):
            if L <= 2 * cfg.motif_len:
                break
            src = rng.integers(0, L - 2 * cfg.motif_len)
            dst = rng.integers(src + cfg.motif_len, L - cfg.motif_len)
            toks[b, dst:dst + cfg.motif_len] = toks[b, src:src + cfg.motif_len]
    return toks.astype(np.int32)


def token_batches(cfg: TokenStreamConfig, *, host_id: int = 0,
                  num_hosts: int = 1):
    """Infinite iterator of per-host batches.

    Yields dict(tokens=(B_host, S), labels=(B_host, S)) — the global batch is
    striped across hosts; each host seeds independently so restarts are
    reproducible from (seed, host_id, step) without coordination.
    """
    assert cfg.global_batch % num_hosts == 0
    b_host = cfg.global_batch // num_hosts
    step = 0
    while True:
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + host_id)
        toks = sample_tokens(cfg, rng, b_host)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        step += 1
