"""Serving engine: prefill + decode steps with a pre-allocated KV cache.

Port of ``repro.serve.engine``.  ``prefill`` runs the full-sequence forward
once and grows its K/V caches to ``max_len`` slots; ``decode_step``
advances one token.  A cache is the model's list with one entry per layer
(``{"self": AttnCache | MambaCache[, "cross": AttnCache]}``), batch first.
Both run under ``torch.no_grad``: serving builds no autograd graph.

Early exit (the paper's active-pruning analogue at the serving layer) lives
in early_exit.py and composes with ``generate``: a retired lane keeps its
cache, length and token bit for bit while the others advance.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ..models.attention import AttnCache
from ..models.transformer import lm_apply

__all__ = ["ServeState", "make_prefill", "make_decode_step", "generate",
           "pad_cache_to"]


class ServeState(NamedTuple):
    cache: Any                 # list per layer (see module docstring)
    cur_len: torch.Tensor      # (B,) int32 valid cache lengths
    last_token: torch.Tensor   # (B,) int32 most recent token
    done: torch.Tensor         # (B,) bool early-exit flags


def pad_cache_to(cache: list, max_len: int) -> list:
    """Grow prefill-created self-attention K/V caches (length S) to
    ``max_len`` slots with zeros; cross-attention K/V and SSM states are
    left as they are."""
    out = []
    for entry in cache:
        entry = dict(entry)
        c = entry.get("self")
        if isinstance(c, AttnCache) and c.k.shape[1] < max_len:
            pad = (0, 0, 0, 0, 0, max_len - c.k.shape[1])
            entry["self"] = AttnCache(k=F.pad(c.k, pad), v=F.pad(c.v, pad))
        out.append(entry)
    return out


def _keep_done(new: list, old: list, done: torch.Tensor) -> list:
    """Each cache leaf of ``new``, with ``old``'s rows where ``done``."""
    def pick(n, o):
        return torch.where(done.reshape((-1,) + (1,) * (n.dim() - 1)), o, n)
    return [{part: type(c)(*(pick(n, o) for n, o in zip(c, o_entry[part])))
             for part, c in n_entry.items()}
            for n_entry, o_entry in zip(new, old)]


def make_prefill(cfg, *, max_len: int):
    @torch.no_grad()
    def prefill(model, batch):
        tokens = batch["tokens"]
        b = tokens.shape[0]
        logits, cache, _ = lm_apply(model, batch, cfg, mode="prefill")
        cache = pad_cache_to(cache, max_len)
        s = logits.shape[1]
        dev = logits.device
        cur = torch.full((b,), s, dtype=torch.int32, device=dev)
        nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1) \
            .to(torch.int32)
        return ServeState(cache=cache, cur_len=cur, last_token=nxt,
                          done=torch.zeros((b,), dtype=torch.bool,
                                           device=dev)), logits

    return prefill


def make_decode_step(cfg):
    @torch.no_grad()
    def decode_step(model, state: ServeState):
        batch = {"tokens": state.last_token[:, None]}
        logits, cache, _ = lm_apply(model, batch, cfg, mode="decode",
                                    cache=state.cache, cur_len=state.cur_len)
        nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1) \
            .to(torch.int32)
        # retired sequences (early exit) stop writing / advancing
        cache = _keep_done(cache, state.cache, state.done)
        cur = torch.where(state.done, state.cur_len, state.cur_len + 1)
        nxt = torch.where(state.done, state.last_token, nxt)
        # logits at the padded width, as the JAX package returns them
        return ServeState(cache=cache, cur_len=cur, last_token=nxt,
                          done=state.done), logits[:, -1]

    return decode_step


def generate(model, batch, cfg, *, steps: int, max_len: int,
             early_exit_fn=None):
    """Greedy generation loop with optional per-sequence early exit.

    early_exit_fn(last_token (B,), logits (B,Vp)) -> (B,) bool — e.g.
    serve.early_exit.stability_gate.  Returns (tokens (B, steps), active
    counts per step (steps,)) — the energy/latency signal.
    """
    prefill = make_prefill(cfg, max_len=max_len)
    decode = make_decode_step(cfg)
    state, _ = prefill(model, batch)
    toks, actives = [], []
    for _ in range(steps):
        state, logits = decode(model, state)
        if early_exit_fn is not None:
            newly_done = early_exit_fn(state.last_token, logits)
            state = state._replace(done=state.done | newly_done)
        toks.append(state.last_token)
        actives.append(torch.sum(~state.done))
    return torch.stack(toks, dim=1), torch.stack(actives)
