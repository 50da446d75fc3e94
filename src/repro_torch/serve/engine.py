"""Serving engine: prefill + decode steps with a pre-allocated KV cache.

Port of ``repro.serve.engine``.  ``prefill`` runs the full-sequence forward
once and grows its K/V caches to ``max_len`` slots; ``decode_step``
advances one token.  A cache is the model's list with one entry per layer
(``{"self": AttnCache | MambaCache[, "cross": AttnCache]}``), batch first.
Both run under ``torch.no_grad``: serving builds no autograd graph.

Early exit (the paper's active-pruning analogue at the serving layer) lives
in early_exit.py and composes with ``generate``: a retired lane keeps its
cache, length and token bit for bit while the others advance.

A placed model (``distributed.partition.place``) serves placed batches:
the state's vectors are DTensors on the batch's placement, the cache on
``partition.cache_specs``' (its sequence on ``kv_seq`` for decode), and the
next token is the argmax of the vocab-sharded logits gathered over the
model axis.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import (all_gather, is_placed, run_local,
                                    shard)
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
            entry["self"] = AttnCache(*(_pad_seq(t, pad) for t in c))
        out.append(entry)
    return out


def _pad_seq(t: torch.Tensor, pad: tuple) -> torch.Tensor:
    """``F.pad`` of a cache leaf; a placed one is gathered over its
    sequence, padded, and put back on ``kv_seq``."""
    if not is_placed(t):
        return F.pad(t, pad)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = t.device_mesh
    full = t.redistribute(mesh, [Replicate() if isinstance(p, Shard) and
                                 p.dim == 1 else p for p in t.placements])
    padded = DTensor.from_local(F.pad(full.to_local(), pad), mesh,
                                full.placements)
    return shard(padded, "batch", "kv_seq", None, None)


def _next_token(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """argmax over the real vocab of the last position's logits (B,)."""
    if not is_placed(logits):
        return torch.argmax(logits[:, -1, :vocab], dim=-1).to(torch.int32)
    from torch.distributed.tensor import Replicate, Shard

    mesh = logits.device_mesh
    split = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == 2]

    def body(lg):
        last = lg[:, -1]
        for i in split:
            last = all_gather(last, mesh, mesh.mesh_dim_names[i], 1)
        return torch.argmax(last[:, :vocab], dim=-1).to(torch.int32)

    out_pl = [Replicate() if i in split else p
              for i, p in enumerate(logits.placements)]
    return run_local(body, mesh, [(logits, tuple(logits.placements))],
                     out_pl)


def _full_like(vec: torch.Tensor, value, dtype) -> torch.Tensor:
    """A (B,) vector of ``value`` placed as ``vec`` is."""
    if not is_placed(vec):
        return torch.full(vec.shape, value, dtype=dtype, device=vec.device)
    from torch.distributed.tensor import DTensor

    loc = vec.to_local()
    return DTensor.from_local(
        torch.full(loc.shape, value, dtype=dtype, device=loc.device),
        vec.device_mesh, vec.placements)


def _keep_done(new: list, old: list, done: torch.Tensor) -> list:
    """Each cache leaf of ``new``, with ``old``'s rows where ``done``; a
    leaf the step left as it was (the cross-attention cache) is kept."""
    def pick(n, o):
        if n is o:
            return n
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
        nxt = _next_token(logits, cfg.vocab_size)
        assert nxt.shape[0] == b
        return ServeState(cache=cache,
                          cur_len=_full_like(nxt, s, torch.int32),
                          last_token=nxt,
                          done=_full_like(nxt, False, torch.bool)), logits

    return prefill


def make_decode_step(cfg):
    @torch.no_grad()
    def decode_step(model, state: ServeState):
        batch = {"tokens": state.last_token[:, None]}
        logits, cache, _ = lm_apply(model, batch, cfg, mode="decode",
                                    cache=state.cache, cur_len=state.cur_len)
        nxt = _next_token(logits, cfg.vocab_size)
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
    placed = is_placed(state.last_token)
    toks, actives = [], []
    for _ in range(steps):
        state, logits = decode(model, state)
        if early_exit_fn is not None:
            if placed:      # the gate sees every lane, as in one process
                from torch.distributed.tensor import distribute_tensor
                newly_done = distribute_tensor(
                    early_exit_fn(state.last_token.full_tensor(),
                                  logits.full_tensor()),
                    state.done.device_mesh, state.done.placements,
                    src_data_rank=None)
            else:
                newly_done = early_exit_fn(state.last_token, logits)
            state = state._replace(done=state.done | newly_done)
        toks.append(state.last_token)
        actives.append(torch.sum(~state.done))
    toks, actives = torch.stack(toks, dim=1), torch.stack(actives)
    if placed:
        return toks.full_tensor(), actives.full_tensor()
    return toks, actives
