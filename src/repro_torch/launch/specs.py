"""Abstract input/state specs for every (arch × shape) dry-run cell (port
of ``repro.launch.specs``).

The JAX package's ``ShapeDtypeStruct`` stand-ins become tensors on the
``meta`` device: shapes and dtypes only, no storage on any device, and
the port's real step runs on them (``launch.dryrun``).  The modality
frontends are stubs: audio/vision cells receive precomputed frame/patch
embeddings.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models.transformer import Transformer, init_cache
from ..serve.engine import ServeState

__all__ = ["train_inputs", "prefill_inputs", "decode_state_spec",
           "abstract_params", "num_microbatches"]

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _token_inputs(cfg: ArchConfig, b: int, s: int, *, labels: bool) -> dict:
    d: dict = {}
    if cfg.frontend == "vision":
        p = min(cfg.num_patches, s - 1)
        d["patches"] = _sds((b, p, cfg.d_model), torch.bfloat16)
        d["tokens"] = _sds((b, s - p), torch.int32)
        if labels:
            d["labels"] = _sds((b, s), torch.int32)
        return d
    if cfg.is_encdec:
        d["frames"] = _sds((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    d["tokens"] = _sds((b, s), torch.int32)
    if labels:
        d["labels"] = _sds((b, s), torch.int32)
    return d


def train_inputs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    return _token_inputs(cfg, shape.global_batch, shape.seq_len, labels=True)


def prefill_inputs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    return _token_inputs(cfg, shape.global_batch, shape.seq_len, labels=False)


def decode_state_spec(cfg: ArchConfig, shape: ShapeConfig) -> ServeState:
    """Abstract ServeState with a max_len = shape.seq_len bf16 cache (one
    entry per layer, each leaf its own storage)."""
    b, s = shape.global_batch, shape.seq_len
    cache = [{part: type(c)(*(_sds(x.shape, x.dtype) for x in c))
              for part, c in entry.items()}
             for entry in init_cache(cfg, b, s, dtype=torch.bfloat16,
                                     device=META)]
    return ServeState(
        cache=cache,
        cur_len=_sds((b,), torch.int32),
        last_token=_sds((b,), torch.int32),
        done=_sds((b,), torch.bool),
    )


def abstract_params(cfg: ArchConfig) -> Transformer:
    """The model's parameters on ``meta``: built with no generator, so
    nothing is drawn and nothing allocated."""
    with torch.device(META):
        return Transformer(cfg, generator=None)


def num_microbatches(cfg: ArchConfig, shape: ShapeConfig,
                     data_ways: int) -> int:
    """Grad-accum depth: targets ≈1-4 sequences per data shard/microbatch."""
    per_shard = max(shape.global_batch // data_ways, 1)
    n = cfg.param_count()
    # per_mb 1→2 for ≥150B halves the number of FSDP parameter regathers
    # (the dominant collective) at ~2× activation stash, which SP keeps
    # affordable.
    if n > 150e9:
        per_mb = 2
    elif n > 20e9:
        per_mb = 2
    else:
        per_mb = 4
    nm = max(per_shard // per_mb, 1)
    while shape.global_batch % (nm * data_ways) and nm > 1:
        nm -= 1
    return nm
