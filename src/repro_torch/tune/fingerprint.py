"""Config fingerprinting for the dispatch cache.

A cache entry is only as trustworthy as its key: tuned shapes measured
for one network must never be adopted by a different one.  The
fingerprint is a SHA-256 over the **canonical JSON** of every
``SNNConfig`` field that changes what the datapath computes or how big
its launches are — topology, window length, LIF constants, quantization
width, readout, pruning, dot implementation, sparse skipping and the
static dispatch threshold.  The backend *request* is left out (the cache
key carries it separately), and so are training-only concerns
(``qat``, ``surrogate_slope``, ``train_threshold``).  The payload and the
hash are the JAX package's, field for field, so one config has one
fingerprint in both packages and a cache file reads the same in either.

A fingerprint that splits two equivalent configs costs one cache miss
(static defaults, always safe); one that merged two different configs
would leak tuned shapes across networks.  When in doubt a field goes in.
"""

from __future__ import annotations

import hashlib
import json

__all__ = ["config_fingerprint", "fingerprint_payload"]


def fingerprint_payload(cfg) -> dict:
    """The identity-bearing fields of an ``SNNConfig``, JSON-canonical."""
    lif = cfg.lif
    return {
        "layer_sizes": [int(s) for s in cfg.layer_sizes],
        "num_steps": int(cfg.num_steps),
        "lif": {
            "decay_shift": int(lif.decay_shift),
            "v_threshold": int(lif.v_threshold),
            "v_rest": int(lif.v_rest),
            "v_min": int(lif.v_min),
            "v_max": int(lif.v_max),
        },
        "weight_bits": int(cfg.weight_bits),
        "readout": str(cfg.readout),
        "active_pruning": bool(cfg.active_pruning),
        "dot_impl": str(cfg.dot_impl),
        "fuse_encoder": bool(cfg.fuse_encoder),
        "sparse_skip": (None if cfg.sparse_skip is None
                        else bool(cfg.sparse_skip)),
        "spike_density_threshold": (
            None if cfg.spike_density_threshold is None
            else float(cfg.spike_density_threshold)),
        "emit_trace": bool(cfg.emit_trace),
    }


def config_fingerprint(cfg) -> str:
    """Short stable hex fingerprint of the config's serving identity."""
    blob = json.dumps(fingerprint_payload(cfg), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]
