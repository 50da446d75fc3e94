"""An LM training step's work, whatever implements it: model flops, the
optimizer's bytes and the least time one NVIDIA H100 could take for them,
from the configuration's widths alone.

Flops: 6 × the matrix parameters × tokens for the forward and backward
of every projection and the head (the embedding lookup is no product),
and for each Mamba-2 layer the SSD's own products, counted by chunk as
the SSD algorithm computes them (arXiv:2405.21060 §6): the causal half of
``C·Bᵀ`` and of its masked product with x (``Q(Q+1)`` a pair), each
chunk's state (``2·Q·N·H·P``), the carry between chunks (``2·H·P·N``)
and the state's read-out (``2·Q·N·H·P``), forward once and backward
twice.  Recomputation in the backward is not counted: it is not the
model's work.  Bytes: the optimizer's float32 parameters, gradients and
two moments, each read and written once a step, and the bf16 copy of
every parameter written and read once.  The least time is the larger of
flops over the bf16 dense peak and bytes over the bandwidth.

A configuration names its counter (``work``: ``work_<name>.py`` with
``step_work(cfg, batch, seq)``); another layer kind brings its own file,
which may take the peaks and :func:`least_time` from here.
"""

from __future__ import annotations

import math

__all__ = ["PEAK_BF16_FLOPS", "HBM_BYTES_PER_S", "parameters",
           "matrix_parameters", "ssd_flops", "step_work", "least_time"]

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# float32 parameter, gradient, first and second moment, each read and
# written; the bf16 copy written and read
OPTIMIZER_BYTES_PER_PARAMETER = 4 * 4 * 2 + 2 * 2


def _widths(cfg: dict) -> dict:
    d = int(cfg["d_model"])
    di = int(cfg["expand"]) * d
    mult = int(cfg["pad_vocab_size_multiple"])
    V = int(cfg["vocab_size"])
    return {"d": d, "di": di, "N": int(cfg["d_state"]) * int(cfg["ngroups"]),
            "H": di // int(cfg["headdim"]), "P": int(cfg["headdim"]),
            "W": int(cfg["d_conv"]), "L": int(cfg["n_layer"]), "V": V,
            "Vp": (V + mult - 1) // mult * mult, "Q": int(cfg["chunk_size"])}


def matrix_parameters(cfg: dict) -> int:
    """Parameters of the products a token passes through: each layer's
    in-projections (z, x, B, C, dt) and out-projection, and the head over
    the real vocabulary."""
    w = _widths(cfg)
    layer = w["d"] * (2 * w["di"] + 2 * w["N"] + w["H"]) + w["di"] * w["d"]
    return w["L"] * layer + w["d"] * w["V"]


def parameters(cfg: dict) -> int:
    """Every parameter the model stores (padded vocabulary, untied head
    unless ``tie_embeddings``)."""
    w = _widths(cfg)
    d, di, N, H, W = w["d"], w["di"], w["N"], w["H"], w["W"]
    layer = (d * (2 * di + 2 * N + H) + W * (di + 2 * N) + di * d
             + 3 * H + di + d)
    embed = w["Vp"] * d * (1 if cfg["tie_embeddings"] else 2)
    return w["L"] * layer + embed + d


def ssd_flops(cfg: dict, seq: int) -> int:
    """The SSD's forward flops for one sequence through one layer."""
    w = _widths(cfg)
    Q, N, HP = w["Q"], w["N"], w["H"] * w["P"]
    chunks = math.ceil(seq / Q)
    per_chunk = Q * (Q + 1) * (N + HP) + 2 * Q * N * HP + 2 * HP * N \
        + 2 * Q * N * HP
    return chunks * per_chunk


def step_work(cfg: dict, batch: int, seq: int) -> dict:
    """One training step on ``batch`` sequences of ``seq`` tokens:
    ``flops`` and ``bytes``."""
    tokens = batch * seq
    flops = 6 * matrix_parameters(cfg) * tokens \
        + 3 * int(cfg["n_layer"]) * batch * ssd_flops(cfg, seq)
    return {"flops": flops,
            "bytes": OPTIMIZER_BYTES_PER_PARAMETER * parameters(cfg)}


def least_time(flops: float, nbytes: float) -> tuple[float, str]:
    """The least seconds the chip could take, and which bound sets it."""
    t_f, t_b = flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_f, "flops") if t_f >= t_b else (t_b, "bytes")
