"""A Nemotron-H training step's work, whatever implements it: model flops
and the optimizer's bytes, from the configuration's widths alone (the
published keys of ``nemotron_h``, with the cut's layers, experts held and
vocabulary); the peaks and the least time are ``work_lm.py``'s.

Flops: 6 × the matrix parameters a token passes through × tokens, for
the forward and backward of every product: each M block's in-projections
(z, x, B, C, dt) and out-projection, each * block's q, k, v and o, each E
block's router, shared expert and held experts at their expected share
(top-k × held / routed over expert widths a token, 1.5 in the cell), and
the head over the vocabulary.  Then the products of the causal attention
(``Q·Kᵀ`` and its product with V over the causal half) and of each M
block's grouped SSD, counted by chunk as ``work_lm.ssd_flops`` counts
them (C·Bᵀ once a group), each forward once and backward twice.
Recomputation in the backward is not counted: it is not the model's
work.  Bytes: the optimizer's float32 parameters, gradients and two
moments, each read and written once a step, and the bf16 copy of every
parameter written and read once, over every stored parameter.
"""

from __future__ import annotations

import math

from perfbench.work_lm import OPTIMIZER_BYTES_PER_PARAMETER, least_time

__all__ = ["parameters", "matrix_parameters", "ssd_flops", "attn_flops",
           "step_work", "least_time"]


def _widths(cfg: dict) -> dict:
    L = int(cfg["num_hidden_layers"])
    pattern = cfg["hybrid_override_pattern"][:L]
    H, P = int(cfg["mamba_num_heads"]), int(cfg["mamba_head_dim"])
    return {"d": int(cfg["hidden_size"]), "V": int(cfg["vocab_size"]),
            "M": pattern.count("M"), "E": pattern.count("E"),
            "A": pattern.count("*"), "H": H, "P": P, "di": H * P,
            "G": int(cfg["n_groups"]), "N": int(cfg["ssm_state_size"]),
            "W": int(cfg["conv_kernel"]), "Q": int(cfg["chunk_size"]),
            "hq": int(cfg["num_attention_heads"]),
            "hkv": int(cfg["num_key_value_heads"]),
            "hd": int(cfg["head_dim"]),
            "routed": int(cfg["experts_routed_over"]),
            "held": int(cfg["n_routed_experts"]),
            "k": int(cfg["num_experts_per_tok"]),
            "F": int(cfg["moe_intermediate_size"]),
            "Fs": int(cfg["moe_shared_expert_intermediate_size"])}


def _mamba_mats(w: dict) -> int:
    return w["d"] * (2 * w["di"] + 2 * w["G"] * w["N"] + w["H"]) \
        + w["di"] * w["d"]


def _attn_mats(w: dict) -> int:
    return 2 * w["d"] * w["hq"] * w["hd"] + 2 * w["d"] * w["hkv"] * w["hd"]


def matrix_parameters(cfg: dict) -> float:
    """Parameters of the products a token passes through, the held
    experts at their expected share."""
    w = _widths(cfg)
    experts = w["k"] * w["held"] / w["routed"] * 2 * w["d"] * w["F"]
    moe = w["d"] * w["routed"] + 2 * w["d"] * w["Fs"] + experts
    return w["M"] * _mamba_mats(w) + w["A"] * _attn_mats(w) \
        + w["E"] * moe + w["d"] * w["V"]


def parameters(cfg: dict) -> int:
    """Every parameter the model stores: the held experts, the untied
    head."""
    w = _widths(cfg)
    d, di, H, GN = w["d"], w["di"], w["H"], w["G"] * w["N"]
    mamba = _mamba_mats(w) + w["W"] * (di + 2 * GN) + 3 * H + di
    moe = d * w["routed"] + 2 * d * w["Fs"] + w["held"] * 2 * d * w["F"]
    norms = w["M"] + w["E"] + w["A"] + 1
    return (w["M"] * mamba + w["A"] * _attn_mats(w) + w["E"] * moe
            + 2 * w["V"] * d + norms * d)


def ssd_flops(cfg: dict, seq: int) -> int:
    """The grouped SSD's forward flops for one sequence through one M
    block: by chunk of Q, the causal half of C·Bᵀ in each group and of its
    masked product with x (``Q(Q+1)`` a pair), each chunk's state and its
    read-out (``2·Q·N·H·P`` each) and the carry (``2·H·P·N``)."""
    w = _widths(cfg)
    Q, N, HP = w["Q"], w["N"], w["H"] * w["P"]
    per_chunk = Q * (Q + 1) * (w["G"] * N + HP) + 4 * Q * N * HP \
        + 2 * HP * N
    return math.ceil(seq / Q) * per_chunk


def attn_flops(cfg: dict, seq: int) -> int:
    """The causal attention's forward flops for one sequence through one
    * block: ``Q·Kᵀ`` and the product with V over the ``S(S+1)/2`` pairs,
    2 flops a multiply-add."""
    w = _widths(cfg)
    return 2 * w["hq"] * w["hd"] * seq * (seq + 1)


def step_work(cfg: dict, batch: int, seq: int) -> dict:
    """One training step on ``batch`` sequences of ``seq`` tokens:
    ``flops`` and ``bytes``."""
    w = _widths(cfg)
    flops = 6 * matrix_parameters(cfg) * batch * seq + 3 * batch * (
        w["M"] * ssd_flops(cfg, seq) + w["A"] * attn_flops(cfg, seq))
    return {"flops": int(flops),
            "bytes": OPTIMIZER_BYTES_PER_PARAMETER * parameters(cfg)}
