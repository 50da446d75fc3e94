"""The plain reference of the integer SNN datapath, frozen for the benchmark.

The paper's datapath, written out again in plain PyTorch from its
description (§III): a SplitMix64-seeded xorshift32 lane per pixel, the
Poisson compare ``pixel > top byte of the lane``, the integer LIF stack
(Σ W·S, saturating add, shift leak, threshold fire, hard reset, optional
active pruning) over the whole window, and the spike-count / first-spike
/ membrane readout.  It imports nothing of the program: the benchmark
holds the program's outputs against it.

Σ W·S runs as a float32 matrix product with TF32 off: every partial sum is
an integer of magnitude at most ``n_in · 256 < 2^24``, so float32 holds it
exactly on any device.  :func:`window` runs whole windows over a block of
lanes; the caller splits a large set into blocks that fit.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["seed_states", "advance", "window", "readout", "to_8bit_codes",
           "exact_float32"]

MASK32 = 0xFFFFFFFF
V_PEAK_INIT = -(1 << 31)
_ZERO_SEED_REMAP = 0x9E3779B9      # displaces the xorshift fixed point 0
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def _i64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 of the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → uint32 of the same bits."""
    signed = ((x & MASK32) ^ 0x80000000) - 0x80000000
    return signed.to(torch.int32).view(torch.uint32)


def _from_u32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32).to(torch.int64) & MASK32


def seed_states(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """uint32 xorshift lanes ``(len(seeds), n)``: lane ``j`` of a request
    seeded ``s`` is the SplitMix64 hash of ``s · golden + j · mix1`` (mod
    2^64), its low 32 bits, zero mapped to the golden constant.  ``seeds``
    is an int64 tensor on the device the lanes are made on."""
    lane = torch.arange(n, dtype=torch.int64, device=seeds.device)
    s = seeds.to(torch.int64)[:, None] * _i64(_GOLDEN) \
        + lane[None, :] * _i64(_MIX1)
    s = s ^ _srl(s, 30)
    s = s * _i64(_MIX1)
    s = s ^ _srl(s, 27)
    s = s * _i64(_MIX2)
    s = s ^ _srl(s, 31)
    s = s & MASK32
    return _to_u32(torch.where(s == 0, _ZERO_SEED_REMAP, s))


def _step32(x: int) -> int:
    x ^= (x << 13) & MASK32
    x ^= x >> 17
    return x ^ ((x << 5) & MASK32)


def _apply(cols: list[int], v: int) -> int:
    """A GF(2)-linear map of 32-bit words, given by the images of the unit
    vectors, applied to ``v``."""
    out = 0
    for j in range(32):
        if v >> j & 1:
            out ^= cols[j]
    return out


def advance(lanes: torch.Tensor, steps: int) -> torch.Tensor:
    """uint32 xorshift lanes after ``steps`` steps.  The step is linear
    over GF(2), so ``steps`` of it are one 32 × 32 bit matrix, its power
    by squaring, applied bit by bit to every lane."""
    power = [1 << j for j in range(32)]
    base = [_step32(1 << j) for j in range(32)]
    while steps:
        if steps & 1:
            power = [_apply(base, c) for c in power]
        base = [_apply(base, c) for c in base]
        steps >>= 1
    x = _from_u32(lanes)
    out = torch.zeros_like(x)
    for j in range(32):
        out ^= ((x >> j) & 1) * power[j]
    return _to_u32(out)


def to_8bit_codes(w: torch.Tensor) -> torch.Tensor:
    """The 9-bit signed codes rounded down to 8 bits of precision (the low
    bit dropped): the precision below the one the configurations state."""
    return (w.to(torch.int32) >> 1) << 1


@contextlib.contextmanager
def exact_float32():
    """Full float32 matrix products (TF32 off) for the block's duration."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def readout(kind: str, counts, first, v_last, v_peak, num_steps: int):
    """The class of each lane (int64): ``count`` is the argmax of the spike
    counts; ``membrane`` of the running peak membrane; ``first_spike``
    ranks spiking classes by their earliest spike above every silent one,
    silent ones by their clipped membrane.  Ties go to the lowest class."""
    if kind == "count":
        return torch.argmax(counts, dim=-1)
    if kind == "membrane":
        return torch.argmax(v_peak, dim=-1)
    if kind != "first_spike":
        raise ValueError(f"unknown readout {kind!r}")
    large = 1 << 24
    score = torch.where(counts > 0, large + (num_steps - first),
                        torch.clamp(v_last, -large + 1, large - 1))
    return torch.argmax(score, dim=-1)


def window(pixels: torch.Tensor, lanes: torch.Tensor, weights,
           cfg: dict) -> dict:
    """Run one whole window over a block of lanes from fresh neuron state.

    ``pixels`` (B, n_in) uint8, ``lanes`` (B, n_in) uint32 xorshift state,
    ``weights`` per layer (n_l, n_{l+1}) integer codes, ``cfg`` the
    configuration file's dict.  Every lane runs all ``num_steps`` steps.

    Returns ``pred``, ``counts``, ``first``, ``v_last`` (the last layer's
    final membrane) and ``lanes`` (final xorshift state).
    """
    lif = cfg["lif"]
    T, kind = int(cfg["num_steps"]), cfg["readout"]
    prune = bool(cfg["active_pruning"])
    shift, th, rest = lif["decay_shift"], lif["v_threshold"], lif["v_rest"]
    vmin, vmax = lif["v_min"], lif["v_max"]
    dev = pixels.device
    B = pixels.shape[0]
    px = pixels.to(torch.int64)
    wf = [w.to(device=dev, dtype=torch.float32) for w in weights]
    sizes = [int(w.shape[1]) for w in weights]

    def full(n, value, dtype=torch.int32):
        return torch.full((B, n), value, dtype=dtype, device=dev)

    x = _from_u32(lanes)
    v = [full(n, rest) for n in sizes]
    en = [full(n, True, torch.bool) for n in sizes]
    vp = [full(n, V_PEAK_INIT) for n in sizes]
    counts, first = full(sizes[-1], 0), full(sizes[-1], T)
    with exact_float32():
        for t in range(T):
            x = x ^ ((x << 13) & MASK32)
            x = x ^ (x >> 17)
            x = x ^ ((x << 5) & MASK32)
            s = px > (x >> 24)
            for l, w in enumerate(wf):
                cur = (s.to(torch.float32) @ w).to(torch.int32)
                cur = torch.where(en[l], cur, 0)
                vi = torch.clamp(v[l] + cur, vmin, vmax)
                vl = vi - (vi >> shift)
                fired = vl >= th
                v[l] = torch.where(en[l], torch.where(fired, rest, vl), v[l])
                fired = fired & en[l]
                if prune:
                    en[l] = en[l] & ~fired
                vp[l] = torch.maximum(vp[l], v[l])
                s = fired
            counts = counts + s.to(torch.int32)
            first = torch.where(s & (first == T), t, first)
    return {"pred": readout(kind, counts, first, v[-1], vp[-1], T),
            "counts": counts, "first": first, "v_last": v[-1],
            "lanes": _to_u32(x)}
