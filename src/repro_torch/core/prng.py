"""Bit-exact 32-bit xorshift PRNG (paper §III-C), on torch tensors.

The state is stored as ``torch.uint32``, one register per pixel, exactly as
``repro.core.prng`` lays it out.  PyTorch implements few operators for
``uint32`` (shifts and ordered comparisons are missing), so the arithmetic
runs in an ``int64`` carrier masked to 32 bits and the result is stored
back as ``uint32``: the bits are the same on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["seed_state", "xorshift32_step", "xorshift32_sequence",
           "uniform_u8", "to_carrier", "from_carrier"]

# Golden constant used by the RTL preloader to displace zero seeds.
_ZERO_SEED_REMAP = np.uint32(0x9E3779B9)
_MASK32 = 0xFFFFFFFF


def seed_state(seed: int, shape: tuple[int, ...], *,
               device: str | torch.device | None = None) -> torch.Tensor:
    """Per-lane uint32 xorshift state from an integer seed.

    SplitMix64-style hashed counter seeding (the RTL's LFSR preload chain),
    bit-identical to the integer path of ``repro.core.prng.seed_state``.
    Zero seeds are remapped: zero is the xorshift fixed point.
    """
    if not isinstance(seed, (int, np.integer)):
        raise TypeError(f"seed must be an int, got {type(seed).__name__}")
    n = int(np.prod(shape)) if shape else 1
    with np.errstate(over="ignore"):  # intentional mod-2^64 wraparound
        lane = np.arange(n, dtype=np.uint64)
        s = (np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
             + lane * np.uint64(0xBF58476D1CE4E5B9))
        s ^= s >> np.uint64(30)
        s *= np.uint64(0xBF58476D1CE4E5B9)
        s ^= s >> np.uint64(27)
        s *= np.uint64(0x94D049BB133111EB)
        s ^= s >> np.uint64(31)
    state = (s & np.uint64(_MASK32)).astype(np.uint32).reshape(shape)
    state = np.where(state == 0, _ZERO_SEED_REMAP, state)
    return torch.from_numpy(state).to(resolve_device(device))


def to_carrier(state: torch.Tensor) -> torch.Tensor:
    """uint32 state → int64 carrier holding the same value in [0, 2^32)."""
    if state.dtype != torch.uint32:
        raise TypeError(f"xorshift32 state must be uint32, got {state.dtype}")
    return state.view(torch.int32).to(torch.int64) & _MASK32


def from_carrier(x: torch.Tensor) -> torch.Tensor:
    """int64 carrier → uint32 state (the low 32 bits)."""
    return (x & _MASK32).to(torch.int32).view(torch.uint32)


def _step_carrier(x: torch.Tensor) -> torch.Tensor:
    x = x ^ ((x << 13) & _MASK32)
    x = x ^ (x >> 17)
    return x ^ ((x << 5) & _MASK32)


def xorshift32_step(state: torch.Tensor) -> torch.Tensor:
    """One xorshift32 update: x ^= x<<13; x ^= x>>17; x ^= x<<5 (mod 2^32)."""
    return from_carrier(_step_carrier(to_carrier(state)))


def xorshift32_sequence(state: torch.Tensor,
                        num_steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Run ``num_steps`` updates; returns ``(final_state, states (T, ...))``,
    every state uint32, as ``repro.core.prng.xorshift32_sequence``."""
    x, seq = to_carrier(state), []
    for _ in range(num_steps):
        x = _step_carrier(x)
        seq.append(x)
    if not seq:
        return state, torch.empty((0, *state.shape), dtype=torch.uint32,
                                  device=state.device)
    return from_carrier(x), from_carrier(torch.stack(seq))


def uniform_u8(state: torch.Tensor) -> torch.Tensor:
    """The encoder's 8-bit comparison value: the state's top byte (uint8)."""
    return (to_carrier(state) >> 24).to(torch.uint8)
