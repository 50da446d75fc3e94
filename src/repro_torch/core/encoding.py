"""Poisson spike encoding (paper §III-C, Fig. 2; port of
``repro.core.encoding``).

:func:`poisson_encode_hw` is the hardware-faithful encoder: at every
timestep each pixel's xorshift32 lane draws an 8-bit value R and emits a
spike iff ``I > R``, bit-identical to
``repro.core.encoding.poisson_encode_hw``.  :func:`poisson_encode_float`
is the training path's encoder: the same distribution from a
``torch.Generator``, where PRNG bit-compatibility does not matter.
"""

from __future__ import annotations

import torch

from . import prng

__all__ = ["poisson_encode_hw", "poisson_encode_float", "spike_train_rates"]


def poisson_encode_hw(pixels_u8: torch.Tensor, state: torch.Tensor,
                      num_steps: int):
    """Encode ``num_steps`` steps.

    Args:
      pixels_u8: uint8 intensities, any shape ``(...,)``.
      state: uint32 xorshift state, same shape as ``pixels_u8``.

    Returns ``(spikes, final_state)``: ``spikes`` is bool ``(T, ...)``.
    """
    if pixels_u8.dtype != torch.uint8:
        raise TypeError(f"pixels must be uint8, got {pixels_u8.dtype}")
    spikes = []
    for _ in range(num_steps):
        state = prng.xorshift32_step(state)
        spikes.append(pixels_u8 > prng.uniform_u8(state))
    return torch.stack(spikes), state


def poisson_encode_float(pixels01: torch.Tensor, num_steps: int, *,
                         generator: torch.Generator) -> torch.Tensor:
    """Training-path Poisson encoding from float intensities in [0, 1]
    (the counterpart of ``repro.core.encoding.poisson_encode_jax``).

    Draws ``(num_steps, *pixels01.shape)`` uniforms from ``generator``,
    which must live on the pixels' device, and returns float32 spikes in
    {0.0, 1.0} (float, so the surrogate-gradient path treats them as
    activations).
    """
    u = torch.rand((num_steps,) + tuple(pixels01.shape), generator=generator,
                   dtype=torch.float32, device=pixels01.device)
    return (pixels01[None] > u).to(torch.float32)


def spike_train_rates(spikes: torch.Tensor) -> torch.Tensor:
    """Empirical firing rate per lane: the float32 mean over the time axis
    (axis 0), taken as the JAX package's mean is (the sum times the
    float32 reciprocal of T, F-n), so that the two agree bit for bit."""
    x = spikes.to(torch.float32)
    inv = torch.ones((), dtype=torch.float32, device=x.device) / x.shape[0]
    return x.sum(dim=0) * inv
