"""Poisson encoder over a whole window in one launch: the CUDA kernel's
launcher and its plain PyTorch version.

Port of ``repro.kernels.poisson_encode.poisson_encode_pallas``, the first
stage of the staged backend: every pixel's xorshift32 lane steps ``T``
times and emits a spike wherever the pixel exceeds the state's top byte,
so the whole (T, B, N) spike train is materialised.  The kernel also
tallies the first layer's telemetry of that train for the staged call.

:func:`poisson_encode` is the wrapper: for CUDA tensors it launches the
kernel of ``csrc/poisson_encode.cu`` (and counts the launch in
``poisson_encode.launches``), for CPU tensors it runs
:func:`poisson_encode_plain`.  There is no fallback from one to the other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.prng import from_carrier, to_carrier
from ..core.telemetry import tile_any
from ._build import check_operand, check_tallies, launch

__all__ = ["poisson_encode", "poisson_encode_plain"]

_MASK32 = 0xFFFFFFFF
BLOCK_B = 8             # the telemetry's lane block


def poisson_encode_plain(pixels_u8: torch.Tensor, state_u32: torch.Tensor,
                         num_steps: int):
    """The encoder kernel's function in plain PyTorch.

    ``pixels_u8``/``state_u32``: (B, N) uint8 / uint32.  Returns ``(spikes
    (T, B, N) uint8, final state (B, N) uint32)``; the xorshift runs in the
    int64 carrier of ``core.prng``.
    """
    s = to_carrier(state_u32)
    spikes = torch.empty((num_steps,) + tuple(pixels_u8.shape),
                         dtype=torch.uint8, device=pixels_u8.device)
    for t in range(num_steps):
        s = s ^ ((s << 13) & _MASK32)
        s = s ^ (s >> 17)
        s = s ^ ((s << 5) & _MASK32)
        spikes[t] = pixels_u8 > (s >> 24).to(torch.uint8)
    return spikes, from_carrier(s)


def poisson_encode(pixels_u8: torch.Tensor, state_u32: torch.Tensor,
                   num_steps: int, tallies=None):
    """Encode ``num_steps`` steps of (B, N) pixels; N a multiple of 4.

    Returns ``(spikes (T, B, N) uint8, final state (B, N) uint32)``.  With
    ``tallies``, a zeroed ``kernels.ops.StagedTallies`` of pad8(B) lanes,
    the first layer's telemetry of the train is added into its layer 0:
    each (step, lane)'s spikes into ``n_spk`` and each (step, 8-lane
    block)'s 128-pixel tiles holding one into ``live_k``.  CUDA tensors
    launch the kernel (one launch, counted in ``poisson_encode.launches``;
    without ``tallies`` it tallies into scratch); CPU tensors run the plain
    version.
    """
    if pixels_u8.ndim != 2:
        raise ValueError(f"pixels_u8 must be (B, N), got "
                         f"{tuple(pixels_u8.shape)}")
    dev = pixels_u8.device
    B, N = pixels_u8.shape
    T = num_steps
    check_operand(pixels_u8, "pixels_u8", torch.uint8, (B, N), dev)
    check_operand(state_u32, "state_u32", torch.uint32, (B, N), dev)
    if T < 0:
        raise ValueError(f"num_steps must be >= 0, got {T}")
    Bp = B + (-B) % BLOCK_B
    if tallies is not None:
        check_tallies(tallies, T, Bp, dev)
    if dev.type == "cpu":
        spikes, state = poisson_encode_plain(pixels_u8, state_u32, T)
        if tallies is not None:
            tallies.n_spk[:, 0] += F.pad(spikes.sum(-1, dtype=torch.int32),
                                         (0, Bp - B))
            tallies.live_k[:, 0] += tile_any(spikes, BLOCK_B).sum(
                -1, dtype=torch.int32)
        return spikes, state
    if dev.type != "cuda":
        raise ValueError(f"no encoder kernel for device {dev}")
    if B * N == 0 or N % 4:
        raise ValueError(f"the encoder kernel takes a non-empty (B, N) with "
                         f"N a multiple of 4, got ({B}, {N})")
    if tallies is None:
        n_spk = torch.zeros((T, Bp), dtype=torch.int32, device=dev)
        live = torch.zeros((T, Bp // BLOCK_B), dtype=torch.int32, device=dev)
    else:
        n_spk, live = tallies.n_spk[:, 0], tallies.live_k[:, 0]
    spikes = torch.empty((T, B, N), dtype=torch.uint8, device=dev)
    state_out = torch.empty_like(state_u32)
    launch("poisson_encode", [pixels_u8, state_u32, spikes, state_out, n_spk,
                              live],
           [B, N, T, n_spk.stride(0), live.stride(0)], dev)
    poisson_encode.launches += 1
    return spikes, state_out


poisson_encode.launches = 0
