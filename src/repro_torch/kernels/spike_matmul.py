"""Spike × weight contraction in one launch: the CUDA kernel's launcher and
its plain PyTorch version.

Port of ``repro.kernels.spike_matmul.spike_matmul_pallas``: (B, K) uint8
spikes × (K, N) int16 codes → (B, N) int32, in two realisations:
``masked`` (the RTL datapath's select and add: a spike is any non-zero
byte and counts as 1) and ``dot`` (a multiply-accumulate by the spike
byte's value, the counterpart of the TPU's MXU branch); on {0,1} spikes
they give the same bits.  The kernel runs both on the int8 tensor cores,
on the two byte planes of the codes (``w = 256·hi + lo``).  Which one runs
is a 0-dim bool tensor on the operands' device, read by the kernel itself,
so a density dispatch (``kernels.ops.spike_matmul_op``) never waits for
the host.

:func:`spike_matmul` is the wrapper: for CUDA tensors it launches the
kernel of ``csrc/spike_matmul.cu`` (and counts the launch in
``spike_matmul.launches``), for CPU tensors it runs
:func:`spike_matmul_plain`.  There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from ._build import check_operand, launch
from .lif_step import _wrap32

__all__ = ["BLOCK", "spike_matmul", "spike_matmul_plain"]

BLOCK = (8, 128, 128)   # (lanes, K rows, N columns) the operands pad to


def spike_matmul_plain(spikes_u8: torch.Tensor, w_i16: torch.Tensor,
                       masked: torch.Tensor) -> torch.Tensor:
    """The spike-matmul kernel's function in plain PyTorch.

    ``masked`` (0-dim bool) picks the select-and-add realisation (a spike is
    any non-zero byte and counts as 1) over the multiply-accumulate one (a
    byte counts its value); for {0,1} spikes both give the same result.
    Each runs as a float64 product, exact while |Σ| < 2^53, then wraps to
    int32 as the kernel's s32 accumulators do.
    """
    w = w_i16.to(torch.float64)
    sel = torch.matmul((spikes_u8 != 0).to(torch.float64), w)
    mac = torch.matmul(spikes_u8.to(torch.float64), w)
    return _wrap32(torch.where(masked, sel, mac).to(torch.int64))


def spike_matmul(spikes_u8: torch.Tensor, w_i16: torch.Tensor,
                 masked: torch.Tensor) -> torch.Tensor:
    """(B, K) uint8 spikes × (K, N) int16 codes → (B, N) int32, B a
    multiple of 8 and K and N of 128 (as ``kernels.ops.spike_matmul_op``
    pads them); ``masked`` a 0-dim bool tensor on the same device.  On
    CUDA the kernel copies 16-byte pieces, so both operands must be
    16-byte aligned.

    CUDA tensors launch the kernel (one launch, counted in
    ``spike_matmul.launches``); CPU tensors run the plain version.
    """
    if spikes_u8.ndim != 2 or w_i16.ndim != 2:
        raise ValueError(f"spikes must be (B, K) and weights (K, N), got "
                         f"{tuple(spikes_u8.shape)} and {tuple(w_i16.shape)}")
    dev = spikes_u8.device
    B, K = spikes_u8.shape
    N = w_i16.shape[1]
    check_operand(spikes_u8, "spikes_u8", torch.uint8, (B, K), dev)
    check_operand(w_i16, "w_i16", torch.int16, (K, N), dev)
    check_operand(masked, "masked", torch.bool, (), dev)
    if dev.type == "cpu":
        return spike_matmul_plain(spikes_u8, w_i16, masked)
    if dev.type != "cuda":
        raise ValueError(f"no spike-matmul kernel for device {dev}")
    bB, bK, bN = BLOCK
    if B == 0 or B % bB or K == 0 or K % bK or N == 0 or N % bN:
        raise ValueError(f"the spike-matmul kernel takes B a multiple of "
                         f"{bB}, K of {bK} and N of {bN}, got ({B}, {K}, "
                         f"{N})")
    if spikes_u8.data_ptr() % 16 or w_i16.data_ptr() % 16:
        raise ValueError("the spike-matmul kernel copies 16-byte pieces: "
                         "spikes_u8 and w_i16 must be 16-byte aligned")
    out = torch.empty((B, N), dtype=torch.int32, device=dev)
    launch("spike_matmul", [spikes_u8, w_i16, out, masked], [B, K, N], dev)
    spike_matmul.launches += 1
    return out


spike_matmul.launches = 0
