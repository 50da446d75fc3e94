"""Fixed-point arithmetic on torch tensors (paper §III-A, §V-B; port of
``repro.core.fixed_point``).

The RTL stores synaptic weights as 8/9-bit signed fixed point and membrane
potentials in a wider accumulator register.  These helpers move between the
float training world and the integer inference world, including stochastic
rounding (Shinji et al. 2024).

Conventions
-----------
* ``Q(w, bits, scale)``: integer code ``q = clip(round(w / scale))`` with
  ``q ∈ [-2^(bits-1), 2^(bits-1)-1]``, rounding half to even.
* Per-tensor or per-axis scales; the RTL's single global scale is the
  default.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.lif_step import _wrap32

__all__ = ["QuantParams", "choose_scale", "quantize", "dequantize",
           "quantize_stochastic", "fake_quant", "int8_matmul"]


@dataclass(frozen=True)
class QuantParams:
    """Static description of a fixed-point format."""

    bits: int = 8
    axis: int | None = None  # None => per-tensor scale

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1


def _code_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else (torch.int16 if bits <= 16
                                         else torch.int32)


def choose_scale(w: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Symmetric max-abs scale (what a synthesis-time calibration picks).

    With ``qp.axis`` set, the max runs over every other dimension (kept);
    as in the reference, a negative axis names no dimension, so its scale
    is the per-tensor one with every dimension kept.
    """
    if qp.axis is None:
        amax = w.abs().max()
    else:
        dims = tuple(i for i in range(w.ndim) if i != qp.axis)
        amax = w.abs().amax(dim=dims, keepdim=True)
    amax = torch.clamp(amax, min=1e-12)
    return (amax / qp.qmax).to(torch.float32)


def quantize(w: torch.Tensor, qp: QuantParams,
             scale: torch.Tensor | None = None):
    """Round-to-nearest-even quantisation; returns ``(codes, scale)``."""
    scale = choose_scale(w, qp) if scale is None else scale
    q = torch.clamp(torch.round(w / scale), qp.qmin, qp.qmax)
    return q.to(_code_dtype(qp.bits)), scale


def quantize_stochastic(w: torch.Tensor, qp: QuantParams,
                        generator: torch.Generator,
                        scale: torch.Tensor | None = None):
    """Stochastic rounding: ``E[q·scale] == w``.  The uniforms come from
    ``generator``, which must live on ``w``'s device."""
    scale = choose_scale(w, qp) if scale is None else scale
    x = w / scale
    lo = torch.floor(x)
    u = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                   device=x.device)
    q = torch.clamp(lo + (u < x - lo).to(x.dtype), qp.qmin, qp.qmax)
    return q.to(_code_dtype(qp.bits)), scale


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


class _FakeQuant(torch.autograd.Function):
    """Quantise-dequantise forward; identity backward (straight-through:
    no gradient flows through the max-abs scale)."""

    @staticmethod
    def forward(ctx, w, bits):
        q, s = quantize(w, QuantParams(bits=bits))
        return dequantize(q, s)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Straight-through-estimator fake quantisation (QAT of the SNN)."""
    return _FakeQuant.apply(w, bits)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale,
                w_scale) -> torch.Tensor:
    """Integer matmul with int32 accumulation, rescaled to float.

    Products never leave the integer domain until the final rescale: the
    sum of products is taken exactly in int64 and wraps to int32 as the
    reference's int32 accumulator does.  CUDA has no integer matrix
    product, so the contraction is a broadcast product summed over K
    (``(..., K, N)`` int64 elements of scratch).
    """
    acc = (x_q.to(torch.int64).unsqueeze(-1) * w_q.to(torch.int64)).sum(-2)
    return _wrap32(acc).to(torch.float32) * (x_scale * w_scale)
