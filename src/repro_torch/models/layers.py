"""Shared model primitives: norms, rotary, activations, initializers.

Port of ``repro.models.layers``.  The functions are pure; compute dtype is
the caller's (configs default to bf16 compute / fp32 params).  The
initializers draw JAX's distributions from a ``torch.Generator``: the
values differ from ``jax.random``'s stream, the distributions do not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "rmsnorm", "layernorm", "rope", "apply_rope", "activation_fn",
    "dense_init", "embed_init", "softcap",
]


def _recorded(*ts: torch.Tensor) -> bool:
    """Whether autograd records an op on ``ts`` (then a norm keeps its
    float32 intermediates for the backward)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    serving = not _recorded(x, scale)
    # serving scales its own float32 copy in place: one copy held, not three
    x32 = x.to(torch.float32, copy=serving)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    # gemma-style (1+scale); configs store scale-1 so zero-init is identity
    if serving:
        return x32.mul_(torch.rsqrt(var + eps)).mul_(
            1.0 + scale.to(torch.float32)).to(dt)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    serving = not _recorded(x, scale, bias)
    x32 = x.to(torch.float32, copy=serving)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    if serving:
        return x32.sub_(mu).mul_(torch.rsqrt(var + eps)).mul_(scale) \
            .add_(bias).to(dt)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap·tanh(x/cap)."""
    return cap * torch.tanh(x / cap)


def rope(positions: torch.Tensor, head_dim: int,
         theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary tables for given positions: returns (sin, cos) of shape (..., hd/2)."""
    half = head_dim // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = theta ** (-idx / half)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (..., heads, head_dim); sin/cos: broadcastable (..., 1, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's default is erf
    return F.gelu(x, approximate="tanh")


def _squared_relu(x: torch.Tensor) -> torch.Tensor:   # nemotron-4
    return torch.square(F.relu(x))


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "squared_relu":
        return _squared_relu
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name}")


def dense_init(shape: tuple[int, ...], in_axis: int = 0, *,
               generator: torch.Generator | None,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (MaxText-style scale): a standard normal
    truncated to [-2, 2], times ``fan_in ** -0.5``, on the generator's
    device.  ``generator=None`` allocates the tensor uninitialised, on the
    current default device (a skeleton that weights are loaded into)."""
    if generator is None:
        return torch.empty(shape, dtype=dtype)
    std = (1.0 / shape[in_axis]) ** 0.5
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def embed_init(vocab: int, dim: int, *, generator: torch.Generator | None,
               dtype=torch.float32) -> torch.Tensor:
    """Normal × 0.02 (``generator=None``: uninitialised, as dense_init)."""
    if generator is None:
        return torch.empty((vocab, dim), dtype=dtype)
    t = torch.randn((vocab, dim), generator=generator,
                    device=generator.device)
    return (t * 0.02).to(dtype)
