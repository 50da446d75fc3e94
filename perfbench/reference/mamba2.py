"""The plain reference of a Mamba-2 language model's training step.

Written from the Mamba-2 paper (Dao & Gu 2024, arXiv:2405.21060, §6–7,
the "minimal SSD" listing) and the ``state-spaces/mamba2-1.3b`` layer
settings, in plain PyTorch, float32, TF32 off.  It imports nothing of
the program.  Each layer:

    u = RMSNorm(x)
    z, x', B, C, dt = u·W_z, u·W_x, u·W_B, u·W_C, u·W_dt
    x', B, C = SiLU(causal depthwise conv, width d_conv, of each)
    dt = softplus(dt + dt_bias);  A = -exp(A_log)          (one per head)
    y = SSD(x'·dt, dt·A, B, C) + D·x'                        (per head)
    x = x + RMSNorm(y · SiLU(z)) · W_out

SSD here is the quadratic form over the whole sequence: ``y_t = Σ_{s≤t}
(C_t·B_s) exp(Σ_{r=s+1..t} a_r) x_s``, the decays built as a masked
segment sum, a block of rows at a time; nothing of the chunked scan the
program runs.  Then the final RMSNorm, the head and the next-token
cross-entropy over the real vocabulary, gradients by autograd, and AdamW
with the global-norm clip written from its formula.

The configuration it is handed is the one the program runs (the
benchmark lays ``assumed.as_run`` over the published keys), so that both
compute one function.  Its departures from the published model, all the
program's: no conv bias (published ``conv_bias=True``), the vocabulary
padded to a multiple of 256 (published 16), every RMSNorm's weight stored
as ``weight - 1`` (so weight decay pulls it toward 1) with eps 1e-6
(published 1e-5), and x', B and C convolved by three weights (published:
one conv over their concatenation, the same function).  The head is the
embedding, transposed (``tie_embeddings``, as published).  The residual
is float32 here; the program's is its compute dtype.

:func:`leaves` names every parameter (the program's names) with its shape
and the draw it is made from; the benchmark draws them from the seed and
hands the same tensors to the program and to :func:`train_steps`.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["leaves", "train_steps", "MATMULS"]

# rows of the SSD's (S, S) decay matrices built at once, every head
ROW_BLOCK = 256
E4M3_MAX = 448.0


def _widths(cfg: dict) -> dict:
    d = int(cfg["d_model"])
    di = int(cfg["expand"]) * d
    mult = int(cfg["pad_vocab_size_multiple"])
    vocab = int(cfg["vocab_size"])
    if int(cfg["ngroups"]) != 1:
        raise ValueError("the reference shares B and C over all heads "
                         "(ngroups 1)")
    if cfg["conv_bias"] or not cfg["tie_embeddings"]:
        raise ValueError("the reference's conv has no bias and its head "
                         "is the embedding")
    return {"d": d, "di": di, "N": int(cfg["d_state"]),
            "P": int(cfg["headdim"]), "H": di // int(cfg["headdim"]),
            "W": int(cfg["d_conv"]), "L": int(cfg["n_layer"]),
            "V": vocab, "Vp": (vocab + mult - 1) // mult * mult,
            "eps": float(cfg["norm_epsilon"])}


def leaves(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """``(name, shape, draw)`` of every parameter, in the program's names.
    ``draw`` is ``("normal", std)``, ``("const", value)`` or ``("uniform",
    lo, hi, transform)``: matrices normal with std 1/√fan-in (the output
    projection also 1/√n_layer, as the published init rescales it), the
    embedding std 0.02; A = U(A_init_range) stored as its log; dt =
    exp(U(log dt_min, log dt_max)) floored at dt_init_floor and stored as
    its inverse softplus; D ones; every norm weight 1 (stored as 0); no
    ``lm_head``, as the head is the embedding."""
    w = _widths(cfg)
    d, di, N, H, W = w["d"], w["di"], w["N"], w["H"], w["W"]
    lo_a, hi_a = cfg["A_init_range"]
    dt = ("uniform", math.log(cfg["dt_min"]), math.log(cfg["dt_max"]),
          "dt_bias")
    out = [("embed", (w["Vp"], d), ("normal", 0.02))]
    for i in range(w["L"]):
        p = f"layers.{i}."
        out += [
            (p + "ln1.scale", (d,), ("const", 0.0)),
            (p + "mamba.wz", (d, di), ("normal", d ** -0.5)),
            (p + "mamba.wx", (d, di), ("normal", d ** -0.5)),
            (p + "mamba.wb", (d, N), ("normal", d ** -0.5)),
            (p + "mamba.wc", (d, N), ("normal", d ** -0.5)),
            (p + "mamba.wdt", (d, H), ("normal", d ** -0.5)),
            (p + "mamba.conv_x", (W, di), ("normal", W ** -0.5)),
            (p + "mamba.conv_b", (W, N), ("normal", W ** -0.5)),
            (p + "mamba.conv_c", (W, N), ("normal", W ** -0.5)),
            (p + "mamba.A_log", (H,), ("uniform", lo_a, hi_a, "log")),
            (p + "mamba.D", (H,), ("const", 1.0)),
            (p + "mamba.dt_bias", (H,), dt),
            (p + "mamba.norm", (di,), ("const", 0.0)),
            (p + "mamba.out", (di, d),
             ("normal", (di * w["L"]) ** -0.5)),
        ]
    out.append(("final_norm.scale", (d,), ("const", 0.0)))
    return out


class _E4M3(torch.autograd.Function):
    """Round to float8 e4m3 with one scale a tensor (its absolute maximum
    at 448), back in float32; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        s = E4M3_MAX / x.detach().abs().amax().clamp(min=1e-30)
        return (x * s).to(torch.float8_e4m3fn).to(x.dtype) / s

    @staticmethod
    def backward(ctx, g):
        return g


def _fp8_matmul(a, b):
    return _E4M3.apply(a) @ _E4M3.apply(b)


# the products of the projections and the head; the SSD stays float32 in
# both, as the configuration computes it
MATMULS = {"float32": torch.matmul, "fp8": _fp8_matmul}


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def _conv(x, w):
    """Causal depthwise conv: ``y_t = Σ_k w_k · x_{t-(W-1)+k}``, zeros
    before the sequence; x (R, S, C), w (W, C)."""
    W = w.shape[0]
    y = F.conv1d(F.pad(x.transpose(1, 2), (W - 1, 0)), w.T[:, None, :],
                 groups=x.shape[-1])
    return F.silu(y.transpose(1, 2))


def _segsum(a):
    """a (..., T) → (..., T, T): ``[t, s] = Σ_{r=s+1..t} a_r`` for s ≤ t,
    -inf above the diagonal (a cumulative sum down a masked copy)."""
    T = a.shape[-1]
    ones = torch.ones(T, T, dtype=torch.bool, device=a.device)
    x = a[..., :, None].expand(*a.shape, T)            # [i, j] = a_i
    x = x.masked_fill(~torch.tril(ones, -1), 0.0)
    seg = torch.cumsum(x, dim=-2)
    return seg.masked_fill(~torch.tril(ones), -math.inf)


def _ssd(x, a, b, c):
    """x (R, S, H, P), a (R, S, H), b and c (R, S, N) → y (R, S, H, P).

    Rows ``t`` in blocks of :data:`ROW_BLOCK`; the blocks above the
    diagonal are all zero and skipped.  For a block starting at ``t0`` and
    ``s < t0``, ``Σ_{r=s+1..t} a_r`` is the sum of ``Σ_{r=s+1..t0-1}`` and
    ``Σ_{r=t0..t}``: both sums of terms of one sign (every ``a ≤ 0``), so
    no two large partial sums are subtracted."""
    S = x.shape[1]
    at = a.transpose(1, 2)                              # (R, H, S)
    ys = []
    for t0 in range(0, S, ROW_BLOCK):
        t1 = min(S, t0 + ROW_BLOCK)
        g = c[:, t0:t1] @ b[:, :t1].transpose(1, 2)     # (R, T, t1)
        decay = torch.exp(_segsum(at[..., t0:t1]))      # (R, H, T, T)
        y = torch.einsum("rhts,rshp->rthp", decay * g[:, None, :, t0:],
                         x[:, t0:t1])
        if t0:
            before = torch.flip(torch.cumsum(torch.flip(
                at[..., 1:t0], [-1]), -1), [-1])       # Σ_{r=s+1..t0-1}
            before = F.pad(before, (0, 1))
            into = torch.cumsum(at[..., t0:t1], -1)     # Σ_{r=t0..t}
            decay = torch.exp(into[..., :, None] + before[..., None, :])
            y = y + torch.einsum("rhts,rshp->rthp",
                                 decay * g[:, None, :, :t0], x[:, :t0])
        ys.append(y)
    return torch.cat(ys, dim=1)


def _layer(x, p: dict, w: dict, mm, d_skip: bool):
    R, S, _ = x.shape
    u = _rmsnorm(x, p["ln1.scale"], w["eps"])
    z, xs = mm(u, p["mamba.wz"]), mm(u, p["mamba.wx"])
    b, c = mm(u, p["mamba.wb"]), mm(u, p["mamba.wc"])
    dt = F.softplus(mm(u, p["mamba.wdt"]) + p["mamba.dt_bias"])
    xs = _conv(xs, p["mamba.conv_x"]).reshape(R, S, w["H"], w["P"])
    b, c = _conv(b, p["mamba.conv_b"]), _conv(c, p["mamba.conv_c"])
    y = checkpoint(_ssd, xs * dt[..., None], dt * -torch.exp(p["mamba.A_log"]),
                   b, c, use_reentrant=False)
    if d_skip:
        y = y + p["mamba.D"][:, None] * xs
    y = _rmsnorm(y.reshape(R, S, w["di"]) * F.silu(z), p["mamba.norm"],
                 w["eps"])
    return x + mm(y, p["mamba.out"])


def _loss(params: dict, tokens, labels, w: dict, mm, d_skip: bool):
    """Mean next-token cross-entropy of rows ``tokens`` (R, S); each
    layer's SSD recomputed in the backward, so that one is held at once."""
    x = params["embed"][tokens]
    for i in range(w["L"]):
        p = {k[len(f"layers.{i}."):]: v for k, v in params.items()
             if k.startswith(f"layers.{i}.")}
        x = _layer(x, p, w, mm, d_skip)
    x = _rmsnorm(x, params["final_norm.scale"], w["eps"])
    logits = mm(x, params["embed"].T)[..., :w["V"]]
    return F.cross_entropy(logits.reshape(-1, w["V"]), labels.reshape(-1))


def _lr(step: int, o: dict) -> float:
    """Linear warm-up to ``learning_rate``, then a cosine down to
    ``final_lr_fraction`` of it at ``total_steps``."""
    lr, warm = float(o["learning_rate"]), int(o["warmup_steps"])
    if step < warm:
        return lr * step / max(warm, 1)
    t = min(max((step - warm) / max(int(o["total_steps"]) - warm, 1), 0.0),
            1.0)
    f = float(o["final_lr_fraction"])
    return lr * (f + (1 - f) * 0.5 * (1 + math.cos(math.pi * t)))


@contextlib.contextmanager
def _exact_float32():
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _norm(t) -> torch.Tensor:
    return torch.linalg.vector_norm(t, dtype=torch.float64)


def _to_host(norms: dict) -> dict[str, float]:
    return dict(zip(norms, torch.stack(list(norms.values())).cpu().tolist()))


def train_steps(params: dict, batches: list, cfg: dict, *, rows: int = 1,
                matmul: str = "float32", d_skip: bool = True,
                keep_rows: int | None = None) -> dict:
    """AdamW steps from a zero optimizer state, one a batch (each ``(B,
    S + 1)`` tokens on the device), over ``rows`` sequences at a time with
    the gradients accumulated.  ``params`` (name → float32 tensor) are
    updated in place.  ``matmul`` names the products (:data:`MATMULS`),
    ``d_skip`` keeps the D skip, ``keep_rows`` takes only the first rows
    of each batch.

    Returns each step's ``loss`` and ``grad_norm`` (the global norm before
    the clip), each leaf's norm of the first step's gradient as the
    optimizer gets it (clipped, ``first_grad``), and of the parameters'
    change over all the steps (``change``)."""
    w, o, mm = _widths(cfg), cfg["optimizer"], MATMULS[matmul]
    b1, b2, eps = float(o["b1"]), float(o["b2"]), float(o["eps"])
    with _exact_float32():
        for t in params.values():
            t.requires_grad_(True)
        start = {n: t.detach().clone() for n, t in params.items()}
        mu = {n: torch.zeros_like(t) for n, t in params.items()}
        nu = {n: torch.zeros_like(t) for n, t in params.items()}
        out = {"loss": [], "grad_norm": []}
        for step, toks in enumerate(batches):
            toks = toks[:keep_rows].long()
            total = torch.zeros((), dtype=torch.float64, device=toks.device)
            for a in range(0, toks.shape[0], rows):
                blk = toks[a:a + rows]
                loss = _loss(params, blk[:, :-1], blk[:, 1:], w, mm,
                             d_skip) * (blk.shape[0] / toks.shape[0])
                loss.backward()
                total += loss.detach()
            with torch.no_grad():
                for t in params.values():      # a leaf the loss never read
                    if t.grad is None:
                        t.grad = torch.zeros_like(t)
                gnorm = math.sqrt(sum(
                    float(torch.sum(t.grad.double() ** 2))
                    for t in params.values()))
                scale = min(1.0, float(o["clip_norm"]) / (gnorm + 1e-9))
                lr, k = _lr(step, o), step + 1
                bc1, bc2 = 1 - b1 ** k, 1 - b2 ** k
                first = {}
                for n, p in params.items():
                    g = p.grad * scale
                    p.grad = None
                    mu[n].mul_(b1).add_(g, alpha=1 - b1)
                    nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    if step == 0:
                        first[n] = _norm(g)
                    upd = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + eps) \
                        + float(o["weight_decay"]) * p
                    p.sub_(lr * upd)
                if step == 0:
                    out["first_grad"] = _to_host(first)
            out["loss"].append(float(total))
            out["grad_norm"].append(gnorm)
        with torch.no_grad():
            out["change"] = _to_host({n: _norm(params[n] - start[n])
                                      for n in start})
        for t in params.values():
            t.requires_grad_(False)
    return out
