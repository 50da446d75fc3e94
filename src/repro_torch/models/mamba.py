"""Mamba-2 (SSD, state-space duality) mixer — mamba2-1.3b and jamba layers.

Port of ``repro.models.mamba``: the chunked SSD forward for train/prefill
(quadratic within a chunk, a linear recurrence across chunks, carried in
float32) and an O(1)-state decode step.  The cross-chunk recurrence is the
leaky-integrator shape of the paper's LIF neuron: state ← decay·state +
input-drive, here with an input-dependent decay.

Projections are separate matrices per component (z, x, B, C, dt).
Shapes: d_inner = expand·d_model, H = d_inner/head_dim heads, N = ssm_state.

On a DTensor input (a placed model) the mixer runs on local shards: its
channels (``mlp``) and heads on the model axis, where both divide, with
the shared B/C projections computed on every model shard.  The depthwise
conv and the scan are local per channel and head, so nothing is gathered;
the gated norm over d_inner all-reduces its sum of squares, and the output
projection leaves a partial sum.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import (all_reduce, is_placed,
                                    logical_placements, mesh_ways,
                                    model_sharded, partial_over_model,
                                    partial_where_replicated, run_local,
                                    shard)
from .layers import dense_init, rmsnorm

__all__ = ["mamba_params", "mamba_apply", "mamba_decode_step", "MambaCache",
           "Mamba2", "init_mamba_cache", "ssd_chunked"]


class MambaCache(NamedTuple):
    ssm: torch.Tensor        # (B, H, P, N) state, float32
    conv_x: torch.Tensor     # (B, W-1, d_inner) conv tail for x
    conv_b: torch.Tensor     # (B, W-1, N)
    conv_c: torch.Tensor     # (B, W-1, N)


def init_mamba_cache(batch: int, cfg, dtype=torch.float32, *,
                     device=None) -> MambaCache:
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    w = cfg.ssm_conv
    return MambaCache(
        ssm=torch.zeros((batch, h, p, n), dtype=torch.float32, device=device),
        conv_x=torch.zeros((batch, w - 1, cfg.d_inner), dtype=dtype,
                           device=device),
        conv_b=torch.zeros((batch, w - 1, n), dtype=dtype, device=device),
        conv_c=torch.zeros((batch, w - 1, n), dtype=dtype, device=device),
    )


def _tables(h: int, device) -> dict:
    """The fixed A_log, D and dt_bias tables of the JAX package (A from 1 to
    16, dt in [1e-3, 0.2]), computed in float64 and rounded once: the JAX
    package's float32 chain of linspace / logspace, log and expm1 lands
    within a few ulps of them, and no two libraries round that chain
    alike."""
    f64 = dict(dtype=torch.float64, device=device)
    a = torch.linspace(1.0, 16.0, h, **f64)
    dt = torch.logspace(-3, -0.7, h, **f64)
    return {"A_log": torch.log(a).float(),
            "D": torch.ones((h,), device=device),
            "dt_bias": torch.log(torch.expm1(dt)).float()}


class Mamba2(nn.Module):
    """wz/wx (D, d_inner), wb/wc (D, N), wdt (D, H), depthwise conv taps
    (W, C), the A_log / D / dt_bias tables (H,), the gated norm's scale
    (d_inner,) and out (d_inner, D)."""

    def __init__(self, cfg, *, generator: torch.Generator | None):
        super().__init__()
        d, di, n, h, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.ssm_heads, cfg.ssm_conv)
        g = generator
        dev = g.device if g is not None else None
        self.wz = nn.Parameter(dense_init((d, di), generator=g))
        self.wx = nn.Parameter(dense_init((d, di), generator=g))
        self.wb = nn.Parameter(dense_init((d, n), generator=g))
        self.wc = nn.Parameter(dense_init((d, n), generator=g))
        self.wdt = nn.Parameter(dense_init((d, h), generator=g))
        self.conv_x = nn.Parameter(dense_init((w, di), generator=g))
        self.conv_b = nn.Parameter(dense_init((w, n), generator=g))
        self.conv_c = nn.Parameter(dense_init((w, n), generator=g))
        tables = _tables(h, dev)
        self.A_log = nn.Parameter(tables["A_log"])
        self.D = nn.Parameter(tables["D"])
        self.dt_bias = nn.Parameter(tables["dt_bias"])
        self.norm = nn.Parameter(torch.zeros((di,), device=dev))
        self.out = nn.Parameter(dense_init((di, d), generator=g))


def mamba_params(cfg, *, generator: torch.Generator | None) -> Mamba2:
    return Mamba2(cfg, generator=generator)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: torch.Tensor | None = None):
    """Depthwise causal conv as a sum of shifts (window is tiny: 4).

    x: (B, S, C); w: (W, C); tail: (B, W-1, C) state from the previous
    segment (zeros for a fresh sequence).  Returns (y (B,S,C), new_tail).
    """
    bw = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], bw - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    ext = torch.cat([tail, x], dim=1)                  # (B, S+W-1, C)
    s = x.shape[1]
    y = sum(ext[:, i:i + s, :] * w[i][None, None, :] for i in range(bw))
    # the tail is copied out: a view would keep all of ``ext`` alive in
    # the cache (W-1 rows holding B·(S+W-1)·C elements)
    return F.silu(y), ext[:, -(bw - 1):, :].clone() if bw > 1 else tail


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable 'segment sum': out[..., i, j] = sum a[..., j+1..i], -inf for j>i.

    a: (..., L). Returns (..., L, L) lower-triangular log-decay matrix; the
    -inf above the diagonal becomes an exact 0 after ``exp``.
    """
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]        # sum over (j, i]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int, h0: torch.Tensor | None = None):
    """SSD: y[t] = Σ_{s≤t} c[t]ᵀ (Π_{r∈(s,t]} exp(a[r])) b[s] x[s]  per head.

    x: (B,S,H,P) — inputs already scaled by dt;
    a: (B,S,H)   — log-decay per step (dt·A, negative);
    b, c: (B,S,N) — input/output mixing (shared across heads, ngroups=1);
    h0: optional (B,H,P,N) initial state.
    Returns (y (B,S,H,P), h_final (B,H,P,N)).
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    S_in = S
    pad = (-S) % chunk
    if pad:
        # decay-neutral padding: a=0 (no decay), x=b=c=0 (no drive/readout)
        # keeps h_final exact for the unpadded prefix.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        S = S + pad
    nc = S // chunk

    xc = x.reshape(B, nc, chunk, H, P)
    ac = a.reshape(B, nc, chunk, H).permute(0, 1, 3, 2)      # (B,nc,H,L)
    bc = b.reshape(B, nc, chunk, N)
    cc = c.reshape(B, nc, chunk, N)

    # within-chunk (diagonal block) term
    Lmat = torch.exp(_segsum(ac))                             # (B,nc,H,L,L)
    y_diag = torch.einsum("bzln,bzsn,bzhls,bzshp->bzlhp",
                          cc, bc, Lmat, xc)

    # per-chunk end-states and decays
    a_cum = torch.cumsum(ac, dim=-1)                          # (B,nc,H,L)
    a_tot = a_cum[..., -1]                                    # (B,nc,H)
    decay_states = torch.exp(a_tot[..., None] - a_cum)        # (B,nc,H,L)
    states = torch.einsum("bzln,bzhl,bzlhp->bzhpn",
                          bc, decay_states, xc)               # (B,nc,H,P,N)

    # cross-chunk leaky-integrator recurrence; emit each chunk's state
    # *before* the chunk
    h = (torch.zeros((B, H, P, N), dtype=x.dtype, device=x.device)
         if h0 is None else h0.to(x.dtype))
    prev = []
    for z in range(nc):
        prev.append(h)
        h = h * torch.exp(a_tot[:, z])[..., None, None] + states[:, z]
    h_prev = torch.stack(prev, dim=1)                         # (B,nc,H,P,N)

    # contribution of carried-in state to each chunk
    y_off = torch.einsum("bzln,bzhpn,bzhl->bzlhp",
                         cc, h_prev, torch.exp(a_cum))
    y = (y_diag + y_off).reshape(B, S, H, P)
    return y[:, :S_in], h


def _project(params: Mamba2, u: torch.Tensor, dt, bc_proj=None):
    """The five input projections; ``bc_proj(u, w)`` computes the shared
    B/C ones where given (a placed shard's ``replicated_proj``)."""
    z = u @ params.wz.to(dt)
    x = u @ params.wx.to(dt)
    proj = bc_proj or (lambda v, w: v @ w.to(dt))
    b = proj(u, params.wb)
    c = proj(u, params.wc)
    delta = u @ params.wdt.to(dt)
    return z, x, b, c, delta


def mamba_apply(params: Mamba2, u: torch.Tensor, cfg, *,
                cache: MambaCache | None = None, want_cache: bool = False,
                norm_fn=rmsnorm, bc_proj=None):
    """Full-sequence mixer (train / prefill). u: (B, S, D) normed input.

    Returns (y (B,S,D), new_cache | None).
    """
    if is_placed(u):
        return _placed_mamba(params, u, cfg, cache=cache,
                             want_cache=want_cache, decode=False)
    dt = u.dtype
    B, S, _ = u.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim

    z, x, b, c, delta = _project(params, u, dt, bc_proj)
    x = shard(x, "batch", None, "mlp")
    x, tail_x = _causal_conv(x, params.conv_x.to(dt),
                             cache.conv_x if cache is not None else None)
    b, tail_b = _causal_conv(b, params.conv_b.to(dt),
                             cache.conv_b if cache is not None else None)
    c, tail_c = _causal_conv(c, params.conv_c.to(dt),
                             cache.conv_c if cache is not None else None)

    delta = F.softplus(delta.to(torch.float32)
                       + params.dt_bias[None, None, :])
    a = -torch.exp(params.A_log)[None, None, :]               # (1,1,H)
    a_log_step = delta * a                                    # (B,S,H) fp32

    xh_raw = x.reshape(B, S, H, P).to(torch.float32)
    xh = shard(xh_raw * delta[..., None], "batch", None, "heads", None)
    y, h_final = ssd_chunked(xh, a_log_step,
                             b.to(torch.float32), c.to(torch.float32),
                             cfg.ssm_chunk,
                             cache.ssm if cache is not None else None)
    y = y + params.D[None, None, :, None] * xh_raw      # skip connection
    y = y.reshape(B, S, cfg.d_inner).to(dt)
    y = norm_fn(y * F.silu(z), params.norm)
    out = y @ params.out.to(dt)

    new_cache = None
    if want_cache:
        new_cache = MambaCache(ssm=h_final.to(torch.float32),
                               conv_x=tail_x, conv_b=tail_b, conv_c=tail_c)
    return out, new_cache


def mamba_decode_step(params: Mamba2, u: torch.Tensor, cfg,
                      cache: MambaCache, *, norm_fn=rmsnorm, bc_proj=None):
    """One-token decode. u: (B, 1, D). Returns (y (B,1,D), new_cache)."""
    if is_placed(u):
        return _placed_mamba(params, u, cfg, cache=cache, want_cache=True,
                             decode=True)
    dt = u.dtype
    B = u.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim

    z, x, b, c, delta = _project(params, u, dt, bc_proj)

    def conv_step(xt, tail, wconv):
        ext = torch.cat([tail, xt], dim=1)                    # (B, W, C)
        y = torch.einsum("bwc,wc->bc", ext, wconv.to(dt))
        return F.silu(y)[:, None, :], ext[:, 1:, :]

    x, tail_x = conv_step(x, cache.conv_x, params.conv_x)
    b, tail_b = conv_step(b, cache.conv_b, params.conv_b)
    c, tail_c = conv_step(c, cache.conv_c, params.conv_c)

    delta = F.softplus(delta[:, 0].to(torch.float32)
                       + params.dt_bias[None, :])              # (B,H)
    a = -torch.exp(params.A_log)[None, :]                      # (1,H)
    da = torch.exp(delta * a)                                  # (B,H)

    xh = x[:, 0].reshape(B, H, P).to(torch.float32)            # (B,H,P)
    bf = b[:, 0].to(torch.float32)                             # (B,N)
    cf = c[:, 0].to(torch.float32)
    drive = torch.einsum("bhp,bn->bhpn", xh * delta[..., None], bf)
    h_new = cache.ssm * da[..., None, None] + drive
    y = torch.einsum("bhpn,bn->bhp", h_new, cf) \
        + params.D[None, :, None] * xh
    y = y.reshape(B, 1, cfg.d_inner).to(dt)
    y = norm_fn(y * F.silu(z), params.norm)
    out = y @ params.out.to(dt)
    return out, MambaCache(ssm=h_new, conv_x=tail_x, conv_b=tail_b,
                           conv_c=tail_c)


def _placed_mamba(params: Mamba2, u, cfg, *, cache, want_cache: bool,
                  decode: bool):
    """The mixer on a placed ``u``: see the module docstring.  Runs the
    one-process functions on each shard's channels and heads."""
    from .attention import replicated_proj

    mesh = u.device_mesh
    tp = mesh_ways(mesh, "model")
    split = cfg.d_inner % tp == 0 and cfg.ssm_heads % tp == 0 and tp > 1
    ch, hd = ("mlp", "heads") if split else (None, None)
    lp = lambda t, *ax: logical_placements(  # noqa: E731
        mesh, getattr(t, "shape", t), *ax)
    u_pl = lp(u, "batch", None, "embed")
    pr = params
    bc_pl = lp(pr.wb, None, None)
    bc_in = (bc_pl, partial_where_replicated(bc_pl, mesh, summed=("model",))) \
        if split else (bc_pl,)
    ins = [(u, u_pl), (pr.wz, lp(pr.wz, None, ch)),
           (pr.wx, lp(pr.wx, None, ch)), (pr.wb, *bc_in),
           (pr.wc, *bc_in), (pr.wdt, lp(pr.wdt, None, hd)),
           (pr.conv_x, lp(pr.conv_x, None, ch)),
           (pr.conv_b, lp(pr.conv_b, None, None)),
           (pr.conv_c, lp(pr.conv_c, None, None)),
           (pr.A_log, lp(pr.A_log, hd)), (pr.D, lp(pr.D, hd)),
           (pr.dt_bias, lp(pr.dt_bias, hd)), (pr.norm, lp(pr.norm, ch)),
           (pr.out, lp(pr.out, ch, None))]
    c_axes = MambaCache(ssm=("batch", hd, None, None),
                        conv_x=("batch", None, ch),
                        conv_b=("batch", None, None),
                        conv_c=("batch", None, None))
    if cache is not None:
        ins += [(getattr(cache, f), lp(getattr(cache, f), *getattr(c_axes, f)))
                for f in MambaCache._fields]
    else:
        ins += [(None, None)] * 4
    sharded = model_sharded(ins[1][1], mesh)
    out_pl = partial_over_model(u_pl, mesh, sharded)

    def gated_norm(y, scale):
        if not sharded:
            return rmsnorm(y, scale)
        y32 = y.to(torch.float32)
        var = all_reduce(torch.sum(torch.square(y32), dim=-1, keepdim=True),
                         mesh, "model", grad="sum") / cfg.d_inner
        out = y32 * torch.rsqrt(var + 1e-6)
        return (out * (1.0 + scale.to(torch.float32))).to(y.dtype)

    def body(ul, wz, wx, wb, wc, wdt, cx, cb, cc, a_log, d_skip, dt_bias,
             norm, w_out, ssm, tx, tb, tc):
        loc = SimpleNamespace(wz=wz, wx=wx, wb=wb, wc=wc, wdt=wdt,
                              conv_x=cx, conv_b=cb, conv_c=cc, A_log=a_log,
                              D=d_skip, dt_bias=dt_bias, norm=norm, out=w_out)
        lcfg = _LocalCfg(cfg, heads=a_log.shape[0])
        bc = (lambda x, w: replicated_proj(x, w, mesh)) if split else None
        c = None if ssm is None else MambaCache(ssm, tx, tb, tc)
        y, nc = (mamba_decode_step(loc, ul, lcfg, c, norm_fn=gated_norm,
                                   bc_proj=bc)
                 if decode else
                 mamba_apply(loc, ul, lcfg, cache=c, want_cache=want_cache,
                             norm_fn=gated_norm, bc_proj=bc))
        return (y,) + (tuple(nc) if nc is not None else (None,) * 4)

    c_pl = [lp(t, *getattr(c_axes, f)) for f, t in zip(
        MambaCache._fields, _cache_shapes(u.shape[0], cfg, u.dtype))]
    out = run_local(body, mesh, ins,
                    (out_pl, *(c_pl if want_cache else [None] * 4)))
    return out[0], (MambaCache(*out[1:]) if want_cache else None)


class _LocalCfg:
    """``cfg`` seen from one shard: its heads and channels."""

    def __init__(self, cfg, *, heads: int):
        self._cfg = cfg
        self.ssm_heads = heads
        self.d_inner = heads * cfg.ssm_head_dim

    def __getattr__(self, name):
        return getattr(self._cfg, name)


def _cache_shapes(batch: int, cfg, dtype) -> MambaCache:
    h, p, n, w = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
    return MambaCache(ssm=torch.Size((batch, h, p, n)),
                      conv_x=torch.Size((batch, w - 1, cfg.d_inner)),
                      conv_b=torch.Size((batch, w - 1, n)),
                      conv_c=torch.Size((batch, w - 1, n)))
