"""One integer LIF layer over a materialised spike train in one launch: the
CUDA kernel's launcher and its plain PyTorch version.

Port of ``repro.kernels.lif_step.lif_forward_pallas``, the per-layer stage
of the staged backend: ``T`` steps of Σ W·S over the step's input spikes,
enable mask, saturating add, shift leak, fire, hard reset and active
pruning, from fresh state (membranes at ``v_rest``, every neuron enabled).
Each step's current counts the spike bytes by value, as the JAX body's
dot does (a byte of 2 adds its code twice).  It takes any int16 weight
code, so it is also the backend for codes wider than the fused kernels'
signed 9-bit range.  The kernel runs each step's Σ W·S on the int8 tensor
cores and the LIF update in its epilogue.

:func:`lif_forward` is the wrapper: for CUDA tensors it launches the
kernel of ``csrc/lif_step.cu`` (and counts the launch in
``lif_forward.launches``), for CPU tensors it runs
:func:`lif_forward_plain`.  There is no fallback from one to the other.
:func:`lif_forward_readout` is the staged call's launch, the kernel's
readout instantiation: the same spikes, and in place of the hidden
layers' traces the call's readouts from the kernel's epilogue (counted in
``lif_forward_readout.launches``; its plain twin
:func:`lif_forward_readout_plain`).
"""

from __future__ import annotations

import torch

from ..core.telemetry import tile_any
from ._build import check_operand, check_tallies, launch

__all__ = ["BLOCK", "K_ALIGN", "lif_forward",
           "lif_forward_plain", "lif_forward_readout",
           "lif_forward_readout_plain"]

BLOCK = (8, 128)        # (lanes, output columns) the operands pad to
K_ALIGN = 16            # the kernel copies 16-byte pieces of spike rows


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with two's-complement wraparound."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def lif_forward_plain(spikes_u8: torch.Tensor, w_i16: torch.Tensor, *,
                      decay_shift: int, v_threshold: int, v_rest: int = 0,
                      v_min: int = -(1 << 20), v_max: int = (1 << 20) - 1,
                      active_pruning: bool = False):
    """The LIF kernel's function in plain PyTorch.

    ``spikes_u8``: (T, B, K) uint8; ``w_i16``: (K, N) int16.  Returns
    ``(spikes (T, B, N) uint8, v_trace (T, B, N) int32, v_final (B, N)
    int32)``.  Σ W·S runs as a float64 product, exact since |Σ| ≤
    K·32,768 ≪ 2^53, then wraps to int32 as the reference's int32 dot
    does; so does the membrane add before the clip.
    """
    T, B, _ = spikes_u8.shape
    N = w_i16.shape[1]
    dev = spikes_u8.device
    w = w_i16.to(torch.float64)
    v = torch.full((B, N), v_rest, dtype=torch.int32, device=dev)
    en = torch.ones((B, N), dtype=torch.bool, device=dev)
    spk = torch.empty((T, B, N), dtype=torch.uint8, device=dev)
    vtr = torch.empty((T, B, N), dtype=torch.int32, device=dev)
    for t in range(T):
        cur = torch.matmul(spikes_u8[t].to(torch.float64), w)
        cur = torch.where(en, cur.to(torch.int64), 0)
        v_int = torch.clamp(_wrap32(v.to(torch.int64) + cur), v_min, v_max)
        v_leak = v_int - (v_int >> decay_shift)
        fired = (v_leak >= v_threshold) & en
        v = torch.where(en, torch.where(fired, v_rest, v_leak), v)
        spk[t] = fired
        vtr[t] = v
        if active_pruning:
            en = en & ~fired
    return spk, vtr, v


def lif_forward(spikes_u8: torch.Tensor, w_i16: torch.Tensor, *,
                decay_shift: int, v_threshold: int, v_rest: int = 0,
                v_min: int = -(1 << 20), v_max: int = (1 << 20) - 1,
                active_pruning: bool = False):
    """Run one LIF layer over ``spikes_u8`` (T, B, K) uint8 with ``w_i16``
    (K, N) int16; B a multiple of 8 and N of 128 (as ``kernels.ops.
    lif_forward_op`` pads them), and on CUDA K a multiple of 16 with both
    operands 16-byte aligned.

    Outputs as :func:`lif_forward_plain`.  CUDA tensors launch the kernel
    (one launch, counted in ``lif_forward.launches``); CPU tensors run the
    plain version.  The kernel chooses its K split over a thread-block
    cluster from the shape and the card.
    """
    if spikes_u8.ndim != 3 or w_i16.ndim != 2:
        raise ValueError(f"spikes must be (T, B, K) and weights (K, N), got "
                         f"{tuple(spikes_u8.shape)} and {tuple(w_i16.shape)}")
    dev = spikes_u8.device
    T, B, K = spikes_u8.shape
    N = w_i16.shape[1]
    check_operand(spikes_u8, "spikes_u8", torch.uint8, (T, B, K), dev)
    check_operand(w_i16, "w_i16", torch.int16, (K, N), dev)
    kw = dict(decay_shift=decay_shift, v_threshold=v_threshold,
              v_rest=v_rest, v_min=v_min, v_max=v_max,
              active_pruning=active_pruning)
    if dev.type == "cpu":
        return lif_forward_plain(spikes_u8, w_i16, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no LIF kernel for device {dev}")
    bB, bN = BLOCK
    if B == 0 or B % bB or N == 0 or N % bN or K % K_ALIGN:
        raise ValueError(f"the LIF kernel takes a batch that is a multiple "
                         f"of {bB}, an input width that is a multiple of "
                         f"{K_ALIGN} and an output width that is a multiple "
                         f"of {bN}, got B={B}, K={K}, N={N}")
    if spikes_u8.data_ptr() % 16 or w_i16.data_ptr() % 16:
        raise ValueError("the LIF kernel copies 16-byte pieces: spikes_u8 "
                         "and w_i16 must be 16-byte aligned")
    spk = torch.empty((T, B, N), dtype=torch.uint8, device=dev)
    vtr = torch.empty((T, B, N), dtype=torch.int32, device=dev)
    vfin = torch.empty((B, N), dtype=torch.int32, device=dev)
    launch("lif_step", [spikes_u8, w_i16, spk, vtr, vfin],
           [T, B, K, N, decay_shift, v_threshold, v_rest, v_min, v_max,
            int(active_pruning)], dev)
    lif_forward.launches += 1
    return spk, vtr, vfin


lif_forward.launches = 0


def lif_forward_readout_plain(spikes_u8: torch.Tensor, w_i16: torch.Tensor,
                              *, b_valid: int, n_valid: int, last: bool,
                              decay_shift: int, v_threshold: int,
                              v_rest: int = 0, v_min: int = -(1 << 20),
                              v_max: int = (1 << 20) - 1,
                              active_pruning: bool = False) -> dict:
    """The readout launch's function in plain PyTorch.

    ``spikes_u8`` (T, B, K) and ``w_i16`` (K, N) as
    :func:`lif_forward_plain`; lanes from ``b_valid`` on and columns from
    ``n_valid`` on are padding, left out of every tally.  Returns a dict:
    ``spikes`` (T, B, N) uint8 and ``v_peak`` (B, N) int32 (the largest
    membrane over the window); ``n_spk`` (T, B) the fired neurons of each
    (step, lane), ``live_k`` (T, B / 8) each (step, 8-lane block)'s
    128-column tiles holding one; ``n_en`` and ``live_n`` the same of the
    neurons enabled at the step's start (``n_en`` None without pruning);
    with ``last`` also ``v_trace``, ``v_final``, ``counts`` (each neuron's
    spikes) and ``first`` (its first spike's step, T if none).
    """
    spk, vtr, vfin = lif_forward_plain(
        spikes_u8, w_i16, decay_shift=decay_shift, v_threshold=v_threshold,
        v_rest=v_rest, v_min=v_min, v_max=v_max,
        active_pruning=active_pruning)
    T, B, N = spk.shape
    dev = spk.device
    valid = ((torch.arange(B, device=dev) < b_valid)[:, None]
             & (torch.arange(N, device=dev) < n_valid)[None, :])
    fired = (spk != 0) & valid
    if active_pruning:
        s = spk.to(torch.int32)
        en = ((torch.cumsum(s, dim=0) - s) == 0) & valid
    else:
        en = valid.expand(T, B, N)
    out = {"spikes": spk,
           "v_peak": (vtr.amax(dim=0) if T else torch.full(
               (B, N), -(1 << 31), dtype=torch.int32, device=dev)),
           "n_spk": fired.sum(-1, dtype=torch.int32),
           "live_k": tile_any(fired, BLOCK[0]).sum(-1, dtype=torch.int32),
           "n_en": en.sum(-1, dtype=torch.int32) if active_pruning else None,
           "live_n": tile_any(en, BLOCK[0]).sum(-1, dtype=torch.int32)}
    if last:
        t_idx = torch.arange(T, dtype=torch.int32, device=dev)[:, None, None]
        out.update(v_trace=vtr, v_final=vfin,
                   counts=spk.sum(0, dtype=torch.int32),
                   first=torch.where(spk != 0, t_idx, T).amin(dim=0) if T
                   else torch.zeros((B, N), dtype=torch.int32, device=dev))
    return out


def lif_forward_readout(spikes_u8: torch.Tensor, w_i16: torch.Tensor,
                        tallies, *, layer: int, b_valid: int, n_valid: int,
                        decay_shift: int, v_threshold: int, v_rest: int = 0,
                        v_min: int = -(1 << 20), v_max: int = (1 << 20) - 1,
                        active_pruning: bool = False) -> dict:
    """Run layer ``layer`` of a stack as :func:`lif_forward` does (the same
    operand rules) and take its readouts in the kernel's epilogue.

    ``tallies`` is the call's zeroed ``kernels.ops.StagedTallies`` of B
    lanes and L layers; the tallies of :func:`lif_forward_readout_plain`
    are added into it: the enabled neurons' into this layer's ``n_en``
    (under pruning only) and ``live_n``, the fired neurons' into the next
    layer's ``n_spk`` and ``live_k`` (none for the last layer, ``layer ==
    L - 1``).  Returns the rest of that dict: ``spikes``, ``v_peak`` and,
    for the last layer, ``v_trace``, ``v_final``, ``counts`` and
    ``first``; a hidden layer's launch writes no trace.  CUDA tensors
    launch the readout instantiation (counted in
    ``lif_forward_readout.launches``); CPU tensors run the plain twin.
    """
    if spikes_u8.ndim != 3 or w_i16.ndim != 2:
        raise ValueError(f"spikes must be (T, B, K) and weights (K, N), got "
                         f"{tuple(spikes_u8.shape)} and {tuple(w_i16.shape)}")
    dev = spikes_u8.device
    T, B, K = spikes_u8.shape
    N = w_i16.shape[1]
    bB, bN = BLOCK
    check_operand(spikes_u8, "spikes_u8", torch.uint8, (T, B, K), dev)
    check_operand(w_i16, "w_i16", torch.int16, (K, N), dev)
    if B == 0 or B % bB or N == 0 or N % bN or K % K_ALIGN:
        raise ValueError(f"the LIF kernel takes a batch that is a multiple "
                         f"of {bB}, an input width that is a multiple of "
                         f"{K_ALIGN} and an output width that is a multiple "
                         f"of {bN}, got B={B}, K={K}, N={N}")
    if not (B - bB < b_valid <= B and 0 < n_valid <= N):
        raise ValueError(f"b_valid={b_valid} and n_valid={n_valid} must "
                         f"leave less than one lane block and some column "
                         f"of ({B}, {N})")
    check_tallies(tallies, T, B, dev)
    L = tallies.n_spk.shape[1]
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} of a stack of {L}")
    last = layer == L - 1
    kw = dict(decay_shift=decay_shift, v_threshold=v_threshold,
              v_rest=v_rest, v_min=v_min, v_max=v_max,
              active_pruning=active_pruning)
    if dev.type == "cpu":
        r = lif_forward_readout_plain(spikes_u8, w_i16, b_valid=b_valid,
                                      n_valid=n_valid, last=last, **kw)
        tallies.live_n[:, layer] += r.pop("live_n")
        if active_pruning:
            tallies.n_en[:, layer] += r["n_en"]
        r.pop("n_en")
        n_spk, live_k = r.pop("n_spk"), r.pop("live_k")
        if not last:
            tallies.n_spk[:, layer + 1] += n_spk
            tallies.live_k[:, layer + 1] += live_k
        return r
    if dev.type != "cuda":
        raise ValueError(f"no LIF kernel for device {dev}")
    if spikes_u8.data_ptr() % 16 or w_i16.data_ptr() % 16:
        raise ValueError("the LIF kernel copies 16-byte pieces: spikes_u8 "
                         "and w_i16 must be 16-byte aligned")

    def new(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {"spikes": new((T, B, N), torch.uint8), "v_peak": new((B, N))}
    if last:
        out.update(v_trace=new((T, B, N)), v_final=new((B, N)),
                   counts=new((B, N)), first=new((B, N)))
    fired = (None, None) if last else (tallies.n_spk[:, layer + 1],
                                       tallies.live_k[:, layer + 1])
    launch("lif_step",
           [spikes_u8, w_i16, out["spikes"], out.get("v_trace"),
            out.get("v_final"), out["v_peak"], out.get("counts"),
            out.get("first"), *fired,
            tallies.n_en[:, layer] if active_pruning else None,
            tallies.live_n[:, layer]],
           [T, B, K, N, decay_shift, v_threshold, v_rest, v_min, v_max,
            int(active_pruning), b_valid, n_valid,
            tallies.n_spk.stride(0), tallies.live_k.stride(0)], dev)
    lif_forward_readout.launches += 1
    return out


lif_forward_readout.launches = 0
