"""Public wrappers of the port's kernels: padding, masks, unpadding.

Port of ``repro.kernels.ops``' ``poisson_encode_op``, ``lif_forward_op``,
``fused_snn_stack_op``, ``partial_contraction_op``, ``spike_matmul_op``
and ``validate_weight_codes``.  Each wrapper pads its operands to the
launch blocks, runs the kernel's launcher (the CUDA kernel for CUDA
tensors, its plain version for CPU tensors) and cuts the results back to
the true shapes.  The stack op also disables padded neurons and padded
batch rows.  The staged call's ops (``staged_tallies``,
``poisson_encode_readout_op``, ``lif_forward_readout_op``,
``staged_telemetry``) pass padded trains from launch to launch and take
the telemetry from the kernels' tallies.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.spans import count, span
from ..core.telemetry import (DEFAULT_SPIKE_DENSITY_THRESHOLD, ChunkTelemetry,
                              MatmulTelemetry, resolve_density_threshold,
                              resolve_sparse_skip, tiles_total)
from . import fused_snn, lif_step, poisson_encode, spike_matmul

__all__ = ["poisson_encode_op", "lif_forward_op", "fused_snn_op",
           "fused_snn_stack_op", "partial_contraction_op", "spike_matmul_op",
           "stack_weights", "stack_operands", "stack_results",
           "StagedTallies", "staged_tallies", "poisson_encode_readout_op",
           "lif_forward_readout_op", "staged_telemetry",
           "validate_weight_codes", "V_PEAK_INIT",
           "SPIKE_DENSITY_THRESHOLD", "resolve_density_threshold"]

# The spike matmul's default dispatch threshold, under the JAX package's
# name: the live value resolves through config / env / this default
# (``core.telemetry.resolve_density_threshold``, re-exported here too).
SPIKE_DENSITY_THRESHOLD = DEFAULT_SPIKE_DENSITY_THRESHOLD

# window-start sentinel for the carried peak-membrane accumulator: the
# first real membrane value always wins the max-fold
V_PEAK_INIT = -(1 << 31)


def validate_weight_codes(weights) -> None:
    """Raise if weights fall outside the signed 9-bit code range.

    The stack kernels (``fused`` and ``fused_streamed``) take the paper's
    signed 9-bit weight codes [-256, 255] (``quantize_params``' output
    contract).  The reference package's fused kernels pack them into two
    int8 planes, exact only on that range; the port holds codes to the same
    contract so both packages accept and refuse the same weights.  The
    staged LIF kernel takes any int16 code.

    The check is the span ``ops.validate_weight_codes``; each of its
    ``int(...)`` reads blocks until the device has caught up, counted in
    ``host_syncs`` (two a layer; ``core.spans``).
    """
    with span("ops.validate_weight_codes"):
        for i, w in enumerate(weights):
            lo, hi = int(w.min()), int(w.max())
            count("host_syncs", 2)
            if lo < -256 or hi > 255:
                raise ValueError(
                    f"layer {i} weight codes span [{lo}, {hi}] — outside "
                    f"the signed 9-bit range [-256, 255] the fused kernels' "
                    f"int8 packing represents exactly (quantize_params' "
                    f"contract); use the staged or reference backend for "
                    f"wider codes")


def _int16_codes(w_q: torch.Tensor, op: str) -> torch.Tensor:
    """``w_q`` as int16 codes: int16 goes through as it is; any other
    dtype is cast only when every code fits int16 and raises otherwise,
    since the JAX op would compute such codes exactly where a cast wraps."""
    if w_q.dtype == torch.int16:
        return w_q
    if w_q.numel() and (int(w_q.min()) < -(1 << 15)
                        or int(w_q.max()) >= 1 << 15):
        raise ValueError(
            f"{op} takes int16 weight codes; codes span [{int(w_q.min())}, "
            f"{int(w_q.max())}], outside [-32768, 32767], and a cast "
            f"would wrap them")
    return w_q.to(torch.int16)


def _uint8_spikes(spikes: torch.Tensor, op: str) -> torch.Tensor:
    """``spikes`` as uint8 bytes: uint8 goes through as it is, bool becomes
    0 / 1; any other dtype is cast only when every value fits [0, 255] and
    raises otherwise, since the JAX op would count such values exactly
    where a cast wraps them."""
    if spikes.dtype == torch.uint8:
        return spikes
    if spikes.dtype != torch.bool and spikes.numel() and (
            int(spikes.min()) < 0 or int(spikes.max()) > 255):
        raise ValueError(
            f"{op} takes uint8 spike bytes; values span "
            f"[{int(spikes.min())}, {int(spikes.max())}], outside [0, 255], "
            f"and a cast would wrap them")
    return spikes.to(torch.uint8)


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to a multiple of ``mult`` (uint32 via int32)."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x.contiguous()
    if x.dtype == torch.uint32:
        return _pad_to(x.view(torch.int32), axis, mult).view(torch.uint32)
    if x.dtype == torch.bool:
        return _pad_to(x.to(torch.uint8), axis, mult).to(torch.bool)
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    return F.pad(x, widths).contiguous()


def _pad2(x: torch.Tensor, rows: int, lanes: int) -> torch.Tensor:
    return _pad_to(_pad_to(x, 0, rows), 1, lanes)


def poisson_encode_op(pixels_u8: torch.Tensor, state_u32: torch.Tensor,
                      num_steps: int):
    """Poisson-encode a whole window: ``(spikes (T, B, N) uint8, final state
    (B, N) uint32)``.  Pads batch to 8 and pixels to 128 (zero pixels and
    zero state never spike) and cuts back."""
    B, N = pixels_u8.shape
    lane = fused_snn.LANE
    spikes, state = poisson_encode.poisson_encode(
        _pad2(pixels_u8, 8, lane), _pad2(state_u32, 8, lane), num_steps)
    return spikes[:, :B, :N], state[:B, :N]


def lif_forward_op(spikes_t: torch.Tensor, w_q: torch.Tensor, *,
                   decay_shift: int, v_threshold: int, v_rest: int = 0,
                   v_min: int = -(1 << 20), v_max: int = (1 << 20) - 1,
                   active_pruning: bool = False):
    """One LIF layer over a (T, B, n_in) spike train with (n_in, n_out) int
    codes, from fresh state: ``(spikes (T, B, n_out) uint8, v_trace
    (T, B, n_out) int32, v_final (B, n_out) int32)``.

    Pads batch to 8 and n_out to 128 (padded columns carry zero weights
    and are cut before anything reads them).  n_in is padded, with zero
    spikes and zero weight rows, only where it is not a multiple of 16:
    the kernel copies 16-byte pieces of spike rows and zero-fills its own
    K tail.  Spike bytes count by value, as in the JAX op's dot; a spike
    train of a wider dtype with values outside [0, 255] raises.  Any int16
    code is exact here; codes of a wider dtype outside int16 raise.
    """
    T, B, _ = spikes_t.shape
    n_out = w_q.shape[1]
    bB, bN = lif_step.BLOCK
    spikes = _pad_to(_pad_to(_uint8_spikes(spikes_t, "lif_forward_op"), 1,
                             bB), 2, lif_step.K_ALIGN)
    w = _pad_to(_pad_to(_int16_codes(w_q, "lif_forward_op"), 1, bN), 0,
                lif_step.K_ALIGN)
    spk, vtr, vfin = lif_step.lif_forward(
        spikes, w, decay_shift=decay_shift,
        v_threshold=v_threshold, v_rest=v_rest, v_min=v_min, v_max=v_max,
        active_pruning=active_pruning)
    return spk[:, :B, :n_out], vtr[:, :B, :n_out], vfin[:B, :n_out]


class StagedTallies(NamedTuple):
    """A staged call's kernel tallies, int32, zeroed before its launches,
    lanes padded to the 8-lane block: per (step, layer, lane) the input
    spikes (``n_spk``) and the enabled neurons (``n_en``), per (step,
    layer, block) the 128-wide input tiles holding a spike (``live_k``)
    and the output tiles holding an enabled neuron (``live_n``)."""

    n_spk: torch.Tensor    # (T, L, Bp)
    n_en: torch.Tensor     # (T, L, Bp)
    live_k: torch.Tensor   # (T, L, Bp / 8)
    live_n: torch.Tensor   # (T, L, Bp / 8)


def staged_tallies(num_steps: int, n_layers: int, batch: int,
                   device) -> StagedTallies:
    """Zeroed tallies for a staged call: one allocation, one fill."""
    bB = lif_step.BLOCK[0]
    T, L, Bp = num_steps, n_layers, batch + (-batch) % bB
    n = 2 * T * L * Bp
    flat = torch.zeros(n + 2 * T * L * (Bp // bB), dtype=torch.int32,
                       device=device)
    lanes = flat[:n].view(2, T, L, Bp)
    blocks = flat[n:].view(2, T, L, Bp // bB)
    return StagedTallies(lanes[0], lanes[1], blocks[0], blocks[1])


def poisson_encode_readout_op(pixels_u8: torch.Tensor,
                              state_u32: torch.Tensor, num_steps: int,
                              tallies: StagedTallies):
    """The staged call's encoder launch, layer 0's telemetry written into
    ``tallies``.  Pads the batch to 8 and the pixels to 16 (zero pixels
    and zero state never spike).  Returns ``(spikes, state)``: the train
    at its padded shape (T, pad8(B), pad16(N)), as the first LIF launch
    reads it, and the final state cut back to (B, N)."""
    B, N = pixels_u8.shape
    bB, k = lif_step.BLOCK[0], lif_step.K_ALIGN
    spikes, state = poisson_encode.poisson_encode(
        _aligned(_pad2(pixels_u8, bB, k)), _aligned(_pad2(state_u32, bB, k)),
        num_steps, tallies)
    return spikes, state[:B, :N]


def lif_forward_readout_op(spikes: torch.Tensor, w_q: torch.Tensor,
                           tallies: StagedTallies, *, layer: int,
                           b_valid: int, decay_shift: int, v_threshold: int,
                           v_rest: int = 0, v_min: int = -(1 << 20),
                           v_max: int = (1 << 20) - 1,
                           active_pruning: bool = False) -> dict:
    """Layer ``layer`` of a staged call: one readout launch of the LIF
    kernel over the padded train the launch before wrote, (T, pad8(B), K)
    with K at least n_in; its codes are padded with zero rows to K and
    zero columns to 128.  Its tallies go into ``tallies``: this layer's
    enables, and the next layer's input spikes (none for the last layer).

    Returns ``spikes`` (T, pad8(B), pad128(n_out)), the next launch's
    input, and ``v_peak`` (B, n_out); for the last layer also ``v_trace``
    (T, B, n_out), ``v_final``, ``counts`` and ``first`` (B, n_out).
    """
    T, Bp, K = spikes.shape
    n_in, n_out = w_q.shape
    if K < n_in:
        raise ValueError(f"a train of {K} inputs for {n_in} weight rows")
    last = layer == tallies.n_spk.shape[1] - 1
    w = _pad_to(_int16_codes(w_q, "lif_forward_readout_op"), 1,
                lif_step.BLOCK[1])
    if K > n_in:
        w = F.pad(w, (0, 0, 0, K - n_in))
    r = lif_step.lif_forward_readout(
        spikes, w, tallies, layer=layer, b_valid=b_valid, n_valid=n_out,
        decay_shift=decay_shift, v_threshold=v_threshold, v_rest=v_rest,
        v_min=v_min, v_max=v_max, active_pruning=active_pruning)
    out = {"spikes": r["spikes"], "v_peak": r["v_peak"][:b_valid, :n_out]}
    if last:
        out["v_trace"] = r["v_trace"][:, :b_valid, :n_out]
        for k in ("v_final", "counts", "first"):
            out[k] = r[k][:b_valid, :n_out]
    return out


def staged_telemetry(tallies: StagedTallies, layer_sizes, batch: int, *,
                     sparse_skip: bool, active_pruning: bool
                     ) -> ChunkTelemetry:
    """A staged call's ``ChunkTelemetry`` from its kernels' tallies, on
    tensors of (T, L, B) elements: without pruning every neuron is enabled
    at every step; a block's skipped tile pairs are its layer's
    nK · nN less the live input tiles times the live output tiles (0 when
    ``sparse_skip`` is off), ``core.telemetry.layer_tile_skips``' count."""
    if not active_pruning:
        for l, n in enumerate(layer_sizes[1:]):
            tallies.n_en[:, l].fill_(int(n))
    if sparse_skip:
        live = tallies.live_k * tallies.live_n
        tiles = torch.stack([tot - live[:, l] for l, tot
                             in enumerate(tiles_total(layer_sizes))], dim=1)
    else:
        tiles = torch.zeros_like(tallies.live_k)
    return ChunkTelemetry(n_spk=tallies.n_spk[:, :, :batch],
                          n_en=tallies.n_en[:, :, :batch],
                          tiles_skipped=tiles)


def stack_weights(weights, n_in: int, layer_sizes=None, *,
                  streamed: bool = False):
    """The stack kernels' weight operands and the true layer widths
    ``[n_in, n_1, ..., n_L]``; the one place where codes become the
    streamed kernel's planes.

    ``weights`` are per-layer (n_l, n_{l+1}) codes.  For the resident
    kernel they go through as int16 at their real widths (only the first
    layer's rows are zero-padded, where n_in is not a multiple of
    ``K1_PIXEL_ALIGN``, to the pixels' padding).  For the streamed kernel
    they are padded to ``LANE`` on both axes and packed into their int8
    planes by ``kernels.fused_snn.pack_weights``, or are already placed
    (2, pad(n_{l+1}), pad(n_l)) planes, which go through as they are;
    planes need ``layer_sizes``, the true widths (n_in, n_1, ..., n_L),
    since their padding hides them.  Returns ``(weights, sizes)``.
    """
    lane = fused_snn.LANE
    if not any(fused_snn.is_planes(w) for w in weights):
        sizes = [n_in] + [int(w.shape[1]) for w in weights]
        if not streamed:
            ws = [_int16_codes(w, "fused_snn_stack_op").contiguous()
                  for w in weights]
            ws[0] = _pad_to(ws[0], 0, fused_snn.K1_PIXEL_ALIGN)
            return tuple(ws), sizes
        ws = tuple(fused_snn.pack_weights(_pad2(w.to(torch.int16), lane,
                                                lane)) for w in weights)
        return ws, sizes
    if not streamed:
        raise ValueError("the resident stack kernel takes int16 codes, not "
                         "packed planes")
    if (layer_sizes is None or len(layer_sizes) != len(weights) + 1
            or int(layer_sizes[0]) != n_in):
        raise ValueError(f"packed weight planes need layer_sizes, the true "
                         f"widths ({n_in}, n_1, ..., n_L)")
    sizes = [int(n) for n in layer_sizes]
    pads = [n + (-n) % lane for n in sizes]
    for l, w in enumerate(weights):
        want = (2, pads[l + 1], pads[l])
        if not fused_snn.is_planes(w) or tuple(w.shape) != want:
            raise ValueError(f"layer {l} weights {tuple(w.shape)} "
                             f"{w.dtype} are not the placed planes {want} "
                             f"int8 of layer_sizes {tuple(sizes)}")
    return tuple(weights), sizes


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned (a copy only where it is not)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def stack_operands(pixels_u8: torch.Tensor, state_u32: torch.Tensor,
                   weights, *, num_steps: int, v_rest: int = 0,
                   init: dict | None = None, gate: dict | None = None,
                   layer_sizes=None, streamed: bool = False):
    """The op's inputs as the stack kernel's launch operands.

    Returns ``(args, meta)``: ``args`` is the positional argument list of
    :func:`kernels.fused_snn.fused_snn_stack` (with ``streamed``, of
    ``fused_snn_stack_streamed``; either way of the plain version),
    ``meta`` what :func:`stack_results` needs to cut the outputs back.
    ``weights``, ``layer_sizes`` and ``streamed`` as
    :func:`stack_weights`.

    The resident kernel takes the arrays at their real widths and batch:
    they go through as they are (enables as the uint8 view of the bool
    tensor), and are padded only where n_in is not a multiple of
    ``K1_PIXEL_ALIGN`` (pixels and PRNG state, with zeros) or copied only
    where pixels or state do not start on a 16-byte boundary.  For the
    streamed kernel the batch pads to the ``block_b_for`` block and every
    neuron axis to ``LANE``.  Zero-padded pixel and state lanes never
    spike (0 > r is false, and 0 is the xorshift fixed point); padded
    neurons and padded batch rows are disabled, so they neither fire nor
    count as executed adds, and the tile-skip telemetry sees the same
    enable geometry whether the state is fresh or carried.

    The set-up, :func:`stack_weights` included, is the span
    ``ops.stack_operands`` (``core.spans``).
    """
    with span("ops.stack_operands"):
        dev = pixels_u8.device
        B, n_in = pixels_u8.shape
        L = len(weights)
        ws, sizes = stack_weights(weights, n_in, layer_sizes,
                                  streamed=streamed)
        bB = fused_snn.block_b_for(B)
        if streamed:
            lane = fused_snn.LANE
            Bp = B + (-B) % bB
            pads = [n + (-n) % lane for n in sizes]
            px = _pad2(pixels_u8, bB, lane)
            st = _pad2(state_u32, bB, lane)

            def rows(x):
                return _pad2(x, bB, lane)
        else:
            Bp, pads = B, sizes
            px = _aligned(_pad_to(pixels_u8, 1, fused_snn.K1_PIXEL_ALIGN))
            st = _aligned(_pad_to(state_u32, 1, fused_snn.K1_PIXEL_ALIGN))

            def rows(x):
                return x.contiguous()

        def valid_mask(n_true, n_pad):
            col = torch.arange(n_pad, device=dev)[None, :]
            row = torch.arange(Bp, device=dev)[:, None]
            return ((col < n_true) & (row < B)).to(torch.uint8)

        def vp_fresh():
            return tuple(torch.full((Bp, pads[l + 1]), V_PEAK_INIT,
                                    dtype=torch.int32, device=dev)
                         for l in range(L))

        if init is None:
            v_in = tuple(torch.full((Bp, pads[l + 1]), v_rest,
                                    dtype=torch.int32, device=dev)
                         for l in range(L))
            en_in = tuple(valid_mask(sizes[l + 1], pads[l + 1])
                          for l in range(L))
            vp_in = vp_fresh()
            cnt_in = torch.zeros((Bp, pads[-1]), dtype=torch.int32,
                                 device=dev)
            first_in = torch.full((Bp, pads[-1]), num_steps,
                                  dtype=torch.int32, device=dev)
            steps_in = torch.zeros((Bp, 1), dtype=torch.int32, device=dev)
        else:
            v_in = tuple(rows(init["v"][l]) for l in range(L))
            # bool is one byte of 0 / 1: the kernels read it as uint8
            en_in = tuple(rows(init["en"][l].to(torch.bool)).view(torch.uint8)
                          for l in range(L))
            vp_in = (vp_fresh() if init.get("v_peak") is None else
                     tuple(rows(init["v_peak"][l]) for l in range(L)))
            cnt_in = rows(init["counts"])
            first_in = rows(init["first"])
            steps_in = _pad_to(init["steps"].to(torch.int32)[:, None], 0,
                               bB if streamed else 1)

        gate_in = None
        if gate is not None:
            gate_in = tuple(_pad_to(gate[k].to(torch.int32)[:, None], 0,
                                    bB if streamed else 1)
                            for k in ("active", "prev", "streak"))
        args = [px, st, ws, v_in, en_in, vp_in, cnt_in, first_in, steps_in,
                gate_in]
        return args, {"B": B, "sizes": sizes, "block_b": bB}


def stack_results(outs, meta: dict) -> dict:
    """Cut the stack kernel's outputs back to the op's result dict (a view
    of each output; the resident kernel's are at their real widths)."""
    B, sizes = meta["B"], meta["sizes"]
    n_in, n_out, L = sizes[0], sizes[-1], len(sizes) - 1
    (cnt, vtr, first, adds, st_out, v_fin, en_fin, vp_fin, tel,
     steps_out) = outs[:10]
    tspk, ten, ttile = tel
    res = {
        "spike_counts": cnt[:B, :n_out],
        "v_trace": vtr[:, :B, :n_out],
        "first_spike_t": first[:B, :n_out],
        "v_final": v_fin[-1][:B, :n_out],
        "active_adds": adds[:, :B],
        "prng_state": st_out[:B, :n_in],
        "v": tuple(v_fin[l][:B, :sizes[l + 1]] for l in range(L)),
        # the kernels write enables as 0 / 1 bytes
        "en": tuple(en_fin[l][:B, :sizes[l + 1]].view(torch.bool)
                    for l in range(L)),
        "v_peak": tuple(vp_fin[l][:B, :sizes[l + 1]] for l in range(L)),
        "telemetry": ChunkTelemetry(n_spk=tspk[:, :, :B], n_en=ten[:, :, :B],
                                    tiles_skipped=ttile),
        "steps": steps_out[:B, 0],
    }
    if len(outs) > 10:
        act, prev, streak = outs[10]
        res["gate"] = {"active": act[:B, 0] != 0, "prev": prev[:B, 0],
                       "streak": streak[:B, 0]}
    return res


def fused_snn_stack_op(pixels_u8: torch.Tensor, state_u32: torch.Tensor,
                       weights, *, num_steps: int,
                       chunk_steps: int | None = None, decay_shift: int,
                       v_threshold: int, v_rest: int = 0,
                       v_min: int = -(1 << 20), v_max: int = (1 << 20) - 1,
                       active_pruning: bool = False, init: dict | None = None,
                       gate: dict | None = None, patience: int = 0,
                       readout: str = "count",
                       sparse_skip: bool | None = None,
                       streamed: bool = False, layer_sizes=None):
    """Multi-layer encode→LIF stack in one resumable launch.

    Args:
      weights: per-layer (n_l, n_{l+1}) int16 codes in [-256, 255] or, for
        the streamed kernel, their placed int8 planes with ``layer_sizes``
        (see :func:`stack_weights`; codes are packed per call there).
      num_steps: the full window T (first-spike sentinel, gate step bound).
      chunk_steps: steps THIS launch executes (default: the whole window).
      init: optional carried state — ``v``/``en``/``v_peak`` per-layer
        tuples ((B, n_l) int32 / bool / int32; ``v_peak`` may be omitted),
        ``counts``/``first`` ((B, n_out) int32) and ``steps`` ((B,) int32).
      gate: optional stability-gate state — ``active`` bool (B,),
        ``prev``/``streak`` int32 (B,); the launch then runs the early-exit
        gate each step and freezes retired lanes.
      sparse_skip: tile-skip telemetry on/off (None = REPRO_SPARSE_SKIP).
      streamed: run the weight-streaming kernel (the ``fused_streamed``
        backend, for stacks whose per-lane state the resident kernel's
        shared memory cannot hold) instead of the resident one.

    Returns a dict with ``spike_counts``/``first_spike_t``/``v_final``
    ((B, n_out) int32), ``v_trace`` ((chunk, B, n_out) int32),
    ``active_adds`` ((chunk, B) int32), ``prng_state`` ((B, n_in) uint32),
    the carried ``v``/``en``/``v_peak``/``steps``, ``telemetry`` (a
    ChunkTelemetry) and, when gated, ``gate``.  CUDA tensors run one launch
    of a stack kernel, CPU tensors the plain version.
    """
    args, meta = stack_operands(pixels_u8, state_u32, weights,
                                num_steps=num_steps, v_rest=v_rest,
                                init=init, gate=gate, layer_sizes=layer_sizes,
                                streamed=streamed)
    run = (fused_snn.fused_snn_stack_streamed if streamed
           else fused_snn.fused_snn_stack)
    outs = run(
        *args, chunk_steps=num_steps if chunk_steps is None else chunk_steps,
        window_steps=num_steps, decay_shift=decay_shift,
        v_threshold=v_threshold, v_rest=v_rest, v_min=v_min, v_max=v_max,
        active_pruning=active_pruning, patience=patience, readout=readout,
        sparse_skip=resolve_sparse_skip(sparse_skip),
        block_b=meta["block_b"])
    return stack_results(outs, meta)


def fused_snn_op(pixels_u8: torch.Tensor, state_u32: torch.Tensor,
                 w_q: torch.Tensor, *, num_steps: int, decay_shift: int,
                 v_threshold: int, v_rest: int = 0, v_min: int = -(1 << 20),
                 v_max: int = (1 << 20) - 1, active_pruning: bool = False,
                 sparse_skip: bool | None = None, streamed: bool = False):
    """Single-layer whole-window wrapper over :func:`fused_snn_stack_op`.

    Returns its dict (``spike_counts``, ``v_trace``, ``first_spike_t``,
    ``v_final``, ``active_adds``, ``prng_state`` and the rest); the
    (T, B, N_in) spike train is never materialised.
    """
    return fused_snn_stack_op(
        pixels_u8, state_u32, (w_q,), num_steps=num_steps,
        decay_shift=decay_shift, v_threshold=v_threshold, v_rest=v_rest,
        v_min=v_min, v_max=v_max, active_pruning=active_pruning,
        sparse_skip=sparse_skip, streamed=streamed)


def partial_contraction_op(spikes: torch.Tensor, en: torch.Tensor,
                           w_q: torch.Tensor, *,
                           sparse_skip: bool | None = None):
    """One layer's Σ W·S against an output-column weight shard.

    The model-axis datapath's per-shard contraction: ``spikes`` (B, n_in)
    bool is the full input-spike vector, ``en`` (B, n_out) bool and
    ``w_q`` the shard's enables and weights.  ``w_q`` is either a placed
    shard, the LANE-padded int8 planes ``(2, pad(n_out), pad(n_in))`` of
    ``kernels.fused_snn.pack_weights`` as the sharded engine places them,
    which go to the kernel as they are (they must be contiguous), or
    unpadded (n_in, n_out) int16 codes, which are padded and packed here
    per call as the JAX op does.  Pads the batch to the ``block_b_for``
    block and both neuron axes to 128, launches
    :func:`kernels.fused_snn.partial_contraction` with ``n_valid = n_out``
    and cuts back.

    Returns ``(current (B, n_out) int32, skipped (n_blocks,) int32)``: the
    raw current (zero across an output tile with no enabled neuron in the
    8-lane block when the tile skip is on, as in the reference kernel) and
    the skipped tile pairs per block, the geometry
    ``core.telemetry.layer_tile_skips`` gives for this shard.
    """
    ss = resolve_sparse_skip(sparse_skip)
    B, n_in = spikes.shape
    n_out = en.shape[1]
    lane = fused_snn.LANE
    bB = fused_snn.block_b_for(B)
    pads = (n_in + (-n_in) % lane, n_out + (-n_out) % lane)
    if w_q.dtype == torch.int8 and tuple(w_q.shape) == (2, pads[1], pads[0]):
        w = w_q
    elif w_q.dtype != torch.int8 and tuple(w_q.shape) == (n_in, n_out):
        w = fused_snn.pack_weights(_pad2(w_q.to(torch.int16), lane, lane))
    else:
        raise ValueError(f"weight shard {tuple(w_q.shape)} {w_q.dtype} fits "
                         f"neither ({n_in}, {n_out}) codes nor their packed "
                         f"planes (2, {pads[1]}, {pads[0]}) int8")
    x = _pad2(spikes.to(torch.uint8), bB, lane)
    e = _pad2(en.to(torch.uint8), bB, lane)
    cur, skipped = fused_snn.partial_contraction(x, e, w, n_valid=n_out,
                                                 sparse_skip=ss, block_b=bB)
    return cur[:B, :n_out], skipped


def spike_matmul_op(spikes: torch.Tensor, w_q: torch.Tensor, *,
                    mode: str = "auto",
                    density_threshold: float | None = None,
                    with_telemetry: bool = False):
    """Event-driven spike × weight contraction: (B, K) {0,1} × (K, N) int
    codes → (B, N) int32.

    ``mode="auto"`` picks the realisation from the batch's observed spike
    density, on the device: the masked (select-and-add) kernel below the
    threshold, the multiply-accumulate (``dot``) kernel at or above it.
    The density is the exact non-zero count times the float32 reciprocal
    of B·K, so it equals the reference's ``mean`` bit for bit while
    B·K < 2^24; the
    threshold (``density_threshold``, None = config/env/default via
    ``resolve_density_threshold``) is a float32 tensor, and the launched
    kernel reads the resulting flag, so nothing waits for the host.
    ``mode="masked"`` / ``"dot"`` force one realisation; all give the same
    result.  Any int16 code is exact; codes of a wider dtype outside int16
    raise.  ``with_telemetry=True`` also returns a ``MatmulTelemetry``
    (0-dim tensors: the density and which realisation ran).
    """
    if mode not in ("auto", "masked", "dot"):
        raise ValueError(f"unknown spike-matmul mode {mode!r}")
    dev = spikes.device
    B, K = spikes.shape
    N = w_q.shape[1]
    bB, bK, bN = spike_matmul.BLOCK
    s = _pad2(spikes.to(torch.uint8), bB, bK)
    w = _pad2(_int16_codes(w_q, "spike_matmul_op"), bK, bN)
    # the reference's mean divides by the constant B·K, which XLA compiles
    # into a product with its float32 reciprocal: do the same, bit for bit
    one = torch.ones((), dtype=torch.float32, device=dev)
    density = torch.count_nonzero(spikes).to(torch.float32) * (
        one / torch.tensor(B * K, dtype=torch.float32, device=dev))
    if mode == "auto":
        threshold = torch.tensor(resolve_density_threshold(density_threshold),
                                 dtype=torch.float32, device=dev)
        used_masked = density < threshold
    else:
        used_masked = torch.tensor(mode == "masked", device=dev)
    out = spike_matmul.spike_matmul(s, w, used_masked)[:B, :N]
    if with_telemetry:
        return out, MatmulTelemetry(density=density, used_masked=used_masked)
    return out
