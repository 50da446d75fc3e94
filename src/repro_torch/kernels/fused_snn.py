"""Fused Poisson-encode → LIF *stack* in one launch: the two CUDA kernels'
launchers and their plain PyTorch version.

Port of ``repro.kernels.fused_snn.fused_snn_stack_pallas``, resident and
weight-streamed.  One launch advances every lane ``chunk_steps`` window
steps through the whole layer stack: xorshift32 PRNG → ``px > top byte``
spikes → per layer Σ W·S over the spiking inputs, enable mask, saturating
add, shift leak, fire, reset, active pruning, peak-membrane max-fold →
final-layer counts and first-spike latch → executed-add and telemetry
counters → (gated) stability-gate readout and lane freeze.  Every piece of
state goes in and comes out, so k chunks equal one launch.

Two kernels compute that function:
:func:`fused_snn_stack` launches the resident kernel of
``csrc/fused_snn_stack.cu`` (each lane's pixels and PRNG state in
registers, its other state in shared memory, sized by
:func:`stack_smem_bytes`), :func:`fused_snn_stack_streamed` the
weight-streaming kernel of ``csrc/fused_snn_streamed.cu`` (per-lane state
in global memory, Σ W·S on the int8 tensor cores over the weights' two
planes read from device memory, 64 lanes per thread-block cluster, sized
by :func:`stack_streamed_smem_bytes`), for stacks the first cannot hold.
Each counts its launches in its ``launches`` attribute.  For CPU tensors
both run :func:`fused_snn_stack_plain`; there is no fallback from a
kernel to the plain version.

The resident kernel takes the arrays at their real widths, as
``kernels.ops.fused_snn_stack_op`` passes them: any batch, k0 a multiple
of 16, every layer its own width, the weights (n_l, n_{l+1}) int16 codes.
The streamed kernel takes them padded: batch to the ``block_b`` block,
every neuron axis to ``LANE``, the weights the int8 planes (2,
n_{l+1}_pad, n_l_pad) of :func:`pack_weights`.  The plain version takes
either.

The model-axis datapath's building block lives here too:
:func:`partial_contraction` (port of ``partial_contraction_pallas``) is one
layer's Σ W·S of the full input-spike vector against one output-column
weight shard, for one step, with the same tile skip; the shard arrives as
the two int8 planes of :func:`pack_weights`.  It launches
``csrc/partial_contraction.cu`` (int8 tensor cores) for CUDA tensors and
runs :func:`partial_contraction_plain` for CPU tensors, counting launches
in ``partial_contraction.launches``.  :func:`layer_shard_ways` says which
layers split over a model axis.
"""

from __future__ import annotations

import torch

from ..core.prng import from_carrier, to_carrier
from ..core.spans import span
from ._build import check_operand, launch
from .lif_step import _wrap32

__all__ = ["LANE", "BLOCK_B", "MAX_LAYERS", "SMEM_LIMIT_BYTES",
           "STREAM_LANES", "K1_PIXEL_ALIGN", "K1_MAX_PIXELS", "READOUTS",
           "block_b_for", "check_block_b", "is_planes",
           "stack_smem_bytes", "stack_streamed_smem_bytes", "fused_snn_stack",
           "fused_snn_stack_streamed", "fused_snn_stack_plain",
           "layer_shard_ways", "pack_weights", "unpack_weights",
           "partial_contraction", "partial_contraction_plain"]

LANE = 128              # telemetry tile width; the streamed kernel pads to it
BLOCK_B = 8             # lanes per batch block (the telemetry's block), the
                        # only block the kernels are built for
K1_PIXEL_ALIGN = 16     # the resident kernel's k0 is a multiple of this
K1_MAX_PIXELS = 3072    # ... and at most this: 3 register slots of 16
                        # pixels per thread, 64 threads per lane
MAX_LAYERS = 8          # layer pointers the kernels' parameter block holds
STREAM_LANES = 64       # lanes one cluster of the streamed kernel owns
# Dynamic shared memory one thread block may ask for on Hopper (sm_90).
SMEM_LIMIT_BYTES = 232_448
READOUTS = ("count", "first_spike", "membrane")
_MASK32 = 0xFFFFFFFF


def block_b_for(batch: int | None = None) -> int:
    """Batch block launched for a ``batch``-row tile: always ``BLOCK_B``
    (batches pad up to it), which is also the telemetry's block geometry."""
    return BLOCK_B


def check_block_b(block_b: int | None) -> None:
    """Refuse a batch block the kernels are not built for.

    The JAX package's kernel takes any multiple of 8 and its results do
    not depend on it; the port's kernels fix their lane grouping (K1: 8
    lanes per 512-thread block, also the telemetry's block; K2: 64 lanes a
    cluster), so the only block there is to ask for is ``BLOCK_B``."""
    if block_b is not None and block_b != BLOCK_B:
        raise ValueError(
            f"block_b={block_b!r}: the port's kernels run a fixed batch "
            f"block of {BLOCK_B} lanes; pass block_b=None or {BLOCK_B}")


def layer_shard_ways(layer_sizes, model_shards: int) -> tuple[int, ...]:
    """Effective model-axis shard count per layer (len = n_layers).

    A layer's output-neuron dimension shards ``model_shards``-way only
    when its raw width divides evenly: contiguous column slices of equal
    width concatenate back to the single-device contraction.  A layer that
    does not divide (the 10-class head on a 4-way axis) replicates: every
    model peer would compute it whole, and it needs no spike exchange.
    """
    if model_shards <= 1:
        return tuple(1 for _ in layer_sizes[1:])
    return tuple(int(model_shards) if int(n) % int(model_shards) == 0 else 1
                 for n in layer_sizes[1:])


def stack_smem_bytes(sizes, block_b: int = BLOCK_B) -> int:
    """Dynamic shared memory the resident kernel asks for, per thread block.

    ``sizes`` are the real layer widths ``(k0, n_1, ..., n_L)`` (k0 a
    multiple of ``K1_PIXEL_ALIGN``).  The pixels and PRNG state live in
    registers; shared memory holds, each section rounded up to 16 bytes:
    per layer the ``block_b`` lanes' membranes and peaks (4 B each) and
    enables (1 B) per neuron; their output counts and first-spike latches
    (4 B each); two lists of input-spike indices per lane (uint16, as long
    as the widest layer input rounded up to 8); the hand-over of the
    second warp's partial sums (32 threads x 4 columns, int32); four ints
    per lane (gate and steps); per layer and lane the list length and the
    enabled count; and one int flag per 128-wide tile of every layer's
    input and output.  The kernel carves the same layout and refuses a
    launch whose carve-up exceeds what it was given.
    """
    k0, outs = int(sizes[0]), [int(n) for n in sizes[1:]]
    ins = [k0] + outs[:-1]

    def r16(n):
        return -(-n // 16) * 16

    flags = sum(-(-k // LANE) for k in ins) + sum(-(-n // LANE) for n in outs)
    return (sum(2 * r16(block_b * n * 4) + r16(block_b * n) for n in outs)
            + 2 * r16(block_b * outs[-1] * 4)
            + 2 * r16(block_b * -(-max(ins) // 8) * 8 * 2)
            + r16(block_b * 32 * 4 * 4) + r16(block_b * 4 * 4)
            + 2 * r16(len(outs) * block_b * 4) + r16(4 * flags))


def _stream_passes(n: int) -> int:
    """The most 256-column passes one CTA of the streamed kernel makes over
    a hidden layer of ``n`` columns: in its smallest cluster, of 6 CTAs,
    each takes the width over 6 rounded up to 32 (rank 0 sits out only
    when that adds no pass)."""
    per = -(-n // 6)
    return -(-(-(-per // 32) * 32) // 256)


def stack_streamed_smem_bytes(padded_sizes) -> int:
    """Dynamic shared memory the weight-streaming kernel asks for, per CTA.

    Membranes, peaks, counters and PRNG state live in global memory and
    the weight planes go straight from device memory to registers.
    Shared memory holds: a ring of two blocks of 4 K chunks of A fragments
    (32 KB); the enables of the CTA's neurons, one bit each, a word per
    thread and 256-column pass (:func:`_stream_passes`, one pass per 256
    columns of the last layer); the ``STREAM_LANES`` lanes' input spikes
    as two bitmaps (ping-pong) as wide as the widest layer, each row
    padded to a stride of 2 mod 32 words; small counters: per layer each
    lane's input spikes and enabled neurons and each 8-lane block's K-tile
    count and N-tile bits (one bit per 128-wide tile, twice: rank 0's sums
    and the CTA's own), per lane its enabled count, active flag, steps and
    gate state; and, when the whole still fits ``SMEM_LIMIT_BYTES``, each
    of the 16 warps' stage of the membranes and peaks of its 64 lanes × 16
    columns (8 KB a warp), without which the kernel reads them from device
    memory.  The kernel carves the same layout from the bytes it is given
    and refuses a launch given less than the layout without stages.
    """
    k0, outs = int(padded_sizes[0]), [int(n) for n in padded_sizes[1:]]
    words = max([k0] + outs) // 32
    stride = words + (34 - words % 32) % 32
    blocks = STREAM_LANES // BLOCK_B
    te = sum(blocks * -(-(n // LANE) // 32) for n in outs)
    en = 512 * (sum(_stream_passes(n) for n in outs[:-1])
                + -(-outs[-1] // 256))
    rest = 4 * (2 * 4 * 256 * 4 + en + 2 * STREAM_LANES * stride
                + len(outs) * (2 * STREAM_LANES + blocks) + 2 * te
                + 5 * STREAM_LANES)
    staged = rest + 4 * 16 * 2 * STREAM_LANES * 16
    return staged if staged <= SMEM_LIMIT_BYTES else rest


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def _block_tile_skips(x, en, block_b: int, sparse_skip: bool):
    """Skipped 128×128 tile pairs per batch block: the batch and both
    widths zero-padded (no spike, no enable) to the block and ``LANE``."""
    nb = -(-x.shape[0] // block_b)
    if not sparse_skip:
        return torch.zeros((nb,), dtype=torch.int32, device=x.device)

    def tiles(a):
        rows, cols = nb * block_b - a.shape[0], (-a.shape[1]) % LANE
        if rows or cols:
            a = torch.nn.functional.pad(a.to(torch.uint8), (0, cols, 0, rows))
        return a.reshape(nb, block_b, -1, LANE).amax(dim=(1, 3)) != 0

    live = tiles(x)[:, :, None] & tiles(en)[:, None, :]
    return (~live).sum(dim=(1, 2), dtype=torch.int32)


def is_planes(w: torch.Tensor) -> bool:
    """Whether a layer's weights are :func:`pack_weights` planes (2, n_out,
    n_in) int8 rather than (n_in, n_out) codes."""
    return w.dtype == torch.int8 and w.ndim == 3


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """First index of the row max, (B, 1) int32 (ties go to the first)."""
    return torch.argmax(x, dim=-1, keepdim=True).to(torch.int32)


def fused_snn_stack_plain(pixels_u8, state_u32, weights, v_init, en_init,
                          vp_init, counts_init, first_init, steps_init,
                          gate_init=None, *, chunk_steps: int,
                          window_steps: int, decay_shift: int,
                          v_threshold: int, v_rest: int = 0,
                          v_min: int = -(1 << 20), v_max: int = (1 << 20) - 1,
                          active_pruning: bool = False, patience: int = 0,
                          readout: str = "count", sparse_skip: bool = True,
                          block_b: int = BLOCK_B):
    """The stack kernels' function in plain PyTorch, on the operands of
    either kernel (real widths or padded).

    Returns ``(counts, v_trace (chunk, B, n_out), first, adds (chunk, B),
    state', v tuple, en tuple (uint8), v_peak tuple, (n_spk, n_en, tiles),
    steps' (B, 1)`` and, when ``gate_init`` is given, ``(active, prev,
    streak)`` each (B, 1) int32).  ``weights`` are codes or planes
    (:func:`is_planes`).  Σ W·S runs as a float64 product: exact, since
    |Σ| ≤ n_in·256 ≪ 2^53.
    """
    L = len(weights)
    gated = gate_init is not None
    ws = [(unpack_weights(w) if is_planes(w) else w).to(torch.float64)
          for w in weights]
    px = pixels_u8
    s = to_carrier(state_u32)
    vs = list(v_init)
    ens = [e != 0 for e in en_init]
    vps = list(vp_init)
    cnt, first, steps = counts_init, first_init, steps_init
    if gated:
        act = gate_init[0] != 0
        gprev, gstreak = gate_init[1], gate_init[2]
    vtr, adds, tspk, ten, ttile = [], [], [], [], []
    for _ in range(chunk_steps):
        s_new = s ^ ((s << 13) & _MASK32)
        s_new = s_new ^ (s_new >> 17)
        s_new = s_new ^ ((s_new << 5) & _MASK32)
        x = px > (s_new >> 24).to(torch.uint8)
        adds_t = torch.zeros_like(steps)
        new_vs, new_ens, new_vps = [], [], []
        spk_t, en_t, skip_t = [], [], []
        for l in range(L):
            en = ens[l]
            skip_t.append(_block_tile_skips(x, en, block_b, sparse_skip))
            cur = torch.matmul(x.to(torch.float64), ws[l]).to(torch.int32)
            cur = torch.where(en, cur, 0)
            v_int = torch.clamp(vs[l] + cur, v_min, v_max)
            v_leak = v_int - (v_int >> decay_shift)
            fired = (v_leak >= v_threshold) & en
            v_new = torch.where(fired, torch.full_like(v_leak, v_rest),
                                v_leak)
            v_new = torch.where(en, v_new, vs[l])
            n_spk = x.sum(-1, keepdim=True, dtype=torch.int32)
            n_en = en.sum(-1, keepdim=True, dtype=torch.int32)
            adds_t = adds_t + n_spk * n_en
            spk_t.append(n_spk[:, 0])
            en_t.append(n_en[:, 0])
            if active_pruning:
                en = en & ~fired
            new_vs.append(v_new)
            new_ens.append(en)
            new_vps.append(torch.maximum(vps[l], v_new))
            x = fired
        cnt_new = cnt + x.to(torch.int32)
        first_new = torch.where(x & (first == window_steps), steps, first)
        tel_spk, tel_en = torch.stack(spk_t), torch.stack(en_t)
        ttile.append(torch.stack(skip_t))
        if gated:
            has_spike = cnt_new.amax(dim=-1, keepdim=True) > 0
            if readout == "first_spike":
                large = 1 << 24
                score = torch.where(
                    cnt_new > 0, large + (window_steps - first_new),
                    torch.clamp(new_vs[-1], -large + 1, large - 1))
                pred = _first_argmax(score)
            elif readout == "membrane":
                pred = _first_argmax(new_vps[-1])
            else:
                pred = _first_argmax(cnt_new)
            streak_raw = torch.where(pred == gprev, gstreak + 1, 0)
            done = (streak_raw >= patience) & has_spike
            gprev_new = torch.where(has_spike, pred, -1)
            gstreak_new = torch.where(has_spike, streak_raw, 0)
            steps_new = steps + act.to(torch.int32)
            still = act & ~done & (steps_new < window_steps)

            def keep(new, old):
                return torch.where(act, new, old)

            s = keep(s_new, s)
            vs = [keep(nv, ov) for nv, ov in zip(new_vs, vs)]
            ens = [keep(ne, oe) for ne, oe in zip(new_ens, ens)]
            vps = [keep(nv, ov) for nv, ov in zip(new_vps, vps)]
            cnt, first = keep(cnt_new, cnt), keep(first_new, first)
            gprev, gstreak = keep(gprev_new, gprev), keep(gstreak_new, gstreak)
            vtr.append(vs[-1])
            adds.append(torch.where(act, adds_t, 0)[:, 0])
            lane_act = act[:, 0][None, :]
            tspk.append(torch.where(lane_act, tel_spk, 0))
            ten.append(torch.where(lane_act, tel_en, 0))
            steps, act = steps_new, still
        else:
            s, vs, ens, vps = s_new, new_vs, new_ens, new_vps
            cnt, first = cnt_new, first_new
            vtr.append(vs[-1])
            adds.append(adds_t[:, 0])
            tspk.append(tel_spk)
            ten.append(tel_en)
            steps = steps + 1
    tel = (torch.stack(tspk), torch.stack(ten), torch.stack(ttile))
    out = (cnt, torch.stack(vtr), first, torch.stack(adds), from_carrier(s),
           tuple(vs), tuple(e.to(torch.uint8) for e in ens), tuple(vps),
           tel, steps)
    if gated:
        return out + ((act.to(torch.int32), gprev, gstreak),)
    return out


# ---------------------------------------------------------------------------
# the CUDA launches
# ---------------------------------------------------------------------------

def _validate(pixels_u8, state_u32, weights, v_init, en_init, vp_init,
              counts_init, first_init, steps_init, gate_init, readout,
              block_b, streamed):
    dev = pixels_u8.device
    Bp, k0 = pixels_u8.shape
    L = len(weights)
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"the stack kernels run 1..{MAX_LAYERS} layers, "
                         f"got {L}")
    if readout not in READOUTS:
        raise ValueError(f"unknown readout {readout!r}")
    if streamed and not all(is_planes(w) for w in weights):
        raise ValueError("the streamed stack kernel takes the int8 planes "
                         "of pack_weights, not int16 codes")
    if not streamed and any(is_planes(w) for w in weights):
        raise ValueError("the resident stack kernel takes int16 codes, not "
                         "packed planes")
    if block_b != BLOCK_B or (streamed and Bp % block_b):
        raise ValueError(f"batch {Bp} / block_b {block_b}: block_b must be "
                         f"{BLOCK_B}" + (" and divide the padded batch"
                                         if streamed else ""))
    sizes = [k0] + [int(w.shape[1]) for w in weights]
    if streamed and any(n % LANE for n in sizes):
        raise ValueError(f"layer widths {sizes} are not padded to {LANE}")
    if not streamed and (k0 % K1_PIXEL_ALIGN or not 0 < k0 <= K1_MAX_PIXELS):
        raise ValueError(f"the resident stack kernel takes a multiple of "
                         f"{K1_PIXEL_ALIGN} pixels up to {K1_MAX_PIXELS}, "
                         f"got {k0}")
    check_operand(pixels_u8, "pixels_u8", torch.uint8, (Bp, k0), dev)
    check_operand(state_u32, "state_u32", torch.uint32, (Bp, k0), dev)
    for l, w in enumerate(weights):
        n = (Bp, sizes[l + 1])
        if is_planes(w):
            check_operand(w, f"weights[{l}]", torch.int8,
                          (2, sizes[l + 1], sizes[l]), dev)
        else:
            check_operand(w, f"weights[{l}]", torch.int16,
                          (sizes[l], sizes[l + 1]), dev)
        check_operand(v_init[l], f"v_init[{l}]", torch.int32, n, dev)
        check_operand(en_init[l], f"en_init[{l}]", torch.uint8, n, dev)
        check_operand(vp_init[l], f"vp_init[{l}]", torch.int32, n, dev)
    check_operand(counts_init, "counts_init", torch.int32, (Bp, sizes[-1]),
                  dev)
    check_operand(first_init, "first_init", torch.int32, (Bp, sizes[-1]),
                  dev)
    check_operand(steps_init, "steps_init", torch.int32, (Bp, 1), dev)
    if gate_init is not None:
        for name, g in zip(("active", "prev", "streak"), gate_init):
            check_operand(g, f"gate_init.{name}", torch.int32, (Bp, 1), dev)
    return sizes


def _launch(streamed, pixels_u8, state_u32, weights, v_init, en_init,
            vp_init, counts_init, first_init, steps_init, gate_init, sizes,
            *, chunk_steps, window_steps, decay_shift, v_threshold, v_rest,
            v_min, v_max, active_pruning, patience, readout, sparse_skip,
            block_b):
    dev = pixels_u8.device
    Bp, k0 = pixels_u8.shape
    L = len(weights)
    n_out = sizes[-1]
    nb = -(-Bp // block_b)
    gated = gate_init is not None
    if streamed:
        smem = stack_streamed_smem_bytes(sizes)
        if any(w.data_ptr() % 16 for w in weights):
            raise ValueError("the streamed kernel loads weight planes in "
                             "16-byte pieces: every plane tensor must be "
                             "16-byte aligned")
        if any(2 * k * n >= 1 << 31 for k, n in zip(sizes, sizes[1:])):
            raise ValueError(f"layer widths {sizes}: the streamed kernel "
                             f"addresses a layer's planes in 31 bits")
    else:
        smem = stack_smem_bytes(sizes, block_b)
        if any(t.data_ptr() % 16 for t in (pixels_u8, state_u32)):
            raise ValueError("the resident kernel reads pixel rows and PRNG "
                             "state in whole 4- and 16-byte pieces: "
                             "pixels_u8 and state_u32 must be 16-byte "
                             "aligned")
        if any(k * n >= 1 << 31 for k, n in zip(sizes, sizes[1:])):
            raise ValueError(f"layer widths {sizes}: the resident kernel "
                             f"addresses a layer's codes in 31 bits")
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"layer widths {sizes} need {smem} B of shared "
                         f"memory per block, over the {SMEM_LIMIT_BYTES} B "
                         f"a block may use")

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    st_out = empty((Bp, k0), torch.uint32)
    cnt_out = empty((Bp, n_out), torch.int32)
    first_out = empty((Bp, n_out), torch.int32)
    steps_out = empty((Bp, 1), torch.int32)
    gate_out = tuple(empty((Bp, 1), torch.int32) for _ in range(3)) \
        if gated else None
    vtr = empty((chunk_steps, Bp, n_out), torch.int32)
    adds = empty((chunk_steps, Bp), torch.int32)
    tspk = empty((chunk_steps, L, Bp), torch.int32)
    ten = empty((chunk_steps, L, Bp), torch.int32)
    ttile = empty((chunk_steps, L, nb), torch.int32)
    v_out = tuple(empty((Bp, n), torch.int32) for n in sizes[1:])
    en_out = tuple(empty((Bp, n), torch.uint8) for n in sizes[1:])
    vp_out = tuple(empty((Bp, n), torch.int32) for n in sizes[1:])

    g_in = gate_init if gated else (None, None, None)
    g_out = gate_out if gated else (None, None, None)
    ptrs = [pixels_u8, state_u32, counts_init, first_init, steps_init,
            *g_in, st_out, cnt_out, first_out, steps_out, *g_out,
            vtr, adds, tspk, ten, ttile]
    for l in range(L):
        ptrs += [weights[l], v_init[l], en_init[l], vp_init[l], v_out[l],
                 en_out[l], vp_out[l]]
    ints = [Bp, L, block_b, chunk_steps, window_steps, decay_shift,
            v_threshold, v_rest, v_min, v_max, int(active_pruning),
            int(gated), patience, READOUTS.index(readout), int(sparse_skip),
            smem, *sizes]
    if streamed:
        launch("fused_snn_streamed", ptrs, ints, dev)
        fused_snn_stack_streamed.launches += 1
    else:
        launch("fused_snn_stack", ptrs, ints, dev)
        fused_snn_stack.launches += 1
    out = (cnt_out, vtr, first_out, adds, st_out, v_out, en_out, vp_out,
           (tspk, ten, ttile), steps_out)
    return out + (gate_out,) if gated else out


def _run(streamed, pixels_u8, state_u32, weights, v_init, en_init, vp_init,
         counts_init, first_init, steps_init, gate_init=None, *,
         chunk_steps: int, window_steps: int, decay_shift: int,
         v_threshold: int, v_rest: int = 0, v_min: int = -(1 << 20),
         v_max: int = (1 << 20) - 1, active_pruning: bool = False,
         patience: int = 0, readout: str = "count", sparse_skip: bool = True,
         block_b: int = BLOCK_B):
    args = (pixels_u8, state_u32, weights, v_init, en_init, vp_init,
            counts_init, first_init, steps_init, gate_init)
    sizes = _validate(*args, readout, block_b, streamed)
    kw = dict(chunk_steps=chunk_steps, window_steps=window_steps,
              decay_shift=decay_shift, v_threshold=v_threshold, v_rest=v_rest,
              v_min=v_min, v_max=v_max, active_pruning=active_pruning,
              patience=patience, readout=readout, sparse_skip=sparse_skip,
              block_b=block_b)
    if pixels_u8.device.type == "cpu":
        return fused_snn_stack_plain(*args, **kw)
    if pixels_u8.device.type != "cuda":
        raise ValueError(f"no stack kernel for device {pixels_u8.device}")
    # the launcher's host work: outputs, alignment checks, the C call
    with span("fused_snn.launch"):
        return _launch(streamed, *args, sizes, **kw)


def fused_snn_stack(*operands, **options):
    """Run ``chunk_steps`` steps of the encode→LIF stack on operands at
    their real widths.

    Operands, in order (keywords and defaults as
    :func:`fused_snn_stack_plain`'s):

      pixels_u8/state_u32: (B, n_in) uint8 / uint32, any B, n_in a
        multiple of ``K1_PIXEL_ALIGN`` up to ``K1_MAX_PIXELS``, both
        16-byte aligned
      weights: per-layer (n_l, n_{l+1}) int16 codes
      v_init/en_init/vp_init: per-layer (B, n_{l+1}) int32 / uint8 / int32
      counts_init/first_init: (B, n_out) int32 (first sentinel = window)
      steps_init: (B, 1) int32 per-lane absolute step counter
      gate_init: None, or (active, prev, streak) each (B, 1) int32

    Outputs as :func:`fused_snn_stack_plain`.  CUDA tensors launch the
    resident kernel (one launch, counted in ``fused_snn_stack.launches``);
    CPU tensors run the plain version.
    """
    return _run(False, *operands, **options)


def fused_snn_stack_streamed(*operands, **options):
    """:func:`fused_snn_stack` on the weight-streaming kernel: the same
    operands, keywords and outputs, except that each layer's weights are
    the :func:`pack_weights` planes (2, n_out, n_in) int8 of its codes,
    placed once by the caller (``kernels.ops.stack_operands(...,
    streamed=True)`` packs codes; the engines place planes per weight
    version).  CUDA tensors launch it (one launch, counted in
    ``fused_snn_stack_streamed.launches``), CPU tensors run the plain
    version.  It holds stacks whose per-lane state does not fit shared
    memory (:func:`stack_streamed_smem_bytes`); planes must be 16-byte
    aligned."""
    return _run(True, *operands, **options)


fused_snn_stack.launches = 0
fused_snn_stack_streamed.launches = 0


# ---------------------------------------------------------------------------
# the model axis: one layer's partial contraction against a column shard
# ---------------------------------------------------------------------------

def pack_weights(w_i16: torch.Tensor) -> torch.Tensor:
    """Split 9-bit signed codes (n_in, n_out) into two int8 planes.

    ``w = 2*hi + lo`` with ``hi = w >> 1`` (arithmetic) and ``lo = w & 1``,
    exact for every code in [-256, 255].  Returns a new contiguous
    ``(2, n_out, n_in)`` int8 tensor, plane 0 = hi, plane 1 = lo, each
    column's K values contiguous: the ``.col`` B operand of the
    partial-contraction kernel's int8 ``mma.sync``.  The JAX package's
    ``pack_weights`` keeps ``(2, n_in, n_out)``; this layout is its
    transpose on purpose.
    """
    w = w_i16.to(torch.int16)
    hi = torch.bitwise_right_shift(w, 1)
    lo = w - 2 * hi                                   # in {0, 1}
    return torch.stack([hi, lo]).transpose(1, 2).to(torch.int8).contiguous()


def unpack_weights(w_packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_weights`: (2, n_out, n_in) int8 planes →
    (n_in, n_out) int16 codes ``2*hi + lo``."""
    w = w_packed.to(torch.int16)
    return (2 * w[0] + w[1]).transpose(0, 1)


def partial_contraction_plain(x_u8, en_u8, w_packed, *, n_valid=None,
                              sparse_skip: bool = True,
                              block_b: int = BLOCK_B):
    """The partial-contraction kernel's function in plain PyTorch.

    ``x_u8`` (B, n_in_pad) spikes (0 or 1), ``en_u8`` (B, n_out_pad) the
    shard's enables, ``w_packed`` (2, n_out_pad, n_in_pad) the shard's
    int8 planes (:func:`pack_weights`).  Returns ``(current (B, n_out_pad)
    int32, skipped (n_blocks,) int32)``.  With ``sparse_skip`` a 128×128
    tile pair is skipped, adding nothing, when its K-slice holds no spike
    in the 8-lane block or its output slice no enabled neuron; the second
    case zeroes raw currents the dense product would not, as the reference
    kernel's tile skip does.  Columns from ``ceil(n_valid / 8) * 8`` on
    are 0, as the kernel leaves them.  Σ W·S runs as a float64 product of
    the unpacked codes (exact) and wraps to int32.
    """
    Bp, n_out = en_u8.shape
    cur = _wrap32(torch.matmul(x_u8.to(torch.float64),
                               unpack_weights(w_packed).to(torch.float64))
                  .to(torch.int64))
    n_valid = n_out if n_valid is None else int(n_valid)
    cur[:, -(-n_valid // 8) * 8:] = 0          # past the columns K3 computes
    skipped = _block_tile_skips(x_u8 != 0, en_u8 != 0, block_b, sparse_skip)
    if sparse_skip:
        nb = Bp // block_b
        live = en_u8.reshape(nb, block_b, n_out // LANE, LANE).amax(
            dim=(1, 3)) != 0                              # (nb, n_tiles)
        live = live.repeat_interleave(block_b, 0).repeat_interleave(LANE, 1)
        cur = torch.where(live, cur, 0)
    return cur, skipped


def partial_contraction(x_u8, en_u8, w_packed, *, n_valid=None,
                        sparse_skip: bool = True, block_b: int = BLOCK_B):
    """One layer, one step: Σ W·S of the full spike vector against one
    output-column weight shard, on padded operands.

    ``x_u8`` (B, n_in) uint8 holding 0 or 1, ``en_u8`` (B, n_out) uint8,
    ``w_packed`` (2, n_out, n_in) int8 planes (:func:`pack_weights`), B a
    multiple of ``block_b`` (8) and both widths of ``LANE``; every operand
    contiguous and 16-byte aligned (a slice of a wider tensor is not
    contiguous: place each shard as its own tensor).  ``n_valid`` (default
    ``n_out``) is the shard's real column count, ``n_out - LANE < n_valid
    <= n_out``; contract: the planes' columns from ``n_valid`` on are zero
    (the padding ``serve.shard_weights`` places), so the kernel computes
    only ``ceil(n_valid / 8) * 8`` columns and writes 0 to the rest.
    Outputs as :func:`partial_contraction_plain`.  CUDA tensors launch the
    kernel (one launch, counted in ``partial_contraction.launches``); CPU
    tensors run the plain version.
    """
    dev = x_u8.device
    Bp, n_in = x_u8.shape
    n_out = en_u8.shape[1]
    n_valid = n_out if n_valid is None else int(n_valid)
    if block_b != BLOCK_B or Bp % block_b or n_in % LANE or n_out % LANE:
        raise ValueError(f"partial contraction takes a batch that is a "
                         f"multiple of {BLOCK_B} and widths that are "
                         f"multiples of {LANE}, got B={Bp}, n_in={n_in}, "
                         f"n_out={n_out}, block_b={block_b}")
    if not n_out - LANE < n_valid <= n_out:
        raise ValueError(f"n_valid={n_valid} must lie in "
                         f"({n_out - LANE}, {n_out}]")
    check_operand(x_u8, "x_u8", torch.uint8, (Bp, n_in), dev)
    check_operand(en_u8, "en_u8", torch.uint8, (Bp, n_out), dev)
    check_operand(w_packed, "w_packed", torch.int8, (2, n_out, n_in), dev)
    if dev.type == "cpu":
        return partial_contraction_plain(x_u8, en_u8, w_packed,
                                         n_valid=n_valid,
                                         sparse_skip=sparse_skip,
                                         block_b=block_b)
    if dev.type != "cuda":
        raise ValueError(f"no partial-contraction kernel for device {dev}")
    if any(t.data_ptr() % 16 for t in (x_u8, en_u8, w_packed)):
        raise ValueError("the partial-contraction kernel copies 16-byte "
                         "pieces: x_u8, en_u8 and w_packed must be 16-byte "
                         "aligned")
    cur = torch.empty((Bp, n_out), dtype=torch.int32, device=dev)
    skipped = torch.zeros((Bp // block_b,), dtype=torch.int32, device=dev)
    launch("partial_contraction", [x_u8, en_u8, w_packed, cur, skipped],
           [Bp, n_in, n_out, int(sparse_skip), n_valid], dev)
    partial_contraction.launches += 1
    return cur, skipped


partial_contraction.launches = 0
