"""The model's work, whatever implements it: operations, bytes and the
least time one NVIDIA H100 could take for them.

Operations: one multiply-add of the dense spike × weight-code contraction
per synapse and executed lane-step, ``2 · Σ_l n_l · n_{l+1}`` int8
operations, counted against the int8 dense peak.  Bytes: each input byte
read once and each output byte written once, at unpadded shapes: pixels,
the xorshift lanes in and out, the weight codes (int16, the
configuration's 9-bit codes as stored) once per launch, and the
readouts.  The least time is the larger of
operations over the peak and bytes over the bandwidth.
"""

from __future__ import annotations

__all__ = ["PEAK_INT8_OPS", "HBM_BYTES_PER_S", "ops_per_lane_step",
           "weight_bytes", "batch_call_bytes", "least_time"]

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


def ops_per_lane_step(sizes) -> int:
    """int8 operations of one lane's step through the whole stack."""
    return 2 * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def weight_bytes(sizes) -> int:
    """The weight codes, two bytes each."""
    return 2 * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def batch_call_bytes(sizes, batch: int) -> int:
    """One whole-window call on ``batch`` images from fresh neuron state:
    pixels and xorshift lanes read, the weights read; the final lanes,
    spike counts, first-spike times, the last layer's final membranes
    (4 B each) and the prediction (4 B) written."""
    n_in, n_out = sizes[0], sizes[-1]
    return batch * (n_in + 4 * n_in + 4 * n_in + 12 * n_out + 4) \
        + weight_bytes(sizes)


def least_time(ops: float, nbytes: float) -> tuple[float, str]:
    """The least seconds the chip could take, and which bound sets it."""
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
