"""The share of the device's busy time spent in matrix-multiply kernels
(cuBLAS's and CUTLASS's, by the trace's names) in an LM training cell;
the rest is the optimizer, the casts, the norms, the SSD's elementwise
work and the copies."""

from perfbench.metrics._lm import gemm_busy_pct


def read(rec):
    return gemm_busy_pct(rec)
