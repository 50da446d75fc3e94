"""The device's idle share in an LM training cell: the part of the traced
window that the union of its kernels, copies and fills leaves
uncovered."""

from perfbench.metrics._lm import idle_pct


def read(rec):
    return idle_pct(rec)
