"""The device's idle share in ``snn784-batch``: the part of the traced
window that the union of its kernels, copies and fills leaves uncovered."""

from perfbench.metrics._model import idle_pct


def read(rec):
    return idle_pct(rec)
