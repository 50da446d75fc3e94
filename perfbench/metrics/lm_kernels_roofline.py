"""The compute kernels' share of their roofline in an LM training cell:
the least time of the window's work on one H100 (``work_lm.py``: the
larger of model flops over the bf16 peak and the optimizer's bytes over
HBM bandwidth) over the device time of every compute kernel in the
window, whatever its name (copies and fills excluded)."""

from perfbench.metrics._lm import roofline_pct


def read(rec):
    return roofline_pct(rec)
