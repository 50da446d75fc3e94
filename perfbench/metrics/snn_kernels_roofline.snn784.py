"""The compute kernels' share of their roofline in ``snn784-batch``: the
least time the model's work of the window needs on one H100
(``work.py``: the larger of operations over the int8 peak and bytes over
HBM bandwidth) over the device time of every compute kernel in the
window, whatever its name (copies and fills excluded)."""

from perfbench.metrics._model import roofline_pct


def read(rec):
    return roofline_pct(rec)
