"""The whole step's share of the chip's int8 peak in ``snn784-batch``:
the model's operations in the window (``work.py``: 2 · Σ n_in · n_out a
lane-step executed) over the window's seconds at 1,979 T int8 op/s."""

from perfbench.metrics._model import mfu_pct


def read(rec):
    return mfu_pct(rec)
