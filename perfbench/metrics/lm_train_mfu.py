"""The whole training step's share of the chip's bf16 peak: the window's
model flops (the configuration's ``work_<name>.py``: 6 × matrix
parameters × tokens and the SSD's products, no recomputation) over the
window's seconds at 989 T flop/s."""

from perfbench.metrics._lm import mfu_pct


def read(rec):
    return mfu_pct(rec)
