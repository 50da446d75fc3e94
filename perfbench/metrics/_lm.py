"""Readers of an LM training run's record (an entry that writes
``tokens``): the window's work is the entry's ``work`` (model flops and
the optimizer's bytes, from the configuration's ``work_<name>.py``).
Every reader finds nothing in a record without ``tokens``."""

from perfbench import work_lm


def _lm(rec) -> bool:
    return bool(rec.get("tokens")) and bool(rec.get("window_s"))


def tokens_per_s(rec):
    """Every token of every step queued in the window, over the host-clock
    seconds until the last step's update was done on the card."""
    if not _lm(rec):
        return None
    return rec["tokens"] / rec["window_s"]


def mfu_pct(rec):
    """The window's model flops over its seconds at the bf16 dense peak."""
    if not _lm(rec) or not rec.get("work", {}).get("flops"):
        return None
    return 100.0 * rec["work"]["flops"] / (rec["window_s"]
                                           * work_lm.PEAK_BF16_FLOPS)


def _trace(rec):
    tr = rec.get("trace")
    return tr if _lm(rec) and tr is not None and tr["window_s"] > 0 \
        else None


def roofline_pct(rec):
    """The least time of the window's work over the device time of every
    compute kernel in it (the union of their intervals)."""
    tr, w = _trace(rec), rec.get("work")
    if tr is None or not w or tr["kernel_s"] <= 0:
        return None
    return 100.0 * work_lm.least_time(w["flops"], w["bytes"])[0] \
        / tr["kernel_s"]


def idle_pct(rec):
    """The share of the traced window no device interval covers."""
    tr = _trace(rec)
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def gemm_busy_pct(rec):
    """The share of the device's busy time inside matrix-multiply kernels
    (the union of their intervals)."""
    tr = _trace(rec)
    if tr is None or "gemm_s" not in tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * tr["gemm_s"] / tr["busy_s"]
