"""Shares of a peak and idle shares from a run's record, for the readers
of every cell: the window's work is what the entry wrote into the record
(``work``: the model's operations and bytes, from ``perfbench.work``)."""

from perfbench import work


def images_per_s(rec):
    """Every image of every call queued in the window, over the host-clock
    seconds until the last call's predictions reached the host."""
    if not rec.get("window_s") or not rec.get("images"):
        return None
    return rec["images"] / rec["window_s"]


def wrapper_idle_ms(rec):
    """Device idle milliseconds a call while the host is inside
    ``snn_apply_int``: the trace's idle gaps under the benchmark's span."""
    tr = rec.get("trace")
    if tr is None or not rec.get("launches"):
        return None
    idle = dict(tr["idle_gaps"]).get("snn_apply_int", 0.0)
    return idle * 1e3 / rec["launches"]


def roofline_pct(rec):
    """The least time of the window's work over the device time of every
    compute kernel in it (the union of their intervals), in percent."""
    tr, w = rec.get("trace"), rec.get("work")
    if tr is None or not w or tr["kernel_s"] <= 0:
        return None
    return 100.0 * work.least_time(w["ops"], w["bytes"])[0] / tr["kernel_s"]


def mfu_pct(rec):
    """The window's operations over its seconds at the int8 peak."""
    w = rec.get("work")
    if not w or not w["ops"] or not rec.get("window_s"):
        return None
    return 100.0 * w["ops"] / (rec["window_s"] * work.PEAK_INT8_OPS)


def idle_pct(rec):
    """The share of the traced window no device interval covers."""
    tr = rec.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
