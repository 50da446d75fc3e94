"""Device idle milliseconds a call in ``snn784-batch`` while the host is
inside ``snn_apply_int``: the device waits there for the call's host
work (the weight-code validation and its syncs, operand set-up, the
launch), read from the trace's idle gaps by the benchmark's span around
the call."""

from perfbench.metrics._model import wrapper_idle_ms


def read(rec):
    return wrapper_idle_ms(rec)
