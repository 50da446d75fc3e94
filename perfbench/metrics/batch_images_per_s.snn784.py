"""Images a second the whole-window batch path classified in
``snn784-batch``: every image of every call queued in the window, over
the host-clock seconds until the last call's predictions reached the
host."""

from perfbench.metrics._model import images_per_s


def read(rec):
    return images_per_s(rec)
