"""Input pipeline: host-sharded batching and prefetch (port of
``repro.data.pipeline``, numpy only).

The generators (``digits.py``) do the heavy lifting; this module owns the
distribution concerns:

  * global batch → per-host striping (``host_shard``),
  * a background-thread prefetcher that overlaps host data generation
    with device compute (``prefetch``),
  * the shuffled epoch iterator over the digit dataset
    (``digit_batches``).

The reference's ``make_global_array`` assembles a ``NamedSharding`` array
and has no PyTorch counterpart: a torch caller places its shard with
``torch.from_numpy(...).to(device)``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["host_shard", "prefetch", "digit_batches"]


def host_shard(array: np.ndarray, host_id: int, num_hosts: int) -> np.ndarray:
    """Contiguous stripe of the leading (batch) axis for this host."""
    n = array.shape[0]
    if n % num_hosts:
        raise ValueError(f"batch {n} does not split over {num_hosts} hosts")
    per = n // num_hosts
    return array[host_id * per:(host_id + 1) * per]


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch: overlaps batch generation with compute."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        yield item


def digit_batches(x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0,
                  epochs: int | None = None) -> Iterator[dict]:
    """Shuffled epoch iterator over the digit dataset."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    epoch = 0
    while epochs is None or epoch < epochs:
        perm = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            idx = perm[i:i + batch]
            yield {"pixels": x[idx], "labels": y[idx]}
        epoch += 1
