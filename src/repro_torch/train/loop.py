"""Host-side training loop: stepping, checkpointing, straggler detection
(port of ``repro.train.loop``).

The loop is deliberately thin (all math lives in the train step) and owns
the operational concerns:

  * periodic async checkpointing (``checkpoint.manager``), resume-by-step;
  * straggler detection: per-step wall time EWMA + variance; a step slower
    than ``mean + k·σ`` is flagged;
  * simulated-failure hook for tests (``fail_at_step``) proving that a
    crash between steps resumes bit-identically from the last checkpoint.

A step's wall time ends when the card has finished it: the loop
synchronises the loss's device where the reference blocks on it.  Under a
process group every rank steps and checkpoints; only rank 0 calls the
metrics hook (the logging).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

__all__ = ["StragglerDetector", "TrainLoop"]


@dataclass
class StragglerDetector:
    """EWMA wall-time monitor; flags steps slower than mean + k·std."""

    alpha: float = 0.1
    k_sigma: float = 3.0
    warmup: int = 5
    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self._n += 1
        if self._n <= self.warmup:
            # prime the statistics without flagging (first steps warm up)
            self._mean = dt if self._n == 1 else \
                (1 - self.alpha) * self._mean + self.alpha * dt
            return False
        slow = dt > self._mean + self.k_sigma * max(self._var ** 0.5,
                                                    0.05 * self._mean)
        d = dt - self._mean
        self._mean += self.alpha * d
        self._var = (1 - self.alpha) * (self._var + self.alpha * d * d)
        if slow:
            self.flagged.append((step, dt, self._mean))
        return slow


def _block_until_ready(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _logs() -> bool:
    """Whether this process logs: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


class TrainLoop:
    def __init__(self, train_step, state, *, ckpt_manager=None,
                 ckpt_every: int = 100, detector: StragglerDetector | None = None,
                 metrics_hook=None):
        self.train_step = train_step
        self.state = state
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.detector = detector or StragglerDetector()
        self.metrics_hook = metrics_hook
        self.history: list[dict] = []

    def run(self, batches, num_steps: int, *, fail_at_step: int | None = None):
        """Run up to ``num_steps`` steps; returns final state.

        ``fail_at_step`` raises RuntimeError *after* that step's checkpoint
        window — the failure-injection hook used by the restart tests.
        """
        it = iter(batches)
        for i in range(num_steps):
            batch = next(it)
            t0 = time.perf_counter()
            self.state, metrics = self.train_step(self.state, batch)
            _block_until_ready(metrics["loss"])
            dt = time.perf_counter() - t0

            step = int(self.state.step)
            slow = self.detector.observe(step, dt)
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step=step, wall_s=dt, straggler=slow)
            self.history.append(rec)
            if self.metrics_hook and _logs():
                self.metrics_hook(rec)

            if self.ckpt is not None and step % self.ckpt_every == 0:
                self.ckpt.save(step, self.state)
            if fail_at_step is not None and step >= fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
        if self.ckpt is not None:
            self.ckpt.save(int(self.state.step), self.state)
            self.ckpt.wait()
        return self.state
