"""Zero-drain weight rollout: version-tagged weight planes (port of
``repro.serve.rollout``).

Every weight tuple is version-tagged in a :class:`WeightBank`; each lane
records the version it was admitted under, finishes its window on it, and
new admissions bind the bank's current version.  While several versions
have live lanes the engine runs one gated chunk per version — each freezes
the other versions' lanes, untouched bit for bit — and
:func:`merge_version_chunks` takes every lane from its own version's run.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.telemetry import ChunkTelemetry

__all__ = ["RolloutEvent", "RolloutInProgressError", "WeightBank",
           "merge_version_chunks", "select_lanes"]


class RolloutInProgressError(RuntimeError):
    """``begin(exclusive=True)`` found a rollout still draining."""

    def __init__(self, versions: tuple):
        self.versions = tuple(versions)
        super().__init__(
            "rollout already in progress: live versions "
            f"{self.versions} (pass exclusive=False to stack)")


@dataclass(frozen=True)
class RolloutEvent:
    """One transition of the rollout state machine."""

    kind: str          # "begin" | "complete" | "restore" | "abort"
    version: int
    retired: tuple = ()


class WeightBank:
    """Version-tagged store of device-placed weight tuples."""

    def __init__(self, weights: tuple, version: int = 0):
        self._planes: dict[int, tuple] = {version: weights}
        self.current = version
        self.history: list[RolloutEvent] = []

    @property
    def versions(self) -> tuple[int, ...]:
        return tuple(sorted(self._planes))

    @property
    def rolling(self) -> bool:
        return len(self._planes) > 1

    def weights(self, version: int) -> tuple:
        return self._planes[version]

    def begin(self, weights: tuple, *, exclusive: bool = False) -> int:
        """Publish a new version (stacks on a draining rollout unless
        ``exclusive``); returns it."""
        if exclusive and self.rolling:
            raise RolloutInProgressError(self.versions)
        v = self.current + 1
        self._planes[v] = weights
        self.current = v
        self.history.append(RolloutEvent(kind="begin", version=v))
        return v

    def ensure(self, version: int, weights: tuple) -> bool:
        """Re-register an old version (the failover path); True if it had
        to be installed."""
        if version in self._planes:
            return False
        if version > self.current:
            raise ValueError(
                f"cannot restore version {version} newer than current "
                f"{self.current}")
        self._planes[version] = weights
        self.history.append(RolloutEvent(kind="restore", version=version))
        return True

    def abort(self) -> tuple[int, ...]:
        """Drop every non-current version unconditionally."""
        dead = tuple(v for v in self._planes if v != self.current)
        for v in dead:
            del self._planes[v]
        if dead:
            self.history.append(RolloutEvent(
                kind="abort", version=self.current, retired=dead))
        return dead

    def gc(self, live_versions: set[int]) -> tuple[int, ...]:
        """Drop versions no occupied lane references (never the current);
        dropping the last old one completes the rollout."""
        dead = tuple(v for v in self._planes
                     if v != self.current and v not in live_versions)
        for v in dead:
            del self._planes[v]
        if dead and not self.rolling:
            self.history.append(RolloutEvent(
                kind="complete", version=self.current, retired=dead))
        return dead


def select_lanes(mask: torch.Tensor, new, old):
    """Per-lane ``where`` over a tensor or a tuple of tensors.

    ``mask`` is (B,) bool; lane ``i`` takes ``new`` where ``mask[i]``.
    uint32 leaves are selected through their int32 view.
    """
    if isinstance(new, tuple):
        return tuple(select_lanes(mask, n, o) for n, o in zip(new, old))
    if new.dtype == torch.uint32:
        return select_lanes(mask, new.view(torch.int32),
                            old.view(torch.int32)).view(torch.uint32)
    m = mask.reshape(mask.shape + (1,) * (new.ndim - 1))
    return torch.where(m, new, old)


def merge_version_chunks(outputs):
    """Merge per-version gated chunk runs into one lane tile + telemetry.

    ``outputs`` is a list of ``(mask, lanes, telemetry)``, one per live
    version.  Each lane takes every leaf from its own version's run; lanes
    owned by no mask fall through to the first run, where they were frozen.
    Telemetry sums: a frozen lane reports zero activity rows.
    """
    _, merged, tel0 = outputs[0]
    for mask, lanes, _ in outputs[1:]:
        m = torch.as_tensor(mask, device=tel0.n_spk.device)
        merged = type(merged)(*[select_lanes(m, n, o)
                                for n, o in zip(lanes, merged)])
    tel = ChunkTelemetry(
        n_spk=sum((t.n_spk for _, _, t in outputs[1:]), tel0.n_spk),
        n_en=sum((t.n_en for _, _, t in outputs[1:]), tel0.n_en),
        tiles_skipped=sum((t.tiles_skipped for _, _, t in outputs[1:]),
                          tel0.tiles_skipped))
    return merged, tel
