"""Write-ahead replicated accounting ledger (port of ``repro.serve.ledger``).

The never-silent contract — ``results ∪ shed ∪ faulted`` exactly
partitions the submitted request ids — lives in one Python process; a
crash of that process would take the partition proof with it.  This
module makes the accounting crash-proof:

* every host appends one JSON line per accounting event to its own
  **append-only JSONL file** (the coordinator logs ``submit``/``shed``/
  ``fault``/``result`` events, every worker *replicates* its own
  ``result`` lines locally before shipping them over RPC — so a result
  computed but never acknowledged still survives a coordinator crash);
* writes are **write-ahead**: the ``submit`` line (with the request's
  pixels) lands on disk before the request is routed, so a restarted
  coordinator can re-run any window that was in flight — a window is a
  pure function of ``(seed, request_id, pixels)``, so the re-run is
  bit-identical to the never-crashed run;
* :func:`read_ledger` tolerates a **torn final line** (the crash arrived
  mid-``write``): the trailing partial record is dropped, while a
  corrupt line anywhere *else* is a real integrity failure and raises;
  reopening a ledger for appending (:class:`Ledger`) truncates such a
  torn tail first, so a recovered process never welds its first record
  onto the previous incarnation's partial line;
* :func:`recover_accounting` folds any set of ledger files back into
  the three maps plus the ordered outstanding-submission list, with
  **exactly-once** semantics: the first terminal record per request id
  wins, and a ``result`` always beats a ``fault``/``shed`` for the same
  id (a worker may have replicated a result the coordinator never saw
  before declaring the request lost — the computed answer is the truth).
"""

from __future__ import annotations

import json
import os

__all__ = ["Ledger", "read_ledger", "recover_accounting",
           "LedgerCorruptError"]


class LedgerCorruptError(ValueError):
    """A ledger line that is not a torn tail failed to parse."""


class Ledger:
    """Append-only JSONL writer with per-record durability.

    Each :meth:`append` writes one compact JSON line, flushes, and
    fsyncs — a record either fully precedes a crash or is the single
    torn tail the reader drops.  Append mode keeps restarts cheap: a
    recovered coordinator reopens the same file and keeps appending —
    but **reopen repairs first**: if the previous incarnation crashed
    mid-append, the file ends in a partial line, and appending straight
    onto it would merge two records into one corrupt line (turning the
    recoverable torn tail into a mid-file integrity failure).  So
    :meth:`__init__` truncates an unterminated final line before the
    first append — exactly the record :func:`read_ledger` would have
    dropped anyway.
    """

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._repair_torn_tail(path)
        self._f = open(path, "a", encoding="utf-8")

    @staticmethod
    def _repair_torn_tail(path: str) -> None:
        """Truncate a partial (newline-less) final line left by a crash.

        Every append is ``<json>\\n`` with no interior newlines, so a
        file not ending in ``\\n`` ends in a torn record; cutting back to
        the last newline restores the append-only invariant for the new
        incarnation without touching any complete record.
        """
        try:
            f = open(path, "r+b")
        except FileNotFoundError:
            return
        with f:
            data = f.read()
            if not data or data.endswith(b"\n"):
                return
            f.truncate(data.rfind(b"\n") + 1)
            f.flush()
            os.fsync(f.fileno())

    def append(self, record: dict) -> None:
        self._f.write(json.dumps(record, separators=(",", ":")) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_ledger(path: str) -> list[dict]:
    """Parse one JSONL ledger file, dropping a torn final line.

    A crash mid-append leaves at most one partial record, and only at
    the tail (appends are sequential and fsynced); a malformed line
    *followed by valid lines* cannot come from a torn write and raises
    :class:`LedgerCorruptError` instead of being skipped silently.
    """
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        lines = f.read().split("\n")
    records: list[dict] = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError as e:
            if all(not later.strip() for later in lines[i + 1:]):
                break  # torn tail: the crash interrupted this append
            raise LedgerCorruptError(
                f"{path}:{i + 1}: corrupt ledger line is not the torn "
                f"tail ({e}) — the file was modified outside the "
                f"append-only protocol") from e
    return records


def recover_accounting(paths: list[str]) -> dict:
    """Reconstruct the accounting state from a set of ledger files.

    Returns ``{"submitted": [(rid, record), ...] in submit order,
    "results": {rid: record}, "shed": {rid: record},
    "faulted": {rid: record}, "outstanding": [rid, ...],
    "rollouts": [record, ...] in append order}`` — ``rollout`` records
    carry the wire-encoded params of every completed weight rollout, so
    a recovered coordinator can replay the fleet up to its pre-crash
    weight version before re-running the outstanding ids.

    Exactly-once: per request id the first terminal record wins within
    its class, and ``result`` records (from any replica) take precedence
    over ``shed``/``fault`` — a coordinator that faulted a request whose
    worker had already durably computed (and replicated) the answer must
    land it in ``results``, never in both maps.  Ids submitted with no
    terminal record anywhere are ``outstanding`` — the restarted
    coordinator re-runs them from their write-ahead pixels.
    """
    submits: dict[int, dict] = {}
    order: list[int] = []
    results: dict[int, dict] = {}
    shed: dict[int, dict] = {}
    faulted: dict[int, dict] = {}
    rollouts: list[dict] = []
    for path in paths:
        for rec in read_ledger(path):
            kind = rec.get("kind")
            rid = rec.get("rid")
            if kind == "submit" and rid not in submits:
                submits[rid] = rec
                order.append(rid)
            elif kind == "result" and rid not in results:
                results[rid] = rec
            elif kind == "shed" and rid not in shed:
                shed[rid] = rec
            elif kind == "fault" and rid not in faulted:
                faulted[rid] = rec
            elif kind == "rollout":
                rollouts.append(rec)
    # results win over the other terminal classes (see docstring)
    for rid in results:
        shed.pop(rid, None)
        faulted.pop(rid, None)
    # between shed and fault, first writer wins is unknowable across
    # files — prefer shed (an admission decision made before any fault)
    for rid in shed:
        faulted.pop(rid, None)
    terminal = set(results) | set(shed) | set(faulted)
    outstanding = [rid for rid in order if rid not in terminal]
    return {"submitted": [(rid, submits[rid]) for rid in order],
            "results": results, "shed": shed, "faulted": faulted,
            "outstanding": outstanding, "rollouts": rollouts}
