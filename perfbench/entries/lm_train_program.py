"""The LM training entry (``lm_train``) with the program's own spans and
counters, and a check of its own.

``run`` is ``lm_train``'s, and in a traced run it holds the program's
recorder (``repro_torch.core.spans.recording``) open over the window's
steps, inside the profiled window, so that the record's ``program``
holds the recorder's ``totals`` (name -> [seconds, calls]), its
``counters`` and the ``steps`` they cover.  An untraced run is
``lm_train``'s own, the recorder off.

``check`` follows the checked steps with ``lm_train``'s reference and
compares, in parts per million: the worst step's gap of the global
gradient norm before the clip; by the worst leaf, the gap of the norms of
the first gradient and of the change over the steps (``lm_train``'s
numbers); and by the median leaf, the same two gaps.  A leaf's gap is
taken against the larger of its reference norm and the median leaf's;
leaves whose reference gradient is nought leave the change.  The worst
leaf moves by a seed's few sensitive leaves (an expert near the top-k's
edge, a lightly loaded one) and finds a leaf left out; the median leaf
moves with the rounding every product makes, steadily over seeds, and
finds products computed below the configuration's precision.  The loss
is not compared: its gap from rounding is a seed's first-order response
and moves as much from seed to seed as from bf16 to float8.

Traffic keys: ``lm_train``'s.
"""

from __future__ import annotations

import contextlib
import statistics
import time

from perfbench import harness
from perfbench.entries import lm_train


def run(ctx: harness.Context) -> None:
    if not ctx.trace:
        lm_train.run(ctx)
        return
    from repro_torch.core import spans
    profiled, held = lm_train.profiled, {}

    @contextlib.contextmanager
    def recorded(on):
        with profiled(on) as prof, spans.recording() as rec:
            held["record"] = rec
            yield prof

    lm_train.profiled = recorded      # the window's own context
    try:
        lm_train.run(ctx)
    finally:
        lm_train.profiled = profiled
    rec = held["record"]
    ctx.record["program"] = {
        "steps": ctx.record["steps"],
        "totals": {k: list(v) for k, v in rec.totals.items()},
        "counters": dict(rec.counters)}


def _median_leaf(got: dict, want: dict, names) -> int:
    """The median leaf's gap of norms, each against the larger of its
    reference norm and the median leaf's, in parts per million."""
    floor = statistics.median(want[n] for n in names)
    return lm_train._ppm(statistics.median(
        abs(got[n] - want[n]) / max(want[n], floor) for n in names))


def compare(got: dict, want: dict, limits: dict) -> dict:
    """The compared numbers of the checked steps, each beside its limit
    (see the module docstring)."""
    fg = want["first_grad"]
    med = statistics.median(fg.values())
    moved = [n for n in fg if fg[n] >= lm_train.NOUGHT * med]
    values = {
        "grad_norm_gap_ppm": lm_train._ppm(max(
            abs(g - w) / abs(w)
            for g, w in zip(got["grad_norm"], want["grad_norm"]))),
        "first_grad_leaf_gap_ppm": lm_train._worst_leaf(
            got["first_grad"], fg, list(fg)),
        "change_leaf_gap_ppm": lm_train._worst_leaf(
            got["change"], want["change"], moved),
        "first_grad_median_leaf_gap_ppm": _median_leaf(
            got["first_grad"], fg, list(fg)),
        "change_median_leaf_gap_ppm": _median_leaf(
            got["change"], want["change"], moved)}
    return dict(harness.check(k, v, int(limits[k]))
                for k, v in values.items())


def check(ctx: harness.Context, control: bool = False):
    """The checked steps against the reference, each number against the
    configuration's ``limits``; at least one window step.  ``control``
    judges each of ``lm_train.CONTROLS`` in the program's place instead,
    its numbers named ``<control>.<number>``.  Returns ``(checks,
    attempted, failed)``."""
    a, limits = ctx.answers, ctx.cfg["limits"]
    if "reference" not in a:
        t0 = time.perf_counter()
        a["reference"] = lm_train._reference(ctx)
        ctx.record["reference_s"] = time.perf_counter() - t0
    want = a["reference"]
    checked = int(ctx.traffic["checked_steps"])
    if control:
        checks = {}
        for name, kw in lm_train.CONTROLS.items():
            checks.update({f"{name}.{k}": c for k, c in compare(
                lm_train._reference(ctx, **kw), want, limits).items()})
        return checks, checked, 0
    checks = dict([harness.check("steps", a["steps"], 1, at_least=True)])
    checks.update(compare(a, want, limits))
    failed = 0 if all(c["ok"] for c in checks.values()) else checked
    return checks, checked + a["steps"], failed
