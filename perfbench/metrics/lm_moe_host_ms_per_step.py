"""Host milliseconds a training step inside the program's MoE spans
(``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine`` of
``repro_torch.core.spans``: Python and launches), over the steps the
traced window recorded, less the blocking count read (``moe.count_read``,
inside ``moe.dispatch``): that read waits for the device to finish all
the work queued before it, earlier layers' kernels included, and is not
the MoE layer's host work.  Nothing where the run recorded no MoE span."""

LAYER = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def read(rec):
    prog = rec.get("program")
    if not prog or not prog.get("steps"):
        return None
    tot = prog["totals"]
    moe = [tot[n][0] for n in LAYER if n in tot]
    if not moe:
        return None
    wait = tot.get("moe.count_read", (0.0, 0))[0]
    return 1e3 * (sum(moe) - wait) / prog["steps"]
