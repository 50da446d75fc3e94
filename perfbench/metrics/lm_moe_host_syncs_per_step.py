"""Blocking device-to-host reads in the program's MoE dispatch a training
step (the counter ``moe.host_syncs`` of ``repro_torch.core.spans``, over
the steps the traced window recorded; a remat recompute reads again).
Nothing where the run recorded no MoE layer: an SNN cell, an LM without
experts, a program without the counter."""


def read(rec):
    prog = rec.get("program")
    if not prog or not prog.get("steps"):
        return None
    n = prog["counters"].get("moe.host_syncs")
    return None if n is None else n / prog["steps"]
