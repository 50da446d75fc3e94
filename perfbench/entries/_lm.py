"""Set-up shared by the LM entries: the weights a run draws from its seed,
the token pool, the configuration's reference and work modules, and the
program's ``ArchConfig`` and model for a configuration file.

A configuration names its plain reference (``reference``:
``reference/<name>.py``, whose ``leaves(cfg)`` lists every parameter in
the program's names with its shape and draw) and its work counter
(``work``: ``work_<name>.py``, whose ``step_work(cfg, batch, seq)`` counts
a training step), and the program's architecture (``arch``, from the
port's registry, with ``program`` overriding fields of it).  The
configuration's top-level keys are the published ones; what only a
change to the program could undo is listed in ``assumed.as_run``, and
the reference and the work count read the configuration as it is run
(:func:`as_run`).
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import re

import numpy as np
import torch

from perfbench.traffic import tokens as tok

__all__ = ["as_run", "reference", "work", "make_weights", "make_pool",
           "program_config", "program_model", "settings", "GEMM_KERNEL"]

# the device's matrix-multiply kernels by name: cuBLAS's (``nvjet_*``,
# ``sm80_xmma_gemm_*``, its split-K reduction) and CUTLASS's
GEMM_KERNEL = re.compile(r"gemm|nvjet|xmma|cutlass|wgmma|splitKreduce",
                         re.IGNORECASE)


def as_run(cfg: dict) -> dict:
    """The configuration as the program runs it: the published keys with
    ``assumed.as_run``'s departures laid over them."""
    return dict(cfg, **cfg.get("assumed", {}).get("as_run", {}))


def reference(cfg: dict):
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")


def work(cfg: dict):
    return importlib.import_module(f"perfbench.work_{cfg['work']}")


def _dt_bias(u: torch.Tensor, floor: float) -> torch.Tensor:
    """dt = exp(u) floored, stored as its inverse softplus."""
    dt = torch.exp(u).clamp(min=floor)
    return dt + torch.log(-torch.expm1(-dt))


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter of the configuration (``reference(cfg).leaves``),
    float32 on ``device``, from the seed: one normal and one uniform draw
    of a ``torch.Generator`` on the device for all leaves together, each
    leaf a view of its draw, scaled or transformed in place."""
    cfg = as_run(cfg)
    spec = reference(cfg).leaves(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    sizes = {kind: sum(math.prod(s) for _, s, d in spec if d[0] == kind)
             for kind in ("normal", "uniform")}
    flat = {"normal": torch.randn(sizes["normal"], generator=g,
                                  device=device),
            "uniform": torch.rand(sizes["uniform"], generator=g,
                                  device=device)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, draw in spec:
        n = math.prod(shape)
        kind = draw[0]
        if kind == "const":
            out[name] = torch.full(shape, float(draw[1]), device=device)
            continue
        t = flat[kind][at[kind]:at[kind] + n].view(shape)
        at[kind] += n
        if kind == "normal":
            t.mul_(float(draw[1]))
        else:
            lo, hi, transform = draw[1:]
            t.mul_(hi - lo).add_(lo)
            if transform == "log":
                t.log_()
            elif transform == "dt_bias":
                t.copy_(_dt_bias(t, float(cfg["dt_init_floor"])))
            else:
                raise ValueError(f"unknown transform {transform!r}")
        out[name] = t
    return out


def make_pool(cfg: dict, traffic: dict, seed: int) -> np.ndarray:
    """The run's token batches, ``(pool_batches, batch, seq_len + 1)``."""
    return tok.make_pool(traffic, int(cfg["vocab_size"]), seed)


def program_config(cfg: dict):
    """The port's ``ArchConfig`` for the configuration: ``arch`` from its
    registry, with the fields in ``program`` replaced (none for a
    configuration run as registered)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(cfg["arch"]),
                               **cfg.get("program", {}))


def program_model(arch, weights: dict):
    """The port's ``Transformer`` for ``arch`` holding ``weights`` (the
    tensors themselves): its uninitialised skeleton built on the weights'
    device (on the meta device it takes seconds), every parameter then
    assigned, names and shapes checked."""
    from repro_torch.models.transformer import Transformer
    with torch.device(next(iter(weights.values())).device):
        model = Transformer(arch, generator=None)
    model.load_state_dict(weights, strict=True, assign=True)
    return model


def settings(cfg: dict, microbatches: int):
    """The port's ``TrainSettings`` for the configuration's optimizer."""
    from repro_torch.train.step import TrainSettings
    o = cfg["optimizer"]
    return TrainSettings(
        learning_rate=float(o["learning_rate"]),
        warmup_steps=int(o["warmup_steps"]),
        total_steps=int(o["total_steps"]),
        weight_decay=float(o["weight_decay"]),
        clip_norm=float(o["clip_norm"]), num_microbatches=microbatches)
