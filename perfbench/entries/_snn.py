"""Set-up shared by the SNN entries: the weights and the digit pool a run
makes from its seed, and the program's ``SNNConfig`` for a configuration
file.  An entry of another kind of model brings its own."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import HERE
from perfbench.traffic.digits import render_pool

__all__ = ["relabelling", "make_codes", "make_pool", "program_config"]


def relabelling(cfg: dict, seed: int) -> list[np.ndarray]:
    """The run's order of the input pixels and of every hidden layer's
    neurons, drawn from its seed (the classes keep theirs: the readout
    breaks ties by class index)."""
    rng = np.random.default_rng([int(seed), 1])
    return [rng.permutation(n) for n in cfg["layer_sizes"][:-1]]


def make_codes(cfg: dict, seed: int, device) -> list[torch.Tensor]:
    """The layers' int16 weight codes for a run: one draw a layer, from a
    ``torch.Generator`` on the device seeded with the configuration's
    ``base_seed``, rounded and clipped to its code range; then its inputs
    and hidden neurons relabelled as :func:`relabelling` orders them (a
    layer's rows by its inputs' order, its columns by its neurons').  With
    the pool's pixels relabelled alike (:func:`make_pool`), every seed runs
    the same network on the same images, its answers drawn anew by the
    seed's Poisson streams and request order."""
    init = cfg["weights"]
    lo, hi = cfg["code_range"]
    sizes = cfg["layer_sizes"]
    orders = [torch.from_numpy(o).to(device)
              for o in relabelling(cfg, seed)]
    g = torch.Generator(device=device)
    g.manual_seed(int(init["base_seed"]))
    codes = []
    for l, (i, o) in enumerate(zip(sizes[:-1], sizes[1:])):
        if init["init"] == "normal":
            std = float(init["std"])
        elif init["init"] == "normal_fan_in":
            std = float(init["scale"]) / float(i) ** 0.5
        else:
            raise ValueError(f"unknown weight init {init['init']!r}")
        w = torch.randn((i, o), generator=g, device=device) * std
        w = torch.clamp(torch.round(w), lo, hi).to(torch.int16)[orders[l]]
        if l + 1 < len(orders):
            w = w[:, orders[l + 1]]
        codes.append(w.contiguous())
    return codes


def make_pool(cfg: dict, traffic: dict, seed: int) -> np.ndarray:
    """The run's digit images: ``pool`` images rendered from the traffic's
    ``pool_seed`` (kept in ``build/perfbench/`` inside the checkout after
    the first run renders them), their pixels relabelled as the weights'
    inputs are (:func:`relabelling`), in an order drawn from the seed."""
    n, pseed = int(traffic["pool"]), int(traffic["pool_seed"])
    path = HERE.parent / "build" / "perfbench" / f"pool-{pseed}-{n}.npy"
    if path.exists():
        pool = np.load(path)
    else:
        pool = render_pool(pseed, n)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp.npy")
        np.save(tmp, pool)
        tmp.replace(path)
    pixels = relabelling(cfg, seed)[0]
    return pool[np.random.default_rng(seed).permutation(n)][:, pixels]


def program_config(cfg: dict):
    """The program's ``SNNConfig`` for a configuration file, every knob
    given (``backend="auto"``: the kernel the card holds the stack in)."""
    from repro_torch.core.lif import LIFConfig
    from repro_torch.core.snn import SNNConfig
    return SNNConfig(layer_sizes=tuple(cfg["layer_sizes"]),
                     num_steps=int(cfg["num_steps"]),
                     lif=LIFConfig(**cfg["lif"]), readout=cfg["readout"],
                     active_pruning=bool(cfg["active_pruning"]),
                     sparse_skip=bool(cfg["sparse_skip"]), backend="auto")
