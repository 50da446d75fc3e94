"""Operation counting and energy modelling (paper §V, Table II; port of
``repro.core.energy``).

The paper's efficiency claim is op-structural: the SNN executes *zero*
multiplications and a spike-sparsity-dependent number of integer additions,
versus the dense ANN's fixed 784×10 MAC grid.  Dynamic power is not
observable here, so the claim is reproduced the way the paper argues it:
count the operations each datapath executes and convert with published
per-op energy costs (Horowitz, ISSCC 2014, 45 nm — the standard reference
for this style of accounting).

Also extended (framework feature) to MoE models, where "active expert
FLOPs / total expert FLOPs" plays the role of spike sparsity.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "EnergyModel",
    "OpCounts",
    "ann_op_counts",
    "snn_op_counts",
    "snn_memory_bytes",
    "ann_memory_bytes",
]

# Horowitz ISSCC'14 (45 nm, pJ). int8 add 0.03, int32 add 0.1, int8 mult 0.2,
# fp32 add 0.9, fp32 mult 3.7.
_PJ = {
    "int8_add": 0.03,
    "int32_add": 0.1,
    "int8_mult": 0.2,
    "fp32_add": 0.9,
    "fp32_mult": 3.7,
    "shift": 0.01,       # barrel shifter, below an int8 add
    "compare": 0.03,     # magnitude comparator ≈ int add
}


@dataclass(frozen=True)
class OpCounts:
    multiplications: int
    additions: int
    shifts: int = 0
    comparisons: int = 0

    def energy_pj(self, mult_kind: str, add_kind: str) -> float:
        return (self.multiplications * _PJ[mult_kind]
                + self.additions * _PJ[add_kind]
                + self.shifts * _PJ["shift"]
                + self.comparisons * _PJ["compare"])


@dataclass(frozen=True)
class EnergyModel:
    """Bundles per-inference op counts into the paper's comparison table."""

    ann: OpCounts
    snn: OpCounts

    @property
    def ann_energy_pj(self) -> float:
        return self.ann.energy_pj("fp32_mult", "fp32_add")

    @property
    def snn_energy_pj(self) -> float:
        # SNN adds are int32 accumulator adds; no multiplies by construction.
        return self.snn.energy_pj("int8_mult", "int32_add")

    @property
    def energy_ratio(self) -> float:
        return self.ann_energy_pj / max(self.snn_energy_pj, 1e-12)


def ann_op_counts(n_in: int = 784, n_out: int = 10,
                  hidden: tuple[int, ...] = (32,)) -> OpCounts:
    """Dense MLP baseline: one MAC per weight + one add per bias.

    The paper's quoted numbers decode exactly to a 784→32→10 MLP:
    25,408 mults = 784·32 + 32·10 and 25,450 adds = 25,408 + 42 biases.
    """
    sizes = (n_in,) + tuple(hidden) + (n_out,)
    mults = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    biases = sum(sizes[1:])
    return OpCounts(multiplications=mults, additions=mults + biases,
                    comparisons=n_out)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def snn_op_counts(active_adds_per_step: np.ndarray | torch.Tensor,
                  n_neurons: int = 10, num_steps: int | None = None,
                  enabled_per_step: np.ndarray | torch.Tensor | None = None
                  ) -> OpCounts:
    """SNN op count from the integer engine's measured event stream.

    ``active_adds_per_step``: (T,) or (T, batch) — executed synaptic adds
    (spikes × enabled targets), as returned by ``run_lif_int``.
    Each enabled neuron also performs one shift (leak) and one comparison
    (threshold) per step.
    """
    a = _host(active_adds_per_step)
    if a.ndim > 1:
        a = a.mean(axis=tuple(range(1, a.ndim)))  # mean over batch
    T = num_steps if num_steps is not None else a.shape[0]
    adds = float(a.sum())
    if enabled_per_step is not None:
        en = float(_host(enabled_per_step).sum())
    else:
        en = float(T * n_neurons)
    return OpCounts(multiplications=0, additions=int(round(adds)),
                    shifts=int(en), comparisons=int(en))


def snn_memory_bytes(n_in: int = 784, n_out: int = 10, weight_bits: int = 9) -> float:
    """Paper §V-B: 784×10×9 bits ≈ 8.6 KB on-chip."""
    return n_in * n_out * weight_bits / 8.0


def ann_memory_bytes(n_in: int = 784, n_out: int = 10,
                     hidden: tuple[int, ...] = (32,)) -> float:
    """Baseline ANN footprint: fp32 weights + biases.

    784→32→10 fp32 = 25,450 params × 4 B = 101,800 B = 99.4 KiB — exactly the
    paper's Table II entry.
    """
    sizes = (n_in,) + tuple(hidden) + (n_out,)
    params = sum(a * b for a, b in zip(sizes[:-1], sizes[1:])) + sum(sizes[1:])
    return params * 4.0
