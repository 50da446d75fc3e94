"""snn-mnist — the paper's model and its stack variants, as data.

784→10 fully connected LIF layer, 20-timestep window, signed 9-bit weight
codes, shift-4 decay (β = 1/16), threshold 128.  ``backend="auto"``
resolves on a card through the CUDA kernels (resident stack kernel →
weight-streaming stack kernel → staged kernels) and to the reference path
on the CPU.  Field for field the same configurations as
``repro.configs.snn_mnist``.
"""

from __future__ import annotations

from ..core.lif import LIFConfig
from ..core.snn import SNNConfig

__all__ = ["SNN_CONFIG", "SNN_CONFIG_PRUNED", "SNN_CONFIG_DEEP",
           "SNN_CONFIG_WIDE"]

_LIF = LIFConfig(decay_shift=4, v_threshold=128, v_rest=0)

SNN_CONFIG = SNNConfig(layer_sizes=(784, 10), num_steps=20, lif=_LIF,
                       readout="count", active_pruning=False, backend="auto")

# Active pruning with the first-spike readout (paper §III-D).
SNN_CONFIG_PRUNED = SNNConfig(layer_sizes=(784, 10), num_steps=20, lif=_LIF,
                              readout="first_spike", active_pruning=True,
                              backend="auto")

# Hidden-layer stack: inter-layer spikes stay on chip in the stack kernel.
SNN_CONFIG_DEEP = SNNConfig(layer_sizes=(784, 128, 64, 10), num_steps=20,
                            lif=_LIF, readout="count",
                            active_pruning=False, backend="auto")

# Widened stack whose per-lane state exceeds the resident stack kernel's
# shared memory: on a card ``auto`` runs it on the weight-streaming kernel.
SNN_CONFIG_WIDE = SNNConfig(layer_sizes=(784, 2048, 2048, 10), num_steps=20,
                            lif=_LIF, readout="count",
                            active_pruning=False, backend="auto")
