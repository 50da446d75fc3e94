"""PyTorch/CUDA port of the Poisson-encoded integer SNN (the ``repro`` package's
serving and training paths on an NVIDIA Hopper card).

The module layout mirrors ``repro``: ``core`` (PRNG, encoders, integer and
float LIF, telemetry, the SNN module, fixed point, conversion, pruning,
energy and the training routes), ``configs`` (the SNN configurations and
the LM archs with their registry), ``data`` (the procedural digits, the
LM token stream and the input pipeline), ``optim`` (SGD / AdamW /
Adafactor, schedules and int8 error-feedback compression), ``kernels``
(the hand-written CUDA kernels, their launchers and their plain PyTorch
versions), ``models`` (the LM zoo), ``train`` (the LM train step and
loop), ``checkpoint`` (checkpoints in the reference's format),
``distributed`` (meshes, sharding rules, partition specs), ``serve``
(the LM prefill/decode engine, the streaming SNN engines, the serving
tier and the cluster), ``launch`` (the LM serving and training
launchers) and ``tune``.  ``convert`` turns ``repro``'s parameters,
quantized, float or the LM's, into this package's, and an LM training
state both ways.

Entry points that create tensors take a ``device``: ``None`` means the CUDA
card, and raises when there is none — pass ``device="cpu"`` to run the plain
PyTorch paths on the CPU.  Nothing here imports JAX.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
