"""PyTorch/CUDA port of the Poisson-encoded integer SNN (the ``repro`` package's
serving path on an NVIDIA Hopper card).

The module layout mirrors ``repro``: ``core`` (PRNG, encoder, integer LIF,
telemetry, the SNN module), ``configs``, ``kernels`` (the hand-written CUDA
encode→LIF stack kernel, its launcher and its plain PyTorch version) and
``serve`` (the streaming engine).  ``convert`` turns ``repro``'s quantized
parameters into this package's.

Entry points that create tensors take a ``device``: ``None`` means the CUDA
card, and raises when there is none — pass ``device="cpu"`` to run the plain
PyTorch paths on the CPU.  Nothing here imports JAX.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
