"""The SNN on torch tensors (port of ``repro.core``): PRNG, encoders,
integer and float LIF, telemetry, the SNN module with its integer engine
and its training half, fixed point, ANN→SNN conversion, pruning, the
energy model and the training routes (``train_snn``)."""
