"""The integer SNN datapath on torch tensors: PRNG, encoder, LIF, telemetry
and the SNN module (port of ``repro.core``'s inference half)."""
